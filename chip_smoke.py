#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``determined_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card (an
H100; the kernels are built for ``sm_90a``)::

    python3 chip_smoke.py

Phases, each printing one line of numbers; any failure raises and the
script exits non-zero without the final result line:

1. device — refuse to run without CUDA; print the card's name and power
   limit; disable TF32 so fp32 means fp32.
2. build  — compile the four CUDA kernels from ``determined_tpu_torch/
   ops/csrc`` with nvcc (one process per source, started together).
3. kernels — each kernel against its plain PyTorch version on the same
   inputs, in bf16 (o and gradients atol/rtol 2e-2, lse atol 1e-3) and
   fp32 (atol 1e-5; the mono backward sums dq with fp32 atomics in no
   fixed order, hence also rtol 1e-5 there); kernel, plain and library
   (SDPA) times with the bound (max of FLOPs / peak and bytes /
   3.35 TB/s). The flash forward and paged kernels run at the serving
   shapes; the mono pair at (B 2, S 1024, causal), (B 2, S 512,
   non-causal) and with a nonzero lse cotangent, and is timed at the
   train phase's shape (B 8, S 1024, H 12, D 64, causal, bf16) against
   SDPA's forward and, on a retained graph, SDPA's backward alone.
4. engine — GPT-2-small at full width (bf16, seeded random weights)
   behind ``build_engine``: 8 requests, then 4 late joiners while the
   first are mid-decode; every request must finish with reason
   ``length``, every page must come back, and the launch counters must
   show 12 flash launches per prefill and 12 paged launches per decode
   iteration.
5. greedy — the same engine at fp32 on the paged kernel, then with
   ``DTPU_PAGED_ATTN=0`` (gather → flash kernel), 4 requests each: one
   full-context ``apply`` over prompt + generated must argmax-predict
   every emitted token except where its top-2 margin is below 1e-4, and
   the two kernels' streams must agree up to the first such near-tie.
6. train — GPT-2-small at full width and depth, bf16 over fp32 master
   parameters, ``remat=False``, batch 8 × seq 1024 of one seeded batch,
   through ``Trainer(trial).fit(max_length=Batch(7),
   report_period=Batch(1))`` under ``chain(clip_by_global_norm(1.0),
   adamw(3e-4))``: every loss finite, the last below the first, and per
   step exactly 12 ``flash_fwd_mono`` and 12 ``flash_bwd_mono`` launches
   and no ``flash_fwd`` launch; median step ms after two warm-up steps,
   tokens/s, MFU (``train_flops_per_token`` against 989 TFLOP/s bf16
   dense) and peak device memory.
7. train-parity — one fp32 loss + gradient of GPT-2-small's width with 2
   layers, batch 1 × seq 1024, from the same parameters, on the card
   (the kernels) and on the CPU (the plain path): loss within 1e-5
   relative, grad_norm within 1e-4 relative, and every gradient leaf
   within 1e-4 of its own largest magnitude (fp32 on both sides; the
   sums run in other orders — cuBLAS, the kernels' tiles and fp32
   atomics against the CPU's — which moves results by ~1e-6 relative; a
   wrong mask, scale or missing term moves them by O(1)).

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
FLASH_SOURCE = "determined_tpu_torch/ops/csrc/flash_fwd.cu"
FLASH_REPLACES = "determined_tpu/ops/flash_attention.py:236"
PAGED_SOURCE = "determined_tpu_torch/ops/csrc/paged_attention.cu"
PAGED_REPLACES = "determined_tpu/ops/paged_attention.py:114"
MONO_FWD_SOURCE = "determined_tpu_torch/ops/csrc/flash_fwd_mono.cu"
MONO_FWD_REPLACES = "determined_tpu/ops/flash_attention.py:438"
MONO_BWD_SOURCE = "determined_tpu_torch/ops/csrc/flash_bwd_mono.cu"
MONO_BWD_REPLACES = "determined_tpu/ops/flash_attention.py:461"
PEAK_BF16 = 989e12
TRAIN_STEPS = 7
ENGINE_CFG = {
    "model": "small", "page_size": 128, "num_pages": 65,
    "max_pages_per_request": 8, "max_batch_size": 8, "prefill_rows": 4,
    "prefill_seq": 512, "max_new_tokens": 64,
}
NEAR_TIE = 1e-4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class Smoke:
    def __init__(self, torch, card: str) -> None:
        self.torch = torch
        self.card = card
        self.dev = torch.device("cuda", 0)
        self.peak = {torch.bfloat16: 989e12, torch.float32: 67e12}

    # -- helpers ------------------------------------------------------------
    def time_ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        """Device ms per call: CUDA events around `iters` calls queued
        behind a ~50 ms spin kernel, so the host has enqueued them all
        before the first starts and its per-call overhead (and any CPU
        contention) adds no gaps between them."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def bound(self, flops: float, nbytes: float, dtype):
        t_ops = flops / self.peak[dtype]
        t_bytes = nbytes / HBM_BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    def randn(self, shape, dtype, gen):
        return self.torch.randn(shape, generator=gen, device=self.dev).to(dtype)

    # -- phase 3: flash forward ------------------------------------------------
    def flash_case(self, name, dtype, *, b, s_q, s_k, kv_offset=0,
                   window=None, segs=None, seed=0):
        import numpy as np
        import torch
        import torch.nn.functional as F

        from determined_tpu_torch.ops import flash_attention as tfa

        h, d = 12, 64
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        rng = np.random.default_rng(seed)
        q = self.randn((b, s_q, h, d), dtype, gen)
        k = self.randn((b, s_k, h, d), dtype, gen)
        v = self.randn((b, s_k, h, d), dtype, gen)
        qseg = kseg = None
        if segs == "packed":
            ids = np.zeros((b, s_k), np.int32)
            for r in range(b):
                n_docs = int(rng.integers(3, 6))
                used = int(rng.integers(s_k * 3 // 4, s_k - 8))
                cuts = np.sort(rng.choice(np.arange(1, used), n_docs - 1,
                                          replace=False))
                for i, (lo, hi) in enumerate(zip([0, *cuts], [*cuts, used])):
                    ids[r, lo:hi] = i + 1
            qseg = kseg = torch.from_numpy(ids).to(self.dev)
        elif segs == "decode":
            lengths = np.array([0, 1023, 517, 1, 260, 900, 128, 64][:b])
            active = np.arange(b) != 4
            pos = np.arange(s_k)[None, :]
            kseg = torch.from_numpy(
                ((pos <= lengths[:, None]) & active[:, None]).astype(np.int32)
            ).to(self.dev)
            qseg = torch.from_numpy(
                np.where(active, 1, 2).astype(np.int32)[:, None]
            ).to(self.dev)
        kw = dict(causal=True, window=window, kv_offset=kv_offset,
                  segment_ids=qseg, kv_segment_ids=kseg,
                  block_q=min(512, s_q), block_k=min(512, s_k))
        o_k, lse_k = tfa.flash_attention_lse(q, k, v, **kw)
        o_p, lse_p = tfa.flash_attention_lse_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        self.check(name, dtype, o_k, o_p, lse_k, lse_p)
        err = float((o_k.float() - o_p.float()).abs().max())

        # dense mask of the same function: band + segments → live pairs
        rows = torch.arange(s_q, device=self.dev)[:, None] + kv_offset
        cols = torch.arange(s_k, device=self.dev)[None, :]
        mask = (rows >= cols)
        if window is not None:
            mask = mask & (rows - cols < window)
        mask = mask[None].expand(b, s_q, s_k)
        if qseg is not None:
            mask = mask & (qseg[:, :, None] == kseg[:, None, :])
        live = int(mask.sum()) * h
        item = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * item \
            + 4 * b * s_q * h + (4 * b * (s_q + s_k) if qseg is not None else 0)
        bound_ms, bound_by = self.bound(4.0 * d * live, nbytes, dtype)
        ms = self.time_ms(lambda: tfa.flash_attention_lse(q, k, v, **kw))
        plain_ms = self.time_ms(
            lambda: tfa.flash_attention_lse_plain(q, k, v, **kw), iters=5)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        attn_mask = mask[:, None]
        library_ms = self.time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=attn_mask))
        rec = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
        self.report("kernels", f"flash_fwd {name} {str(dtype)[6:]}", rec)
        return rec

    # -- phase 3: paged decode ------------------------------------------------
    def paged_case(self, name, dtype, *, q_rows, ragged, seed=0):
        import numpy as np
        import torch
        import torch.nn.functional as F

        from determined_tpu_torch.ops import paged_attention as tpa

        b, p, ps, h, d = 8, 8, 128, 12, 64
        num_pages = b * p + 1
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        rng = np.random.default_rng(seed)
        k_pool = self.randn((num_pages, ps, h, d), dtype, gen)
        v_pool = self.randn((num_pages, ps, h, d), dtype, gen)
        pt = rng.permutation(np.arange(1, num_pages)).reshape(b, p)
        q_lens = (rng.integers(1, 6, size=b) if ragged
                  else np.ones(b, np.int64))
        lengths = np.array([0, 1023, 517, 1, 260, 900, 128, 64])
        lengths = np.minimum(lengths, p * ps - q_lens)
        active = np.arange(b) != 4
        q = self.randn((b, q_rows, h, d), dtype, gen)
        dev_i32 = [torch.from_numpy(a.astype(np.int32)).to(self.dev)
                   for a in (pt, lengths, active, q_lens)]
        args = (q, k_pool, v_pool, *dev_i32[:3])
        kw = dict(q_lens=dev_i32[3])
        o_k = tpa.paged_attention(*args, **kw)
        o_p = tpa.paged_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        self.check(name, dtype, o_k, o_p)
        err = float((o_k.float() - o_p.float()).abs().max())

        r = np.arange(q_rows)[None, :]
        visible = lengths[:, None] + np.minimum(r, q_lens[:, None] - 1) + 1
        flops = 4.0 * d * h * float((visible * active[:, None]).sum())
        item = q.element_size()
        kv_bytes = 2 * item * h * d * float(((lengths + q_lens) * active).sum())
        nbytes = kv_bytes + 2 * q.numel() * item + 4 * (b * p + 3 * b)
        bound_ms, bound_by = self.bound(flops, nbytes, dtype)
        ms = self.time_ms(lambda: tpa.paged_attention(*args, **kw))
        plain_ms = self.time_ms(
            lambda: tpa.paged_attention_plain(*args, **kw), iters=5)
        pt_long = dev_i32[0].long()
        cols = torch.arange(p * ps, device=self.dev)
        bound = torch.from_numpy(visible - 1).to(self.dev)
        attn_mask = ((cols[None, None, :] <= bound[:, :, None])
                     & torch.from_numpy(active).to(self.dev)[:, None, None])
        attn_mask = attn_mask[:, None]
        qh = q.transpose(1, 2)

        def library():
            k_full = k_pool[pt_long].reshape(b, p * ps, h, d).transpose(1, 2)
            v_full = v_pool[pt_long].reshape(b, p * ps, h, d).transpose(1, 2)
            return F.scaled_dot_product_attention(qh, k_full, v_full,
                                                  attn_mask=attn_mask)

        library_ms = self.time_ms(library)
        rec = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
        self.report("kernels", f"paged_attention {name} {str(dtype)[6:]}", rec)
        return rec

    # -- phase 3: the mono pair (training attention) ----------------------------
    def mono_case(self, name, dtype, *, b, s, causal, dlse, seed=0,
                  timed=False):
        import torch
        import torch.nn.functional as F

        from determined_tpu_torch.ops import flash_attention as tfa

        h, d = 12, 64
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        qkv = self.randn((b, s, 3, h, d), dtype, gen)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # as GPT passes them
        do = self.randn((b, s, h, d), dtype, gen)
        dl = (torch.randn((b, s, h), generator=gen, device=self.dev)
              if dlse else None)
        o_k, lse_k = tfa.flash_fwd_mono(q, k, v, causal=causal)
        o_p, lse_p = tfa.flash_fwd_mono_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        self.check(f"{name} fwd", dtype, o_k, o_p, lse_k, lse_p)
        delta = (do.float() * o_p.float()).sum(-1)
        bwd_args = (q, k, v, do, lse_p, delta, dl)
        g_k = tfa.flash_bwd_mono(*bwd_args, causal=causal)
        g_p = tfa.flash_bwd_mono_plain(*bwd_args, causal=causal)
        torch.cuda.synchronize()
        for which, gk, gp in zip(("dq", "dk", "dv"), g_k, g_p):
            if dtype == torch.bfloat16:
                torch.testing.assert_close(gk.float(), gp.float(), atol=2e-2,
                                           rtol=2e-2, msg=f"{name}: {which}")
            else:
                torch.testing.assert_close(gk, gp, atol=1e-5, rtol=1e-5,
                                           msg=f"{name}: {which}")
        fwd_err = float((o_k.float() - o_p.float()).abs().max())
        bwd_err = max(float((gk.float() - gp.float()).abs().max())
                      for gk, gp in zip(g_k, g_p))
        tag = f"{name} {str(dtype)[6:]}"
        if not timed:
            self.report("kernels", f"flash_fwd_mono {tag}",
                        dict(max_abs_err=fwd_err))
            self.report("kernels", f"flash_bwd_mono {tag}",
                        dict(max_abs_err=bwd_err))
            return None, None
        live = b * h * (s * (s + 1) // 2 if causal else s * s)
        item = q.element_size()
        qkv_bytes = 3 * q.numel() * item
        rows = 4 * b * s * h  # one fp32 per (b, query, head)
        fwd_bound = self.bound(4.0 * d * live, qkv_bytes + o_k.numel() * item
                               + rows, dtype)
        bwd_bound = self.bound(
            10.0 * d * live,
            qkv_bytes + do.numel() * item + (3 if dlse else 2) * rows
            + 3 * q.numel() * item, dtype)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        recs = []
        for kernel, plain, library, (bound_ms, bound_by), err in (
            (lambda: tfa.flash_fwd_mono(q, k, v, causal=causal),
             lambda: tfa.flash_fwd_mono_plain(q, k, v, causal=causal),
             lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                    is_causal=causal),
             fwd_bound, fwd_err),
            (lambda: tfa.flash_bwd_mono(*bwd_args, causal=causal),
             lambda: tfa.flash_bwd_mono_plain(*bwd_args, causal=causal),
             self.sdpa_backward(qh, kh, vh, do, causal),
             bwd_bound, bwd_err),
        ):
            recs.append(dict(
                ms=self.time_ms(kernel), plain_ms=self.time_ms(plain, iters=5),
                library_ms=self.time_ms(library), bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err,
            ))
        self.report("kernels", f"flash_fwd_mono {tag}", recs[0])
        self.report("kernels", f"flash_bwd_mono {tag}", recs[1])
        return recs

    def sdpa_backward(self, qh, kh, vh, do, causal):
        """SDPA's backward alone: autograd.grad over a retained graph."""
        import torch
        import torch.nn.functional as F

        xs = [x.detach().requires_grad_() for x in (qh, kh, vh)]
        out = F.scaled_dot_product_attention(*xs, is_causal=causal)
        doh = do.transpose(1, 2).contiguous()
        return lambda: torch.autograd.grad(out, xs, doh, retain_graph=True)

    def check(self, name, dtype, o_k, o_p, lse_k=None, lse_p=None):
        torch = self.torch
        if dtype == torch.bfloat16:
            torch.testing.assert_close(o_k.float(), o_p.float(), atol=2e-2,
                                       rtol=2e-2, msg=f"{name}: o")
            if lse_k is not None:
                torch.testing.assert_close(lse_k, lse_p, atol=1e-3, rtol=1e-6,
                                           msg=f"{name}: lse")
        else:
            torch.testing.assert_close(o_k, o_p, atol=1e-5, rtol=0,
                                       msg=f"{name}: o")
            if lse_k is not None:
                torch.testing.assert_close(lse_k, lse_p, atol=1e-5, rtol=1e-6,
                                           msg=f"{name}: lse")

    def report(self, phase, what, rec):
        nums = " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in rec.items()
        )
        print(f"phase {phase}: {what} {nums} | card {self.card}", flush=True)

    # -- phase 4: the engine at full width ------------------------------------
    def engine_phase(self):
        import numpy as np
        import torch

        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.serving import build_engine

        eng = build_engine(ENGINE_CFG)  # the card, by default
        rng = np.random.default_rng(0)
        vocab = eng.model.config.vocab_size
        n_layers = eng.model.config.n_layers
        eng.start()
        try:
            warm = eng.submit(list(rng.integers(1, vocab, size=64)),
                              max_new_tokens=2)
            assert warm.result(timeout=600)["reason"] == "length"
            before = eng.stats()
            for k in _build.KERNELS.values():
                k.launches = 0
            t0 = time.perf_counter()
            first = [
                eng.submit(list(rng.integers(1, vocab, size=int(n))),
                           max_new_tokens=64 - 4 * i)
                for i, n in enumerate(rng.integers(64, 481, size=8))
            ]
            # late joiners arrive while the batch is mid-decode
            give_up = time.perf_counter() + 300
            while (len(first[0].tokens) < 8 and not first[0].finish_reason
                   and time.perf_counter() < give_up):
                time.sleep(0.005)
            late = [
                eng.submit(list(rng.integers(1, vocab, size=int(n))),
                           max_new_tokens=64, temperature=0.8 * (i == 3))
                for i, n in enumerate(rng.integers(64, 481, size=4))
            ]
            reqs = first + late
            results = [r.result(timeout=600) for r in reqs]
            wall = time.perf_counter() - t0
            after = eng.stats()
            launches = {k: v.launches for k, v in _build.KERNELS.items()}
        finally:
            eng.stop()
        reasons = [res.get("reason", res.get("error")) for res in results]
        assert reasons == ["length"] * len(reqs), reasons
        assert after["pages_in_use"] == 0, after
        for r, res in zip(reqs, results):
            assert len(res["tokens"]) == r.max_new_tokens
            assert all(0 <= t < vocab for t in res["tokens"])
        iters = after["decode_iterations"] - before["decode_iterations"]
        prefills = after["prefill_batches"] - before["prefill_batches"]
        assert launches["paged_attention"] == n_layers * iters, (launches, iters)
        assert launches["flash_fwd"] == n_layers * prefills, (launches, prefills)
        tokens = sum(len(res["tokens"]) for res in results)
        ttft = sorted((r.t_first_token - r.t_submit) * 1e3 for r in reqs)
        rec = dict(
            requests=len(reqs), tokens=tokens, prefills=prefills,
            decode_iterations=iters, tokens_per_s=tokens / wall,
            ttft_p50_ms=float(np.percentile(ttft, 50)),
            ttft_p99_ms=float(np.percentile(ttft, 99)),
            decode_iter_ms=(after["decode_seconds"] - before["decode_seconds"])
            * 1e3 / iters,
            flash_launches=launches["flash_fwd"],
            paged_launches=launches["paged_attention"],
        )
        self.report("engine", "gpt2-small bf16", rec)
        del eng
        torch.cuda.empty_cache()
        return launches

    # -- phase 5: greedy parity at fp32 -----------------------------------------
    def greedy_phase(self):
        import numpy as np
        import torch

        from determined_tpu_torch.models import gpt
        from determined_tpu_torch.serving import GenerationEngine, ServingConfig

        model = gpt.GPT(dataclasses.replace(gpt.small(), dtype=torch.float32))
        cfg = ServingConfig.from_dict({**ENGINE_CFG, "max_new_tokens": 32})
        rng = np.random.default_rng(1)
        prompts = [list(rng.integers(1, model.config.vocab_size, size=int(n)))
                   for n in rng.integers(64, 481, size=4)]
        streams = {}
        for kernel, env in (("paged", None), ("gather", "0")):
            if env is None:
                os.environ.pop("DTPU_PAGED_ATTN", None)
            else:
                os.environ["DTPU_PAGED_ATTN"] = env
            eng = GenerationEngine(model, None, cfg)
            assert eng.stats()["decode_kernel"] == kernel
            eng.start()
            try:
                reqs = [eng.submit(p, max_new_tokens=32) for p in prompts]
                res = [r.result(timeout=600) for r in reqs]
            finally:
                eng.stop()
            assert all(r["reason"] == "length" for r in res), res
            streams[kernel] = [r["tokens"] for r in res]
            del eng
        os.environ.pop("DTPU_PAGED_ATTN", None)
        near_ties = 0
        for prompt, paged, gather in zip(prompts, streams["paged"],
                                         streams["gather"]):
            first_tie = None
            for kernel, gen_toks in (("paged", paged), ("gather", gather)):
                seq = prompt + gen_toks
                logits = model.apply(torch.tensor([seq], device=model.device))
                top2 = logits[0].float().topk(2, dim=-1)
                for i in range(len(prompt) - 1, len(seq) - 1):
                    margin = float(top2.values[i, 0] - top2.values[i, 1])
                    if margin < NEAR_TIE:
                        near_ties += 1
                        if kernel == "paged" and first_tie is None:
                            first_tie = i - (len(prompt) - 1)
                        continue
                    assert int(top2.indices[i, 0]) == seq[i + 1], (
                        f"{kernel}: greedy divergence at position {i}"
                    )
            upto = len(paged) if first_tie is None else first_tie
            assert paged[:upto] == gather[:upto], (paged, gather)
        rec = dict(requests=len(prompts), tokens_per_stream=32,
                   near_ties=near_ties,
                   identical_streams=sum(p == g for p, g in
                                         zip(streams["paged"],
                                             streams["gather"])))
        self.report("greedy", "gpt2-small fp32 paged vs gather", rec)


    # -- phase 6: training at full width ------------------------------------------
    def train_phase(self):
        import numpy as np
        import torch

        from determined_tpu_torch import core
        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.trainer import Batch, Trainer
        from determined_tpu_torch.trainer.profile import RepeatedBatchTrial

        snapshots = []

        class CountedTrial(RepeatedBatchTrial):
            """Snapshots the launch counters as each step takes its batch."""

            def build_training_data(self):
                for batch in super().build_training_data():
                    snapshots.append({n: k.launches
                                      for n, k in _build.KERNELS.items()})
                    yield batch

        b, s = 8, 1024
        trial = CountedTrial(b, s)
        ctx = core._dummy_init()
        trainer = Trainer(trial, ctx)  # the card, by default
        cfg = trainer.model.config
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in _build.KERNELS.values():
            k.launches = 0
        trainer.fit(max_length=Batch(TRAIN_STEPS), report_period=Batch(1))
        launches = {n: k.launches for n, k in _build.KERNELS.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        snapshots.append(launches)
        reports = [m for g, _, m in ctx.train._reported if g == "training"]
        assert len(reports) == TRAIN_STEPS, reports
        losses = [m.get("loss", float("nan")) for m in reports]
        assert all(np.isfinite(losses)), losses
        assert losses[-1] < losses[0], losses
        n_layers = cfg.n_layers
        for i, (before, after) in enumerate(zip(snapshots, snapshots[1:])):
            step = {n: after[n] - before[n] for n in after}
            assert step["flash_fwd_mono"] == n_layers, (i, step)
            assert step["flash_bwd_mono"] == n_layers, (i, step)
            assert step["flash_fwd"] == 0, (i, step)
        step_ms = float(np.median(
            [1e3 / m["batches_per_second"] for m in reports[2:]]))
        tokens_per_s = b * s / (step_ms / 1e3)
        rec = dict(
            steps=TRAIN_STEPS, batch=b, seq=s, loss_first=losses[0],
            loss_last=losses[-1], grad_norm_last=reports[-1]["grad_norm"],
            step_ms_median=step_ms, tokens_per_s=tokens_per_s,
            mfu=tokens_per_s * cfg.train_flops_per_token() / PEAK_BF16,
            max_memory_allocated_gb=peak_gb,
            flash_fwd_mono_launches=launches["flash_fwd_mono"],
            flash_bwd_mono_launches=launches["flash_bwd_mono"],
            flash_fwd_launches=launches["flash_fwd"],
        )
        self.report("train", "gpt2-small bf16 remat=False", rec)
        del trainer
        torch.cuda.empty_cache()
        return launches

    # -- phase 7: one fp32 step, card against CPU ----------------------------------
    def train_parity_phase(self):
        import numpy as np
        import torch

        from determined_tpu_torch.models import gpt
        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.trainer import optim

        cfg = dataclasses.replace(gpt.small(), n_layers=2,
                                  dtype=torch.float32, remat=False)
        cpu = gpt.GPT(cfg, device="cpu", seed=1)
        card = gpt.GPT(cfg, device=self.dev)
        card.load_state_dict(cpu.state_dict())
        tokens = np.random.default_rng(1).integers(
            0, cfg.vocab_size, size=(1, cfg.seq_len)).astype(np.int32)
        mono = (_build.FLASH_FWD_MONO, _build.FLASH_BWD_MONO)
        before = [k.launches for k in mono]
        out = {}
        for where, model in (("card", card), ("cpu", cpu)):
            loss, _ = model.loss({"tokens": torch.from_numpy(tokens)})
            grads = torch.autograd.grad(loss, list(model.parameters()))
            out[where] = (float(loss.detach()), float(optim.global_norm(grads)),
                          [g.detach().cpu() for g in grads])
        assert [k.launches - n for k, n in zip(mono, before)] == [2, 2], (
            "the card's step did not go through the mono kernels")
        (loss_c, norm_c, g_c), (loss_p, norm_p, g_p) = out["card"], out["cpu"]
        assert abs(loss_c - loss_p) <= 1e-5 * abs(loss_p), (loss_c, loss_p)
        assert abs(norm_c - norm_p) <= 1e-4 * norm_p, (norm_c, norm_p)
        worst = 0.0
        for (name, _), gc, gp in zip(card.named_parameters(), g_c, g_p):
            scale = float(gp.abs().max())
            err = float((gc - gp).abs().max())
            assert err <= 1e-4 * scale, (name, err, scale)
            worst = max(worst, err / scale if scale else 0.0)
        self.report("train-parity", "gpt2-small-width L2 fp32 card vs cpu",
                    dict(loss_card=loss_c, loss_cpu=loss_p,
                         grad_norm_card=norm_c, grad_norm_cpu=norm_p,
                         leaves=len(g_c), worst_leaf_rel_err=worst))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from determined_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: run from the repo root ({exc})", file=sys.stderr)
        return 2

    # -- phase 1: device --------------------------------------------------------
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke(torch, card)
    print(f"phase device: {torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda} | card {card}", flush=True)

    # -- phase 2: build ----------------------------------------------------------
    build_s = _build.build_all()
    print(f"phase build: seconds={build_s:.3f} kernels="
          f"{','.join(_build.KERNELS)}", flush=True)
    for k in _build.KERNELS.values():
        for line in k.ptxas_report():
            print(f"  ptxas {k.name}: {line}", flush=True)

    # -- phase 3: kernels against their plain versions ---------------------------
    bf16, fp32 = torch.bfloat16, torch.float32
    flash = {}
    for dtype in (bf16, fp32):
        flash[dtype] = smoke.flash_case("prefill", dtype, b=4, s_q=512,
                                        s_k=512, segs="packed")
        smoke.flash_case("gather-decode", dtype, b=8, s_q=1, s_k=1024,
                         kv_offset=1023, segs="decode", seed=1)
        smoke.flash_case("window128", dtype, b=4, s_q=512, s_k=512,
                         window=128, seed=2)
    paged = {}
    for dtype in (bf16, fp32):
        paged[dtype] = smoke.paged_case("decode", dtype, q_rows=1,
                                        ragged=False)
        smoke.paged_case("ragged-qlens", dtype, q_rows=8, ragged=True,
                         seed=1)
    for dtype in (bf16, fp32):
        smoke.mono_case("causal", dtype, b=2, s=1024, causal=True,
                        dlse=False)
        smoke.mono_case("full", dtype, b=2, s=512, causal=False, dlse=False,
                        seed=1)
        smoke.mono_case("causal-dlse", dtype, b=2, s=1024, causal=True,
                        dlse=True, seed=2)
    mono_fwd, mono_bwd = smoke.mono_case("train", bf16, b=8, s=1024,
                                         causal=True, dlse=False, seed=3,
                                         timed=True)

    # -- phases 4 to 7: the main paths -----------------------------------------------
    launches = smoke.engine_phase()
    smoke.greedy_phase()
    launches.update({n: v for n, v in smoke.train_phase().items()
                     if n in ("flash_fwd_mono", "flash_bwd_mono")})
    smoke.train_parity_phase()

    kernels = []
    for name, source, replaces, rec in (
        ("flash_fwd", FLASH_SOURCE, FLASH_REPLACES, flash[bf16]),
        ("paged_attention", PAGED_SOURCE, PAGED_REPLACES, paged[bf16]),
        ("flash_fwd_mono", MONO_FWD_SOURCE, MONO_FWD_REPLACES, mono_fwd),
        ("flash_bwd_mono", MONO_BWD_SOURCE, MONO_BWD_REPLACES, mono_bwd),
    ):
        assert launches[name] > 0, f"{name} never launched on its main path"
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
