#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``determined_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card (an
H100; the kernels are built for ``sm_90a``)::

    python3 chip_smoke.py

Phases, each printing one line of numbers; any failure raises and the
script exits non-zero without the final result line:

1. device — refuse to run without CUDA; print the card's name and power
   limit; disable TF32 so fp32 means fp32.
2. build  — compile the seven CUDA kernels from ``determined_tpu_torch/
   ops/csrc`` with nvcc (one process per source, started together).
3. kernels — each kernel against its plain PyTorch version on the same
   inputs, in bf16 (o and gradients atol/rtol 2e-2, lse atol 1e-3) and
   fp32 (atol 1e-5; the mono and fused blocked backward sum dq with fp32
   atomics in no fixed order, hence also rtol 1e-5 for every backward);
   kernel, plain and library (SDPA) times with the bound (max of FLOPs /
   peak and bytes / 3.35 TB/s), the TFLOP/s on live pairs and the share
   of the bound. The flash forward is held against its own plain version
   (``flash_fwd_plain``, p rounded to bf16 where the kernel rounds it)
   and against the entry point's plain path
   (``flash_attention_lse_plain``). The flash forward and paged kernels
   run at the serving shapes; the mono pair at (B 2, S 1024, causal), (B
   2, S 512, non-causal) and with a nonzero lse cotangent, then over
   ``MONO_GRID`` (the cases its persistent wgmma/TMA design makes risky:
   ragged tiles, s_q ≠ s_k causal and full, misaligned views, fewer work
   items than SMs and many more, s = 1448, no queries, no keys) at head
   dims 16/32/64/128 in both dtypes, and is timed at the train phase's
   shape (B 8, S 1024, H 12, D 64, causal, bf16) against SDPA's forward
   and, on a retained graph, SDPA's backward alone, and beside the
   blocked sm90 kernels (``flash_fwd``, ``flash_bwd_blocked``) on the
   same inputs; the backward wrapper's zeroing of its fp32 dq workspace
   and its cast are timed alone too. The blocked backward kernels — the
   fused ``flash_bwd_blocked`` and the two-pass ``flash_bwd_dq`` +
   ``flash_bwd_dkv`` — run
   ``BLOCKED_CASES`` (causal at S 2048, a 256 window, packed segments,
   kv_offset with s_q 512 and s_k 1024, a nonzero lse cotangent, all of
   them at once), then the shapes the main paths give them, in bf16: the
   packed phase's batch (B 8 × 1024, its ``pack_sequences`` segment ids;
   ``flash_fwd`` too; both timed), and the long-context shapes (B 1, H
   12, D 64, causal): ``flash_fwd`` and the fused kernel at S 16384
   against SDPA, the two passes and the fused kernel at S 32768. At the
   long shapes the plain versions run one head at a time (one [S, S]
   fp32 matrix per call); each kernel is held against it and timed
   beside it on the same inputs, and both once more at S ``PLAIN_SEQ`` =
   4096. The ``max_abs_err`` of rows 4–6 in the kernels line comes from
   these main-path shapes; every row names its ``shape``.
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
   wrong mask, scale or missing term moves them by O(1)). Three times:
   plain tokens through the mono pair; a packed batch with
   ``attn_window=256`` through ``flash_fwd`` and ``flash_bwd_blocked``;
   the same with the partials cap at 0 through ``flash_bwd_dq`` and
   ``flash_bwd_dkv``.
8. train-long — the long-context rung (``trainer/profile.py``
   ``RUNGS["long16k"]``: GPT-2-small at full width and depth, seq 16384,
   batch 1, ``remat=True``, ``fused_loss=True``) for 3 steps: losses
   finite and falling, per step exactly 12 ``flash_fwd`` and 12
   ``flash_bwd_blocked`` launches and no other port kernel; step ms,
   tokens/s, MFU, peak memory.
9. train-32k — the long32k rung at full width with its depth cut to 2
   layers (the two-pass backward takes ~190 ms a layer at 32k: at full
   depth one step would take seconds), 2 steps: rematted attention
   (``layer_loop="auto"`` past 16384 tokens), so per step 2
   ``flash_fwd`` launches per layer (the forward and its recompute) and
   one ``flash_bwd_dq`` and one ``flash_bwd_dkv`` per layer, nothing
   else.
10. train-packed — ``gpt.small()`` at B 8 × 1024 on one repeated
   ``pack_sequences`` batch of seeded random documents of 32–1024
   tokens, 5 steps: the loss falls, per step 12 ``flash_fwd`` and 12
   ``flash_bwd_blocked`` launches and no mono launch.

The last lines are the whole run's seconds, the kernels' JSON record,
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
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
BLOCKED_SOURCE = "determined_tpu_torch/ops/csrc/flash_bwd_blocked.cu"
BLOCKED_REPLACES = "determined_tpu/ops/flash_attention.py:499"
DQ_SOURCE = "determined_tpu_torch/ops/csrc/flash_bwd_dq.cu"
DQ_REPLACES = "determined_tpu/ops/flash_attention.py:594"
DKV_SOURCE = "determined_tpu_torch/ops/csrc/flash_bwd_dkv.cu"
DKV_REPLACES = "determined_tpu/ops/flash_attention.py:651"
PEAK_BF16 = 989e12
TRAIN_STEPS = 7
LONG_STEPS = 3        # long16k rung, full width and depth
LONG32_STEPS = 2      # long32k rung, full width
LONG32_LAYERS = 2     # depth cut of the 32k phase (see the docstring)
PACKED_STEPS = 5      # packed documents, B=8 x 1024
PLAIN_SEQ = 4096      # second long-context reading, plain backward on all heads
ENGINE_CFG = {
    "model": "small", "page_size": 128, "num_pages": 65,
    "max_pages_per_request": 8, "max_batch_size": 8, "prefill_rows": 4,
    "prefill_seq": 512, "max_new_tokens": 64,
}
NEAR_TIE = 1e-4
BLOCKED = ("flash_bwd_blocked", "flash_bwd_dq", "flash_bwd_dkv")
#: The blocked backward kernels' grid on the card (B, H 12, D 64).
BLOCKED_CASES = (
    ("causal-s2048", dict(b=1, s_q=2048, s_k=2048)),
    ("window256", dict(b=2, s_q=1024, s_k=1024, window=256, seed=1)),
    ("packed", dict(b=2, s_q=1024, s_k=1024, segs=True, seed=2)),
    ("kv-offset", dict(b=2, s_q=512, s_k=1024, kv_offset=512, seed=3)),
    ("causal-dlse", dict(b=2, s_q=1024, s_k=1024, dlse=True, seed=4)),
    ("all-masks-dlse", dict(b=2, s_q=512, s_k=1024, kv_offset=512,
                            window=256, segs=True, dlse=True, seed=5)),
)


#: The mono pair's grid on the card (name, B, H, s_q, s_k, causal, layout):
#: ragged tiles, s_q ≠ s_k under the top-left causal mask and without it,
#: misaligned views (copied before TMA), fewer work items than SMs and
#: many more (the persistent walk wraps), ``_mono_ok``'s largest square, no
#: queries, no keys.
MONO_GRID = (
    ("ragged-200", 2, 3, 200, 200, True, "qkv"),
    ("ragged-200-full", 2, 3, 200, 200, False, "qkv"),
    ("sq-lt-sk-causal", 2, 3, 96, 300, True, "qkv"),
    ("sq-gt-sk-causal", 2, 3, 300, 96, True, "qkv"),
    ("sq-lt-sk-full", 2, 3, 96, 300, False, "qkv"),
    ("sq-gt-sk-full", 2, 3, 300, 96, False, "qkv"),
    ("odd-base", 2, 3, 200, 200, True, "odd-base"),
    ("odd-stride", 2, 3, 200, 200, True, "odd-stride"),
    ("few-items", 1, 2, 128, 128, True, "qkv"),
    ("wraps", 8, 12, 1024, 1024, True, "qkv"),
    ("largest", 1, 2, 1448, 1448, True, "qkv"),
    ("no-queries", 2, 3, 0, 64, False, "qkv"),
    ("no-keys", 2, 3, 64, 0, False, "qkv"),
)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def packed_batch(b, s, seed, vocab):
    """One ``pack_sequences`` batch [b, s] of seeded random documents of
    32-1024 tokens below `vocab` (tokens, segment_ids, loss_mask)."""
    from determined_tpu_torch.trainer.profile import packed_batch as batch

    return batch(b, s, seed, vocab)


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
                   window=None, segs=None, seed=0, block=512):
        """flash_fwd against its plain version and SDPA. `segs`: None,
        "packed" (seeded documents), "decode" (the gather-decode layout) or
        an int32 [b, s_k] array of segment ids."""
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
        if segs is not None and not isinstance(segs, str):
            qseg = kseg = torch.from_numpy(np.asarray(segs, np.int32)).to(
                self.dev)
        elif segs == "packed":
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
                  block_q=min(block, s_q), block_k=min(block, s_k))
        fw = dict(causal=True, window=window, kv_offset=kv_offset,
                  segment_ids=qseg, kv_segment_ids=kseg)
        o_k, lse_k = tfa.flash_attention_lse(q, k, v, **kw)
        o_p, lse_p = tfa.flash_attention_lse_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        self.check(name, dtype, o_k, o_p, lse_k, lse_p)
        # the kernel against its own plain version (p rounded where the
        # kernel rounds it)
        o_k, lse_k = tfa.flash_fwd(q, k, v, **fw)
        o_p, lse_p = tfa.flash_fwd_plain(q, k, v, **fw)
        torch.cuda.synchronize()
        self.check(f"{name} kernel-level", dtype, o_k, o_p, lse_k, lse_p)
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
        ms = self.time_ms(lambda: tfa.flash_fwd(q, k, v, **fw))
        plain_ms = self.time_ms(
            lambda: tfa.flash_fwd_plain(q, k, v, **fw), iters=5)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        attn_mask = mask[:, None]
        library_ms = self.time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=attn_mask))
        rec = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                   **self.rates(4.0 * d * live, ms, bound_ms))
        self.report("kernels", f"flash_fwd {name} {str(dtype)[6:]}", rec)
        return rec

    def rates(self, flops, ms, bound_ms):
        """A record's TFLOP/s on live pairs and share of the bound."""
        return dict(tflops=flops / ms / 1e9, bound_share=bound_ms / ms)

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
                   bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                   **self.rates(flops, ms, bound_ms))
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
        for kname, per_pair, kernel, plain, library, (bound_ms, bound_by), \
                err in (
            ("flash_fwd_mono", 4,
             lambda: tfa.flash_fwd_mono(q, k, v, causal=causal),
             lambda: tfa.flash_fwd_mono_plain(q, k, v, causal=causal),
             lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                    is_causal=causal),
             fwd_bound, fwd_err),
            ("flash_bwd_mono", 10,
             lambda: tfa.flash_bwd_mono(*bwd_args, causal=causal),
             lambda: tfa.flash_bwd_mono_plain(*bwd_args, causal=causal),
             self.sdpa_backward(qh, kh, vh, do, causal),
             bwd_bound, bwd_err),
        ):
            ms = self.time_ms(kernel)
            recs.append(dict(
                ms=ms, plain_ms=self.time_ms(plain, iters=5),
                library_ms=self.time_ms(library), bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err,
                **self.rates(per_pair * d * live, ms, bound_ms),
            ))
        # the blocked sm90 kernels on the same inputs: that design's time
        # at this size with nothing mono-specific
        recs[0]["blocked_sm90_ms"] = self.time_ms(
            lambda: tfa.flash_fwd(q, k, v, causal=causal))
        recs[1]["blocked_sm90_ms"] = self.time_ms(
            lambda: tfa.flash_bwd_blocked(*bwd_args, causal=causal))
        # what the backward's wrapper adds around its kernel: zeroing the
        # fp32 dq workspace and casting it to the input dtype
        ws = torch.zeros((b, s, h, d), dtype=torch.float32, device=self.dev)
        recs[1]["dq_zero_ms"] = self.time_ms(
            lambda: torch.zeros((b, s, h, d), dtype=torch.float32,
                                device=self.dev))
        recs[1]["dq_cast_ms"] = self.time_ms(lambda: ws.to(dtype))
        self.report("kernels", f"flash_fwd_mono {tag}", recs[0])
        self.report("kernels", f"flash_bwd_mono {tag}", recs[1])
        return recs

    def mono_grid(self, dtype):
        """The mono pair against its plain versions over ``MONO_GRID`` at
        every head dim, with and without an lse cotangent; one line with
        the cases run and the largest differences."""
        import torch

        from determined_tpu_torch.ops import flash_attention as tfa

        errs = {"fwd": 0.0, "bwd": 0.0}
        n = 0
        for name, b, h, s_q, s_k, causal, layout in MONO_GRID:
            for d in (16, 32, 64, 128):
                gen = torch.Generator(device=self.dev).manual_seed(d + s_q)
                q, k, v, do = self.layout_views(dtype, layout, b, h, s_q,
                                                s_k, d, gen)
                dl = torch.randn((b, s_q, h), generator=gen, device=self.dev)
                tag = f"mono grid {name} d{d} {str(dtype)[6:]}"
                o_k, lse_k = tfa.flash_fwd_mono(q, k, v, causal=causal)
                o_p, lse_p = tfa.flash_fwd_mono_plain(q, k, v, causal=causal)
                torch.cuda.synchronize()
                self.check(tag, dtype, o_k, o_p, lse_k, lse_p)
                if o_k.numel():
                    errs["fwd"] = max(errs["fwd"], float(
                        (o_k.float() - o_p.float()).abs().max()))
                delta = (do.float() * o_p.float()).sum(-1)
                for cot in (None, dl):
                    args = (q, k, v, do, lse_p, delta, cot)
                    got = tfa.flash_bwd_mono(*args, causal=causal)
                    want = tfa.flash_bwd_mono_plain(*args, causal=causal)
                    torch.cuda.synchronize()
                    errs["bwd"] = max(errs["bwd"],
                                      self.hold_grads(tag, dtype, got, want))
                n += 1
        self.report("kernels", f"mono grid {str(dtype)[6:]}",
                    dict(cases=n, fwd_max_abs_err=errs["fwd"],
                         bwd_max_abs_err=errs["bwd"]))

    def layout_views(self, dtype, layout, b, h, s_q, s_k, d, gen):
        """q/k/v as the kernels meet them: "qkv" strided views of one
        [B, S, 3, H, D] projection (as GPT passes them), "odd-base"
        contiguous tensors one element past 16-byte alignment, "odd-stride"
        rows padded to D + 1 elements; and do."""
        if layout == "qkv":
            qkv = self.randn((b, max(s_q, s_k), 3, h, d), dtype, gen)
            q, k, v = qkv[:, :s_q, 0], qkv[:, :s_k, 1], qkv[:, :s_k, 2]
        elif layout == "odd-base":
            n_q, n_k = b * s_q * h * d, b * s_k * h * d
            flat = self.randn((n_q + 2 * n_k + 1,), dtype, gen)
            q = flat[1:1 + n_q].view(b, s_q, h, d)
            k = flat[1 + n_q:1 + n_q + n_k].view(b, s_k, h, d)
            v = flat[1 + n_q + n_k:].view(b, s_k, h, d)
        else:
            q = self.randn((b, s_q, h, d + 1), dtype, gen)[..., :d]
            k = self.randn((b, s_k, h, d + 1), dtype, gen)[..., :d]
            v = self.randn((b, s_k, h, d + 1), dtype, gen)[..., :d]
        return q, k, v, self.randn((b, s_q, h, d), dtype, gen)

    def sdpa_backward(self, qh, kh, vh, do, causal, attn_mask=None):
        """SDPA's backward alone: autograd.grad over a retained graph."""
        import torch
        import torch.nn.functional as F

        xs = [x.detach().requires_grad_() for x in (qh, kh, vh)]
        out = F.scaled_dot_product_attention(*xs, is_causal=causal,
                                             attn_mask=attn_mask)
        doh = do.transpose(1, 2).contiguous()
        return lambda: torch.autograd.grad(out, xs, doh, retain_graph=True)

    # -- phase 3: the blocked backward kernels ----------------------------------
    def blocked_inputs(self, dtype, *, b, s_q, s_k, kv_offset=0, window=None,
                       segs=False, dlse=False, seed=0):
        """q/k/v as strided views of one [B, S, 3, H, D] tensor (as GPT
        passes them), do, lse/delta from the plain forward, an optional lse
        cotangent and segment ids (`segs`: True for seeded documents of
        32-512 tokens, or an int32 [b, s_k] array) → (positional args,
        keyword args) of the kernel-level backward wrappers."""
        import numpy as np
        import torch

        from determined_tpu_torch.ops import flash_attention as tfa

        h, d = 12, 64
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        qkv = self.randn((b, s_k, 3, h, d), dtype, gen)
        q = qkv[:, s_k - s_q:, 0]
        k, v = qkv[:, :, 1], qkv[:, :, 2]
        do = self.randn((b, s_q, h, d), dtype, gen)
        dl = (torch.randn((b, s_q, h), generator=gen, device=self.dev)
              if dlse else None)
        kw = dict(causal=True, window=window, kv_offset=kv_offset)
        if segs is True:
            rng = np.random.default_rng(seed)
            ids = np.zeros((b, s_k), np.int32)
            for r in range(b):
                pos, doc = 0, 1
                while pos < s_k:
                    n = int(rng.integers(32, 513))
                    ids[r, pos:pos + n] = doc
                    pos, doc = pos + n, doc + 1
            segs = ids
        if segs is not False:
            kseg = torch.from_numpy(np.asarray(segs, np.int32)).to(self.dev)
            kw.update(segment_ids=kseg[:, s_k - s_q:], kv_segment_ids=kseg)
        o, lse = tfa.flash_attention_lse_plain(
            q, k, v, block_q=s_q, block_k=tfa.fit_block(s_k, 1024), **kw)
        delta = (do.float() * o.float()).sum(-1)
        return (q, k, v, do, lse, delta, dl), kw

    def blocked_run(self, name, args, kw):
        """One blocked backward kernel on the card → (dq, dk, dv), None
        where it computes nothing."""
        from determined_tpu_torch.ops import flash_attention as tfa

        if name == "flash_bwd_dq":
            return tfa.flash_bwd_dq(*args, **kw), None, None
        if name == "flash_bwd_dkv":
            return (None, *tfa.flash_bwd_dkv(*args, **kw))
        return tfa.flash_bwd_blocked(*args, **kw)

    def hold_grads(self, what, dtype, got, want):
        """Each gradient the kernel computed against the plain one (bf16
        atol/rtol 2e-2, fp32 1e-5) → the largest difference."""
        torch = self.torch
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
        err = 0.0
        for which, g, w in zip(("dq", "dk", "dv"), got, want):
            if g is None:
                continue
            torch.testing.assert_close(g.float(), w.float(), atol=tol,
                                       rtol=tol, msg=f"{what}: {which}")
            if g.numel():
                err = max(err, float((g.float() - w.float()).abs().max()))
        return err

    def fwd_plain_by_head(self, q, k, v):
        """flash_fwd_plain (causal) one head at a time → (o, lse)."""
        import torch

        from determined_tpu_torch.ops import flash_attention as tfa

        parts = [tfa.flash_fwd_plain(q[:, :, i:i + 1], k[:, :, i:i + 1],
                                     v[:, :, i:i + 1], causal=True)
                 for i in range(q.shape[2])]
        return tuple(torch.cat(x, dim=2) for x in zip(*parts))

    def plain_by_head(self, args, kw):
        """The dense plain backward one head at a time, so one [S, S] fp32
        score matrix is live per call (1.1 GB at S 16384, 4.3 GB at 32768)
        → (dq, dk, dv) of every head."""
        import torch

        from determined_tpu_torch.ops import flash_attention as tfa

        parts = [
            tfa.flash_bwd_blocked_plain(
                *(None if x is None else x[:, :, i:i + 1] for x in args), **kw)
            for i in range(args[0].shape[2])
        ]
        return tuple(torch.cat(g, dim=2) for g in zip(*parts))

    def blocked_case(self, name, dtype, timed=False, **shape):
        """flash_bwd_blocked, and flash_bwd_dq + flash_bwd_dkv, against the
        dense plain formula on the same inputs → largest differences. With
        `timed`, also the fused kernel's record at this shape: its time,
        the plain formula's, SDPA's backward alone under the same dense
        mask, and the bound."""
        import torch

        from determined_tpu_torch.ops import flash_attention as tfa

        args, kw = self.blocked_inputs(dtype, **shape)
        want = tfa.flash_bwd_blocked_plain(*args, **kw)
        errs = {}
        for kernel in BLOCKED:
            got = self.blocked_run(kernel, args, kw)
            torch.cuda.synchronize()
            errs[kernel] = self.hold_grads(f"{kernel} {name}", dtype, got,
                                           want)
        self.report("kernels", f"blocked-backward {name} {str(dtype)[6:]}",
                    {f"{k}_max_abs_err": v for k, v in errs.items()})
        if not timed:
            return errs
        q, k, v, do = args[:4]
        b, s_q, h, d = q.shape
        s_k = k.shape[1]
        rows = torch.arange(s_q, device=self.dev)[:, None] + kw["kv_offset"]
        cols = torch.arange(s_k, device=self.dev)[None, :]
        mask = (rows >= cols)[None].expand(b, s_q, s_k)
        if kw.get("segment_ids") is not None:
            mask = mask & (kw["segment_ids"][:, :, None]
                           == kw["kv_segment_ids"][:, None, :])
        live = int(mask.sum()) * h
        item = q.element_size()
        nbytes = 7 * q.numel() * item + 2 * 4 * b * s_q * h
        bound_ms, bound_by = self.bound(10.0 * d * live, nbytes, dtype)
        ms = self.time_ms(lambda: tfa.flash_bwd_blocked(*args, **kw))
        plain_ms = self.time_ms(
            lambda: tfa.flash_bwd_blocked_plain(*args, **kw), iters=5)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        library_ms = self.time_ms(self.sdpa_backward(
            qh, kh, vh, do, False, attn_mask=mask[:, None]))
        rec = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   max_abs_err=errs["flash_bwd_blocked"],
                   **self.rates(10.0 * d * live, ms, bound_ms))
        self.report("kernels", f"flash_bwd_blocked {name} "
                    f"{str(dtype)[6:]}", rec)
        return errs

    def long_timed(self, seq, kernels):
        """`kernels` at a long-context training shape (B 1, H 12, D 64,
        causal, bf16, seq `seq`), each held against its plain version on
        the same inputs (the backward's dense formula one head at a time)
        and timed beside it: flash_fwd and flash_bwd_blocked against SDPA's
        forward and backward; flash_bwd_dq and flash_bwd_dkv with no
        library time (no single library call computes one pass alone;
        SDPA's whole backward is printed beside them). The same again at
        PLAIN_SEQ, where the plain backward runs on all heads at once."""
        import torch
        import torch.nn.functional as F

        from determined_tpu_torch.ops import flash_attention as tfa

        bf16 = torch.bfloat16
        h, d = 12, 64
        item = 2
        # FLOP per live pair / D, [B, S, H, D] outputs
        work = {"flash_bwd_blocked": (10, 3), "flash_bwd_dq": (6, 1),
                "flash_bwd_dkv": (8, 2)}
        recs = {name: dict(shape=f"B1 S{seq} H12 D64 causal bf16", seq=seq)
                for name in kernels}
        for s in (seq, PLAIN_SEQ):
            args, kw = self.blocked_inputs(bf16, b=1, s_q=s, s_k=s, seed=7)
            q, k, v, do = args[:4]
            live = h * s * (s + 1) // 2
            big = s == seq
            it, plain_it = (3, 1) if big else (10, 3)
            blk = dict(causal=True, block_q=min(1024, s),
                       block_k=min(1024, s))
            if big:
                plain_bwd = lambda: self.plain_by_head(args, kw)
            else:
                plain_bwd = lambda: tfa.flash_bwd_blocked_plain(*args, **kw)
            want = plain_bwd() if kernels != ("flash_fwd",) else None
            bwd_plain_ms = None
            for name in kernels:
                if name == "flash_fwd":
                    kernel = lambda: tfa.flash_fwd(q, k, v, causal=True)
                    if big:
                        plain = lambda: self.fwd_plain_by_head(q, k, v)
                    else:
                        plain = lambda: tfa.flash_fwd_plain(q, k, v,
                                                            causal=True)
                    o_k, lse_k = kernel()
                    o_p, lse_p = tfa.flash_attention_lse_plain(q, k, v,
                                                               **blk)
                    torch.cuda.synchronize()
                    self.check(f"flash_fwd long S{s}", bf16, o_k, o_p, lse_k,
                               lse_p)
                    o_p, lse_p = plain()
                    torch.cuda.synchronize()
                    self.check(f"flash_fwd long S{s} kernel-level", bf16, o_k,
                               o_p, lse_k, lse_p)
                    err = float((o_k.float() - o_p.float()).abs().max())
                    del o_k, lse_k, o_p, lse_p
                    plain_ms = self.time_ms(plain, iters=plain_it, warmup=1)
                    flops = 4.0 * d * live
                    nbytes = 4 * q.numel() * item + 4 * s * h
                else:
                    per_pair, outs = work[name]
                    kernel = lambda: self.blocked_run(name, args, kw)
                    got = kernel()
                    torch.cuda.synchronize()
                    err = self.hold_grads(f"{name} long S{s}", bf16, got,
                                          want)
                    del got
                    if bwd_plain_ms is None:  # one formula for all three
                        bwd_plain_ms = self.time_ms(plain_bwd, iters=plain_it,
                                                    warmup=0 if big else 1)
                    plain_ms = bwd_plain_ms
                    flops = per_pair * d * live
                    # q, k, v, do and lse, delta read; the outputs written
                    nbytes = (4 + outs) * q.numel() * item + 2 * 4 * s * h
                ms = self.time_ms(kernel, iters=it, warmup=1)
                rec = recs[name]
                if not big:
                    rec.update(plain_seq=s, ms_at_plain_seq=ms,
                               plain_ms_at_plain_seq=plain_ms,
                               max_abs_err_at_plain_seq=err)
                    continue
                bound_ms, bound_by = self.bound(flops, nbytes, bf16)
                qh, kh, vh = (x.transpose(1, 2).contiguous()
                              for x in (q, k, v))
                if name == "flash_fwd":
                    lib = lambda: F.scaled_dot_product_attention(
                        qh, kh, vh, is_causal=True)
                else:
                    lib = self.sdpa_backward(qh, kh, vh, do, True)
                sdpa_ms = self.time_ms(lib, iters=it, warmup=1)
                del qh, kh, vh, lib
                rec.update(
                    ms=ms, plain_ms=plain_ms, max_abs_err=err,
                    bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=(sdpa_ms if name in ("flash_fwd",
                                                    "flash_bwd_blocked")
                                else None),
                    sdpa_ms=sdpa_ms,
                    **self.rates(flops, ms, bound_ms))
            del args, q, k, v, do, want, plain_bwd
            torch.cuda.empty_cache()
        for name, rec in recs.items():
            self.report("kernels", f"{name} long-context", rec)
        return recs

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


    # -- phases 6 and 8-10: training through Trainer.fit ---------------------------
    def fit_counted(self, trial, steps):
        """``Trainer(trial).fit`` for `steps` steps on the card, with the
        launch counters set to 0 just before → (reports, per-step launch
        counts, the run's launch counts, peak GB, config)."""
        import numpy as np
        import torch

        from determined_tpu_torch import core
        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.trainer import Batch, Trainer

        snapshots = []
        data = trial.build_training_data

        def counted():
            """Snapshots the launch counters as each step takes its batch."""
            for batch in data():
                snapshots.append({n: k.launches
                                  for n, k in _build.KERNELS.items()})
                yield batch

        trial.build_training_data = counted
        ctx = core._dummy_init()
        trainer = Trainer(trial, ctx)  # the card, by default
        cfg = trainer.model.config
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in _build.KERNELS.values():
            k.launches = 0
        trainer.fit(max_length=Batch(steps), report_period=Batch(1))
        launches = {n: k.launches for n, k in _build.KERNELS.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        snapshots.append(launches)
        reports = [m for g, _, m in ctx.train._reported if g == "training"]
        assert len(reports) == steps, reports
        losses = [m.get("loss", float("nan")) for m in reports]
        assert all(np.isfinite(losses)), losses
        per_step = [{n: after[n] - before[n] for n in after}
                    for before, after in zip(snapshots, snapshots[1:])]
        del trainer
        torch.cuda.empty_cache()
        return reports, per_step, launches, peak_gb, cfg

    def train_record(self, reports, launches, peak_gb, cfg, batch, seq,
                     warm):
        """Loss, step ms (median after `warm` steps), tokens/s, MFU and
        peak memory of a fit, plus the port kernels' launches."""
        import numpy as np

        step_ms = float(np.median(
            [1e3 / m["batches_per_second"] for m in reports[warm:]]))
        tokens_per_s = batch * seq / (step_ms / 1e3)
        return dict(
            steps=len(reports), batch=batch, seq=seq, layers=cfg.n_layers,
            loss_first=reports[0]["loss"], loss_last=reports[-1]["loss"],
            grad_norm_last=reports[-1]["grad_norm"], step_ms_median=step_ms,
            tokens_per_s=tokens_per_s,
            mfu=tokens_per_s * cfg.train_flops_per_token() / PEAK_BF16,
            max_memory_allocated_gb=peak_gb,
            **{f"{n}_launches": v for n, v in launches.items() if v},
        )

    def train_phase(self):
        from determined_tpu_torch.trainer.profile import RepeatedBatchTrial

        b, s = 8, 1024
        reports, per_step, launches, peak_gb, cfg = self.fit_counted(
            RepeatedBatchTrial(b, s), TRAIN_STEPS)
        losses = [m["loss"] for m in reports]
        assert losses[-1] < losses[0], losses
        n_layers = cfg.n_layers
        for i, step in enumerate(per_step):
            assert step["flash_fwd_mono"] == n_layers, (i, step)
            assert step["flash_bwd_mono"] == n_layers, (i, step)
            assert step["flash_fwd"] == 0, (i, step)
        self.report("train", "gpt2-small bf16 remat=False",
                    self.train_record(reports, launches, peak_gb, cfg, b, s,
                                      warm=2))
        return launches

    def train_long_phase(self):
        """The long16k rung at full width and depth: flash_fwd and the
        fused blocked backward only."""
        from determined_tpu_torch.trainer.profile import RUNGS, RepeatedBatchTrial

        b, cfg = RUNGS["long16k"]
        s = cfg.seq_len
        reports, per_step, launches, peak_gb, cfg = self.fit_counted(
            RepeatedBatchTrial(b, s, config=cfg), LONG_STEPS)
        losses = [m["loss"] for m in reports]
        assert losses[-1] < losses[0], losses
        want = dict(flash_fwd=cfg.n_layers, flash_bwd_blocked=cfg.n_layers)
        for i, step in enumerate(per_step):
            got = {n: v for n, v in step.items() if v}
            assert got == want, (i, step)
        self.report("train-long", "gpt2-small bf16 long16k remat fused_loss",
                    self.train_record(reports, launches, peak_gb, cfg, b, s,
                                      warm=1))
        return launches

    def train_32k_phase(self):
        """The long32k rung at full width, depth cut to LONG32_LAYERS:
        rematted attention (two forwards per layer and step) and the
        two-pass backward."""
        from determined_tpu_torch.trainer.profile import RUNGS, RepeatedBatchTrial

        b, cfg = RUNGS["long32k"]
        cfg = dataclasses.replace(cfg, n_layers=LONG32_LAYERS)
        s = cfg.seq_len
        reports, per_step, launches, peak_gb, cfg = self.fit_counted(
            RepeatedBatchTrial(b, s, config=cfg), LONG32_STEPS)
        n = cfg.n_layers
        want = dict(flash_fwd=2 * n, flash_bwd_dq=n, flash_bwd_dkv=n)
        for i, step in enumerate(per_step):
            got = {k: v for k, v in step.items() if v}
            assert got == want, (i, step)
        self.report("train-32k", f"gpt2-small-width L{n} bf16 long32k "
                    "remat_attention fused_loss",
                    self.train_record(reports, launches, peak_gb, cfg, b, s,
                                      warm=1))
        return launches

    def train_packed_phase(self):
        """gpt.small() on packed documents at B=8 x 1024: the blocked
        forward and the fused blocked backward."""
        from determined_tpu_torch.trainer.profile import RepeatedBatchTrial

        b, s = 8, 1024
        from determined_tpu_torch.models import gpt

        trial = RepeatedBatchTrial(b, s, config=gpt.small())
        batch = packed_batch(b, s, 3, trial.config.vocab_size)

        def repeated():
            while True:
                yield batch

        trial.build_training_data = repeated
        reports, per_step, launches, peak_gb, cfg = self.fit_counted(
            trial, PACKED_STEPS)
        losses = [m["loss"] for m in reports]
        assert losses[-1] < losses[0], losses
        want = dict(flash_fwd=cfg.n_layers, flash_bwd_blocked=cfg.n_layers)
        for i, step in enumerate(per_step):
            got = {n: v for n, v in step.items() if v}
            assert got == want, (i, step)
        rec = self.train_record(reports, launches, peak_gb, cfg, b, s, warm=2)
        rec["documents"] = int(batch["segment_ids"].max(axis=1).sum())
        self.report("train-packed", "gpt2-small bf16 packed documents", rec)
        return launches

    # -- phase 7: one fp32 step, card against CPU ----------------------------------
    def train_parity_phase(self, route="mono"):
        """One fp32 loss + gradient of GPT-2-small's width with 2 layers,
        batch 1 x seq 1024, on the card and on the CPU from the same
        parameters. "mono": plain tokens through the mono pair; "fused" and
        "two_pass": a packed batch with attn_window=256 through flash_fwd
        and the fused blocked backward, or (the partials cap set to 0 for
        the card's call) the dq and dk/dv passes."""
        import numpy as np
        import torch

        from determined_tpu_torch.models import gpt
        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.ops import flash_attention as tfa
        from determined_tpu_torch.trainer import optim

        cfg = dataclasses.replace(gpt.small(), n_layers=2,
                                  dtype=torch.float32, remat=False)
        if route == "mono":
            batch = {"tokens": np.random.default_rng(1).integers(
                0, cfg.vocab_size, size=(1, cfg.seq_len)).astype(np.int32)}
            want = dict(flash_fwd_mono=2, flash_bwd_mono=2)
        else:
            cfg = dataclasses.replace(cfg, attn_window=256)
            batch = packed_batch(1, cfg.seq_len, 5, cfg.vocab_size)
            want = ({"flash_fwd": 2, "flash_bwd_blocked": 2}
                    if route == "fused" else
                    {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2})
        cpu = gpt.GPT(cfg, device="cpu", seed=1)
        card = gpt.GPT(cfg, device=self.dev)
        card.load_state_dict(cpu.state_dict())
        cap = tfa._FUSED_BWD_PARTIALS_CAP
        out = {}
        for where, model in (("card", card), ("cpu", cpu)):
            before = {n: k.launches for n, k in _build.KERNELS.items()}
            if where == "card" and route == "two_pass":
                tfa._FUSED_BWD_PARTIALS_CAP = 0
            try:
                loss, _ = model.loss({k: torch.from_numpy(v)
                                      for k, v in batch.items()})
                grads = torch.autograd.grad(loss, list(model.parameters()))
            finally:
                tfa._FUSED_BWD_PARTIALS_CAP = cap
            out[where] = (float(loss.detach()), float(optim.global_norm(grads)),
                          [g.detach().cpu() for g in grads])
            if where == "card":
                got = {n: k.launches - before[n]
                       for n, k in _build.KERNELS.items()
                       if k.launches != before[n]}
                assert got == want, (
                    f"the card's {route} step did not go through its "
                    f"kernels: {got}")
        (loss_c, norm_c, g_c), (loss_p, norm_p, g_p) = out["card"], out["cpu"]
        assert abs(loss_c - loss_p) <= 1e-5 * abs(loss_p), (loss_c, loss_p)
        assert abs(norm_c - norm_p) <= 1e-4 * norm_p, (norm_c, norm_p)
        worst = 0.0
        for (name, _), gc, gp in zip(card.named_parameters(), g_c, g_p):
            scale = float(gp.abs().max())
            err = float((gc - gp).abs().max())
            assert err <= 1e-4 * scale, (name, err, scale)
            worst = max(worst, err / scale if scale else 0.0)
        what = "gpt2-small-width L2 fp32 card vs cpu"
        if route != "mono":
            what += f" packed window256 {route}"
        self.report("train-parity", what,
                    dict(loss_card=loss_c, loss_cpu=loss_p,
                         grad_norm_card=norm_c, grad_norm_cpu=norm_p,
                         leaves=len(g_c), worst_leaf_rel_err=worst))


def main() -> int:
    import torch

    t_start = time.perf_counter()
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
    for dtype in (bf16, fp32):
        smoke.mono_grid(dtype)
    mono_fwd, mono_bwd = smoke.mono_case("train", bf16, b=8, s=1024,
                                         causal=True, dlse=False, seed=3,
                                         timed=True)
    for dtype in (bf16, fp32):
        for name, shape in BLOCKED_CASES:
            smoke.blocked_case(name, dtype, **shape)
    # the shapes the main paths give the blocked kernels: the packed
    # phase's batch, the long16k rung, the long32k rung (flash_bwd_blocked
    # there too, beside the two passes the route picks)
    from determined_tpu_torch.models import gpt

    packed_ids = packed_batch(8, 1024, 3, gpt.small().vocab_size)[
        "segment_ids"]
    smoke.flash_case("packed-b8x1024", bf16, b=8, s_q=1024, s_k=1024,
                     segs=packed_ids, block=1024)
    packed_err = smoke.blocked_case("packed-b8x1024", bf16, timed=True, b=8,
                                    s_q=1024, s_k=1024, segs=packed_ids)
    long16 = smoke.long_timed(16384, ("flash_fwd", "flash_bwd_blocked"))
    long32 = smoke.long_timed(32768, ("flash_bwd_dq", "flash_bwd_dkv",
                                      "flash_bwd_blocked"))
    long_recs = {"flash_bwd_blocked": long16["flash_bwd_blocked"],
                 "flash_bwd_dq": long32["flash_bwd_dq"],
                 "flash_bwd_dkv": long32["flash_bwd_dkv"]}
    long_recs["flash_bwd_blocked"]["max_abs_err"] = max(
        long16["flash_bwd_blocked"]["max_abs_err"],
        packed_err["flash_bwd_blocked"])

    # -- phases 4 to 10: the main paths ----------------------------------------------
    launches = smoke.engine_phase()
    smoke.greedy_phase()
    launches.update({n: v for n, v in smoke.train_phase().items()
                     if n in ("flash_fwd_mono", "flash_bwd_mono")})
    smoke.train_parity_phase()
    smoke.train_parity_phase("fused")
    smoke.train_parity_phase("two_pass")
    launches["flash_bwd_blocked"] = \
        smoke.train_long_phase()["flash_bwd_blocked"]
    launches.update({n: v for n, v in smoke.train_32k_phase().items()
                     if n in ("flash_bwd_dq", "flash_bwd_dkv")})
    smoke.train_packed_phase()

    kernels = []
    mono_shape = "B8 S1024 H12 D64 causal bf16"
    for name, source, replaces, rec, shape in (
        ("flash_fwd", FLASH_SOURCE, FLASH_REPLACES, flash[bf16],
         "B4 S512 H12 D64 causal packed bf16"),
        ("paged_attention", PAGED_SOURCE, PAGED_REPLACES, paged[bf16],
         "B8 R1 H12 D64 8 pages of 128 bf16"),
        ("flash_fwd_mono", MONO_FWD_SOURCE, MONO_FWD_REPLACES, mono_fwd,
         mono_shape),
        ("flash_bwd_mono", MONO_BWD_SOURCE, MONO_BWD_REPLACES, mono_bwd,
         mono_shape),
        *((name, source, replaces, long_recs[name], long_recs[name]["shape"])
          for name, source, replaces in (
              ("flash_bwd_blocked", BLOCKED_SOURCE, BLOCKED_REPLACES),
              ("flash_bwd_dq", DQ_SOURCE, DQ_REPLACES),
              ("flash_bwd_dkv", DKV_SOURCE, DKV_REPLACES))),
    ):
        assert launches[name] > 0, f"{name} never launched on its main path"
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": shape, "tflops": rec["tflops"],
            "bound_share": rec["bound_share"],
        })
    print(f"phase total: seconds={time.perf_counter() - t_start:.1f} "
          f"| card {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
