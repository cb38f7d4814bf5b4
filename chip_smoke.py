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
   run at the serving shapes, the paged kernel also at 32 slots of 8 full
   pages (where bytes, not latency, set its time; two paged launches must
   agree bit for bit); the mono pair at (B 2, S 1024, causal), (B
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
   them at once; two dq launches and two dk/dv launches must each agree
   bit for bit), then the shapes the main paths give them, in bf16: the
   packed phase's batch (B 8 × 1024, its ``pack_sequences`` segment ids;
   ``flash_fwd`` too; both timed), and the long-context shapes (B 1, H
   12, D 64, causal): ``flash_fwd`` and the fused kernel at S 16384
   against SDPA, the two passes and the fused kernel at S 32768. At the
   long shapes the plain versions run one head at a time (one [S, S]
   fp32 matrix per call); each kernel is held against it and timed
   beside it on the same inputs, and both once more at S ``PLAIN_SEQ`` =
   4096, where ``flash_bwd_dq`` is also held against the plain copy of
   its own tile walk (``_bwd_dq_walk_plain``: the same ds roundings and
   the same fp32 summation order by tile) at bf16 atol 2e-3 and rtol
   2^-7 (one bf16 ulp; the 2e-2 of the other bf16 checks would pass an
   error ten times larger). At S 32768 one more line, ``route-32k``, times
   the two routes past the partials cap on the same inputs: the fused
   kernel against the dq and dk/dv passes back to back. The
   ``max_abs_err`` of rows 4–6 in the kernels line comes from these
   main-path shapes; every row names its ``shape``.
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
9. train-32k — the long32k rung (``RUNGS["long32k"]``) as it stands:
   GPT-2-small at full width and depth (12 layers), seq 32768, batch 1,
   2 steps: losses finite and falling; rematted attention
   (``layer_loop="auto"`` past 16384 tokens), so per step 2
   ``flash_fwd`` launches per layer (the forward and its recompute) and
   one ``flash_bwd_dq`` and one ``flash_bwd_dkv`` per layer, nothing
   else.
10. train-packed — ``gpt.small()`` at B 8 × 1024 on one repeated
   ``pack_sequences`` batch of seeded random documents of 32–1024
   tokens, 5 steps: the loss falls, per step 12 ``flash_fwd`` and 12
   ``flash_bwd_blocked`` launches and no mono launch.
11. checkpoint — the train phase's trial (GPT-2-small, bf16 over fp32
   masters, B 8 × 1024): run A, ``core.init(checkpoint_storage=<tmp>)``
   and ``fit(max_length=Batch(4), checkpoint_period=Batch(2))``, saves at
   steps 2 and 4 in the reference's format; run B, a fresh ``Trainer``,
   resumes with ``fit(max_length=Batch(4), latest_checkpoint=<step 2>)``.
   The state restored at step 2 (step, every parameter, every ``mu``,
   ``nu`` and ``count``) must equal the step-2 snapshot bit for bit; run
   B's losses at steps 3–4 run A's within 1e-3 relative (the mono
   backward sums dq by fp32 atomics, so bf16 steps do not repeat bit for
   bit); per step 12 ``flash_fwd_mono`` and 12 ``flash_bwd_mono``
   launches. Prints the checkpoint's bytes and files, the host-blocking
   snapshot, the background write + upload, and the restore's verify and
   load, in ms and GB/s. Then run A's step-4 parameters, saved as a
   parameter-only checkpoint, are served at fp32 through
   ``build_engine`` with ``DTPU_SERVING_CHECKPOINT``: 4 greedy requests
   must stream exactly what an engine built in memory from the same
   arrays streams. The checkpoints (~1.5 GB each) live in a temporary
   directory, removed at the end of the phase.
12. fixture — ``serving.fixture.ensure_fixture(<tmp>)`` on the card: it
   trains the fixture (300 steps, the mono pair at fp32 and seq 64, 2
   launches of each a step), whose final loss must be ≤ 0.05; a second
   call must load it without training; then ``{"model": "fixture"}`` is
   served from its directory: the greedy continuation (20 tokens) of
   each of the 12 phrases, prompted with the phrase twice, must follow
   the phrase's cycle in ≥ 95% of tokens, through ``flash_fwd`` and
   ``paged_attention``.
13. serving-http — the reference bench's serving rung
   (``SERVING_HTTP_CFG``: GPT-2-small bf16, seeded, 129 pages × 128, 8
   slots, prefill 4 × 512) behind ``GenerationServer`` on 127.0.0.1,
   driven by ``loadgen.drive`` over ``zipf_prefix_prompts(16,
   corpus_size=4, prefix_len=256, suffix_len=16, seed=7)`` at
   concurrency 8 and 32 new tokens, twice over the same list: cache off +
   spec off, then cache on + spec ngram (draft 4, min match 2). Prints
   tokens/s, TTFT p50 and p99, hit rate, proposed and accepted drafts,
   the median decode iteration, and the launches of ``flash_fwd`` at the
   cached-tail geometry (B 4, s_q 512, s_k 1536, kv_offset 1024) and of
   ``paged_attention`` at 5 query rows. Every request ends with
   ``length`` and 32 tokens, every page is back after ``flush()``, and
   the second pass hits the cache, proposes drafts and launches both
   kernels at those geometries.
14. serving-parity — fp32 (TF32 off): GPT-2-small greedy streams of 6 of
   those prompts × 16 tokens (in two waves, so the second hits the
   cache) under cache off / spec off, cache on / spec off and cache on /
   spec on, on the paged kernel and with ``DTPU_PAGED_ATTN=0``: every
   emitted token is the full-context argmax of ``apply`` except at a
   near-tie (top-2 margin < 1e-4), and all six configurations stream the
   same tokens up to the first near-tie; ``flash_fwd`` must have run at
   the cached-tail and the speculative gather geometry and
   ``paged_attention`` at 5 query rows; then the pre-trained fixture
   (trained anew in a temporary directory) on
   ``corpus_ngram_prompts(8, fixture_phrases(), seed=7)``: spec on
   streams exactly what spec off streams, with drafts accepted.
15. train-health — the train phase's trial (GPT-2-small, bf16 over fp32
   masters, B 8 × 1024) on an indexed stream (batch i from seed 1000 +
   i mod 4, O(1) ``skip``, every index recorded) under
   ``health=TRAIN_HEALTH`` (``max_consecutive_skips`` 2, ``spike_zscore``
   6, ``spike_min_history`` 4), ``checkpoint_period=Batch(4)``,
   ``report_period=Batch(1)``, ``profiling=True`` and a temporary
   ``tensorboard_dir``. Non-finite drill: ``fit`` to step 8, then to 16
   with ``train.nonfinite`` ``failures=2``: two skipped steps, one
   rollback to the step-8 checkpoint (the restored state bitwise the
   step-8 state), ``_data_offset`` 2, the recorder 0..17 (indices 8 and
   9 poisoned, steps 9–16 on 10..17). Spike drill: to 24 with
   ``train.spike`` ``failures=1``: the ×1e6 step applied and reported,
   a second rollback, ``_data_offset`` 3. Every report finite, the last
   loss below the first, per step (poisoned and spiked ones too) 12
   ``flash_fwd_mono`` and 12 ``flash_bwd_mono`` launches and nothing
   else. The ``profiling`` group carries the phase fractions (summing to
   1 within 1e-6), 0 < ``goodput_pct`` < 100, ``rollback_lost_s`` > 0,
   ``step_flops`` and, from the profiler agent, ``device0_bytes_in_use``
   above the parameters and Adam state (1.49 GB); the tfevents file,
   read back with ``read_scalars``, holds every reported loss and is
   synced to checkpoint storage; a fresh ``Trainer`` resuming the final
   checkpoint trains on index 27 with ``ledger_restarts`` 1. Prints each
   rollback restore's blocking ms (verify + load), then the median step
   ms with the sentinel, timeline, profiler agent and TensorBoard all on
   and all off (``DTPU_TIMELINE=0``, default health, no profiling) over
   ``HEALTH_COST_ROUNDS`` interleaved rounds of ``HEALTH_COST_STEPS``.

Phase 3 also holds ``flash_fwd`` at the cached-tail geometry (separate
query and key segment ids as ``_prefill_cached`` builds them, one row all
padding) and at the speculative gather verify's (B 8, s_q 5, s_k 1029,
kv_offset 1024, dead rows in query segment 2), and ``paged_attention`` at
5 and 9 query rows with ragged ``q_lens``, in both dtypes.

The last lines are the whole run's seconds, the kernels' JSON record
(each kernel's ``launches`` summed over the main paths that run it:
phases 4, 6, 8, 9 and 11 to 15), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""
import contextlib
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
LONG32_STEPS = 2      # long32k rung, full width and depth
PACKED_STEPS = 5      # packed documents, B=8 x 1024
PLAIN_SEQ = 4096      # second long-context reading, plain backward on all heads
#: phase train-health: the sentinel's settings, and the cost rounds
TRAIN_HEALTH = {"max_consecutive_skips": 2, "spike_zscore": 6.0,
                "spike_min_history": 4}
HEALTH_COST_ROUNDS = 3
HEALTH_COST_STEPS = 20
ENGINE_CFG = {
    "model": "small", "page_size": 128, "num_pages": 65,
    "max_pages_per_request": 8, "max_batch_size": 8, "prefill_rows": 4,
    "prefill_seq": 512, "max_new_tokens": 64,
}
#: The serving rung of the reference's bench (``bench.py:672-684``): its
#: engine geometry, its zipfian shared-prefix traffic and its draft.
SERVING_HTTP_CFG = {
    "model": "small", "page_size": 128, "num_pages": 129,
    "max_pages_per_request": 8, "max_batch_size": 8, "prefill_rows": 4,
    "prefill_seq": 512, "max_new_tokens": 128, "max_queue_depth": 64,
}
SERVING_HTTP_PROMPTS = dict(n_requests=16, corpus_size=4, prefix_len=256,
                            suffix_len=16, seed=7, vocab=200)
SERVING_HTTP_CONC = 8
SERVING_HTTP_NEW_TOKENS = 32
SERVING_HTTP_SPEC = {"mode": "ngram", "draft_len": 4, "min_match": 2}
#: The reference bench's fixture serving geometry (``bench.py:698-702``).
FIXTURE_SPEC_CFG = {
    "model": "fixture", "page_size": 16, "num_pages": 65,
    "max_pages_per_request": 4, "max_batch_size": 8, "prefill_rows": 4,
    "prefill_seq": 64, "max_new_tokens": 32, "max_queue_depth": 64,
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


def cached_tail_segments(prefix_lens, tail_lens, s_q, s_p):
    """The segment ids ``_prefill_cached`` gives ``prefill_kv_cached``:
    queries 1 on each row's tail, 0 on padding; keys the row's live
    prefix (1 below its cached length, 0 past it) then the queries'
    ids."""
    import numpy as np

    qseg = np.zeros((len(tail_lens), s_q), np.int32)
    for r, n in enumerate(tail_lens):
        qseg[r, :n] = 1
    pseg = (np.arange(s_p)[None, :]
            < np.asarray(prefix_lens)[:, None]).astype(np.int32)
    return qseg, np.concatenate([pseg, qseg], axis=1)


def spec_gather_segments(b, q, s_max, seed):
    """The segment ids ``decode_kv_spec``'s gather path gives flash
    attention for `b` slots of `q` rows over an `s_max` window: ragged
    lengths (one reaching the window's last page), q_lens in [1, q], slot
    4 inactive. → (q [b, q], kv [b, s_max + q])."""
    import numpy as np

    rng = np.random.default_rng(seed)
    q_lens = rng.integers(1, q + 1, size=b)
    lengths = np.minimum(np.array([0, 1023, 517, 1, 260, 900, 128, 64][:b]),
                         s_max - q_lens)
    active = np.arange(b) != 4
    win = (np.arange(s_max)[None, :] < lengths[:, None]) & active[:, None]
    tail = (np.arange(q)[None, :] < q_lens[:, None]) & active[:, None]
    return (np.where(tail, 1, 2).astype(np.int32),
            np.concatenate([win, tail], axis=1).astype(np.int32))


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
        "packed" (seeded documents), "decode" (the gather-decode layout),
        "spec" (the speculative gather verify's), an int32 [b, s_k] array
        of segment ids, or a (q [b, s_q], kv [b, s_k]) pair of them."""
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
        if isinstance(segs, tuple):
            qseg, kseg = (torch.from_numpy(np.asarray(x, np.int32)).to(
                self.dev) for x in segs)
        elif segs is not None and not isinstance(segs, str):
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
        elif segs == "spec":
            # decode_kv_spec's gather layout: the committed window (pos <
            # length) and the s_q fresh rows behind it; dead rows carry
            # query segment 2, which no key carries
            qseg, kseg = (torch.from_numpy(x).to(self.dev)
                          for x in spec_gather_segments(b, s_q, s_k - s_q,
                                                        seed))
        kw = dict(causal=True, window=window, kv_offset=kv_offset,
                  segment_ids=qseg, kv_segment_ids=kseg,
                  block_q=tfa.fit_block(s_q, block),
                  block_k=tfa.fit_block(s_k, block))
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
    def paged_case(self, name, dtype, *, q_rows, ragged, seed=0, full=False,
                   max_q_len=5):
        """paged_attention against its plain version and gather + SDPA, 8
        pages of 128 tokens a slot, H 12, D 64: the engine's decode batch
        (8 slots of ragged lengths, one inactive; `ragged`: q_lens drawn
        from [1, max_q_len]), or with `full` 32 slots of 8 full pages
        (100.7 MB of bf16 K/V, where bytes and not latency set the time).
        Two launches must agree bit for bit."""
        import numpy as np
        import torch
        import torch.nn.functional as F

        from determined_tpu_torch.ops import paged_attention as tpa

        b, p, ps, h, d = (32 if full else 8), 8, 128, 12, 64
        num_pages = b * p + 1
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        rng = np.random.default_rng(seed)
        k_pool = self.randn((num_pages, ps, h, d), dtype, gen)
        v_pool = self.randn((num_pages, ps, h, d), dtype, gen)
        pt = rng.permutation(np.arange(1, num_pages)).reshape(b, p)
        q_lens = (rng.integers(1, max_q_len + 1, size=b) if ragged
                  else np.ones(b, np.int64))
        if full:
            lengths = np.full(b, p * ps - 1)
            active = np.ones(b, bool)
        else:
            lengths = np.array([0, 1023, 517, 1, 260, 900, 128, 64])
            active = np.arange(b) != 4
        lengths = np.minimum(lengths, p * ps - q_lens)
        q = self.randn((b, q_rows, h, d), dtype, gen)
        dev_i32 = [torch.from_numpy(a.astype(np.int32)).to(self.dev)
                   for a in (pt, lengths, active, q_lens)]
        args = (q, k_pool, v_pool, *dev_i32[:3])
        kw = dict(q_lens=dev_i32[3])
        o_k = tpa.paged_attention(*args, **kw)
        o_p = tpa.paged_attention_plain(*args, **kw)
        again = tpa.paged_attention(*args, **kw)
        torch.cuda.synchronize()
        self.check(name, dtype, o_k, o_p)
        assert torch.equal(o_k, again), f"paged {name}: launches differ"
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
            if kernel != "flash_bwd_blocked":  # deterministic sums
                again = self.blocked_run(kernel, args, kw)
                assert all(torch.equal(g, a) for g, a in zip(got, again)
                           if g is not None), \
                    f"{kernel} {name}: launches differ"
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
                    if name == "flash_bwd_dq" and not big:
                        self.hold_dq_walk(f"S{s}", got[0], args, kw)
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
            if big and set(BLOCKED) <= set(kernels):
                # the two routes past the partials cap, like for like
                self.report("kernels", f"route-32k S{s}", dict(
                    fused_ms=self.time_ms(
                        lambda: self.blocked_run("flash_bwd_blocked", args,
                                                 kw), iters=it, warmup=1),
                    two_pass_ms=self.time_ms(
                        lambda: (self.blocked_run("flash_bwd_dq", args, kw),
                                 self.blocked_run("flash_bwd_dkv", args, kw)),
                        iters=it, warmup=1),
                    dq_ms=recs["flash_bwd_dq"]["ms"],
                    dkv_ms=recs["flash_bwd_dkv"]["ms"]))
            del args, q, k, v, do, want, plain_bwd
            torch.cuda.empty_cache()
        for name, rec in recs.items():
            self.report("kernels", f"{name} long-context", rec)
        return recs

    def hold_dq_walk(self, what, dq, args, kw):
        """The bf16 dq kernel's output against the plain copy of its own
        tile walk on the same inputs: the same ds roundings and fp32
        summation order by tile, so one bf16 ulp apart at most (rtol
        2^-7), with atol 2e-3 for values near zero, where ds rounded the
        other way (ex2 against exp) moves dq by up to ~5e-4 at S 4096 →
        the largest difference."""
        from determined_tpu_torch.ops import flash_attention as tfa

        walk = tfa._bwd_dq_walk_plain(*args, **kw)
        self.torch.testing.assert_close(dq.float(), walk.float(), atol=2e-3,
                                        rtol=2.0 ** -7,
                                        msg=f"flash_bwd_dq {what}: walk")
        err = float((dq.float() - walk.float()).abs().max())
        self.report("kernels", f"flash_bwd_dq {what} vs its walk",
                    dict(max_abs_err=err))
        return err

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
    def fit_counted(self, trial, steps, ctx=None, prepare=None, **fit_kw):
        """``Trainer(trial).fit`` to step `steps` on the card (more
        ``fit`` arguments in `fit_kw`; `prepare` sees the trainer first),
        with the launch counters set to 0 just before → (reports, per-step
        launch counts of the steps trained, the run's launch counts, peak
        GB, config)."""
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
        ctx = ctx or core._dummy_init()
        trainer = Trainer(trial, ctx)  # the card, by default
        if prepare is not None:
            prepare(trainer)
        cfg = trainer.model.config
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in _build.KERNELS.values():
            k.launches = 0
        trainer.fit(max_length=Batch(steps), report_period=Batch(1), **fit_kw)
        launches = {n: k.launches for n, k in _build.KERNELS.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        snapshots.append(launches)
        reports = [m for g, _, m in ctx.train._reported if g == "training"]
        losses = [m.get("loss", float("nan")) for m in reports]
        assert all(np.isfinite(losses)), losses
        per_step = [{n: after[n] - before[n] for n in after}
                    for before, after in zip(snapshots, snapshots[1:])]
        # a resumed fit first discards the batches its checkpoint consumed
        resumed = len(per_step) - len(reports)
        assert len(reports) == steps - resumed, (reports, per_step)
        assert not any(v for d in per_step[:resumed] for v in d.values())
        per_step = per_step[resumed:]
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
        """The long32k rung at full width and depth: rematted attention
        (two forwards per layer and step) and the two-pass backward."""
        from determined_tpu_torch.trainer.profile import RUNGS, RepeatedBatchTrial

        b, cfg = RUNGS["long32k"]
        s = cfg.seq_len
        reports, per_step, launches, peak_gb, cfg = self.fit_counted(
            RepeatedBatchTrial(b, s, config=cfg), LONG32_STEPS)
        losses = [m["loss"] for m in reports]
        assert losses[-1] < losses[0], losses
        n = cfg.n_layers
        want = dict(flash_fwd=2 * n, flash_bwd_dq=n, flash_bwd_dkv=n)
        for i, step in enumerate(per_step):
            got = {k: v for k, v in step.items() if v}
            assert got == want, (i, step)
        self.report("train-32k", f"gpt2-small L{n} bf16 long32k "
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

    # -- phase 11: save, verify and resume; serve the trained weights ----------
    def checkpoint_phase(self):
        """GPT-2-small (the train phase's trial) saves at step 2 and 4 of
        run A; run B resumes from step 2: its restored state must equal
        the step-2 snapshot bitwise and its losses at steps 3-4 run A's
        within 1e-3 relative. Then the trained parameters, saved as a
        parameter-only checkpoint, are served through build_engine with
        DTPU_SERVING_CHECKPOINT and must stream exactly what an engine
        built in memory from the same arrays streams."""
        import shutil
        import tempfile

        import numpy as np
        import torch

        from determined_tpu_torch import core
        from determined_tpu_torch.models import gpt
        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.serving import (
            GenerationEngine,
            ServingConfig,
            build_engine,
            service,
        )
        from determined_tpu_torch.storage import shared
        from determined_tpu_torch.storage.base import file_digest
        from determined_tpu_torch.trainer import Batch
        from determined_tpu_torch.trainer import _checkpoint as ckpt_io
        from determined_tpu_torch.trainer.profile import RepeatedBatchTrial

        b, s, steps = 8, 1024, 4
        tmp = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
        seconds = {"snapshot": [], "write_upload": [], "verify": [],
                   "load": []}
        snaps, restored = {}, {}
        real = {"snapshot": ckpt_io.snapshot_pytree,
                "verify": shared.verify_checkpoint_dir,
                "load": ckpt_io.load_pytree}

        def timed(key, fn, sync=False):
            def call(*args, **kwargs):
                if sync:  # the step before a snapshot is not its time
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                seconds[key].append(time.perf_counter() - t0)
                return out
            return call

        def snapshot(tree):
            snap = timed("snapshot", real["snapshot"], sync=True)(tree)
            snaps[int(snap["step"])] = snap
            return snap

        def watch_writer(trainer):
            submit = trainer._ckpt_writer.submit
            trainer._ckpt_writer.submit = lambda work: submit(
                timed("write_upload", work))

        def watch_restore(trainer):
            restore = trainer._restore_checkpoint

            def call(storage_id):
                restore(storage_id)
                restored.update(real["snapshot"](trainer._state_view()))
            trainer._restore_checkpoint = call

        ckpt_io.snapshot_pytree = snapshot
        shared.verify_checkpoint_dir = timed("verify", real["verify"])
        ckpt_io.load_pytree = timed("load", real["load"])
        try:
            ctx_a = core.init(checkpoint_storage=tmp)
            rep_a, per_a, launch_a, _, cfg = self.fit_counted(
                RepeatedBatchTrial(b, s), steps, ctx=ctx_a,
                prepare=watch_writer, checkpoint_period=Batch(2))
            ids = {}
            for sid in os.listdir(tmp):
                with open(os.path.join(tmp, sid, "metadata.json")) as f:
                    ids[json.load(f)["steps_completed"]] = sid
            assert sorted(ids) == [2, 4], ids
            ckpt_dir = os.path.join(tmp, ids[2])
            files = os.listdir(ckpt_dir)
            nbytes = sum(os.path.getsize(os.path.join(ckpt_dir, f))
                         for f in files)
            state_bytes = sum(a.nbytes for a in snaps[2].values())
            rep_b, per_b, launch_b, _, _ = self.fit_counted(
                RepeatedBatchTrial(b, s), steps,
                ctx=core.init(checkpoint_storage=tmp), prepare=watch_restore,
                latest_checkpoint=ids[2])
        finally:
            ckpt_io.snapshot_pytree = real["snapshot"]
            shared.verify_checkpoint_dir = real["verify"]
            ckpt_io.load_pytree = real["load"]
        try:
            assert sorted(restored) == sorted(snaps[2])
            for name, arr in snaps[2].items():
                assert restored[name].dtype == arr.dtype, name
                assert np.array_equal(restored[name], arr), name
            assert int(restored["step"]) == 2
            assert len(rep_b) == 2, rep_b
            worst = 0.0
            for ma, mb in zip(rep_a[2:], rep_b):
                rel = abs(mb["loss"] - ma["loss"]) / abs(ma["loss"])
                worst = max(worst, rel)
                assert rel <= 1e-3, (ma["loss"], mb["loss"])
            n = cfg.n_layers
            for i, step in enumerate(per_a + per_b):
                got = {k: v for k, v in step.items() if v}
                assert got == dict(flash_fwd_mono=n, flash_bwd_mono=n), (
                    i, step)

            # Serve run A's step-4 parameters from a parameter-only
            # checkpoint (root names, as save_pytree(params) writes them).
            serve_dir = os.path.join(tmp, "serve")
            tree = {name[len("params__"):]: arr
                    for name, arr in snaps[4].items()
                    if name.startswith("params__")}
            tree = ckpt_io.nest({k.replace("__", "."): v
                                 for k, v in tree.items()})
            written = ckpt_io.save_pytree(tree, serve_dir)
            shared.SharedFSStorageManager(tmp).commit_manifest(
                "serve", {r: file_digest(os.path.join(serve_dir, r))
                          for r in written})
            fp32_small = dataclasses.replace(gpt.small(), dtype=torch.float32)
            rng = np.random.default_rng(4)
            prompts = [list(rng.integers(1, fp32_small.vocab_size,
                                         size=int(k)))
                       for k in rng.integers(64, 481, size=4)]
            for k in _build.KERNELS.values():
                k.launches = 0
            # build_engine serves gpt.small() in bf16; the parity check
            # runs it at fp32, the greedy contract's dtype.
            small = service._MODEL_CONFIGS["small"]
            service._MODEL_CONFIGS["small"] = lambda: fp32_small
            os.environ["DTPU_SERVING_CHECKPOINT"] = serve_dir
            try:
                t0 = time.perf_counter()
                eng = build_engine(ENGINE_CFG)
                startup_s = time.perf_counter() - t0
            finally:
                service._MODEL_CONFIGS["small"] = small
                os.environ.pop("DTPU_SERVING_CHECKPOINT")
            from_ckpt = self.greedy_streams(eng, prompts, 32)
            serve_launch = {n: k.launches
                            for n, k in _build.KERNELS.items()}
            model = gpt.GPT(fp32_small)
            in_memory = self.greedy_streams(
                GenerationEngine(model, tree, ServingConfig.from_dict(
                    ENGINE_CFG)), prompts, 32)
            assert from_ckpt == in_memory, (from_ckpt, in_memory)
            assert serve_launch["flash_fwd"] > 0
            assert serve_launch["paged_attention"] > 0
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        gb = state_bytes / 1e9
        rec = dict(
            checkpoint_bytes=nbytes, checkpoint_files=len(files),
            state_bytes=state_bytes,
            snapshot_ms=seconds["snapshot"][0] * 1e3,
            snapshot_gb_per_s=gb / seconds["snapshot"][0],
            write_upload_ms=seconds["write_upload"][0] * 1e3,
            write_upload_gb_per_s=nbytes / 1e9 / seconds["write_upload"][0],
            verify_ms=seconds["verify"][0] * 1e3,
            verify_gb_per_s=nbytes / 1e9 / seconds["verify"][0],
            load_ms=seconds["load"][0] * 1e3,
            load_gb_per_s=gb / seconds["load"][0],
            loss_a=[round(m["loss"], 6) for m in rep_a],
            loss_b=[round(m["loss"], 6) for m in rep_b],
            worst_resumed_loss_rel=worst, restored_leaves=len(restored),
            serve_startup_ms=startup_s * 1e3,
            identical_streams=len(from_ckpt),
        )
        self.report("checkpoint", "gpt2-small bf16 save/verify/resume, "
                    "fp32 serve from checkpoint", rec)
        launches = {n: launch_a[n] + launch_b[n] + serve_launch[n]
                    for n in launch_a}
        del eng, model
        torch.cuda.empty_cache()
        return launches

    # -- phase 12: the pre-trained fixture ---------------------------------------
    def fixture_phase(self):
        """ensure_fixture on the card (trains it: the mono pair at fp32,
        seq 64), again (loads it, no training), then serves
        ``{"model": "fixture"}`` from its directory: the greedy
        continuation of each phrase must follow the phrase's cycle."""
        import shutil
        import tempfile

        import numpy as np
        import torch

        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.serving import build_engine, fixture

        tmp = tempfile.mkdtemp(prefix="chip-smoke-fixture-")
        losses = []
        fit = fixture._fit

        def recorded(model, steps):
            losses.append(fit(model, steps))
            return losses[-1]

        fixture._fit = recorded
        try:
            for k in _build.KERNELS.values():
                k.launches = 0
            t0 = time.perf_counter()
            _m, _p, path = fixture.ensure_fixture(tmp)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            train_launch = {n: k.launches for n, k in _build.KERNELS.items()}
            t0 = time.perf_counter()
            _m, _p, again = fixture.ensure_fixture(tmp)
            load_s = time.perf_counter() - t0
            assert again == path and len(losses) == 1, losses
            assert losses[0] <= 0.05, losses

            phrases = fixture.fixture_phrases()
            for k in _build.KERNELS.values():
                k.launches = 0
            os.environ["DTPU_SERVING_CHECKPOINT"] = path
            try:
                eng = build_engine({"model": "fixture"})
            finally:
                os.environ.pop("DTPU_SERVING_CHECKPOINT")
            streams = self.greedy_streams(eng, [p * 2 for p in phrases], 20)
            serve_launch = {n: k.launches for n, k in _build.KERNELS.items()}
        finally:
            fixture._fit = fit
            shutil.rmtree(tmp, ignore_errors=True)
        hits = sum(int(a == b) for p, got in zip(phrases, streams)
                   for a, b in zip(got, (p * 2)[:20]))
        accuracy = hits / (len(phrases) * 20)
        assert accuracy >= 0.95, (accuracy, streams)
        steps = fixture.TRAIN_STEPS
        assert train_launch["flash_fwd_mono"] == 2 * steps, train_launch
        assert train_launch["flash_bwd_mono"] == 2 * steps, train_launch
        assert serve_launch["flash_fwd"] > 0, serve_launch
        assert serve_launch["paged_attention"] > 0, serve_launch
        self.report("fixture", "tiny GPT fp32 pre-trained on the phrase "
                    "corpus, served from its checkpoint", dict(
                        train_steps=steps, final_loss=losses[0],
                        train_s=train_s, load_s=load_s,
                        phrases=len(phrases), continuation_accuracy=accuracy,
                        **{f"{n}_launches": v for n, v in
                           {**{k: train_launch[k] for k in
                               ("flash_fwd_mono", "flash_bwd_mono")},
                            **{k: serve_launch[k] for k in
                               ("flash_fwd", "paged_attention")}}.items()}))
        del eng
        return {n: train_launch[n] + serve_launch[n] for n in train_launch}

    def greedy_streams(self, eng, prompts, new_tokens):
        """Every prompt submitted before the engine starts (so two
        engines batch them alike), greedy → the token streams."""
        reqs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
        eng.start()
        try:
            res = [r.result(timeout=600) for r in reqs]
        finally:
            eng.stop()
        assert all(r["reason"] == "length" for r in res), res
        return [r["tokens"] for r in res]

    # -- phases 13 and 14: the rest of serving ------------------------------------
    @contextlib.contextmanager
    def launch_geometry(self):
        """Record the geometry of every ``flash_fwd`` and
        ``paged_attention`` launch inside the block, as ("flash_fwd", b,
        s_q, s_k, kv_offset) and ("paged_attention", b, q_rows) tuples;
        the launches and their counts are the wrappers' own."""
        from determined_tpu_torch.ops import _build

        log = []
        kernels = (_build.FLASH_FWD, _build.PAGED_ATTENTION)

        def recorder(k):
            launch = type(k).launch

            def recorded(*args):
                launch(k, *args)
                if k is _build.FLASH_FWD:
                    log.append((k.name, args[9], args[11], args[12],
                                args[-3]))
                else:
                    log.append((k.name, args[10], args[11]))
            return recorded

        for k in kernels:
            k.launch = recorder(k)
        try:
            yield log
        finally:
            for k in kernels:
                del k.launch

    def serving_http_phase(self):
        """GPT-2-small bf16 behind ``GenerationServer``, driven by
        ``loadgen.drive`` over ``SERVING_HTTP_PROMPTS``: cache off + spec
        off, then cache on + spec ngram, the same request list."""
        import numpy as np
        import torch

        from determined_tpu_torch.models import gpt
        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.serving import (
            GenerationEngine,
            GenerationServer,
            ServingConfig,
            loadgen,
        )

        model = gpt.GPT(gpt.small(), device=self.dev, seed=0)
        prompts = loadgen.zipf_prefix_prompts(**SERVING_HTTP_PROMPTS)
        n, m_new = len(prompts), SERVING_HTTP_NEW_TOKENS
        launches = {k: 0 for k in _build.KERNELS}
        recs = {}
        for name, extra in (
            ("cache-off spec-off", {}),
            ("cache-on spec-ngram", {"prefix_cache": "on", "speculation":
                                     SERVING_HTTP_SPEC}),
        ):
            eng = GenerationEngine(
                model, None, ServingConfig(**SERVING_HTTP_CFG, **extra))
            submitted, iter_s = [], []
            submit, decode_iter = eng.submit, eng._decode_iter

            def recording_submit(*a, _submit=submit, **kw):
                req = _submit(*a, **kw)
                submitted.append(req)
                return req

            def timed_iter(_decode_iter=decode_iter):
                t0 = time.perf_counter()
                _decode_iter()
                iter_s.append(time.perf_counter() - t0)

            eng.submit, eng._decode_iter = recording_submit, timed_iter
            eng.start()
            srv = GenerationServer(eng, host="127.0.0.1")
            srv.start()
            try:
                warm = loadgen.drive(srv.url, 4, 4, prompt_len=8,
                                     max_new_tokens=2, timeout_s=600.0)
                assert warm.completed == 4, [t.error for t in warm.traces]
                submitted.clear()
                iter_s.clear()
                for k in _build.KERNELS.values():
                    k.launches = 0
                with self.launch_geometry() as geometry:
                    report = loadgen.drive(srv.url, n, SERVING_HTTP_CONC,
                                           max_new_tokens=m_new,
                                           timeout_s=600.0, prompts=prompts)
                    torch.cuda.synchronize()
                counts = {k: v.launches for k, v in _build.KERNELS.items()}
                stats = eng.stats()
            finally:
                srv.stop()
                eng.stop()
            if eng.prefix_cache is not None:
                eng.prefix_cache.flush()
            assert eng.pool.pages_in_use == 0, eng.stats()
            assert report.completed == n, [t.error for t in report.traces]
            assert [r.finish_reason for r in submitted] == ["length"] * n
            assert all(t.tokens == m_new and len(t.token_ids) == m_new
                       and all(0 <= x < model.config.vocab_size
                               for x in t.token_ids)
                       for t in report.traces)
            for k, v in counts.items():
                launches[k] += v
            tail = sum(g == ("flash_fwd", 4, 512, 1536, 1024)
                       for g in geometry)
            verify = sum(g[0] == "paged_attention" and g[2] == 5
                         for g in geometry)
            spec = stats["speculation"]
            rec = dict(
                requests=n, tokens=report.total_tokens,
                tokens_per_s=report.tokens_per_sec,
                ttft_p50_ms=report.ttft_percentile_ms(50),
                ttft_p99_ms=report.ttft_percentile_ms(99),
                hit_rate=stats["cache_hit_rate"],
                proposed=spec["proposed_tokens"],
                accepted=spec["accepted_tokens"],
                decode_iterations=len(iter_s),
                decode_iter_ms_p50=float(np.median(iter_s)) * 1e3,
                flash_cached_tail_launches=tail,
                paged_q5_launches=verify,
                flash_launches=counts["flash_fwd"],
                paged_launches=counts["paged_attention"],
            )
            self.report("serving-http", f"gpt2-small bf16 {name}", rec)
            recs[name] = rec
            del eng
        on = recs["cache-on spec-ngram"]
        assert on["hit_rate"] > 0 and on["proposed"] > 0, on
        assert on["flash_cached_tail_launches"] > 0, on
        assert on["paged_q5_launches"] > 0, on
        del model
        torch.cuda.empty_cache()
        return launches

    def parity_streams(self, model, cfg, prompts, new_tokens, waves=2):
        """Greedy streams of `prompts` through a fresh engine, submitted
        in `waves` (each waits for the one before, so a later wave can
        hit the prefix cache) → (streams, stats)."""
        from determined_tpu_torch.serving import GenerationEngine

        eng = GenerationEngine(model, None, cfg)
        eng.start()
        try:
            res = []
            step = -(-len(prompts) // waves)
            for i in range(0, len(prompts), step):
                reqs = [eng.submit(p, max_new_tokens=new_tokens)
                        for p in prompts[i:i + step]]
                res += [r.result(timeout=600) for r in reqs]
            stats = eng.stats()
        finally:
            eng.stop()
        assert all(r["reason"] == "length" for r in res), res
        return [r["tokens"] for r in res], stats

    def serving_parity_phase(self):
        """fp32 greedy streams of GPT-2-small across prefix cache and
        speculation settings, on the paged and the gather path; then the
        pre-trained fixture with speculation on and off."""
        import shutil
        import tempfile

        import torch

        from determined_tpu_torch.models import gpt
        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.serving import ServingConfig, fixture, loadgen

        for k in _build.KERNELS.values():
            k.launches = 0
        model = gpt.GPT(dataclasses.replace(gpt.small(), dtype=torch.float32),
                        device=self.dev, seed=0)
        prompts = loadgen.zipf_prefix_prompts(**SERVING_HTTP_PROMPTS)[:6]
        configs = (("off", "off"), ("on", "off"), ("on", "ngram"))
        streams, hits, accepted = {}, 0, 0
        with self.launch_geometry() as geometry:
            for kernel, env in (("paged", None), ("gather", "0")):
                if env is None:
                    os.environ.pop("DTPU_PAGED_ATTN", None)
                else:
                    os.environ["DTPU_PAGED_ATTN"] = env
                for cache, spec in configs:
                    cfg = ServingConfig(
                        **SERVING_HTTP_CFG, prefix_cache=cache,
                        speculation={**SERVING_HTTP_SPEC, "mode": spec})
                    got, stats = self.parity_streams(model, cfg, prompts, 16)
                    assert stats["decode_kernel"] == kernel, stats
                    streams[(kernel, cache, spec)] = got
                    hits += stats.get("prefix_cache", {}).get("hits", 0)
                    accepted += stats["speculation"]["accepted_tokens"]
        os.environ.pop("DTPU_PAGED_ATTN", None)
        assert hits > 0, "the prefix cache never hit"
        shapes = dict(
            flash_cached_tail=("flash_fwd", 4, 512, 1536, 1024),
            flash_spec_gather=("flash_fwd", 8, 5, 1029, 1024),
            paged_q5=("paged_attention", 8, 5),
        )
        at_shape = {name: sum(g == shape for g in geometry)
                    for name, shape in shapes.items()}
        assert all(at_shape.values()), at_shape
        near_ties, identical = 0, 0
        base_key = ("paged", "off", "off")
        for j, prompt in enumerate(prompts):
            first_tie = {}
            for key, got in streams.items():
                seq = prompt + got[j]
                logits = model.apply(torch.tensor([seq], device=self.dev))
                top2 = logits[0].float().topk(2, dim=-1)
                first_tie[key] = len(got[j])
                for i in range(len(prompt) - 1, len(seq) - 1):
                    if float(top2.values[i, 0] - top2.values[i, 1]) < NEAR_TIE:
                        near_ties += 1
                        first_tie[key] = min(first_tie[key],
                                             i - (len(prompt) - 1))
                        continue
                    assert int(top2.indices[i, 0]) == seq[i + 1], (
                        f"{key}: greedy divergence at position {i}")
            base = streams[base_key][j]
            for key, got in streams.items():
                upto = min(first_tie[key], first_tie[base_key])
                assert got[j][:upto] == base[:upto], (key, got[j], base)
                identical += got[j] == base
        self.report("serving-parity", "gpt2-small fp32 cache x spec x "
                    "paged/gather", dict(
                        prompts=len(prompts), tokens_per_stream=16,
                        configs=len(streams), prefix_hits=hits,
                        accepted=accepted, near_ties=near_ties,
                        identical_streams=identical,
                        **{f"{n}_launches": v for n, v in at_shape.items()}))
        del model
        torch.cuda.empty_cache()

        tmp = tempfile.mkdtemp(prefix="chip-smoke-fixture-spec-")
        try:
            fmodel, _params, _path = fixture.ensure_fixture(tmp)
            prompts = loadgen.corpus_ngram_prompts(
                8, fixture.fixture_phrases(), seed=7)
            fixture_streams = {}
            for spec in ("off", "ngram"):
                cfg = ServingConfig(**FIXTURE_SPEC_CFG, speculation={
                    **SERVING_HTTP_SPEC, "mode": spec})
                fixture_streams[spec], stats = self.parity_streams(
                    fmodel, cfg, prompts, 24, waves=1)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        spec = stats["speculation"]
        assert fixture_streams["ngram"] == fixture_streams["off"], \
            fixture_streams
        assert spec["accepted_tokens"] > 0, spec
        self.report("serving-parity", "fixture fp32 spec ngram vs off",
                    dict(prompts=len(prompts), tokens_per_stream=24,
                         identical_streams=len(prompts),
                         proposed=spec["proposed_tokens"],
                         accepted=spec["accepted_tokens"],
                         acceptance_rate=spec["acceptance_rate"]))
        return {k: v.launches for k, v in _build.KERNELS.items()}

    # -- phase 7: one fp32 step, card against CPU ----------------------------------
    # -- phase 15: the health sentinel, the timeline, TensorBoard, profiler -----
    def train_health_phase(self):
        """The headline trial on an indexed stream (batch i from seed 1000
        + i mod 4; O(1) skip; every index recorded) under the health
        sentinel, the timeline, the profiler agent and TensorBoard: the
        non-finite drill (fit to 8, then to 16 with steps 9-10 poisoned:
        two skips, one rollback to step 8, the parameters bitwise the
        step-8 checkpoint's), the spike drill (to 24 with step 17 ×1e6:
        a second rollback), the ledger, scalars and card memory in the
        reports, a fresh trainer resuming the ledger; then the step ms
        with all of it on and all of it off, interleaved."""
        import math
        import shutil
        import tempfile

        import numpy as np
        import torch

        from determined_tpu_torch import core
        from determined_tpu_torch.common import faults
        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.storage import shared
        from determined_tpu_torch.tensorboard import read_scalars
        from determined_tpu_torch.trainer import Batch, Trainer
        from determined_tpu_torch.trainer import _checkpoint as ckpt_io
        from determined_tpu_torch.trainer.profile import RepeatedBatchTrial

        class IndexedTrial(RepeatedBatchTrial):
            def __init__(self, record):
                super().__init__(8, 1024)
                self.record = record
                self.batches = {}

            def build_training_data(self):
                trial = self

                class Stream:
                    i = 0

                    def skip(self, n):
                        self.i += n

                    def __iter__(self):
                        return self

                    def __next__(self):
                        i, self.i = self.i, self.i + 1
                        trial.record.append(i)
                        if i % 4 not in trial.batches:
                            rng = np.random.default_rng(1000 + i % 4)
                            trial.batches[i % 4] = {"tokens": rng.integers(
                                0, trial.config.vocab_size,
                                (trial.batch, trial.config.seq_len),
                            ).astype(np.int32)}
                        return trial.batches[i % 4]

                return Stream()

        def plan(site, n):
            return faults.plan_active(faults.FaultPlan(
                {site: faults.FaultSpec(failures=n)}))

        def counts():
            return {n: k.launches for n, k in _build.KERNELS.items()}

        tmp = tempfile.mkdtemp(prefix="chip-smoke-health-")
        store, tb = os.path.join(tmp, "ckpt"), os.path.join(tmp, "tb")
        record, per_step, restores = [], [], []
        seconds = {"verify": [], "load": []}
        real = {"verify": shared.verify_checkpoint_dir,
                "load": ckpt_io.load_pytree}

        def timed(key):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                out = real[key](*args, **kwargs)
                seconds[key].append(time.perf_counter() - t0)
                return out
            return call

        ctx = core.init(checkpoint_storage=store)
        trainer = Trainer(IndexedTrial(record), ctx, health=TRAIN_HEALTH,
                          profiling=True, tensorboard_dir=tb)
        n_layers = trainer.model.config.n_layers
        step_fn, restore_fn = trainer._train_step, trainer._restore_with_fallback

        def counted_step(batch, poison=1.0):
            before = counts()
            out = step_fn(batch, poison)
            per_step.append({n: v - before[n] for n, v in counts().items()})
            return out

        def timed_restore(storage_id):
            torch.cuda.synchronize()  # the steps before are not its time
            t0 = time.perf_counter()
            restore_fn(storage_id)
            restores.append(time.perf_counter() - t0)
            if len(restores) == 1:
                restored.update(ckpt_io.snapshot_pytree(trainer._state_view()))

        def drop_older(keep):
            """Delete every checkpoint but `keep` (at most three of 1.49
            GB live on the disk at once)."""
            for sid in os.listdir(store):
                if sid not in (keep, "tensorboard"):
                    ctx.checkpoint.delete(sid)

        restored = {}
        trainer._train_step = counted_step
        trainer._restore_with_fallback = timed_restore
        shared.verify_checkpoint_dir = timed("verify")
        ckpt_io.load_pytree = timed("load")
        period = dict(report_period=Batch(1), checkpoint_period=Batch(4))
        try:
            torch.cuda.synchronize()
            for k in _build.KERNELS.values():
                k.launches = 0
            # 1. the non-finite drill
            trainer.fit(max_length=Batch(8), **period)
            at8 = ckpt_io.snapshot_pytree(trainer._state_view())
            assert record == list(range(8)), record
            drop_older(trainer._last_ckpt_id)
            with plan("train.nonfinite", 2):
                trainer.fit(max_length=Batch(16), **period)
            assert (trainer.steps_skipped, trainer.rollbacks,
                    trainer._data_offset) == (2, 1, 2), trainer._data_offset
            # 0..7, then 8 and 9 (poisoned), then 10..17 for steps 9-16
            assert record == list(range(18)), record
            assert sorted(restored) == sorted(at8)
            for name, arr in at8.items():
                assert np.array_equal(restored[name], arr), name
            del at8
            restored.clear()
            drop_older(trainer._last_ckpt_id)
            # 2. the spike drill
            with plan("train.spike", 1):
                trainer.fit(max_length=Batch(24), **period)
            assert (trainer.steps_skipped, trainer.rollbacks,
                    trainer._data_offset) == (2, 2, 3)
            assert record == list(range(27)), record
            final = trainer._last_ckpt_id
            drop_older(final)
        finally:
            shared.verify_checkpoint_dir = real["verify"]
            ckpt_io.load_pytree = real["load"]
        try:
            reports = [(s, m) for g, s, m in ctx.train._reported
                       if g == "training"]
            assert len(reports) == 8 + 10 + 9 == len(per_step), len(reports)
            for s, m in reports:
                assert all(math.isfinite(v) for v in m.values()), (s, m)
            skipped = [s for s, m in reports if m["sentinel_skipped"]]
            assert skipped == [9, 10], skipped
            losses = [m["loss"] for _, m in reports if "loss" in m]
            assert losses[-1] < losses[0], losses
            assert max(losses) > 1e5  # the spiked step, applied and reported
            for i, step in enumerate(per_step):
                got = {n: v for n, v in step.items() if v}
                assert got == dict(flash_fwd_mono=n_layers,
                                   flash_bwd_mono=n_layers), (i, step)

            # 3. the ledger, the profiler's samples, TensorBoard
            prof = [m for g, _, m in ctx.train._reported if g == "profiling"]
            ledger = [m for m in prof if "goodput_pct" in m]
            samples = [m for m in prof if "memory_used_bytes" in m]
            assert len(ledger) == len(reports)
            for m in ledger:
                frac = sum(m[f"{p}_frac"] for p in
                           ("data_wait", "h2d_put", "report", "checkpoint",
                            "step"))
                assert abs(frac - 1.0) <= 1e-6, m
            last = ledger[-1]
            assert 0.0 < last["goodput_pct"] < 100.0, last
            assert last["rollback_lost_s"] > 0 and last["ledger_rollbacks"] == 2
            flops = {m["step_flops"] for m in ledger if "step_flops" in m}
            assert flops == {trainer.model.train_flops_per_token() * 8 * 1024}
            state_bytes = sum(p.numel() * 4 * 3 for p in trainer._params)
            assert samples and max(m["device0_bytes_in_use"]
                                   for m in samples) > state_bytes, samples
            (tb_file,) = os.listdir(tb)
            tb_losses = [(e["step"], e["scalars"]["loss"])
                         for e in read_scalars(os.path.join(tb, tb_file))
                         if "loss" in e["scalars"]]
            want = [(s, m["loss"]) for s, m in reports if "loss" in m]
            assert [s for s, _ in tb_losses] == [s for s, _ in want]
            for (s, got), (_, loss) in zip(tb_losses, want):
                assert abs(got - loss) <= 1e-6 * abs(loss), (s, got, loss)
            synced = os.listdir(os.path.join(store, "tensorboard", "local"))
            assert synced == [tb_file], synced
            trainer._train_step = step_fn
            del trainer
            torch.cuda.empty_cache()

            # a fresh trainer resumes the final checkpoint and its ledger
            resumed_record = []
            ctx2 = core.init(checkpoint_storage=store)
            resumed = Trainer(IndexedTrial(resumed_record), ctx2,
                              health=TRAIN_HEALTH)
            resumed.fit(max_length=Batch(25), report_period=Batch(1),
                        latest_checkpoint=final)
            assert resumed_record == [27], resumed_record
            resumed_ledger = [m for g, _, m in ctx2.train._reported
                              if g == "profiling"][-1]
            assert resumed_ledger["ledger_restarts"] == 1, resumed_ledger
            assert resumed_ledger["ledger_rollbacks"] == 2, resumed_ledger
            launches = counts()  # the drills and the resumed step
            del resumed
            torch.cuda.empty_cache()

            # 4. cost: all on against all off, interleaved
            cost = self.health_cost()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        rec = dict(
            steps=len(reports), rollbacks=2, steps_skipped=2, data_offset=3,
            records=len(record), loss_first=losses[0], loss_last=losses[-1],
            goodput_pct=last["goodput_pct"],
            rollback_lost_s=last["rollback_lost_s"],
            productive_s=last["productive_s"],
            step_frac=last["total_step_frac"],
            data_wait_frac=last["total_data_wait_frac"],
            checkpoint_frac=last["total_checkpoint_frac"],
            step_flops=last["step_flops"],
            device0_bytes_in_use_max=max(m["device0_bytes_in_use"]
                                         for m in samples),
            device0_hbm_util_max=max(m["device0_hbm_util"] for m in samples),
            profiler_reports=len(samples), tb_losses=len(tb_losses),
            resumed_restarts=resumed_ledger["ledger_restarts"],
            **{f"restore{i + 1}_ms": s * 1e3 for i, s in enumerate(restores)},
            **{f"verify{i + 1}_ms": s * 1e3
               for i, s in enumerate(seconds["verify"])},
            **{f"load{i + 1}_ms": s * 1e3
               for i, s in enumerate(seconds["load"])},
            **cost,
            **{f"{n}_launches": v for n, v in launches.items() if v},
        )
        self.report("train-health", "gpt2-small bf16 B8x1024 sentinel "
                    "timeline profiler tensorboard", rec)
        return launches

    def health_cost(self):
        """Median step ms of the headline trial with the sentinel (spike
        detector on), the timeline, the profiler agent and TensorBoard all
        on, and all off (DTPU_TIMELINE=0, default health, no profiling),
        in HEALTH_COST_ROUNDS interleaved rounds of HEALTH_COST_STEPS."""
        import shutil
        import tempfile

        import numpy as np
        import torch

        from determined_tpu_torch import core
        from determined_tpu_torch.profiler import ProfilerAgent
        from determined_tpu_torch.trainer import Batch, Trainer
        from determined_tpu_torch.trainer.profile import RepeatedBatchTrial

        tb = tempfile.mkdtemp(prefix="chip-smoke-health-tb-")
        os.environ["DTPU_TIMELINE"] = "0"
        try:
            off = Trainer(RepeatedBatchTrial(8, 1024), core._dummy_init())
        finally:
            del os.environ["DTPU_TIMELINE"]
        on = Trainer(RepeatedBatchTrial(8, 1024), core._dummy_init(),
                     health=TRAIN_HEALTH, profiling=True, tensorboard_dir=tb)
        assert not off.timeline.enabled and on.timeline.enabled
        ms = {"on": [], "off": []}
        for trainer in (on, off):  # warm-up, not counted
            trainer.fit(max_length=Batch(2), report_period=Batch(1))
        for r in range(HEALTH_COST_ROUNDS):
            for name in (("on", "off") if r % 2 == 0 else ("off", "on")):
                trainer = on if name == "on" else off
                if trainer is on:  # the agent samples during one fit only
                    on._profiler = ProfilerAgent(on.core.train)
                n = len(trainer.core.train._reported)
                trainer.fit(max_length=Batch(trainer.steps_completed
                                             + HEALTH_COST_STEPS),
                            report_period=Batch(1))
                ms[name] += [1e3 / m["batches_per_second"] for g, _, m in
                             trainer.core.train._reported[n:]
                             if g == "training"]
        del on, off
        torch.cuda.empty_cache()
        shutil.rmtree(tb, ignore_errors=True)
        assert len(ms["on"]) == len(ms["off"]) == \
            HEALTH_COST_ROUNDS * HEALTH_COST_STEPS
        med_on, med_off = (float(np.median(ms[k])) for k in ("on", "off"))
        return dict(step_ms_on=med_on, step_ms_off=med_off,
                    step_ms_on_minus_off=med_on - med_off,
                    cost_rounds=HEALTH_COST_ROUNDS,
                    cost_steps=HEALTH_COST_STEPS)

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
    # the serving path's other geometries: the prefix-cache tail prefill
    # (4 tails of 512 against 8 cached pages + themselves) and the
    # speculative gather verify (8 slots of 5 rows behind 8 pages)
    tail_segs = cached_tail_segments((256, 384, 896, 0), (16, 128, 512, 0),
                                     512, 1024)
    for dtype in (bf16, fp32):
        smoke.flash_case("cached-tail", dtype, b=4, s_q=512, s_k=1536,
                         kv_offset=1024, segs=tail_segs, seed=3)
        smoke.flash_case("spec-gather", dtype, b=8, s_q=5, s_k=1029,
                         kv_offset=1024, segs="spec", seed=4)
    paged = {}
    for dtype in (bf16, fp32):
        paged[dtype] = smoke.paged_case("decode", dtype, q_rows=1,
                                        ragged=False)
        smoke.paged_case("ragged-qlens", dtype, q_rows=8, ragged=True,
                         seed=1)
        for q_rows in (5, 9):   # the speculative verify, draft_len 4 and 8
            smoke.paged_case(f"spec-verify-q{q_rows}", dtype, q_rows=q_rows,
                             ragged=True, seed=q_rows, max_q_len=q_rows)
    smoke.paged_case("full", bf16, q_rows=1, ragged=False, seed=2, full=True)
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

    # -- phases 11 to 15: checkpoints, the fixture, the rest of serving, the
    # -- rest of the training loop ---------------------------------------------------
    for phase in (smoke.checkpoint_phase, smoke.fixture_phase,
                  smoke.serving_http_phase, smoke.serving_parity_phase,
                  smoke.train_health_phase):
        for name, count in phase().items():
            launches[name] += count

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
