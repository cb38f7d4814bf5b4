"""Where a train step of the port spends its time, on the card.

    python -m determined_tpu_torch.trainer.profile [--rung headline]
        [--steps 5] [--batch B] [--seq S] [--packed]

Builds one of ``bench.py``'s training rungs (``RUNGS``) — GPT-2-small at
full width and depth, bf16 compute over fp32 master parameters, seeded
random weights, one seeded batch of ``--batch`` rows of ``--seq`` tokens
(the rung's own by default), ``chain(clip_by_global_norm(1.0),
adamw(3e-4))``:

- ``headline``: ``remat=False``, batch 8 × seq 1024 (``bench.py``'s
  headline rung runs batch 24);
- ``long16k``: the long-context rung, ``remat=True``, ``fused_loss=True``,
  batch 1 × seq 16384;
- ``long32k``: the same fields at seq 32768, where ``layer_loop="auto"``
  also rematerializes attention.

``--packed`` replaces the random tokens with one ``pack_sequences`` batch
of seeded random documents of 32-1024 tokens (``packed_batch``): segment
ids then route attention through the blocked kernels.

It puts the model behind the ``Trainer`` and runs its guarded step on
the calling thread: two warm-up steps, ``--steps`` timed with the
profiler off (host clock around steps that end in a device sync), then
``--steps`` under ``torch.profiler``. Prints one JSON line: wall ms per
step, the host's ms per step to enqueue them (the loop's time before its
closing sync; the device's queue can hold it back), tokens/s and MFU (``train_flops_per_token`` against the H100's
989 TFLOP/s bf16 dense peak), device-busy ms per step (the kernels' own
time summed), the device's idle share under the profiler, kernel
launches per step (all, and per port kernel from the launch counters),
peak device memory, device ms and launches per step by kernel group
(``GROUPS``), and the kernels that take the most device time per step.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import List, Optional

import numpy as np
import torch

from determined_tpu_torch.models import gpt
from determined_tpu_torch.ops import _build
from determined_tpu_torch.trainer import optim
from determined_tpu_torch.trainer._trainer import Trainer
from determined_tpu_torch.trainer._trial import TorchTrial

PEAK_BF16_FLOPS = 989e12

#: Kernel-name patterns of the breakdown's groups, first match wins; the
#: rest are PyTorch's elementwise, reduction, copy and indexing kernels.
GROUPS = (
    ("port attention kernels", ("dtpu::",)),
    ("GEMMs (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")),
    ("foreach (optimizer)", ("multi_tensor_apply",)),
)


def _group(name: str) -> str:
    lowered = name.lower()
    for group, patterns in GROUPS:
        if any(p in lowered for p in patterns):
            return group
    return "elementwise, reductions, copies"


#: bench.py's training rungs: (batch, config). The headline mirrors
#: ``bench.py``'s ``GPTConfig(remat=False)`` (at batch 8, not 24); the long
#: rungs its ``long_ctx_mfu_at`` (``remat=True, fused_loss=True``, batch 1).
RUNGS = {
    "headline": (8, dataclasses.replace(gpt.small(), remat=False)),
    "long16k": (1, dataclasses.replace(gpt.small(), seq_len=16384,
                                       remat=True, fused_loss=True)),
    "long32k": (1, dataclasses.replace(gpt.small(), seq_len=32768,
                                       remat=True, fused_loss=True)),
}


class RepeatedBatchTrial(TorchTrial):
    """GPT-2 over one seeded batch of random tokens, repeated: a train
    step at a rung's shape with a loss that must fall. ``config``
    (default: the headline rung's) keeps its fields; ``seq`` sets its
    sequence length."""

    def __init__(self, batch: int = 8, seq: int = 1024, *,
                 config: Optional[gpt.GPTConfig] = None, seed: int = 0,
                 lr: float = 3e-4) -> None:
        super().__init__({"lr": lr})
        self.config = dataclasses.replace(config or RUNGS["headline"][1],
                                          seq_len=seq)
        self.batch = batch
        self.seed = seed

    def build_model(self, device):
        return gpt.GPT(self.config, device=device, seed=self.seed)

    def build_optimizer(self):
        return optim.chain(optim.clip_by_global_norm(1.0),
                           optim.adamw(self.hparams["lr"]))

    def build_training_data(self):
        rng = np.random.default_rng(self.seed)
        tokens = rng.integers(0, self.config.vocab_size,
                              size=(self.batch, self.config.seq_len))
        batch = {"tokens": tokens.astype(np.int32)}
        while True:
            yield batch


def packed_batch(b: int, s: int, seed: int, vocab: int) -> dict:
    """One ``pack_sequences`` batch [b, s] of seeded random documents of
    32-1024 tokens below `vocab` (tokens, segment_ids, loss_mask)."""
    from determined_tpu_torch.batch_inference import pack_sequences

    rng = np.random.default_rng(seed)
    docs = (rng.integers(1, vocab, int(n)).tolist()
            for n in rng.integers(32, 1025, size=100_000))
    return next(pack_sequences(docs, s, b))


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, name, None)
        if value is not None:
            return float(value)
    return 0.0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rung", choices=sorted(RUNGS), default="headline")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--packed", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    rung_batch, rung_cfg = RUNGS[args.rung]
    args.batch = args.batch or rung_batch
    args.seq = args.seq or rung_cfg.seq_len
    trial = RepeatedBatchTrial(args.batch, args.seq, config=rung_cfg)
    trainer = Trainer(trial)
    host_batch = next(iter(trial.build_training_data()))
    if args.packed:
        host_batch = packed_batch(args.batch, args.seq, 3,
                                  trial.config.vocab_size)
    batch = trainer._put_batch(host_batch)
    for _ in range(2):  # warm-up: kernel builds, allocator, cuBLAS plans
        trainer._train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in _build.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    for _ in range(args.steps):
        metrics = trainer._train_step(batch)
    host_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    port_launches = {name: k.launches / args.steps
                     for name, k in _build.KERNELS.items() if k.launches}

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            trainer._train_step(batch)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    kernels = [
        (evt.key, _device_us(evt), evt.count) for evt in prof.key_averages()
        if _device_us(evt) > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
    ]
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(us for _, us, _ in kernels) / 1e3 / args.steps
    groups = {}
    for name, us, count in kernels:
        g = groups.setdefault(_group(name), {"ms": 0.0, "launches": 0.0})
        g["ms"] += us / 1e3 / args.steps
        g["launches"] += count / args.steps
    tokens = args.batch * args.seq
    cfg = trial.config
    out = {
        "device": torch.cuda.get_device_name(0),
        "rung": args.rung + (" packed" if args.packed else ""),
        "config": f"gpt2-small bf16 remat={cfg.remat} "
                  f"fused_loss={cfg.fused_loss} "
                  f"remat_attention={gpt.remat_attention(cfg)}",
        "batch": args.batch, "seq": args.seq, "steps": args.steps,
        "loss": float(metrics["loss"]),
        "wall_ms_per_step": wall_ms,
        "host_enqueue_ms_per_step": host_ms,
        "tokens_per_s": tokens / (wall_ms / 1e3),
        "mfu": tokens / (wall_ms / 1e3) * cfg.train_flops_per_token()
        / PEAK_BF16_FLOPS,
        "wall_ms_per_step_profiled": prof_wall_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / prof_wall_ms),
        "kernel_launches_per_step": sum(c for _, _, c in kernels) / args.steps,
        "port_kernel_launches_per_step": port_launches,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "device_ms_per_step_by_group": groups,
        "top_kernels": [
            {"name": name[:120], "ms_per_step": us / 1e3 / args.steps,
             "calls_per_step": count / args.steps}
            for name, us, count in kernels[:args.top]
        ],
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
