"""Where a decode iteration of the port's engine spends its time, on the
card.

    python -m determined_tpu_torch.serving.profile [--iters 20]

Builds the engine of ``chip_smoke.py`` (GPT-2-small, bf16, seeded random
weights), fills all decode slots with prompts of ``--prompt`` tokens
through one packed prefill per admission round, then runs decode
iterations on the calling thread: ``--iters`` timed with the profiler off
(host clock around iterations that end in a device sync), then ``--iters``
under ``torch.profiler``. Prints one JSON line: wall ms per iteration,
device-busy ms per iteration (the kernels' own time summed), the device's
idle share, and the kernels that take the most device time per iteration.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

import torch

from determined_tpu_torch.serving.service import build_engine

ENGINE_CFG = {
    "model": "small", "page_size": 128, "num_pages": 65,
    "max_pages_per_request": 8, "max_batch_size": 8, "prefill_rows": 4,
    "prefill_seq": 512, "max_new_tokens": 256,
}


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, name, None)
        if value is not None:
            return float(value)
    return 0.0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")
    eng = build_engine(ENGINE_CFG)
    gen = torch.Generator().manual_seed(0)
    vocab = eng.model.config.vocab_size
    for _ in range(eng.cfg.max_batch_size):
        prompt = torch.randint(1, vocab, (args.prompt,), generator=gen)
        eng.submit(prompt.tolist(), max_new_tokens=2 * args.iters + 8)
    while True:  # admission rounds until every slot holds a request
        admitted = eng._admit()
        if not admitted:
            break
        eng._prefill_packed(admitted)
    active = sum(r is not None for r in eng._slots)
    for _ in range(3):  # warm-up
        eng._decode_iter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        eng._decode_iter()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            eng._decode_iter()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters
    kernels = [
        (evt.key, _device_us(evt), evt.count) for evt in prof.key_averages()
        if _device_us(evt) > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
    ]
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(us for _, us, _ in kernels) / 1e3 / args.iters
    out = {
        "active_slots": active,
        "prompt_tokens": args.prompt,
        "iters": args.iters,
        "wall_ms_per_iter": wall_ms,
        "wall_ms_per_iter_profiled": prof_wall_ms,
        "device_busy_ms_per_iter": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / prof_wall_ms),
        "kernel_launches_per_iter": sum(c for _, _, c in kernels) / args.iters,
        "top_kernels": [
            {"name": name[:120], "us_per_iter": us / args.iters,
             "calls_per_iter": count / args.iters}
            for name, us, count in kernels[:args.top]
        ],
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
