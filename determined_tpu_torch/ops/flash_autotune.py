"""Flash-attention block-size autotuner (port of
``determined_tpu/ops/flash_autotune.py``).

The reference times its Pallas kernels over a small candidate set of
``(block_q, block_k)`` at the exact shape, dtype and mask mode a model
will run, keeps the fastest, and remembers it in an on-disk cache. The
port keeps the candidate set, the cache and the knobs. What a candidate
means differs: the CUDA kernels pick their own tiles
(``ops/flash_attention.py``), so ``block_q`` / ``block_k`` decide only the
route a call launches:

- the forward: ``flash_fwd_mono`` when ``_mono_ok`` holds (block == seq,
  no window, segments or offset), else the blocked ``flash_fwd``;
- the backward: ``_bwd_route`` — mono, else the fused blocked kernel
  while the dq partials of ``nk = s_k / block_k`` key blocks fit under
  ``_FUSED_BWD_PARTIALS_CAP``, else the dq and dk/dv passes.

So the probe groups the fitted candidates by the route they launch
(``candidate_route``), times each distinct route once (forward and
backward through ``flash_attention`` on the device, CUDA events), and
returns the first candidate of the fastest route in ``candidate_blocks``
order: the caller's wanted pair comes first and wins ties.

Cache: one JSON object at ``DTPU_FLASH_TUNE_CACHE`` (default
``~/.cache/determined_tpu_torch/flash_blocks.json``), keyed by the format
version, the card's name, the torch version, a digest of the kernel
sources (``_build.sources_digest``: a redesigned kernel re-probes), the
shape, dtype and mask mode. Writes are atomic (tempfile + rename) and
best-effort. Probing runs real launches, so callers resolve blocks when
they build a model (``GPT._flash_blocks``), not inside a step.

On a CPU device no probe runs: the tuner returns the wanted blocks fitted
to the sequence, as the reference does off the TPU.
``DTPU_FLASH_AUTOTUNE=0`` forces that everywhere. Only
``torch.cuda.OutOfMemoryError`` makes a candidate lose (``inf``); any
other error of a probe (a build or a launch that failed) propagates, so
the tuner never hides a broken kernel.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
from typing import Dict, List, Optional, Tuple, Union

import torch

from determined_tpu_torch._device import resolve_device
from determined_tpu_torch.ops import _build
from determined_tpu_torch.ops.flash_attention import (
    _MONO_MAX_SCORES,
    _bwd_route,
    _mono_ok,
    fit_block,
    flash_attention,
)
from determined_tpu_torch.ops.paged_attention import default_paged_block_h

logger = logging.getLogger("determined_tpu_torch.ops.flash_autotune")

#: Bump when the key schema or probe methodology changes incompatibly.
CACHE_VERSION = 1

#: (block_q, block_k) seeds; each is fitted to the actual sequence lengths
#: and deduped, and the single-block candidate joins the set when its
#: score matrix fits ``_MONO_MAX_SCORES``.
_CANDIDATE_SEEDS: Tuple[Tuple[int, int], ...] = (
    (256, 256),
    (512, 512),
    (1024, 1024),
    (2048, 1024),
    (1024, 512),
    (512, 1024),
)

#: Probe cost guardrails: per-route warm-up and timed steps.
_PROBE_WARMUP = 1
_PROBE_STEPS = 3
#: The spin (``torch.cuda._sleep`` cycles, ~12 ms on an H100) queued
#: before the timed steps: the host enqueues them all while the card
#: spins, so the events time the card's work, not the host's launch gaps
#: (at B 1 × 1024 those are most of a step, and they flipped the winner
#: from call to call).
_PROBE_SPIN_CYCLES = 20_000_000

Device = Optional[Union[str, torch.device]]


def cache_path() -> str:
    return os.environ.get(
        "DTPU_FLASH_TUNE_CACHE",
        os.path.join(
            os.path.expanduser("~"), ".cache", "determined_tpu_torch",
            "flash_blocks.json",
        ),
    )


def _load_cache(path: str) -> dict:
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except Exception:  # noqa: BLE001 - missing/corrupt cache: re-probe
        return {}


def _store_cache(path: str, data: dict) -> None:
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(path), prefix=".flash_blocks."
        )
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=0, sort_keys=True)
        os.replace(tmp, path)  # atomic: readers never see a torn file
    except Exception:  # noqa: BLE001 - cache is an optimization only
        logger.debug("flash autotune cache write failed", exc_info=True)


def _device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device)


def _cache_key(device_kind: str, s_q: int, s_k: int, n_heads: int,
               head_dim: int, batch: int, dtype, causal: bool,
               window: Optional[int], segments: bool) -> str:
    return "|".join([
        f"v{CACHE_VERSION}",
        device_kind,
        f"torch{torch.__version__}",
        f"src{_build.sources_digest()}",
        f"b{batch}h{n_heads}q{s_q}k{s_k}d{head_dim}",
        str(dtype).replace("torch.", ""),
        f"causal{int(causal)}",
        f"win{window if window is not None else 0}",
        f"seg{int(segments)}",
    ])


def candidate_blocks(s_q: int, s_k: int,
                     want_q: int = 1024, want_k: int = 1024
                     ) -> List[Tuple[int, int]]:
    """Fitted, deduped candidate list for one shape. The caller's wanted
    pair goes first (it wins ties and is the no-probe fallback); the
    (s_q, s_k) single-block candidate joins when its score matrix fits
    ``_MONO_MAX_SCORES``. Under ``segments`` that candidate runs the
    blocked kernels at block == seq (mono declines segment ids), in the
    probe as in training."""
    out: List[Tuple[int, int]] = []
    seeds = ((want_q, want_k),) + _CANDIDATE_SEEDS
    for bq, bk in seeds:
        cand = (fit_block(s_q, bq), fit_block(s_k, bk))
        if cand not in out:
            out.append(cand)
    if s_q * s_k <= _MONO_MAX_SCORES and (s_q, s_k) not in out:
        out.append((s_q, s_k))
    return out


def candidate_route(bq: int, bk: int, *, s_q: int, s_k: int, n_heads: int,
                    head_dim: int, batch: int = 1,
                    window: Optional[int] = None,
                    segments: bool = False) -> Tuple[str, str]:
    """(forward kernel, backward route) that ``flash_attention`` launches
    on CUDA tensors at blocks (bq, bk): ("flash_fwd_mono" or "flash_fwd",
    "mono", "fused" or "two_pass")."""
    fwd = ("flash_fwd_mono" if _mono_ok(s_q, s_k, bq, bk, window=window,
                                        has_segments=segments)
           else "flash_fwd")
    bwd = _bwd_route(batch * n_heads, s_q, s_k, head_dim, bq, bk,
                     window=window, has_segments=segments)
    return fwd, bwd


def _probe_ms(bq: int, bk: int, *, s_q: int, s_k: int, n_heads: int,
              head_dim: int, batch: int, dtype, causal: bool,
              window: Optional[int], segments: bool = False,
              device: Device = None) -> float:
    """Device ms (CUDA events) of one forward + backward through
    ``flash_attention`` at (bq, bk): the mean of ``_PROBE_STEPS`` calls
    queued behind a spin, after ``_PROBE_WARMUP`` untimed calls; ``inf``
    when the card runs out of memory. Every other error propagates."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(s):
        return torch.randn((batch, s, n_heads, head_dim), generator=gen,
                           device=dev, dtype=torch.float32).to(dtype)

    try:
        q, k, v = rand(s_q), rand(s_k), rand(s_k)
        for t in (q, k, v):
            t.requires_grad_(True)
        seg = kv_seg = None
        if segments:
            # A few contiguous documents a row, as the reference's probe:
            # the ids' values barely matter, the masked tiles do.
            def runs(s):
                starts = (torch.arange(s, device=dev) % max(s // 4, 1)) == 0
                return torch.cumsum(starts.to(torch.int32), 0).to(
                    torch.int32)[None].expand(batch, s).contiguous()

            seg, kv_seg = runs(s_q), runs(s_k)

        def step():
            o = flash_attention(
                q, k, v, causal=causal, window=window, segment_ids=seg,
                kv_segment_ids=kv_seg, block_q=bq, block_k=bk,
            )
            # All three gradients, so the route's whole backward runs.
            return torch.autograd.grad(o.float().sum(), (q, k, v))

        for _ in range(_PROBE_WARMUP):
            step()
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(_PROBE_SPIN_CYCLES)
        start.record()
        for _ in range(_PROBE_STEPS):
            step()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / _PROBE_STEPS
    except torch.cuda.OutOfMemoryError:
        logger.debug("flash probe (%d, %d) out of memory", bq, bk,
                     exc_info=True)
        return float("inf")
    finally:
        torch.cuda.empty_cache()


def tune_paged_block_h(
    *,
    n_heads: int,
    head_dim: int,
    page_size: int,
    num_pages: int,
    pages_per_slot: int,
    batch: int,
    q_rows: int = 1,
    dtype=torch.bfloat16,
    cache_file: Optional[str] = None,
) -> int:
    """``block_h`` (heads per grid step) for the paged decode kernel, the
    reference's signature: ``default_paged_block_h`` on every device, and
    no probe. The reference times each divisor of H because its Pallas
    kernel tiles heads by it; the CUDA kernel validates ``block_h`` and
    ignores it (one head per thread block cluster,
    ``ops/paged_attention.py``), so every candidate would time the same
    launch."""
    del num_pages, pages_per_slot, batch, q_rows, cache_file
    return default_paged_block_h(n_heads, head_dim, page_size, dtype)


def tune_flash_blocks(
    *,
    s_q: int,
    s_k: Optional[int] = None,
    n_heads: int,
    head_dim: int,
    batch: int = 1,
    dtype=torch.bfloat16,
    causal: bool = True,
    window: Optional[int] = None,
    segments: bool = False,
    want_q: int = 1024,
    want_k: int = 1024,
    cache_file: Optional[str] = None,
    device: Device = None,
) -> Tuple[int, int]:
    """Resolve (block_q, block_k) for one attention shape on `device`
    (default: the current CUDA card, ``CudaUnavailableError`` without
    one).

    Returns the fitted wanted blocks on a CPU device or when disabled by
    ``DTPU_FLASH_AUTOTUNE=0``; otherwise the cached winner, probing once
    per (card, torch version, kernel sources, shape, dtype, mask mode).
    ``segments``: tune for packed batches; the probe carries segment ids
    and the entry is keyed apart from the segment-free one.
    """
    s_k = s_q if s_k is None else s_k
    fallback = (fit_block(s_q, want_q), fit_block(s_k, want_k))
    if os.environ.get("DTPU_FLASH_AUTOTUNE", "1") == "0":
        return fallback
    dev = torch.device(device) if device is not None else resolve_device(None)
    if dev.type != "cuda":
        return fallback

    path = cache_file or cache_path()
    key = _cache_key(_device_kind(dev), s_q, s_k, n_heads, head_dim, batch,
                     dtype, causal, window, segments)
    hit = _load_cache(path).get(key)
    if isinstance(hit, (list, tuple)) and len(hit) == 2:
        return int(hit[0]), int(hit[1])

    cands = candidate_blocks(s_q, s_k, want_q, want_k)
    # One probe a distinct route, timed at its first candidate.
    routes: Dict[Tuple[str, str], Tuple[int, int]] = {}
    for bq, bk in cands:
        route = candidate_route(bq, bk, s_q=s_q, s_k=s_k, n_heads=n_heads,
                                head_dim=head_dim, batch=batch,
                                window=window, segments=segments)
        routes.setdefault(route, (bq, bk))
    timings = {
        route: _probe_ms(
            bq, bk, s_q=s_q, s_k=s_k, n_heads=n_heads, head_dim=head_dim,
            batch=batch, dtype=dtype, causal=causal, window=window,
            segments=segments, device=dev,
        )
        for route, (bq, bk) in routes.items()
    }
    best_route = min(timings, key=timings.get)
    if timings[best_route] == float("inf"):
        # Every route ran out of memory: return the fallback for THIS
        # process but do not pin it in the cache.
        logger.warning(
            "flash autotune %s: all %d routes failed; using fallback %s "
            "(not cached)", key, len(routes), fallback,
        )
        return fallback
    best = routes[best_route]
    logger.info(
        "flash autotune %s -> blocks %s, route %s (%.3f ms; %d candidates, "
        "%d routes)", key, best, best_route, timings[best_route],
        len(cands), len(routes),
    )
    cache = _load_cache(path)  # re-read: another process may have written
    cache[key] = list(best)
    _store_cache(path, cache)
    return best
