"""Attention dispatch of the port.

Port of ``determined_tpu/models/attention.py`` for one device: the model
calls one entry point over ``[B, S, H, D]`` tensors and ``impl`` picks the
path.

- ``"auto"`` and ``"flash"``: ``ops.flash_attention`` with the tuned block
  sizes fitted down to divisors of the sequence — the CUDA kernels on the
  card (the mono pair when one block spans the sequence), their plain
  versions on the CPU. Unlike the reference, ``"auto"`` takes the flash
  path on every device: the port's CPU path is the reference's own CPU
  scan, so there is no separate dense default to fall back to.
- ``"dense"``: plain softmax attention with the same band/segment mask
  model (port of ``parallel/ring.py::reference_attention``).
- ``"ring"`` and ``"ulysses"`` shard the sequence over a mesh's context
  axis and come with the multi-device slice's part 2 (ROADMAP queue 1,
  item 4).
"""
from __future__ import annotations

from typing import Optional

import torch

from determined_tpu_torch.ops.flash_attention import fit_block, flash_attention


def reference_attention(q, k, v, *, causal: bool = True, scale=None,
                        window: Optional[int] = None,
                        segment_ids: Optional[torch.Tensor] = None):
    """Plain softmax attention over [B, S, H, D] with the flash kernels'
    band/segment mask model; a row with no live key gives zeros."""
    if window is not None and not causal:
        raise ValueError("window (sliding-window) requires causal=True")
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    s_q, s_k = scores.shape[-2:]
    dev = q.device
    mask = None
    if causal:
        mask = torch.ones((s_q, s_k), dtype=torch.bool, device=dev).tril()
        mask = mask[None, None]
    if window is not None:
        rows = torch.arange(s_q, device=dev)[:, None]
        wm = (rows - torch.arange(s_k, device=dev)[None, :] < window)
        mask = wm[None, None] if mask is None else mask & wm[None, None]
    if segment_ids is not None:
        sm = (segment_ids[:, :, None] == segment_ids[:, None, :])[:, None]
        mask = sm if mask is None else mask & sm
    if mask is not None:
        scores = scores.masked_fill(~mask, float("-inf"))
        p = torch.softmax(scores, dim=-1)
        # Rows with no live key softmax all-(-inf) to NaN; they are
        # defined as zero output. Only those rows are scrubbed.
        empty = ~mask.any(dim=-1, keepdim=True)
        p = p.masked_fill(empty, 0.0)
    else:
        p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    impl: str = "auto",
    block_q: int = 512,
    block_k: int = 512,
    layout: str = "contiguous",
    window: Optional[int] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head attention over [B, S, H, D] tensors (see the module
    docstring for ``impl``). block_q/block_k: flash tile sizes, fitted down
    to divisors of the sequence. segment_ids: [B, S] int ids for packed
    sequences; attention only within equal ids."""
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"{impl} attention shards the sequence over a device mesh's "
            "context axis; it comes with the multi-device slice's ROADMAP "
            "queue 1, item 4, part 2"
        )
    if layout != "contiguous":
        raise ValueError(
            f"layout={layout!r} requires ring attention (a sharded context "
            "axis); dense/flash causal masks assume contiguous order"
        )
    if impl == "dense":
        return reference_attention(q, k, v, causal=causal, window=window,
                                   segment_ids=segment_ids)
    if impl in ("auto", "flash"):
        return flash_attention(
            q, k, v, causal=causal, block_q=fit_block(q.shape[1], block_q),
            block_k=fit_block(k.shape[1], block_k), window=window,
            segment_ids=segment_ids,
        )
    raise ValueError(f"unknown attention impl {impl!r}")
