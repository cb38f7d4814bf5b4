"""Attention dispatch of the port.

Port of ``determined_tpu/models/attention.py``: the model calls one entry
point over ``[B, S, H, D]`` tensors (on a device mesh, each rank's local
rows and sequence chunk) and ``impl`` picks the path.

- ``"auto"``: ``"ring"`` when the mesh's context axis is above 1, else
  ``"flash"``. Unlike the reference, ``"auto"`` takes the flash path on
  every device: the port's CPU path is the reference's own CPU scan, so
  there is no separate dense default to fall back to.
- ``"flash"``: ``ops.flash_attention`` with the tuned block sizes fitted
  down to divisors of the sequence — the CUDA kernels on the card (the
  mono pair when one block spans the sequence), their plain versions on
  the CPU.
- ``"dense"``: plain softmax attention with the same band/segment mask
  model (port of ``parallel/ring.py::reference_attention``).
- ``"ring"``: ``parallel/ring.py`` on the mesh's context group, a flash
  call a hop; ``layout="zigzag"`` (the sequence already in zigzag order,
  as the zigzag loader emits it) needs it.
- ``"ulysses"``: ``parallel/ulysses.py``, dense local attention over
  H/(tensor · context) heads; no window, no segments, the rank's heads
  divisible by the context axis.

On a tensor axis above 1 every path runs on the rank's H/tensor heads
(the reference's ``shard_map`` over heads split by ``tensor``).
"""
from __future__ import annotations

from typing import Any, Optional

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
    mesh: Any = None,
    causal: bool = True,
    impl: str = "auto",
    block_q: int = 512,
    block_k: int = 512,
    layout: str = "contiguous",
    window: Optional[int] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head attention over [B, S, H, D] tensors (see the module
    docstring for ``impl``). mesh: the DeviceMesh the tensors are this
    rank's block of (rows over data × fsdp, sequence over context, heads
    over tensor).
    block_q/block_k: flash tile sizes, fitted down to divisors of the
    sequence. segment_ids: [B, S] int ids for packed sequences; attention
    only within equal ids."""
    context = 1
    if mesh is not None:
        context = int(mesh.shape[mesh.mesh_dim_names.index("context")])
    if impl == "auto":
        impl = "ring" if context > 1 else "flash"
    if layout == "zigzag" and impl != "ring":
        raise ValueError(
            "layout='zigzag' requires ring attention (a sharded context "
            f"axis); resolved impl is {impl!r} — dense/flash causal masks "
            "assume contiguous order and would be silently wrong"
        )
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown sequence layout {layout!r}")
    if impl in ("flash", "dense") and context > 1:
        raise ValueError(
            f"impl={impl!r} on a mesh with context={context}: each rank "
            "holds one chunk of the sequence; use ring or ulysses"
        )
    if impl == "dense":
        return reference_attention(q, k, v, causal=causal, window=window,
                                   segment_ids=segment_ids)
    if impl == "flash":
        return flash_attention(
            q, k, v, causal=causal, block_q=fit_block(q.shape[1], block_q),
            block_k=fit_block(k.shape[1], block_k), window=window,
            segment_ids=segment_ids,
        )
    if impl == "ring":
        if mesh is None:
            raise ValueError("ring attention needs a mesh")
        from determined_tpu_torch.parallel.ring import ring_attention

        # The hop's flash calls fit the tuned blocks to their own lengths.
        return ring_attention(
            q, k, v, group=mesh, causal=causal, block_q=block_q,
            block_k=block_k, layout=layout, window=window,
            segment_ids=segment_ids,
        )
    if impl == "ulysses":
        if window is not None or segment_ids is not None:
            raise ValueError(
                "window/segment_ids are not supported with ulysses "
                "attention; use ring (sharded context) or flash/dense"
            )
        if mesh is None:
            raise ValueError("ulysses attention needs a mesh")
        tp = int(mesh.shape[mesh.mesh_dim_names.index("tensor")])
        if q.shape[2] % context:
            # the reference's message, over the whole heads
            raise ValueError(
                f"ulysses needs heads ({q.shape[2] * tp}) divisible by "
                f"tensor ({tp}) and heads/tensor ({q.shape[2]}) divisible "
                f"by the context axis ({context})"
            )
        from determined_tpu_torch.parallel.ulysses import ulysses_attention

        return ulysses_attention(q, k, v, group=mesh, causal=causal)
    raise ValueError(f"unknown attention impl {impl!r}")
