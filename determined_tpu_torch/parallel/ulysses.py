"""Ulysses-style sequence parallelism: all-to-all head↔sequence swap.

Port of ``determined_tpu/parallel/ulysses.py``. Activations arrive
sequence-sharded over the context group; an all-to-all re-shards them
over heads, so each rank runs full-sequence attention for H/c heads, and
a second all-to-all restores the sequence sharding. Both all-to-alls are
differentiable (their backward is the other one). Q, K and V go through
one all-to-all together.

The default ``local_attn`` is ``reference_attention``, dense, as in the
reference; ``determined_tpu_torch.models.attention`` dispatches here
without one.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import torch

from determined_tpu_torch.models.attention import reference_attention


def _group(group: Any, axis_name: str):
    if group is not None and hasattr(group, "mesh_dim_names"):
        return group.get_group(axis_name)
    return group


def _all_to_all(x: torch.Tensor, group: Any, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    """Tiled all-to-all: `split_dim` cut into c pieces, piece j to rank j;
    the pieces received concatenated along `concat_dim` in rank order."""
    import torch.distributed as dist

    c = int(dist.get_world_size(group))
    send = torch.stack(x.chunk(c, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, concat_dim, split_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad.contiguous(), *ctx.args), None, None, None


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    axis_name: str = "context",
    group: Any = None,
    causal: bool = True,
    local_attn: Optional[Callable] = None,
) -> torch.Tensor:
    """Call on every rank of the context group; per-rank shapes
    [B, S/c, H, D]. `group`: a process group (None: the default one) or a
    ``DeviceMesh`` (its `axis_name` dimension). Requires H divisible by
    the group's size."""
    import torch.distributed as dist

    group = _group(group, axis_name)
    c = int(dist.get_world_size(group))
    local_attn = local_attn or functools.partial(reference_attention,
                                                 causal=causal)
    if c == 1:
        return local_attn(q, k, v)
    if q.shape[2] % c:
        raise ValueError(
            f"ulysses needs heads ({q.shape[2]}) divisible by the context "
            f"axis ({c})")
    # [3, B, S/c, H, D] -> [3, B, S, H/c, D]
    qkv = _AllToAll.apply(torch.stack([q, k, v]), group, 3, 2)
    out = local_attn(qkv[0], qkv[1], qkv[2])
    return _AllToAll.apply(out, group, 1, 2)


def make_ulysses_attention(
    mesh: Any,
    *,
    causal: bool = True,
    batch_axes=("data", "fsdp"),
    seq_axis: str = "context",
):
    """ulysses_attention over a DeviceMesh, on global [B, S, H, D]
    tensors that are the same on every rank (``make_ring_attention``'s
    contract): each rank's rows, sequence chunk and heads (H/tensor over
    the mesh's ``tensor`` axis, of which the all-to-all gives each rank
    H/(tensor · context)), the result gathered back whole."""
    from determined_tpu_torch.parallel.ring import _Global, _Local, mesh_splits

    splits = (mesh_splits(mesh, batch_axes, 0)
              + mesh_splits(mesh, (seq_axis,), 1)
              + mesh_splits(mesh, ("tensor",), 2))
    group = mesh.get_group(seq_axis)

    def call(q, k, v):
        local = [_Local.apply(x, splits) for x in (q, k, v)]
        o = ulysses_attention(*local, group=group, causal=causal)
        return _Global.apply(o, splits)

    return call
