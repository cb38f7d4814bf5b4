"""Experts over the mesh's ``expert`` axis: top-1 (switch) routing, its
dispatch into capacity buckets and back, and the collectives around it.

Port of the routing inside ``determined_tpu/models/gpt.py:335 _moe_mlp``.
The reference traces its mixture of experts on the global [B, S, D] batch
and lets GSPMD insert the collectives that ``we_in`` / ``we_out`` split
over ``expert`` imply. Here each rank holds its rows of the batch
(``("data", "fsdp")``) and E/ep experts (``"expert"`` → ``expert``), and
the model calls these pieces itself:

- ``route``: the router's fp32 softmax, top-1 by ``argmax`` (the first
  maximum on ties, as ``jnp.argmax``), and each token's position in its
  expert's bucket. The reference's capacity ``int(cf · T / E)``, the
  position cumsum and the load-balance loss are taken over the GLOBAL
  tokens in row order, so a token can be dropped because of another
  rank's: the per-expert counts are all-gathered over the batch group and
  a rank's cumsum starts after the counts of the ranks before it
  (``rows`` order); the gates' sums behind the aux loss's ``mean_gate``
  are all-reduced, forward and backward (``sum_over``: every rank adds
  the same global aux to its loss, and the Trainer's weights sum to one
  over the batch group, so the backward's sum gives each rank's gates the
  aux's whole gradient). ``frac`` counts every token, kept or dropped.
- ``dispatch`` / ``combine``: the main path's index form scatters each
  kept token's row of this rank's experts into its [E/ep, C, D] bucket
  and gathers the experts' rows back times the gate; the plain form is
  the reference's dense [T, E, C] one-hot and two einsums. Their outputs
  agree bit for bit: a one-hot sum of rows is exact, and so is one
  product a token. Their gradients agree within rounding: the gate's is a
  dot product over D, which the einsum's backward takes by a matmul and
  the index form's by a reduction.
- ``copy_to_expert`` (*f*: identity forward, all-reduce backward over the
  expert group) on the dispatch's rows and the gate, ``reduce_from_expert``
  (*g*) on the partial combine: each expert rank routes the same tokens,
  runs its own experts and adds its share; without *f* every replicated
  leaf upstream would train on only its own experts' share of the
  gradient.

No kernel: the dispatch is a scatter and a gather, the experts two
batched matmuls, as the reference's einsums. The collectives run on the
card's tensors over NCCL or gloo, and on CPU tensors over gloo; a group
of one rank (None) is skipped.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F

from determined_tpu_torch.parallel.tensor import (
    copy_to_tensor as copy_to_expert,
    reduce_from_tensor as reduce_from_expert,
)

__all__ = ["Routing", "combine", "copy_to_expert", "dispatch",
           "expert_group", "reduce_from_expert", "route", "sum_over"]


def expert_group(mesh: Any) -> Optional[Any]:
    """The process group of the mesh's expert axis this rank belongs to;
    None without a mesh or when the axis has one rank."""
    if mesh is None:
        return None
    if int(mesh.shape[mesh.mesh_dim_names.index("expert")]) == 1:
        return None
    return mesh.get_group("expert")


class _SumOver(torch.autograd.Function):
    """All-reduce forward and backward: a global sum that every rank adds
    to its own loss, each rank's share of the cotangent summed back."""

    @staticmethod
    def forward(ctx, x, group):  # noqa: ANN001
        import torch.distributed as dist

        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):  # noqa: ANN001
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def sum_over(x: torch.Tensor, group: Any) -> torch.Tensor:
    """`x` summed over `group`, forward and backward (None: `x`)."""
    return x if group is None else _SumOver.apply(x, group)


class Routing(NamedTuple):
    """Where each of a rank's T tokens goes: its expert [T], its gate
    [T] fp32 (differentiable), its position in the expert's bucket [T]
    (global, over the batch group's tokens in row order), whether it fits
    the capacity [T], the capacity C, the load-balance aux loss (global)
    and this rank's dropped tokens."""

    expert: torch.Tensor
    gate: torch.Tensor
    position: torch.Tensor
    kept: torch.Tensor
    capacity: int
    aux: torch.Tensor
    dropped: torch.Tensor


def route(gates: torch.Tensor, capacity_factor: float, *,
          group: Any = None, index: int = 0, size: int = 1) -> Routing:
    """Top-1 routing of a rank's tokens from their fp32 router softmax
    `gates` [T, E]. `group`: the batch group (``("data", "fsdp")``, None
    for one rank), this rank's `index` on it (its row block) and its
    `size`; every rank holds T tokens."""
    import torch.distributed as dist

    t, e = gates.shape
    t_global = t * size
    cap = max(1, int(capacity_factor * t_global / e))
    expert = gates.argmax(dim=-1)
    gate = gates.gather(-1, expert[:, None])[:, 0]
    onehot = F.one_hot(expert, e)
    counts = onehot.sum(dim=0)
    offset = torch.zeros_like(counts)
    if group is not None:
        mine = torch.cat([counts.new_tensor([index]), counts])
        every = mine.new_empty(size * (e + 1))
        dist.all_gather_into_tensor(every, mine, group=group)
        every = every.view(size, e + 1)
        before = (every[:, 0] < index)[:, None]
        offset = (every[:, 1:] * before).sum(dim=0)
        counts = every[:, 1:].sum(dim=0)
    position = (onehot.cumsum(dim=0) - 1).gather(-1, expert[:, None])[:, 0]
    position = position + offset[expert]
    kept = position < cap
    frac = counts.float() / t_global
    mean_gate = sum_over(gates.sum(dim=0), group) / t_global
    aux = e * (frac * mean_gate).sum()
    return Routing(expert, gate, position, kept, cap, aux,
                   (~kept).sum())


def _mine(routing: Routing, first: int, n: int) -> torch.Tensor:
    """The kept tokens routed to this rank's experts [first, first + n)."""
    return routing.kept & (routing.expert >= first) & (routing.expert
                                                      < first + n)


def _plain_dispatch(routing: Routing, first: int, n: int) -> torch.Tensor:
    """The reference's dense [T, n, C] fp32 one-hot of this rank's
    experts."""
    sel = _mine(routing, first, n).float()
    e_oh = F.one_hot((routing.expert - first).clamp(0, n - 1), n) * sel[:,
                                                                       None]
    c_oh = F.one_hot(routing.position.clamp(0, routing.capacity - 1),
                     routing.capacity)
    return e_oh[:, :, None].float() * c_oh[:, None, :].float()


def dispatch(x: torch.Tensor, routing: Routing, first: int, n: int,
             form: str = "index") -> torch.Tensor:
    """x [T, D] → this rank's buckets [n, C, D] (experts first … first +
    n − 1): each kept token's row at its position, zeros elsewhere.
    ``form="dense"``: the reference's einsum over the [T, n, C] one-hot."""
    if form == "dense":
        return torch.einsum("tec,td->ecd",
                            _plain_dispatch(routing, first, n).to(x.dtype), x)
    tok = _mine(routing, first, n).nonzero()[:, 0]
    xe = x.new_zeros(n, routing.capacity, x.shape[-1])
    return xe.index_put((routing.expert[tok] - first, routing.position[tok]),
                        x[tok])


def combine(ye: torch.Tensor, routing: Routing, gate: torch.Tensor,
            first: int, n: int, form: str = "index") -> torch.Tensor:
    """This rank's experts' outputs [n, C, D] → [T, D]: each kept token's
    row times its gate (in ye's dtype), zeros for the others.
    ``form="dense"``: the reference's einsum of the gated one-hot."""
    t = routing.expert.shape[0]
    if form == "dense":
        comb = _plain_dispatch(routing, first, n) * gate[:, None, None]
        return torch.einsum("tec,ecd->td", comb.to(ye.dtype), ye)
    tok = _mine(routing, first, n).nonzero()[:, 0]
    rows = ye[routing.expert[tok] - first, routing.position[tok]]
    y = ye.new_zeros(t, ye.shape[-1])
    return y.index_put((tok,), rows * gate[tok].to(ye.dtype)[:, None])
