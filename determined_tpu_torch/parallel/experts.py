"""Experts over the mesh: top-1 (switch) routing, its dispatch into
capacity buckets and back, and the collectives around it.

Port of the routing inside ``determined_tpu/models/gpt.py:335 _moe_mlp``.
The reference traces its mixture of experts on the global [B, S, D] batch
and lets GSPMD insert the collectives that ``we_in`` / ``we_out`` split
over ``expert`` (their "expert" dimension) and ``tensor`` (their "mlp"
dimension) imply. Here each rank holds its rows of the batch
(``("data", "fsdp")``), on a context axis its chunk of the sequence, its
E/ep experts and, on a tensor axis, their f/tp slice, and the model calls
these pieces itself. Its two groups (``groups``):

- the *routing* group, data × fsdp × context: the ranks whose tokens make
  up the global batch. ``route`` takes the router's fp32 softmax, top-1 by
  ``argmax`` (the first maximum on ties, as ``jnp.argmax``), and each
  token's position in its expert's bucket. The reference's capacity
  ``int(cf · T / E)``, the position cumsum and the load-balance loss are
  taken over the GLOBAL tokens in the batch's [B·S] order, so a token can
  be dropped because of another rank's: the tokens before token (b, s)
  are every token of the rows before b and those of row b before s, which
  sit earlier in this rank's chunk or on the context ranks before it. So
  every rank all-gathers its per-row expert counts [rows, E] over the
  group, and a row's offset is the rows before it plus its chunks before
  this one. On the zigzag layout the batch arrives permuted and the
  chunks are contiguous in that order, which is the reference's order
  too. The gates' sums behind the aux loss's ``mean_gate`` are
  all-reduced, forward and backward (``sum_over``: every rank adds the
  same global aux to its loss, and the Trainer's weights sum to one over
  this group, so the backward's sum gives each rank's gates the aux's
  whole gradient). ``frac`` counts every token, kept or dropped.
- the *compute* group, expert × tensor: the ranks that run one token's
  expert MLP between them, each its experts' ``mlp`` slice. The router,
  ``bo_mlp`` and the gate are replicated compute over it.
  ``copy_to_expert`` (*f*: identity forward, all-reduce backward) goes on
  the dispatch's rows and on the gate, ``reduce_from_expert`` (*g*) on the
  partial combine: the combine is linear, so one all-reduce over expert ×
  tensor after it sums the experts' shares and the ``mlp`` slices'
  partial products alike. Without *f* every replicated leaf upstream
  would train on only this rank's share of the gradient.

``dispatch`` / ``combine``: the main path's index form scatters each
kept token's row of this rank's experts into its [E/ep, C, D] bucket and
gathers the experts' rows back times the gate; the plain form is the
reference's dense [T, E, C] one-hot and two einsums. Their outputs agree
bit for bit: a one-hot sum of rows is exact, and so is one product a
token. Their gradients agree within rounding: the gate's is a dot product
over D, which the einsum's backward takes by a matmul and the index
form's by a reduction.

No kernel: the dispatch is a scatter and a gather, the experts two
batched matmuls, as the reference's einsums. The collectives run on the
card's tensors over NCCL or gloo, and on CPU tensors over gloo; a group
of one rank (None) is skipped.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from determined_tpu_torch.parallel.tensor import (
    copy_to_tensor as copy_to_expert,
    reduce_from_tensor as reduce_from_expert,
)

__all__ = ["NO_GROUPS", "Groups", "Routing", "combine", "copy_to_expert",
           "dispatch", "groups", "reduce_from_expert", "route", "sum_over"]


class Groups(NamedTuple):
    """An expert model's process groups on a mesh (None: one rank) and
    where this rank sits: the compute group (expert × tensor), the
    routing group (data × fsdp × context), this rank's index on it (its
    row block times ``chunks`` plus its context index), its size and the
    context axis's degree (``chunks``: the pieces of a row)."""

    compute: Any
    routing: Any
    index: int
    size: int
    chunks: int


#: one device: no collective
NO_GROUPS = Groups(None, None, 0, 1, 1)


def _group(mesh: Any, axes: Tuple[str, ...]) -> Any:
    """The group of the ranks that differ from this one only along
    `axes`: the mesh's own group of one axis, ``axes_group`` of more;
    None when every axis has one rank."""
    from determined_tpu_torch.parallel.mesh import _axis, axes_group

    above = tuple(a for a in axes if _axis(mesh, a) > 1)
    if not above:
        return None
    if len(above) == 1:
        return mesh.get_group(above[0])
    return axes_group(mesh, above)


def groups(mesh: Any) -> Groups:
    """The experts' groups on `mesh`."""
    from determined_tpu_torch.parallel.mesh import (
        context_index,
        context_size,
        data_parallel_index,
        data_parallel_size,
    )

    cp = context_size(mesh)
    return Groups(
        compute=_group(mesh, ("expert", "tensor")),
        routing=_group(mesh, ("data", "fsdp", "context")),
        index=data_parallel_index(mesh) * cp + context_index(mesh),
        size=data_parallel_size(mesh) * cp, chunks=cp)


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
    (global, over the routing group's tokens in the batch's order),
    whether it fits the capacity [T], the capacity C, the load-balance
    aux loss (global) and this rank's dropped tokens."""

    expert: torch.Tensor
    gate: torch.Tensor
    position: torch.Tensor
    kept: torch.Tensor
    capacity: int
    aux: torch.Tensor
    dropped: torch.Tensor


def route(gates: torch.Tensor, capacity_factor: float, *, rows: int = 1,
          groups: Groups = NO_GROUPS) -> Routing:
    """Top-1 routing of a rank's tokens from their fp32 router softmax
    `gates` [T, E]: `rows` rows of T / rows tokens each, in row-major
    order. Every rank of the routing group holds T tokens."""
    import torch.distributed as dist

    t, e = gates.shape
    t_global = t * groups.size
    cap = max(1, int(capacity_factor * t_global / e))
    expert = gates.argmax(dim=-1)
    gate = gates.gather(-1, expert[:, None])[:, 0]
    onehot = F.one_hot(expert, e).view(rows, t // rows, e)
    per_row = onehot.sum(dim=1)                          # [rows, E]
    # each row's tokens before it: this rank's rows before it
    offset = per_row.cumsum(dim=0) - per_row
    counts = per_row.sum(dim=0)
    if groups.routing is not None:
        mine = torch.cat([per_row.new_tensor([groups.index]),
                          per_row.reshape(-1)])
        every = mine.new_empty(groups.size * mine.numel())
        dist.all_gather_into_tensor(every, mine, group=groups.routing)
        every = every.view(groups.size, -1)
        every = every[every[:, 0].argsort(), 1:].view(
            groups.size // groups.chunks, groups.chunks, rows, e)
        block, chunk = divmod(groups.index, groups.chunks)
        whole = every.sum(dim=1).reshape(-1, e)          # the global rows
        before = (whole.cumsum(dim=0) - whole).view(-1, rows, e)
        # every global row before it, and its own chunks before this one
        offset = before[block] + every[block, :chunk].sum(dim=0)
        counts = whole.sum(dim=0)
    position = (onehot.cumsum(dim=1) - 1 + offset[:, None, :]).view(t, e)
    position = position.gather(-1, expert[:, None])[:, 0]
    kept = position < cap
    frac = counts.float() / t_global
    mean_gate = sum_over(gates.sum(dim=0), groups.routing) / t_global
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
