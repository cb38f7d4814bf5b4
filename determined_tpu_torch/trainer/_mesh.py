"""The Trainer's state on a ``data × fsdp × context × tensor`` device
mesh, and its collectives.

The reference lets GSPMD shard its jitted step over the mesh. Here one
process drives one device, and ``MeshLayout`` does by hand what the
reference's shardings imply, from the same rule table
(``parallel/sharding.py``) over the model's ``logical_axes()``:

- **Parameters and optimizer state** live as each rank's block (ZeRO-3,
  as the reference's GSPMD layout keeps them): a parameter whose "embed"
  dimension the rules map to ``fsdp`` is split along that dimension
  over the fsdp axis; on a tensor axis above 1 one that the model holds
  a slice of (``tensor_dims``: its "heads", "mlp" or "vocab" dimension,
  which the reference's rules map to ``tensor``) is split along it over
  the tensor axis, and a parameter may be split both ways, on two
  dimensions; every other one is whole on every rank. Every block is
  replicated over ``data`` and ``context``, and a parameter that the
  tensor axis does not split over it too. The model's own
  ``nn.Parameter`` of a split leaf holds the block alone
  (``shard_parameters``, after the first broadcast from rank 0, which
  is the only time a whole copy exists); a whole one is its own block.
  The trial's optimizer chain (``trainer.optim``, optax's arithmetic)
  runs on the blocks, so the AdamW moments take the parameters' layout,
  and ``optim.global_norm`` is the whole gradient's norm
  (``norm_reduction``: the blocks' sums of squares, all-reduced over
  fsdp once a step; the whole parameters' added once).
- **Gathered at use** (``gather``, an autograd Function): the forward
  casts the block to the compute dtype and all-gathers it over fsdp
  (bitwise the cast of the gathered fp32, at half the bytes); the
  backward reduce-scatters the gathered weight's gradient, in fp32, over
  fsdp into the block's gradient. The GPT gathers one layer's weights
  at a time (``Model.gather_at_use``), inside its rematted regions,
  whose recompute gathers again; a gathered weight that autograd would
  keep for the backward (a matmul's operand) is saved as a token and
  gathered again when the backward reads it (``regather_saved``), so no
  whole weight outlives its layer. Any other model gets its split leaves
  gathered once at the step's start (``gathered_into``); autograd frees
  them in the backward. The attention kernels see each rank's local
  activations as plain tensors.
- **The batch** (``local``): rows split over ``("data", "fsdp")``, data
  major (``rows``); on a context axis above 1 the sequence (dimension 1
  of every batch array but a per-row [B] one) split over ``context``,
  each rank one slice of ``S / context`` columns (``columns``). On the
  zigzag layout that slice is the rank's two chunks (i, 2R−1−i),
  adjacent in the loader's permuted order. The trial's
  ``replicated_batch_keys`` (default ``positions``) go to every rank
  whole. On a context axis the Trainer first pre-shifts a batch that
  has no ``targets`` (``preshift``): the in-model shift and the packed
  boundary mask cross the edge between two ranks' chunks, which each
  rank alone cannot see.
- **The loss is the global token mean.** Each rank's loss is its own
  tokens' mean; ``loss_weight`` weights it by the rank's share of the
  token count of its tensor group's replicas (``tokens``; 1/(dp·cp) for
  a model that reports none), so that the ranks' weighted losses sum to
  the reference's loss over the global batch, and so do their gradients
  (a rank's gradient holds what its queries sent back around the ring
  too). The ranks of one tensor group compute the same loss over the
  same rows (``replica_group``: the ranks that hold one tensor slice).
- **Gradients**: a parameter split over fsdp is reduce-scattered over
  fsdp (summed) in the backward of its gather and all-reduced over
  every other replica of its block, data and context; any other is
  all-reduced over data × fsdp × context (the gang when the tensor axis
  has one rank) in one flat buffer. A
  tensor slice's gradient is its own rank's, and one that the tensor
  axis replicates is the same on every rank of the group (*f* sums
  theirs); neither is summed over tensor. The global norm all-reduces
  the blocks' sums of squares over the axes that split them, fsdp and
  tensor, once for each call of ``optim.global_norm`` (the trainer's and
  the chain's clip); a replicated block counts once.
- **Metrics**: every scalar metric is summed over data × fsdp × context
  after the same weighting (``tokens`` unweighted), in one all-reduce, so
  every rank holds the same global loss and grad norm, and the
  non-finite guard, the spike detector, rollback-and-skip and the
  reports decide alike on every rank.

A mesh is refused by name when an axis of a later part of the
multi-device item (pipeline, expert) is above 1, or when the rules split
a parameter over any axis but fsdp (the tensor axis splits what the
model holds sliced, ``tensor_dims``). A collective over a
group of one rank is skipped, so one rank on a ``data=1 × fsdp=1`` mesh
does the one-device step's work and the layout's bookkeeping.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from determined_tpu_torch.parallel.mesh import (
    context_index,
    context_size,
    data_parallel_index,
    data_parallel_size,
    refuse_later_axes,
    tensor_size,
    validate_divisibility,
)
from determined_tpu_torch.parallel.sharding import (
    ShardingRules,
    flatten_axes,
    local_region,
    logical_to_sharding,
    replica_index,
)
from determined_tpu_torch.trainer._checkpoint import Shard


@dataclasses.dataclass(frozen=True)
class ParamBlock:
    """Where one parameter lives: its global shape, the dimension split
    over fsdp (None: whole over fsdp), the dimension split over tensor
    (None: whole over tensor; else the model holds that slice), this
    rank's block (global indices) and whether it holds replica 0 of the
    block."""

    shape: Tuple[int, ...]
    dim: Optional[int]
    tdim: Optional[int]
    region: Tuple[Tuple[int, int], ...]
    replica0: bool

    @property
    def starts(self) -> Tuple[int, ...]:
        return tuple(lo for lo, _ in self.region)


def _replica_group(mesh: Any) -> Optional[Any]:
    """The group of the ranks that hold the same tensor slice as this one
    (every axis but ``tensor``); None (the whole gang) when the tensor
    axis has one rank. Every rank of the gang makes every such group
    (``new_group``'s contract)."""
    import torch.distributed as dist

    names = mesh.mesh_dim_names
    t = int(mesh.shape[names.index("tensor")])
    if t == 1:
        return None
    ranks = mesh.mesh.movedim(names.index("tensor"), -1).reshape(-1, t)
    mine = int(mesh.get_coordinate()[names.index("tensor")])
    groups = [dist.new_group([int(r) for r in ranks[:, j]]) for j in range(t)]
    return groups[mine]


class MeshLayout:
    def __init__(self, mesh: Any, rules: ShardingRules, logical_axes: Any,
                 named: Sequence[Tuple[str, torch.Tensor]],
                 tensor_dims: Optional[Dict[str, int]] = None) -> None:
        """`tensor_dims`: {parameter name: the dimension the model holds
        a tensor slice of} (``GPT.tensor_dims``; none: every parameter
        whole). The model's slices place a parameter over the tensor
        axis; the rules place it over the others."""
        import torch.distributed as dist
        from torch.distributed.tensor import Replicate
        from torch.distributed.tensor import Shard as DShard

        refuse_later_axes(mesh)
        if mesh.size() != dist.get_world_size():
            raise ValueError(
                f"the mesh spans {mesh.size()} ranks of a gang of "
                f"{dist.get_world_size()}; the Trainer's mesh spans the gang"
            )
        self.mesh = mesh
        self.fsdp_group = mesh.get_group("fsdp")
        self.data_group = mesh.get_group("data")
        self.context_group = mesh.get_group("context")
        self.world = int(dist.get_world_size())
        self.dp = data_parallel_size(mesh)
        self.dp_index = data_parallel_index(mesh)
        self.cp = context_size(mesh)
        self.cp_index = context_index(mesh)
        self.tp = tensor_size(mesh)
        self.tensor_group = mesh.get_group("tensor")
        #: the ranks that hold the same tensor slice (None: the gang)
        self.replica_group = _replica_group(mesh)
        fsdp = int(mesh.shape[mesh.mesh_dim_names.index("fsdp")])
        ti = mesh.mesh_dim_names.index("tensor")
        axes = flatten_axes(logical_axes)
        tensor_dims = tensor_dims or {}
        self.blocks: List[ParamBlock] = []
        for name, p in named:
            if name not in axes:
                raise ValueError(
                    f"parameter {name} has no entry in the model's "
                    "logical_axes()")
            placements = list(logical_to_sharding(axes[name], mesh, rules))
            tdim = tensor_dims.get(name)
            placements[ti] = Replicate() if tdim is None else DShard(tdim)
            dim = None
            for i, pl in enumerate(placements):
                if not pl.is_shard() or int(mesh.shape[i]) == 1 or i == ti:
                    continue
                axis = mesh.mesh_dim_names[i]
                if axis != "fsdp":
                    raise ValueError(
                        f"the sharding rules split parameter {name} over "
                        f"{axis!r}; the Trainer splits parameters over "
                        "fsdp and, where the model holds slices, tensor"
                    )
                dim = pl.dim
            if dim is not None and dim == tdim:
                raise ValueError(
                    f"the sharding rules split dimension {dim} of parameter "
                    f"{name} over both fsdp and tensor; the Trainer splits "
                    "a dimension over one of them")
            if dim is not None and p.shape[dim] % fsdp:
                raise ValueError(
                    f"parameter {name} {tuple(p.shape)}: dimension "
                    f"{dim} is not divisible by fsdp={fsdp}"
                )
            shape = tuple(n * self.tp if d == tdim else n
                          for d, n in enumerate(p.shape))
            self.blocks.append(ParamBlock(
                shape, dim, tdim,
                tuple(local_region(shape, placements, mesh)),
                replica_index(placements, mesh) == 0,
            ))
        self.fsdp = fsdp
        self.names = [name for name, _ in named]
        #: {parameter name: the dimension split over fsdp} of the
        #: parameters that live as blocks smaller than the model's tensor
        self.split_dims = {name: b.dim for name, b in zip(self.names,
                                                          self.blocks)
                           if b.dim is not None}
        device = named[0][1].device if named else torch.device("cpu")
        #: per parameter 1.0 where fsdp / tensor / both split it: the
        #: norm's parts all-reduced over those axes.
        self._norm_parts = torch.tensor(
            [[float(b.dim is not None and b.tdim is None),
              float(b.dim is None and b.tdim is not None),
              float(b.dim is not None and b.tdim is not None)]
             for b in self.blocks], device=device).reshape(-1, 3)

    # -- placement ---------------------------------------------------------
    def shard_parameters(self, params: Sequence[torch.Tensor]) -> None:
        """Each split parameter's storage ← a copy of this rank's region
        of it, freeing the whole tensor (the fsdp dimension is never split
        over tensor, so its indices are the model's tensor's); one whole
        over fsdp is its own block."""
        with torch.no_grad():
            for b, p in zip(self.blocks, params):
                if b.dim is not None:
                    lo, hi = b.region[b.dim]
                    p.data = p.detach().narrow(b.dim, lo, hi - lo).clone()

    def _all_gather(self, block: torch.Tensor, dim: int,
                    dtype: Optional[torch.dtype]) -> torch.Tensor:
        import torch.distributed as dist

        src = block.detach() if dtype is None else block.detach().to(dtype)
        src = src.movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] * self.fsdp, *src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.all_gather_into_tensor(out, src, group=self.fsdp_group)
        return out if dim == 0 else out.movedim(0, dim).contiguous()

    def _reduce_scatter(self, whole: torch.Tensor, dim: int) -> torch.Tensor:
        import torch.distributed as dist

        src = whole.movedim(dim, 0).contiguous()
        part = torch.empty((src.shape[0] // self.fsdp, *src.shape[1:]),
                           dtype=src.dtype, device=src.device)
        dist.reduce_scatter_tensor(part, src, group=self.fsdp_group)
        return part if dim == 0 else part.movedim(0, dim).contiguous()

    def gather(self, block: torch.Tensor, dim: int,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The whole tensor of `block` (this rank's part of it, split on
        `dim` over fsdp), in `dtype` (None: the block's), through
        ``_Gather``: its gradient is reduce-scattered into the block's. A
        matmul that saves the result for the backward saves a token
        under ``regather_saved``."""
        whole = _Gather.apply(block, self, dim, dtype)
        if whole.requires_grad:
            whole._dtpu_regather = (self, block, dim, dtype)
        return whole

    def regather_saved(self) -> Any:
        """Within this context autograd saves a gathered weight (or a
        view of one) as a token, and the backward gathers it again where
        it reads it."""
        return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)

    @contextlib.contextmanager
    def gathered_into(self, model: Any) -> Iterator[None]:
        """The model's split parameters replaced by their gathered wholes
        while the block runs; the blocks are back on the way out."""
        swapped = []
        try:
            for name, dim in self.split_dims.items():
                owner, _, leaf = name.rpartition(".")
                module = model.get_submodule(owner)
                block = module._parameters[leaf]
                module._parameters[leaf] = _Gather.apply(block, self, dim,
                                                         None)
                swapped.append((module, leaf, block))
            yield
        finally:
            for module, leaf, block in swapped:
                module._parameters[leaf] = block

    def gather_whole(self, blocks: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
        """Every parameter whole over fsdp (a collective; no graph): the
        split ones all-gathered from their blocks, the others as they
        are."""
        with torch.no_grad():
            return [blk.detach() if b.dim is None
                    else self._all_gather(blk, b.dim, None)
                    for b, blk in zip(self.blocks, blocks)]

    def broadcast_from_rank0(self, fulls: Sequence[torch.Tensor]) -> None:
        """Every rank starts from rank 0's parameters; a tensor slice
        from the first rank that holds the same slice."""
        import torch.distributed as dist

        if self.world == 1:
            return
        with torch.no_grad():
            for b, full in zip(self.blocks, fulls):
                if b.tdim is None:
                    dist.broadcast(full, src=0)
                elif self.world > self.tp:
                    group = self.replica_group
                    dist.broadcast(full, src=dist.get_global_rank(group, 0),
                                   group=group)

    def rows(self, x: Any) -> Any:
        """This rank's rows of a global batch array."""
        n = x.shape[0] // self.dp
        return x[self.dp_index * n:(self.dp_index + 1) * n]

    def columns(self, x: Any) -> Any:
        """This rank's slice of the sequence (dimension 1) of a batch
        array: one chunk of S / context columns (a per-row array [B]
        stays whole)."""
        if self.cp == 1 or x.ndim < 2:
            return x
        n = x.shape[1] // self.cp
        return x[:, self.cp_index * n:(self.cp_index + 1) * n]

    def local(self, x: Any) -> Any:
        """This rank's block of a global batch array."""
        return self.columns(self.rows(x))

    def check_batch(self, batch: Dict[str, Any], replicated: frozenset) -> None:
        for k, v in batch.items():
            if k not in replicated:
                seq = v.shape[1] if self.cp > 1 and v.ndim > 1 else None
                validate_divisibility(self.mesh, global_batch=len(v),
                                      seq_len=seq)

    def shard_view_blocks(self) -> List[Tuple[Tuple[int, ...], Tuple[int, ...], bool]]:
        """(global shape, starts, replica0) per parameter, for
        ``_checkpoint.sharded_state_view``."""
        return [(b.shape, b.starts, b.replica0) for b in self.blocks]

    def shards(self, names: Sequence[str],
               blocks: Sequence[torch.Tensor]) -> Dict[str, Shard]:
        return {n: Shard(t, b.shape, b.starts, b.replica0)
                for n, t, b in zip(names, blocks, self.blocks)}

    # -- the step's collectives ----------------------------------------------
    def loss_weight(self, metrics: Dict[str, torch.Tensor]) -> Any:
        """This rank's share of the global mean: its tokens over the
        gang's (all-reduced), or 1/(dp·cp) without a ``tokens`` metric."""
        import torch.distributed as dist

        tokens = metrics.get("tokens")
        if tokens is None:
            return 1.0 / (self.dp * self.cp)
        mine = tokens.detach().float().reshape(())
        total = mine.clone()
        if self.world > self.tp:
            dist.all_reduce(total, group=self.replica_group)
        return mine / torch.clamp(total, min=1.0)

    def reduce_grads(self, grads: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
        """The gradients of this rank's weighted loss w.r.t. its blocks →
        the gang's summed gradient of each block: a split block's, already
        reduce-scattered over fsdp by its gather's backward, all-reduced
        over its other replicas (data × context); a whole one's over the
        replica group in one flat buffer."""
        import torch.distributed as dist

        out: List[torch.Tensor] = list(grads)
        whole = [i for i, b in enumerate(self.blocks) if b.dim is None]
        for i, (b, g) in enumerate(zip(self.blocks, grads)):
            if b.dim is None:
                continue
            for group in (self.data_group, self.context_group):
                if int(group.size()) > 1:
                    g = g.contiguous()
                    dist.all_reduce(g, group=group)
            out[i] = g
        if whole and self.world > self.tp:
            flat = torch.cat([grads[i].reshape(-1) for i in whole])
            dist.all_reduce(flat, group=self.replica_group)
            for i, piece in zip(whole, flat.split(
                    [grads[i].numel() for i in whole])):
                out[i] = piece.view_as(grads[i])
        return out

    def sum_of_squares(self, tensors: Sequence[torch.Tensor],
                       sq: torch.Tensor) -> torch.Tensor:
        """``optim.norm_reduction``'s total for per-parameter tensors:
        the sums of the parameters split over fsdp all-reduced over fsdp,
        of those split over tensor over tensor, of those split both ways
        over both, plus the whole ones' (held alike by every rank)."""
        import torch.distributed as dist

        if len(tensors) != len(self.blocks):
            raise ValueError(
                f"a global norm over {len(tensors)} tensors of a sharded "
                f"state of {len(self.blocks)} parameters")
        fsdp, tensor, both = (sq[:, None] * self._norm_parts).sum(dim=0)
        if int(self.fsdp_group.size()) > 1:
            fsdp_both = torch.stack([fsdp, both])
            dist.all_reduce(fsdp_both, group=self.fsdp_group)
            fsdp, both = fsdp_both
        if self.tp > 1:
            tensor_both = torch.stack([tensor, both])
            dist.all_reduce(tensor_both, group=self.tensor_group)
            tensor, both = tensor_both
        whole = (sq * (1.0 - self._norm_parts.sum(dim=1))).sum()
        return fsdp + tensor + both + whole

    def reduce_metrics(self, metrics: Dict[str, torch.Tensor],
                       weight: Any) -> Dict[str, torch.Tensor]:
        """Every scalar metric summed over data × fsdp × context,
        weighted by `weight` (``tokens`` unweighted), in one all-reduce
        (every rank of a tensor group holds the same metrics)."""
        import torch.distributed as dist

        keys = [k for k, v in metrics.items() if v.dim() == 0]
        vals = torch.stack([
            metrics[k].detach().float() * (1.0 if k == "tokens" else weight)
            for k in keys])
        if self.world > self.tp:
            dist.all_reduce(vals, group=self.replica_group)
        return dict(zip(keys, vals.unbind(0)))


class _Gather(torch.autograd.Function):
    """A block → its whole tensor over fsdp (cast first, so the gather
    moves the compute dtype); the backward reduce-scatters the whole
    gradient, in the block's dtype (fp32), into the block's."""

    @staticmethod
    def forward(ctx, block, layout, dim, dtype):  # noqa: ANN001
        ctx.layout, ctx.dim, ctx.block_dtype = layout, dim, block.dtype
        return layout._all_gather(block, dim, dtype)

    @staticmethod
    def backward(ctx, grad):  # noqa: ANN001
        return (ctx.layout._reduce_scatter(grad.to(ctx.block_dtype), ctx.dim),
                None, None, None)


class _Regather:
    """A saved view of a gathered weight, as a token: its block and the
    view's geometry."""

    __slots__ = ("source", "size", "stride", "offset")

    def __init__(self, source: Tuple[Any, ...], t: torch.Tensor) -> None:
        self.source = source
        self.size, self.stride = t.size(), t.stride()
        self.offset = t.storage_offset()


def _pack(t: torch.Tensor) -> Any:
    base = t if t._base is None else t._base
    source = getattr(base, "_dtpu_regather", None)
    if source is None:
        return t
    return _Regather(source, t)


def _unpack(saved: Any) -> torch.Tensor:
    if not isinstance(saved, _Regather):
        return saved
    layout, block, dim, dtype = saved.source
    whole = layout._all_gather(block, dim, dtype)
    return whole.as_strided(saved.size, saved.stride, saved.offset)


def preshift(batch: Dict[str, Any]) -> Dict[str, Any]:
    """A global batch with the in-model next-token shift made explicit:
    ``targets`` = tokens shifted by one, the last column masked, and the
    packed boundary and padding mask (``GPT.loss``'s, from
    ``segment_ids``) folded into ``loss_mask``, shifted with the targets.
    The per-token sums equal the in-model shift's."""
    tokens = np.asarray(batch["tokens"])
    mask = batch.get("loss_mask")
    mask = (np.ones(tokens.shape, np.float32) if mask is None
            else np.asarray(mask, np.float32))
    seg = batch.get("segment_ids")
    if seg is not None:
        seg = np.asarray(seg)
        boundary = np.concatenate(
            [np.ones_like(mask[:, :1]),
             (seg[:, 1:] == seg[:, :-1]).astype(np.float32)], axis=1)
        mask = mask * boundary * (seg != 0)
    targets = np.zeros_like(tokens)
    targets[:, :-1] = tokens[:, 1:]
    shifted = np.zeros_like(mask)
    shifted[:, :-1] = mask[:, 1:]
    return dict(batch, targets=targets, loss_mask=shifted)


def rank_seed(seed: int, rank: int) -> int:
    """Each rank's generator seed, from (seed, rank)."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])
