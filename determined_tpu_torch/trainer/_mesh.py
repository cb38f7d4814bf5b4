"""The Trainer's state on a device mesh over the reference's six axes,
and its collectives.

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
  the tensor axis, and on an expert axis above 1 one whose "expert"
  dimension the model holds its experts' slice of (``expert_dims``) is
  split along it over ``expert``; a parameter may be split on three
  dimensions at once (an expert model's ``we_in`` [L, E, d, f] on a
  ``fsdp × expert × tensor`` mesh: E over expert, f over tensor and d
  over fsdp as its ZeRO-3 block); every other one is whole on every
  rank. Every block is
  replicated over ``data``, ``context`` and ``pipeline`` (the rules do
  not map "layers": every stage holds every block, as the reference's),
  and a parameter that the tensor or expert axis does not split over it
  too. The model's own
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
  token count over data × fsdp × context (``tokens``; 1/(dp·cp) for a
  model that reports none), so that the ranks' weighted losses sum to
  the reference's loss over the global batch, and so do their gradients
  (a rank's gradient holds what its queries sent back around the ring
  too). The ranks of one tensor, expert or pipeline group compute the
  same loss over the same rows and count once (``token_group``); an
  expert model's aux loss is global over the same group
  (``parallel/experts.py``), so it counts once too.
- **Gradients**: a parameter split over fsdp is reduce-scattered over
  fsdp (summed) in the backward of its gather and all-reduced over
  every other holder of its block; any other is all-reduced over its
  holders in one flat buffer (``_grad_groups``). The holders are the
  ranks of every axis but tensor (the model's *f* gives every rank of
  a tensor group the same gradient of a leaf it replicates) and but
  the axes that split the leaf. For a pipelined model (``pipelined``:
  each stage computes its own layers' gradients, the embedding's on
  stage 0 and the head's where the loss is computed) the sum over the
  pipeline axis assembles the whole gradient. The expert ranks, and the
  stages of a model that runs no pipeline, compute the same
  contribution: their sum is divided by their count, so every replica
  leaves the step with the same bits (their backwards differ by
  rounding, dq by atomics). The global norm all-reduces
  the blocks' sums of squares over the axes that split them, fsdp,
  tensor and expert, once for each call of ``optim.global_norm`` (the
  trainer's and the chain's clip); a replicated block counts once.
- **Metrics**: every scalar metric is summed over data × fsdp × context
  after the same weighting (``tokens`` unweighted), in one all-reduce, so
  every rank holds the same global loss and grad norm, and the
  non-finite guard, the spike detector, rollback-and-skip and the
  reports decide alike on every rank.

A mesh is refused by name where the port leaves the composition out
(``parallel/mesh.py refuse_later_axes``), or when the rules split a
parameter over any axis but fsdp (the tensor and expert axes split what
the model holds sliced, ``tensor_dims`` and ``expert_dims``). A
collective over a group of one rank is skipped, so one rank on a
``data=1 × fsdp=1`` mesh does the one-device step's work and the
layout's bookkeeping.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from determined_tpu_torch.parallel.mesh import (
    _axis,
    axes_group,
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
    (None: whole over tensor; else the model holds that slice), the one
    split over expert (likewise), this rank's block (global indices) and
    whether it holds replica 0 of the block."""

    shape: Tuple[int, ...]
    dim: Optional[int]
    tdim: Optional[int]
    edim: Optional[int]
    region: Tuple[Tuple[int, int], ...]
    replica0: bool

    @property
    def starts(self) -> Tuple[int, ...]:
        return tuple(lo for lo, _ in self.region)


#: the axes whose splits the norm all-reduces, in ``_norm_parts``' order
_NORM_AXES = ("fsdp", "tensor", "expert")


def _all_reduce(x: torch.Tensor, group: Any) -> torch.Tensor:
    """All-reduce over `group` (None: a group of one rank, skipped)."""
    import torch.distributed as dist

    if group is not None:
        dist.all_reduce(x, group=group)
    return x


class MeshLayout:
    def __init__(self, mesh: Any, rules: ShardingRules, logical_axes: Any,
                 named: Sequence[Tuple[str, torch.Tensor]],
                 tensor_dims: Optional[Dict[str, int]] = None,
                 expert_dims: Optional[Dict[str, int]] = None,
                 pipelined: bool = False) -> None:
        """`tensor_dims` / `expert_dims`: {parameter name: the dimension
        the model holds a tensor / expert slice of} (``GPT.tensor_dims``,
        ``GPT.expert_dims``; none: every parameter whole). The model's
        slices place a parameter over the tensor and expert axes; the
        rules place it over the others. `pipelined`: the model's stages
        compute disjoint parts of the gradient, summed over the pipeline
        axis."""
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
        self.world = int(dist.get_world_size())
        self.dp = data_parallel_size(mesh)
        self.dp_index = data_parallel_index(mesh)
        self.cp = context_size(mesh)
        self.cp_index = context_index(mesh)
        self.tp = tensor_size(mesh)
        self.ep = _axis(mesh, "expert")
        self.tensor_group = mesh.get_group("tensor")
        self.expert_group = mesh.get_group("expert")
        pp = _axis(mesh, "pipeline")
        #: the ranks whose tokens make up the global batch: the loss
        #: weights and the metrics (None: this rank alone)
        self.token_group = axes_group(mesh, ("data", "fsdp", "context"))
        # A gradient sums over the ranks that hold its block, but for the
        # tensor axis (the model's *f* makes it the same there). Among
        # them, the expert ranks and, for a model that runs no pipeline
        # stages, the pipeline ranks each compute the same contribution:
        # the sum over them is divided by their count, which leaves every
        # replica with the same bits (their backwards differ by rounding:
        # dq by atomics). A block split over expert sums over the others.
        #: by whether a block is split over fsdp and whether over expert:
        #: its gradient's group (None: this rank alone) and divisor
        self._grad_groups: Dict[Tuple[bool, bool], Tuple[Any, int]] = {}
        for split in (False, True):
            for by_expert in (False, True):
                axes = ("pipeline", "data") + ("fsdp",) * (not split) + (
                    ("context",) if by_expert else ("expert", "context"))
                dup = (1 if pipelined else pp) * (1 if by_expert
                                                  else self.ep)
                self._grad_groups[split, by_expert] = (
                    axes_group(mesh, axes), dup)
        #: the group of a whole parameter's gradient (the flat buffer's)
        self.replica_group = self._grad_groups[False, False][0]
        fsdp = int(mesh.shape[mesh.mesh_dim_names.index("fsdp")])
        ti = mesh.mesh_dim_names.index("tensor")
        ei = mesh.mesh_dim_names.index("expert")
        axes = flatten_axes(logical_axes)
        tensor_dims = tensor_dims or {}
        expert_dims = expert_dims or {}
        self.blocks: List[ParamBlock] = []
        for name, p in named:
            if name not in axes:
                raise ValueError(
                    f"parameter {name} has no entry in the model's "
                    "logical_axes()")
            placements = list(logical_to_sharding(axes[name], mesh, rules))
            tdim, edim = tensor_dims.get(name), expert_dims.get(name)
            placements[ti] = Replicate() if tdim is None else DShard(tdim)
            placements[ei] = Replicate() if edim is None else DShard(edim)
            dim = None
            for i, pl in enumerate(placements):
                if (not pl.is_shard() or int(mesh.shape[i]) == 1
                        or i in (ti, ei)):
                    continue
                axis = mesh.mesh_dim_names[i]
                if axis != "fsdp":
                    raise ValueError(
                        f"the sharding rules split parameter {name} over "
                        f"{axis!r}; the Trainer splits parameters over "
                        "fsdp and, where the model holds slices, tensor "
                        "and expert"
                    )
                dim = pl.dim
            if dim is not None and dim in (tdim, edim):
                other = "tensor" if dim == tdim else "expert"
                raise ValueError(
                    f"the sharding rules split dimension {dim} of parameter "
                    f"{name} over both fsdp and {other}; the Trainer "
                    "splits a dimension over one of them")
            if dim is not None and p.shape[dim] % fsdp:
                raise ValueError(
                    f"parameter {name} {tuple(p.shape)}: dimension "
                    f"{dim} is not divisible by fsdp={fsdp}"
                )
            shape = tuple(n * self.tp if d == tdim else
                          n * self.ep if d == edim else n
                          for d, n in enumerate(p.shape))
            self.blocks.append(ParamBlock(
                shape, dim, tdim, edim,
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
        #: per parameter, a one-hot over the 8 sets of the axes of
        #: ``_NORM_AXES`` that split it: the norm's parts, each
        #: all-reduced over its axes
        self._norm_parts = torch.zeros(len(self.blocks), 8, device=device)
        for i, b in enumerate(self.blocks):
            bits = (b.dim is not None, b.tdim is not None, b.edim is not None)
            self._norm_parts[i, sum(1 << k for k, on in enumerate(bits)
                                    if on)] = 1.0
        #: per parameter that the model holds sliced over tensor or
        #: expert, the group of the ranks that hold the same slice
        self._slice_groups: Dict[Tuple[bool, bool], Any] = {}
        for b in self.blocks:
            key = (b.tdim is not None, b.edim is not None)
            if key != (False, False) and key not in self._slice_groups:
                skip = {a for a, on in zip(("tensor", "expert"), key) if on}
                self._slice_groups[key] = axes_group(
                    mesh, [a for a in mesh.mesh_dim_names if a not in skip])

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
        """Every rank starts from rank 0's parameters; a tensor or expert
        slice from the first rank that holds the same slice."""
        import torch.distributed as dist

        if self.world == 1:
            return
        with torch.no_grad():
            for b, full in zip(self.blocks, fulls):
                key = (b.tdim is not None, b.edim is not None)
                if key == (False, False):
                    dist.broadcast(full, src=0)
                    continue
                group = self._slice_groups[key]
                if group is not None:
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
        total = _all_reduce(mine.clone(), self.token_group)
        return mine / torch.clamp(total, min=1.0)

    def reduce_grads(self, grads: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
        """The gradients of this rank's weighted loss w.r.t. its blocks →
        the gang's summed gradient of each block (``_grad_groups``): a
        split block's, already reduce-scattered over fsdp by its gather's
        backward, all-reduced over its other holders; the whole ones', in
        one flat buffer a group."""
        out: List[torch.Tensor] = list(grads)
        whole: Dict[bool, List[int]] = {}
        for i, (b, g) in enumerate(zip(self.blocks, grads)):
            by_expert = b.edim is not None
            if b.dim is None:
                whole.setdefault(by_expert, []).append(i)
                continue
            group, dup = self._grad_groups[True, by_expert]
            if group is not None:
                g = _all_reduce(g.contiguous(), group)
            out[i] = g / dup if dup > 1 else g
        for by_expert, idx in whole.items():
            group, dup = self._grad_groups[False, by_expert]
            if group is None:
                continue
            flat = _all_reduce(torch.cat([grads[i].reshape(-1)
                                          for i in idx]), group)
            if dup > 1:
                flat /= dup
            for i, piece in zip(idx, flat.split([grads[i].numel()
                                                 for i in idx])):
                out[i] = piece.view_as(grads[i])
        return out

    def sum_of_squares(self, tensors: Sequence[torch.Tensor],
                       sq: torch.Tensor) -> torch.Tensor:
        """``optim.norm_reduction``'s total for per-parameter tensors:
        the sums of the parameters split over some of fsdp, tensor and
        expert all-reduced over those axes, plus the whole ones' (held
        alike by every rank)."""
        if len(tensors) != len(self.blocks):
            raise ValueError(
                f"a global norm over {len(tensors)} tensors of a sharded "
                f"state of {len(self.blocks)} parameters")
        parts = (sq[:, None] * self._norm_parts).sum(dim=0)
        for k, (axis, group) in enumerate(zip(
                _NORM_AXES, (self.fsdp_group, self.tensor_group,
                             self.expert_group))):
            if int(group.size()) == 1:
                continue
            sets = [j for j in range(8) if j & (1 << k)]
            sub = _all_reduce(parts[sets].contiguous(), group)
            parts = parts.index_copy(0, torch.tensor(sets,
                                                     device=parts.device),
                                     sub)
        return parts.sum()

    def reduce_metrics(self, metrics: Dict[str, torch.Tensor],
                       weight: Any) -> Dict[str, torch.Tensor]:
        """Every scalar metric summed over data × fsdp × context,
        weighted by `weight` (``tokens`` unweighted), in one all-reduce
        (every rank of a tensor, expert or pipeline group holds the same
        metrics)."""
        keys = [k for k, v in metrics.items() if v.dim() == 0]
        vals = torch.stack([
            metrics[k].detach().float() * (1.0 if k == "tokens" else weight)
            for k in keys])
        _all_reduce(vals, self.token_group)
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


def rank_seed(seed: int, *more: int) -> int:
    """A generator seed from (seed, rank) or (seed, [rank,] step)."""
    return int(np.random.SeedSequence([seed, *more]).generate_state(1)[0])
