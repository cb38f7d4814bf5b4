"""Logical-axis sharding rules: how tensors map onto the mesh.

Port of ``determined_tpu/parallel/sharding.py``. Models name their
parameters' dimensions with logical axes ("batch", "embed", "mlp",
"heads", ...) and one rule table maps logical names to mesh axes, the
same table in both packages (``DEFAULT_RULES``): "embed" → ``fsdp``, the
batch → ``("data", "fsdp")``, "mlp", "heads" and "vocab" → ``tensor``.

``logical_to_spec`` gives the reference's partition spec (one entry per
tensor dimension: a mesh axis, a tuple of them or None).
``logical_to_sharding`` turns it into DTensor placements, one per mesh
dimension: ``Shard(d)`` where the mesh axis splits tensor dimension d,
``Replicate()`` elsewhere. ``local_region`` is the block of a tensor that
one rank holds under such placements (``torch.chunk``'s split, as
DTensor's ``Shard``), and ``shard_pytree_like`` places a tree of tensors
with ``distribute_tensor``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dimension: the mesh axes that split it."""

    def __new__(cls, *axes: MeshAxes) -> "PartitionSpec":
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Ordered (logical_name → mesh axes) rules; first match wins."""

    rules: Tuple[Tuple[str, MeshAxes], ...]

    def lookup(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        for name, axes in self.rules:
            if name == logical:
                return axes
        return None

    def replace(self, **updates: MeshAxes) -> "ShardingRules":
        new = [(k, updates.pop(k)) if k in updates else (k, v) for k, v in self.rules]
        new += [(k, v) for k, v in updates.items()]
        return ShardingRules(tuple(new))


# The reference's canonical rules for transformer training.
DEFAULT_RULES = ShardingRules(
    rules=(
        ("batch", ("data", "fsdp")),
        ("sequence", "context"),
        ("embed", "fsdp"),
        ("mlp", "tensor"),
        ("heads", "tensor"),
        ("kv", None),
        ("head_dim", None),
        ("vocab", "tensor"),
        ("expert", "expert"),
        ("stage", "pipeline"),
        ("norm", None),
    )
)


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def logical_to_spec(
    logical_axes: Sequence[Optional[str]], rules: ShardingRules = DEFAULT_RULES
) -> PartitionSpec:
    return PartitionSpec(*(rules.lookup(ax) for ax in logical_axes))


def spec_for_pytree(logical_tree: Any,
                    rules: ShardingRules = DEFAULT_RULES) -> Any:
    """Map a tree (nested dicts) of logical-axis tuples to the same tree
    of PartitionSpecs."""
    if _is_axes(logical_tree):
        return logical_to_spec(logical_tree, rules)
    if isinstance(logical_tree, dict):
        return {k: spec_for_pytree(v, rules) for k, v in logical_tree.items()}
    raise TypeError(f"not a logical-axes tree: {logical_tree!r}")


def spec_to_placements(spec: Sequence[MeshAxes], mesh: Any) -> Tuple[Any, ...]:
    """A partition spec → one DTensor placement per mesh dimension."""
    from torch.distributed.tensor import Replicate, Shard

    placements: List[Any] = [Replicate()] * len(mesh.mesh_dim_names)
    for dim, axes in enumerate(spec):
        for axis in (axes,) if isinstance(axes, str) else (axes or ()):
            i = mesh.mesh_dim_names.index(axis)
            if not isinstance(placements[i], Replicate):
                raise ValueError(
                    f"mesh axis {axis!r} splits two dimensions of {spec}")
            placements[i] = Shard(dim)
    return tuple(placements)


def logical_to_sharding(
    logical_axes: Sequence[Optional[str]],
    mesh: Any,
    rules: ShardingRules = DEFAULT_RULES,
) -> Tuple[Any, ...]:
    """The placements (``Shard(d)`` / ``Replicate()``, one per mesh
    dimension) of a tensor whose dimensions carry `logical_axes`."""
    return spec_to_placements(logical_to_spec(logical_axes, rules), mesh)


def local_region(shape: Sequence[int], placements: Sequence[Any], mesh: Any,
                 coordinate: Optional[Sequence[int]] = None
                 ) -> List[Tuple[int, int]]:
    """[start, stop) per tensor dimension of the block that the rank at
    `coordinate` (default: this rank) holds. Mesh dimensions that split
    the same tensor dimension nest in mesh order, outer first, and each
    split is ``torch.chunk``'s (ceil-sized pieces, the last ones short or
    empty), as DTensor's ``Shard`` splits."""
    coord = mesh.get_coordinate() if coordinate is None else coordinate
    region = [(0, int(n)) for n in shape]
    for i, placement in enumerate(placements):
        dim = getattr(placement, "dim", None)
        if dim is None or not placement.is_shard():
            continue
        k = int(mesh.shape[i])
        lo, hi = region[dim]
        chunk = -(-(hi - lo) // k)
        start = min(lo + chunk * int(coord[i]), hi)
        region[dim] = (start, min(start + chunk, hi))
    return region


def replica_index(placements: Sequence[Any], mesh: Any,
                  coordinate: Optional[Sequence[int]] = None) -> int:
    """Which copy of its block the rank at `coordinate` holds: its
    coordinate over the mesh dimensions that replicate the tensor, row
    major (0 = the copy a checkpoint writes)."""
    coord = mesh.get_coordinate() if coordinate is None else coordinate
    index = 0
    for i, placement in enumerate(placements):
        if not placement.is_shard():
            index = index * int(mesh.shape[i]) + int(coord[i])
    return index


def shard_pytree_like(
    tree: Any,
    logical_tree: Any,
    mesh: Any,
    rules: ShardingRules = DEFAULT_RULES,
) -> Any:
    """Place a tree (nested dicts) of tensors on the mesh by its logical
    axis annotations: ``distribute_tensor`` per leaf (rank 0's values)."""
    from torch.distributed.tensor import distribute_tensor

    if _is_axes(logical_tree):
        return distribute_tensor(
            tree, mesh, logical_to_sharding(logical_tree, mesh, rules))
    return {k: shard_pytree_like(tree[k], v, mesh, rules)
            for k, v in logical_tree.items()}


def flatten_axes(logical_tree: Dict[str, Any],
                 prefix: str = "") -> Dict[str, Tuple[Optional[str], ...]]:
    """Nested logical axes → {dotted name: axes}, as ``named_parameters``
    names the leaves."""
    out: Dict[str, Tuple[Optional[str], ...]] = {}
    for key, value in logical_tree.items():
        if _is_axes(value):
            out[f"{prefix}{key}"] = value
        else:
            out.update(flatten_axes(value, f"{prefix}{key}."))
    return out
