"""Checkpoint (de)serialization in the reference's on-disk format.

Port of ``determined_tpu/trainer/_checkpoint.py``. The format is the
reference's, letter for letter, so either package loads the other's
checkpoints: one ``.npy`` file per leaf, named by the leaf's flattened
keypath (``_leaf_name``), plus a ``tree.json`` manifest
(``keypath-flat-v1``). A multi-host JAX pod writes sharded leaves as
``<name>.shard<starts>.npy``; ``_read_region`` reassembles them with the
reference's coverage, overlap and shape-drift checks.

The names are JAX keypaths: a dict entry is named by its key, a tuple
element by its index, a NamedTuple field by its field name, joined by
``__``. The port's objects do not flatten to those names on their own:
the module holds parameters as ``nn.Parameter``s named ``blocks.wqkv``,
and the optimizer state (``trainer.optim``) holds ``mu`` and ``nu`` as
sequences in parameter order. So the trainer saves and loads a **named state
view** (``state_view``): ``{"step": int32 0-d, "params": nested dict from
the dotted parameter names, "opt_state": the optimizer's NamedTuples and
tuples, each per-parameter sequence replaced by the same nested dict}``.
For ``gpt.tiny()`` under ``chain(clip_by_global_norm(1.0), adamw(lr))``
that gives ``params__blocks__wqkv`` and ``opt_state__1__0__mu__tok_embed``,
as the JAX ``Trainer`` writes them.

A gang on a device mesh saves its state sharded, as the reference's
multi-host pod does: every per-parameter leaf is this rank's block of it
(``Shard``: the local tensor, the leaf's global shape, the block's
starts — its fsdp and tensor offsets — whether this rank holds replica
0 of the block). Each rank writes
the blocks it holds replica 0 of — a block that is not the whole leaf as
``{name}.shard<starts>.npy`` (starts joined by ``_``), a whole one under
the leaf's own name — and the chief alone writes the rest (the step, the
optimizer's counts) and ``tree.json``. Loading into a view of ``Shard``
leaves reads each rank's own block (``_read_region``) at the layout the
gang has now, whatever layout wrote the files (one rank, ``fsdp``,
``tensor``, ``context``): the region is stitched from every shard file
that overlaps it, and a region the files do not cover raises
``CorruptCheckpointError``. ``load_pytree(shardings=...)`` is the same
read with the reference's signature: a ``Placement`` per leaf.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from determined_tpu_torch.storage.base import CorruptCheckpointError

MANIFEST = "tree.json"


def _leaf_name(path: Sequence[Any]) -> str:
    """The file name of the leaf at `path` (dict keys, tuple indices and
    NamedTuple field names), sanitized as the reference sanitizes it."""
    name = "__".join(str(p) for p in path) or "leaf"
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_path(tree: Any, path: Tuple[Any, ...] = ()
                       ) -> Iterator[Tuple[Tuple[Any, ...], Any]]:
    """(path, leaf) pairs in ``jax.tree_util``'s order: dict keys sorted,
    NamedTuple fields and sequence elements in order; None has no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten_with_path(tree[key], path + (key,))
    elif _is_namedtuple(tree):
        for field, value in zip(tree._fields, tree):
            yield from _flatten_with_path(value, path + (field,))
    elif isinstance(tree, (tuple, list)):
        for i, value in enumerate(tree):
            yield from _flatten_with_path(value, path + (i,))
    else:
        yield path, tree


def _unflatten(like: Any, leaves: Iterator[Any]) -> Any:
    """`like`'s structure with its leaves taken in order from `leaves`."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {key: _unflatten(like[key], leaves) for key in sorted(like)}
        return {key: out[key] for key in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's block of one leaf of a sharded state."""

    local: torch.Tensor
    #: the leaf's global shape.
    shape: Tuple[int, ...]
    #: the block's first index along each dimension.
    starts: Tuple[int, ...]
    #: whether this rank holds replica 0 of the block (the copy saved).
    replica0: bool

    @property
    def whole(self) -> bool:
        return tuple(self.local.shape) == tuple(self.shape)

    @property
    def region(self) -> List[Tuple[int, int]]:
        return [(s, s + n) for s, n in zip(self.starts, self.local.shape)]


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one leaf lives on a gang: its global shape and this rank's
    region of it ([start, stop) per dimension): the port's counterpart of
    the reference's ``NamedSharding`` leaf in ``load_pytree``."""

    shape: Tuple[int, ...]
    region: Tuple[Tuple[int, int], ...]

    @classmethod
    def of(cls, shard: "Shard") -> "Placement":
        return cls(tuple(shard.shape), tuple(shard.region))


# ---------------------------------------------------------------------------
# The named state view
# ---------------------------------------------------------------------------
def nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{"blocks.wqkv": x, "tok_embed": y} → {"blocks": {"wqkv": x},
    "tok_embed": y}: the reference's parameter tree from dotted names."""
    out: Dict[str, Any] = {}
    for dotted, value in flat.items():
        *parents, leaf = dotted.split(".")
        node = out
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return out


def unnest(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Inverse of ``nest``: {"blocks": {"wqkv": x}} → {"blocks.wqkv": x}."""
    out: Dict[str, Any] = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(unnest(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = value
    return out


def _param_aligned(x: Any) -> bool:
    """A list or (non-Named) tuple of tensors: in ``trainer.optim``'s
    states that is a per-parameter sequence (``mu``, ``nu``); a chain's
    state is a tuple of NamedTuple states."""
    return (isinstance(x, (list, tuple)) and not _is_namedtuple(x)
            and len(x) > 0
            and all(isinstance(t, (torch.Tensor, Shard)) for t in x))


def _name_lists(tree: Any, names: Sequence[str]) -> Any:
    """`tree` with every per-parameter sequence of the optimizer state
    (``mu``, ``nu``) replaced by the nested dict of its entries keyed by
    parameter name."""
    if _param_aligned(tree):
        if len(tree) != len(names):
            raise ValueError(
                f"optimizer state list of {len(tree)} entries does not "
                f"align with the {len(names)} parameters"
            )
        return nest(dict(zip(names, tree)))
    if _is_namedtuple(tree):
        return type(tree)(*(_name_lists(v, names) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_name_lists(v, names) for v in tree)
    return tree


def state_view(step: int, names: Sequence[str], params: Sequence[Any],
               opt_state: Any) -> Dict[str, Any]:
    """The trainer's state under the reference's names: ``{"step",
    "params", "opt_state"}``, as the JAX ``Trainer``'s state pytree."""
    return {
        "step": torch.tensor(step, dtype=torch.int32),
        "params": nest(dict(zip(names, params))),
        "opt_state": _name_lists(opt_state, names),
    }


def sharded_state_view(step: int, names: Sequence[str],
                       params: Sequence[torch.Tensor], opt_state: Any,
                       blocks: Sequence[Tuple[Tuple[int, ...],
                                              Tuple[int, ...], bool]]
                       ) -> Dict[str, Any]:
    """``state_view`` of a sharded state: every per-parameter tensor (the
    parameter's block, its moments' blocks) becomes a ``Shard`` with the
    parameter's (global shape, starts, replica0) from `blocks`."""

    def wrap(tensors: Sequence[torch.Tensor]) -> List[Shard]:
        return [Shard(t, *block) for t, block in zip(tensors, blocks)]

    def walk(tree: Any) -> Any:
        if _param_aligned(tree):
            return wrap(tree)
        if _is_namedtuple(tree):
            return type(tree)(*(walk(v) for v in tree))
        if isinstance(tree, tuple):
            return tuple(walk(v) for v in tree)
        return tree

    return state_view(step, names, wrap(params), walk(opt_state))


def opt_state_from_view(template: Any, view: Any,
                        names: Sequence[str]) -> Any:
    """Inverse of the view's ``opt_state``: `view`'s values in
    `template`'s structure (the port's optimizer state), each named dict
    turned back into a list in `names` order."""
    if _param_aligned(template):
        flat = unnest(view)
        return [flat[n] for n in names]
    if _is_namedtuple(template):
        return type(template)(*(opt_state_from_view(t, v, names)
                                for t, v in zip(template, view)))
    if isinstance(template, tuple):
        return tuple(opt_state_from_view(t, v, names)
                     for t, v in zip(template, view))
    return view


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------
def _to_host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        # copy=True: a CPU tensor's .cpu() is the tensor itself, and the
        # trainer writes its parameters in place on the next step.
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def snapshot_pytree(tree: Any, chief: bool = True) -> Dict[str, np.ndarray]:
    """Device→host copy of the leaves of `tree` (a named state view) that
    this rank saves: a ``Shard`` leaf where this rank holds replica 0 of
    its block (``{name}.shard<starts>`` unless the block is the whole
    leaf), any other leaf on the `chief` only.

    This is the only part of a save that must block the step loop: once
    the arrays are host numpy, serialization and upload can run on a
    background thread. The copy is synchronous because the next step
    writes the parameters in place (``_sentinel.guarded_update``).
    Returns {filename (sans .npy): array}.
    """
    leaves = list(_flatten_with_path(tree))
    names = [_leaf_name(path) for path, _ in leaves]
    if len(set(names)) != len(names):
        raise ValueError("pytree keypaths collide after sanitization")
    snap: Dict[str, np.ndarray] = {}
    for (_, leaf), name in zip(leaves, names):
        if not isinstance(leaf, Shard):
            if chief:
                snap[name] = _to_host(leaf)
        elif leaf.replica0:
            if not leaf.whole:
                name = f"{name}.shard{'_'.join(str(s) for s in leaf.starts)}"
            snap[name] = _to_host(leaf.local)
    return snap


def write_snapshot(snap: Dict[str, np.ndarray], directory: str,
                   manifest: bool = True) -> List[str]:
    """Serialize a host snapshot to `directory` (and ``tree.json`` when
    `manifest`: the chief's); returns files written."""
    os.makedirs(directory, exist_ok=True)
    written: List[str] = []
    for name, arr in snap.items():
        np.save(os.path.join(directory, f"{name}.npy"), arr)
        written.append(f"{name}.npy")
    if not manifest:
        return written
    # The reference's manifest; "leaves" is advisory (loaders resolve by
    # file name) and, in a gang, lists the chief's leaves only.
    manifest_body = {
        "leaves": sorted({n.split(".shard")[0] for n in snap}),
        "leaves_scope": "chief-host-only",
        "structure": "keypath-flat-v1",
    }
    with open(os.path.join(directory, MANIFEST), "w") as f:
        json.dump(manifest_body, f)
    written.append(MANIFEST)
    return written


def save_pytree(tree: Any, directory: str) -> List[str]:
    """Write every leaf of `tree` under `directory`; returns the files
    written. Synchronous: snapshot + write in one call."""
    return write_snapshot(snapshot_pytree(tree), directory)


class AsyncCheckpointWriter:
    """Single-lane background checkpoint pipeline: ``submit(work)`` runs
    `work` on a daemon thread; at most one save is in flight, so a second
    ``submit`` (or ``wait``) first joins the previous one. Exceptions
    surface at the next ``wait()`` / ``submit()``: a failed checkpoint
    must fail the run, not pass silently."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._result: Any = None

    @property
    def in_flight(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def submit(self, work: Callable[[], Any]) -> None:
        self.wait()

        def run() -> None:
            try:
                self._result = work()
            except BaseException as e:  # noqa: BLE001 — re-raised in wait()
                self._error = e

        self._thread = threading.Thread(
            target=run, name="dtpu-ckpt-writer", daemon=True
        )
        self._thread.start()

    def wait(self) -> Any:
        """Block until the in-flight save (if any) finishes; return its
        result. Raises if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        result, self._result = self._result, None
        return result


# ---------------------------------------------------------------------------
# Load
# ---------------------------------------------------------------------------
# Bytes copied out of checkpoint files by _read_region since the last
# reset: the restore path's cost meter.
_bytes_materialized = 0


def reset_load_stats() -> None:
    global _bytes_materialized
    _bytes_materialized = 0


def load_stats() -> Dict[str, int]:
    return {"bytes_materialized": _bytes_materialized}


def _leaf_dtype(like_leaf: Any) -> np.dtype:
    dtype = getattr(like_leaf, "dtype", np.dtype(np.float32))
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _checkpoint_inventory(directory: str) -> Dict[str, Dict[str, Any]]:
    """One directory scan → {leaf: {"file": path} and/or {"shards":
    [(starts, shape, path)]}}, shard shapes from one header read each."""
    inv: Dict[str, Dict[str, Any]] = {}
    for f in sorted(os.listdir(directory)):
        if not f.endswith(".npy"):
            continue
        path = os.path.join(directory, f)
        base = f[: -len(".npy")]
        if ".shard" in base:
            name, starts_str = base.split(".shard", 1)
            starts = (
                [int(s) for s in starts_str.split("_")] if starts_str else []
            )
            arr = np.load(path, mmap_mode="r")
            fshape = tuple(arr.shape)
            del arr  # drop the mapping; reopened only if a region needs it
            inv.setdefault(name, {}).setdefault("shards", []).append(
                (starts, fshape, path)
            )
        else:
            inv.setdefault(base, {})["file"] = path
    return inv


def _read_region(
    directory: str, name: str, region: List[tuple], shape: tuple,
    dtype: np.dtype, inventory: Optional[Dict[str, Dict[str, Any]]] = None,
) -> np.ndarray:
    """Read ONLY `region` ([start, stop) per dim) of leaf `name`: a single
    ``{name}.npy`` is memory-mapped and sliced; shard files
    (``{name}.shard<starts>.npy``) are mapped and copied only where they
    overlap the region.

    Shape drift is an error, not a silent crop: the file (or shard layout)
    must match the expected leaf `shape` exactly. Incomplete coverage is
    an error too, counted element by element so that overlapping shards
    cannot hide a hole.
    """
    global _bytes_materialized
    if inventory is None:
        inventory = _checkpoint_inventory(directory)
    entry = inventory.get(name)
    if not entry:
        raise FileNotFoundError(
            f"checkpoint missing leaf {name} (no .npy or shard files)"
        )
    if "file" in entry:
        arr = np.load(entry["file"], mmap_mode="r")
        if tuple(arr.shape) != shape:
            raise CorruptCheckpointError(
                f"checkpoint leaf {name} has shape {tuple(arr.shape)}, "
                f"expected {shape} — refusing a silently-cropped restore"
            )
        sel = tuple(slice(s, e) for s, e in region)
        # np.array (not ascontiguousarray: it promotes 0-d to 1-d) copies
        # just the mapped slice out of the file.
        out = np.array(arr[sel], dtype=dtype)
        _bytes_materialized += out.nbytes
        return out

    rshape = tuple(e - s for s, e in region)
    out = np.empty(rshape, dtype=dtype)
    seen = np.zeros(rshape, dtype=np.bool_)
    for starts, fshape, path in entry["shards"]:
        if len(starts) != len(fshape) or len(fshape) != len(shape):
            raise CorruptCheckpointError(
                f"malformed shard filename {path} for shape {shape}"
            )
        for fs, fdim, dim in zip(starts, fshape, shape):
            if fs + fdim > dim:
                raise CorruptCheckpointError(
                    f"shard {path} extends to {fs + fdim} past the leaf "
                    f"extent {dim} for {name} — checkpoint shape drift"
                )
        src, dst, overlaps = [], [], True
        for (rs, re_), fs, fdim in zip(region, starts, fshape):
            lo, hi = max(rs, fs), min(re_, fs + fdim)
            if lo >= hi:
                overlaps = False
                break
            src.append(slice(lo - fs, hi - fs))
            dst.append(slice(lo - rs, hi - rs))
        if not overlaps:
            continue
        arr = np.load(path, mmap_mode="r")
        chunk = np.asarray(arr[tuple(src)]).astype(dtype, copy=False)
        out[tuple(dst)] = chunk
        seen[tuple(dst)] = True
        _bytes_materialized += chunk.nbytes
    covered = int(seen.sum())
    if covered < out.size:
        raise CorruptCheckpointError(
            f"shards for {name} cover {covered} of {out.size} elements; "
            "checkpoint is incomplete"
        )
    return out


def load_pytree(directory: str, like: Any, shardings: Optional[Any] = None) -> Any:
    """Read a checkpoint into the structure of `like`.

    `like` gives the structure, the names, and each leaf's shape and dtype
    (a named state view, or nested dicts of parameters). EVERY leaf is
    read and checked before anything is returned, so a checkpoint with a
    missing leaf, drifted shapes or incomplete shards changes nothing.
    A torch leaf of `like` comes back as a tensor of its dtype on its
    device; any other leaf as a numpy array of its dtype. A ``Shard`` leaf
    comes back as its block alone, read at the gang's layout from whatever
    files hold it (a whole leaf's file, or the shard files of any layout).

    `shardings` (the reference's lazy restore onto a new mesh): the same
    structure as `like`, each leaf a ``Placement`` (global shape and this
    rank's region; a ``Shard`` gives its own) or None (the whole leaf).
    Each leaf is read at its placement only, from the files of whatever
    layout wrote them, and comes back as this rank's region of it.
    """
    leaves = list(_flatten_with_path(like))
    if shardings is None:
        placements: List[Optional[Placement]] = [
            Placement.of(leaf) if isinstance(leaf, Shard) else None
            for _, leaf in leaves]
    else:
        placements = [_placement(sh) for sh in _leaves_of(shardings, like)]
    inventory = _checkpoint_inventory(directory)
    host = []
    for (path, leaf), place in zip(leaves, placements):
        name = _leaf_name(path)
        local = leaf.local if isinstance(leaf, Shard) else leaf
        if place is None:
            shape = tuple(local.shape)
            place = Placement(shape, tuple((0, d) for d in shape))
        host.append(_read_region(
            directory, name, list(place.region), tuple(place.shape),
            _leaf_dtype(local), inventory,
        ))
    out = []
    for (_, leaf), arr in zip(leaves, host):
        if isinstance(leaf, Shard):
            leaf = leaf.local
        out.append(torch.from_numpy(arr).to(leaf.device)
                   if isinstance(leaf, torch.Tensor) else arr)
    return _unflatten(like, iter(out))


def _placement(leaf: Any) -> Optional[Placement]:
    if leaf is None or isinstance(leaf, Placement):
        return leaf
    if isinstance(leaf, Shard):
        return Placement.of(leaf)
    raise TypeError(
        f"a shardings leaf is a Placement, a Shard or None, not "
        f"{type(leaf).__name__}")


def _leaves_of(shardings: Any, like: Any) -> List[Any]:
    """`shardings`' leaves in `like`'s order (a None or Placement leaf
    stands for a whole subtree's leaves only where `like` has a leaf)."""
    out: List[Any] = []

    def walk(s: Any, l: Any) -> None:
        if isinstance(l, dict):
            for key in sorted(l):
                walk(None if s is None else s[key], l[key])
        elif _is_namedtuple(l) or isinstance(l, (tuple, list)):
            for i, v in enumerate(l):
                walk(None if s is None else s[i], v)
        elif l is not None:
            out.append(s)

    walk(shardings, like)
    return out
