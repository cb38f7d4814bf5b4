"""Device meshes over a gang of processes, one process per device.

Port of ``determined_tpu/parallel/mesh.py``. The axes are the reference's
six, in its order (outermost first): ``pipeline``, ``data``, ``fsdp``,
``expert``, ``context``, ``tensor``. ``MeshConfig`` resolves the degrees
as the reference does (one axis may be -1, inferred from the device
count) and ``refit`` is the reference's arithmetic for an elastic resize
(the harness's resize loop refits a configured mesh that no longer fits
the resized gang, ``exec/harness.py:resolve_mesh``).

``make_mesh`` builds a ``torch.distributed.device_mesh.DeviceMesh`` over
the gang that ``torch.distributed`` already joined (``core.init()`` joins
it for a gang; a single process calls ``init_process_group`` itself):
one device per rank, the ranks laid out row-major over the six axes as
the reference reshapes its device list. The mesh lives on CUDA unless the
caller passes ``device="cpu"``.

The port trains over all six: ``data``, ``fsdp``, ``context`` (the
sequence split over the context group, attention by ring or Ulysses),
``tensor`` (Megatron's column and row splits, ``parallel/tensor.py``),
``pipeline`` (the stages' schedules, ``parallel/pipeline.py``) and
``expert`` (the top-1 experts, ``parallel/experts.py``, over data ×
fsdp × expert × context × tensor). What the port leaves out is refused by
name (``refuse_later_axes``): an expert axis beside a pipeline axis above
1, the reference's own limit. ``axes_group`` is the process group of the
ranks that differ from this one only along some axes: the Trainer's
gradient, loss and norm groups (``trainer/_mesh.py``) and the experts'
compute and routing groups (``parallel/experts.py groups``) are such
groups.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple, Union

import torch

from determined_tpu_torch._device import resolve_device

# Outermost (DCN-friendly) → innermost (ICI-hungry), as the reference.
AXIS_NAMES: Tuple[str, ...] = ("pipeline", "data", "fsdp", "expert",
                               "context", "tensor")

#: The axes the expert axis does not compose with: experts under a
#: pipeline are the reference's own limit ("MoE+pipeline composition not
#: supported yet", ``determined_tpu/models/gpt.py:793``).
_NOT_WITH_EXPERT = ("pipeline",)


@dataclasses.dataclass
class MeshConfig:
    """Per-axis parallel degrees. One axis may be -1 = infer from device count."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1
    pipeline: int = 1
    context: int = 1
    expert: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        sizes = dataclasses.asdict(self)
        unknown = [k for k, v in sizes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError(f"at most one axis may be -1, got {unknown}")
        known = math.prod(v for v in sizes.values() if v != -1)
        if unknown:
            if n_devices % known != 0:
                raise ValueError(
                    f"cannot infer {unknown[0]}: {n_devices} devices not divisible "
                    f"by {known}"
                )
            sizes[unknown[0]] = n_devices // known
        if math.prod(sizes.values()) != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {math.prod(sizes.values())} devices, "
                f"have {n_devices}"
            )
        return MeshConfig(**sizes)

    def axis_sizes(self) -> Tuple[int, ...]:
        d = dataclasses.asdict(self)
        return tuple(d[name] for name in AXIS_NAMES)

    def refit(self, n_devices: int) -> "MeshConfig":
        """Re-resolve this layout for a changed device count: the
        model-parallel degrees (tensor, pipeline, context, expert) are
        kept and the replication axes absorb the change — fsdp keeps its
        largest degree that still divides the room left (an inferred
        fsdp keeps sharding over all of it), data takes the rest — else
        a pure data-parallel mesh (the reference's arithmetic)."""
        sizes = dataclasses.asdict(self)
        try:
            return self.resolve(n_devices)  # an inferred axis absorbs it
        except ValueError:
            pass
        mp_sizes = {k: v for k, v in sizes.items() if k not in ("data", "fsdp")}
        if any(v == -1 for v in mp_sizes.values()):
            return MeshConfig(data=-1).resolve(n_devices)
        mp = math.prod(max(1, v) for v in mp_sizes.values())
        if n_devices % mp != 0:
            return MeshConfig(data=-1).resolve(n_devices)
        dp_total = n_devices // mp
        fsdp = sizes["fsdp"]
        fsdp = dp_total if fsdp == -1 else math.gcd(max(1, fsdp), dp_total)
        return MeshConfig(
            data=-1, fsdp=fsdp,
            tensor=max(1, sizes["tensor"]),
            pipeline=max(1, sizes["pipeline"]),
            context=max(1, sizes["context"]),
            expert=max(1, sizes["expert"]),
        ).resolve(n_devices)


def refuse_later_axes(sizes: Any, what: str = "mesh") -> None:
    """Refuse, by name, a layout that the port leaves out: an expert axis
    above 1 beside a pipeline axis above 1. `sizes`: a MeshConfig, a
    DeviceMesh or a {axis: degree} mapping."""
    if isinstance(sizes, MeshConfig):
        sizes = dataclasses.asdict(sizes)
    elif not isinstance(sizes, dict):
        sizes = dict(zip(sizes.mesh_dim_names, tuple(sizes.shape)))
    expert = int(sizes.get("expert", 1))
    if expert == 1:
        return
    for axis in _NOT_WITH_EXPERT:
        degree = int(sizes.get(axis, 1))
        if degree != 1:
            raise NotImplementedError(
                f"{what} with expert={expert} and {axis}={degree}: experts "
                f"over {axis} are left out (ROADMAP queue 1, item 4), as "
                "the reference leaves them out; the port runs experts over "
                "data, fsdp, expert, context and tensor"
            )


def axes_group(mesh: Any, axes: Sequence[str]) -> Any:
    """The process group of the ranks that share this rank's coordinates
    on every axis but `axes` (ordered by global rank, which is row-major
    over `axes`); ``dist.group.WORLD`` when that is the whole mesh; None
    when it is this rank alone. Every rank of the mesh makes every such
    group, in one order (``new_group``'s contract); a mesh keeps the
    groups it made."""
    import torch.distributed as dist

    names = mesh.mesh_dim_names
    keep = [names.index(a) for a in axes]
    size = math.prod(int(mesh.shape[i]) for i in keep)
    if size == 1:
        return None
    if size == dist.get_world_size() == math.prod(int(n) for n in mesh.shape):
        return dist.group.WORLD
    cache = mesh.__dict__.setdefault("_dtpu_axes_groups", {})
    key = tuple(axes)
    if key not in cache:
        other = [i for i in range(len(names)) if i not in keep]
        rows = mesh.mesh.permute(*other, *keep).reshape(-1, size)
        me = dist.get_rank()
        mine = None
        for row in rows.tolist():
            group = dist.new_group([int(r) for r in row])
            if me in row:
                mine = group
        cache[key] = mine
    return cache[key]


def _world_size() -> int:
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a device mesh spans the gang that torch.distributed joined: "
            "core.init() joins it for a gang; one process calls "
            "torch.distributed.init_process_group itself"
        )
    return dist.get_world_size()


def _device_mesh(sizes: Tuple[int, ...],
                 device: Optional[Union[str, torch.device]]):
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    return init_device_mesh(dev.type, sizes, mesh_dim_names=AXIS_NAMES)


def make_mesh(config: Optional[MeshConfig] = None, *,
              device: Optional[Union[str, torch.device]] = None):
    """A DeviceMesh over every rank of the gang with the canonical axis
    names, ranks laid out row-major (the reference's reshape of its
    device list)."""
    config = config or MeshConfig()
    refuse_later_axes(config)
    return _device_mesh(config.resolve(_world_size()).axis_sizes(), device)


def multislice_axis_sizes(config: Optional[MeshConfig], n_devices: int,
                          dcn_data: int) -> Tuple[int, ...]:
    """The axis sizes of a mesh over `dcn_data` slices of `n_devices`
    devices in all: `config` describes one slice, and its data axis is
    multiplied by `dcn_data`."""
    if n_devices % dcn_data != 0:
        raise ValueError(
            f"{n_devices} devices not divisible by dcn_data={dcn_data} slices"
        )
    ici = (config or MeshConfig()).resolve(n_devices // dcn_data).axis_sizes()
    return tuple(s * dcn_data if name == "data" else s
                 for name, s in zip(AXIS_NAMES, ici))


def make_multislice_mesh(config: Optional[MeshConfig] = None, *,
                         dcn_data: int = 0,
                         device: Optional[Union[str, torch.device]] = None):
    """The reference's multi-slice mesh: the data axis multiplied by
    `dcn_data`. A GPU gang has no slice topology to detect, so
    ``dcn_data=0`` means one slice; the layout is the plain reshape the
    reference uses off the TPU."""
    refuse_later_axes(config or MeshConfig())
    sizes = multislice_axis_sizes(config, _world_size(), max(1, dcn_data))
    return _device_mesh(sizes, device)


def batch_axes() -> Tuple[str, ...]:
    """Mesh axes over which the global batch is split."""
    return ("data", "fsdp")


def _axis(mesh: Any, name: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(name)])


def axis_index(mesh: Any, name: str) -> int:
    """This rank's coordinate on the mesh axis `name`."""
    return int(mesh.get_coordinate()[mesh.mesh_dim_names.index(name)])


def data_parallel_size(mesh: Any) -> int:
    return _axis(mesh, "data") * _axis(mesh, "fsdp")


def data_parallel_index(mesh: Any) -> int:
    """This rank's row block of the global batch: its (data, fsdp)
    coordinate, data major, as ``("data", "fsdp")`` splits the batch."""
    coord = mesh.get_coordinate()
    names = mesh.mesh_dim_names
    return (coord[names.index("data")] * _axis(mesh, "fsdp")
            + coord[names.index("fsdp")])


def context_size(mesh: Any) -> int:
    return _axis(mesh, "context")


def context_index(mesh: Any) -> int:
    """This rank's sequence chunk: its coordinate on the context axis."""
    return int(mesh.get_coordinate()[mesh.mesh_dim_names.index("context")])


def tensor_size(mesh: Any) -> int:
    return _axis(mesh, "tensor")


def tensor_index(mesh: Any) -> int:
    """This rank's slice of the split parameters: its coordinate on the
    tensor axis."""
    return int(mesh.get_coordinate()[mesh.mesh_dim_names.index("tensor")])


def validate_divisibility(mesh: Any, *, global_batch: int,
                          seq_len: Optional[int] = None) -> None:
    dp = data_parallel_size(mesh)
    if global_batch % dp != 0:
        raise ValueError(f"global batch {global_batch} not divisible by dp size {dp}")
    context = _axis(mesh, "context")
    if seq_len is not None and context > 1 and seq_len % context != 0:
        raise ValueError(
            f"seq_len {seq_len} not divisible by context axis {context}"
        )
