"""Parallelism layer of the port: device meshes and logical-axis shardings.

Port of ``determined_tpu/parallel``. The reference's data plane is GSPMD
over a ``jax.sharding.Mesh``; here it is one process per device, joined by
``torch.distributed``, with a ``DeviceMesh`` over the reference's six
axes and DTensor placements from the same logical-axis rule table. The
Trainer shards parameters and optimizer state over ``fsdp``, splits
batches' rows over ``("data", "fsdp")`` and their sequence over
``context`` (``trainer/_mesh.py``), where attention runs as ring
attention (``ring.py``) or Ulysses (``ulysses.py``) on the context group.
On a ``tensor`` axis the model holds Megatron's column and row slices,
with the collectives of ``tensor.py``.

Not ported yet, and refused by name: the pipeline schedules and experts
(ROADMAP queue 1, item 4, part 3).
"""
from determined_tpu_torch.parallel.mesh import (
    AXIS_NAMES,
    MeshConfig,
    batch_axes,
    context_index,
    data_parallel_size,
    make_mesh,
    make_multislice_mesh,
    validate_divisibility,
)
from determined_tpu_torch.parallel.ring import (
    make_ring_attention,
    ring_attention,
    zigzag_indices,
)
from determined_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    PartitionSpec,
    ShardingRules,
    logical_to_sharding,
    logical_to_spec,
    shard_pytree_like,
    spec_for_pytree,
)
from determined_tpu_torch.parallel.ulysses import (
    make_ulysses_attention,
    ulysses_attention,
)


def _later(name: str, part: str):
    def refused(*args, **kwargs):
        raise NotImplementedError(
            f"{name} comes with ROADMAP queue 1, item 4, {part}; the port "
            "trains over data, fsdp, context and tensor"
        )

    refused.__name__ = name
    return refused


pipeline_apply = _later("pipeline_apply", "part 3 (pipeline stages)")
circular_pipeline_apply = _later("circular_pipeline_apply",
                                 "part 3 (pipeline stages)")
stack_circular_stages = _later("stack_circular_stages",
                               "part 3 (pipeline stages)")

__all__ = [
    "AXIS_NAMES",
    "MeshConfig",
    "make_mesh",
    "make_multislice_mesh",
    "batch_axes",
    "context_index",
    "data_parallel_size",
    "validate_divisibility",
    "ShardingRules",
    "DEFAULT_RULES",
    "PartitionSpec",
    "logical_to_spec",
    "logical_to_sharding",
    "spec_for_pytree",
    "shard_pytree_like",
    "ring_attention",
    "make_ring_attention",
    "zigzag_indices",
    "ulysses_attention",
    "make_ulysses_attention",
]
