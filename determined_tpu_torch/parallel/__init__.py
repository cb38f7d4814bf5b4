"""Parallelism layer of the port: device meshes and logical-axis shardings.

Port of ``determined_tpu/parallel``. The reference's data plane is GSPMD
over a ``jax.sharding.Mesh``; here it is one process per device, joined by
``torch.distributed``, with a ``DeviceMesh`` over the reference's six
axes and DTensor placements from the same logical-axis rule table. The
Trainer shards parameters and optimizer state over ``fsdp`` and splits
batches over ``("data", "fsdp")`` (``trainer/_trainer.py``).

Not ported yet, and refused by name: ring and Ulysses attention (the
context axis; ROADMAP queue 1, item 4, part 2) and the pipeline schedules
(item 4, part 3).
"""
from determined_tpu_torch.parallel.mesh import (
    AXIS_NAMES,
    MeshConfig,
    batch_axes,
    data_parallel_size,
    make_mesh,
    make_multislice_mesh,
    validate_divisibility,
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


def _later(name: str, part: str):
    def refused(*args, **kwargs):
        raise NotImplementedError(
            f"{name} comes with ROADMAP queue 1, item 4, {part}; this slice "
            "trains over data and fsdp"
        )

    refused.__name__ = name
    return refused


ring_attention = _later("ring_attention", "part 2 (the context axis)")
ulysses_attention = _later("ulysses_attention", "part 2 (the context axis)")
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
    "data_parallel_size",
    "validate_divisibility",
    "ShardingRules",
    "DEFAULT_RULES",
    "PartitionSpec",
    "logical_to_spec",
    "logical_to_sharding",
    "spec_for_pytree",
    "shard_pytree_like",
]
