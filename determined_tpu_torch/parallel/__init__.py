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
with the collectives of ``tensor.py``; on a ``pipeline`` axis its stages
run the reference's schedules (``pipeline.py``: GPipe, circular, 1F1B);
on an ``expert`` axis each rank holds its experts and routes every token
(``experts.py``).
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


from determined_tpu_torch.parallel.pipeline import (
    circular_pipeline_apply,
    one_f_one_b_grads,
    one_f_one_b_stash_size,
    pipeline_apply,
    stack_circular_stages,
)

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
    "pipeline_apply",
    "circular_pipeline_apply",
    "one_f_one_b_grads",
    "one_f_one_b_stash_size",
    "stack_circular_stages",
]
