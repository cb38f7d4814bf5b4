"""Core API of the port: the trial<->platform surface that ``Trainer.fit``
calls (port of ``determined_tpu/core``).

``init()`` returns the live contexts on a cluster (``DTPU_MASTER`` set:
metrics, heartbeats, checkpoints, searcher operations and preemption
through the master's REST API) and the dummy ones off it (metrics kept in
memory, checkpoints in a local shared-filesystem directory, one searcher
operation, no preemption). A rendezvous of more than one process makes a
gang: ``torch.distributed`` joined, and the ``DistributedContext``'s
object collectives that the contexts use to agree.
"""
from determined_tpu_torch.core._checkpoint import (
    METADATA_FILE,
    CheckpointContext,
    DummyCheckpointContext,
    merge_metadata,
)
from determined_tpu_torch.core._context import Context, _dummy_init, init
from determined_tpu_torch.core._distributed import (
    DistributedContext,
    DummyDistributedContext,
)
from determined_tpu_torch.core._preempt import (
    DummyPreemptContext,
    PreemptContext,
)
from determined_tpu_torch.core._searcher import (
    DummySearcherContext,
    SearcherContext,
    SearcherOperation,
)
from determined_tpu_torch.core._train import DummyTrainContext, TrainContext

__all__ = [
    "Context",
    "init",
    "CheckpointContext",
    "DistributedContext",
    "DummyCheckpointContext",
    "DummyDistributedContext",
    "DummyPreemptContext",
    "DummySearcherContext",
    "DummyTrainContext",
    "METADATA_FILE",
    "PreemptContext",
    "SearcherContext",
    "SearcherOperation",
    "TrainContext",
    "merge_metadata",
]
