"""Core API of the port, off-cluster: the trial<->platform surface that
``Trainer.fit`` calls (port of ``determined_tpu/core``).

Only the off-cluster ("dummy") contexts are ported: metrics are kept in
memory, checkpoints go to a local shared-filesystem directory, the
searcher hands out one operation, preemption never fires and there is one
process. On-cluster mode (``DTPU_MASTER`` set) comes with the exec slice
and a multi-process gang with the multi-device slice; each is refused by
name.
"""
from determined_tpu_torch.core._checkpoint import (
    METADATA_FILE,
    CheckpointContext,
    DummyCheckpointContext,
    merge_metadata,
)
from determined_tpu_torch.core._context import Context, _dummy_init, init
from determined_tpu_torch.core._distributed import DummyDistributedContext
from determined_tpu_torch.core._preempt import DummyPreemptContext
from determined_tpu_torch.core._searcher import (
    DummySearcherContext,
    SearcherOperation,
)
from determined_tpu_torch.core._train import DummyTrainContext

__all__ = [
    "Context",
    "init",
    "CheckpointContext",
    "DummyCheckpointContext",
    "DummyDistributedContext",
    "DummyPreemptContext",
    "DummySearcherContext",
    "DummyTrainContext",
    "METADATA_FILE",
    "SearcherOperation",
    "merge_metadata",
]
