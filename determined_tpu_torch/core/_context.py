"""core.Context: the composition of the sub-contexts, and init().

Port of ``determined_tpu/core/_context.py`` trimmed to the off-cluster
path: ``init()`` with no ``DTPU_MASTER`` in the environment returns dummy
contexts (``_dummy_init``), the official way to run trial code outside a
cluster (notebooks, tests, ``chip_smoke.py``). Checkpoints go to a local
shared-filesystem directory: ``checkpoint_storage``, or
``~/.dtpu/checkpoints`` when it is not given.
"""
from __future__ import annotations

import logging
import os
from typing import Optional

from determined_tpu_torch.core._checkpoint import DummyCheckpointContext
from determined_tpu_torch.core._distributed import DummyDistributedContext
from determined_tpu_torch.core._preempt import DummyPreemptContext
from determined_tpu_torch.core._searcher import DummySearcherContext
from determined_tpu_torch.core._train import DummyTrainContext
from determined_tpu_torch.storage import from_config as storage_from_config

logger = logging.getLogger("determined_tpu_torch.core")


class Context:
    def __init__(
        self,
        *,
        distributed: DummyDistributedContext,
        train: DummyTrainContext,
        checkpoint: DummyCheckpointContext,
        preempt: DummyPreemptContext,
        searcher: DummySearcherContext,
    ) -> None:
        self.distributed = distributed
        self.train = train
        self.checkpoint = checkpoint
        self.preempt = preempt
        self.searcher = searcher
        #: the cluster's view of this task (trial id, config, latest
        #: checkpoint); None off-cluster, as in the reference.
        self.info = None


def _dummy_init(*, checkpoint_storage: Optional[str] = None) -> Context:
    dist = DummyDistributedContext()
    storage = storage_from_config(
        {"type": "shared_fs", "host_path": checkpoint_storage}
        if checkpoint_storage
        else None
    )
    return Context(
        distributed=dist,
        train=DummyTrainContext(),
        checkpoint=DummyCheckpointContext(dist, storage),
        preempt=DummyPreemptContext(),
        searcher=DummySearcherContext(),
    )


def init(*, checkpoint_storage: Optional[str] = None) -> Context:
    if os.environ.get("DTPU_MASTER") is not None:
        raise NotImplementedError(
            "core.init() on a cluster (DTPU_MASTER is set) is not ported "
            "yet: the master session, live contexts and the launch layer "
            "come with the exec slice; unset DTPU_MASTER to run off-cluster"
        )
    logger.info("no cluster detected; core.init() in dummy (off-cluster) mode")
    return _dummy_init(checkpoint_storage=checkpoint_storage)
