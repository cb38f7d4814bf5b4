"""core.Context: the composition of the sub-contexts, and init().

Port of ``determined_tpu/core/_context.py`` trimmed to the off-cluster
path: ``init()`` with no ``DTPU_MASTER`` in the environment returns dummy
contexts (``_dummy_init``), the official way to run trial code outside a
cluster (notebooks, tests, ``chip_smoke.py``).
"""
from __future__ import annotations

import logging
import os
from typing import Optional

from determined_tpu_torch.core._distributed import DummyDistributedContext
from determined_tpu_torch.core._preempt import DummyPreemptContext
from determined_tpu_torch.core._searcher import DummySearcherContext
from determined_tpu_torch.core._train import DummyTrainContext

logger = logging.getLogger("determined_tpu_torch.core")


class Context:
    def __init__(
        self,
        *,
        distributed: DummyDistributedContext,
        train: DummyTrainContext,
        preempt: DummyPreemptContext,
        searcher: DummySearcherContext,
    ) -> None:
        self.distributed = distributed
        self.train = train
        self.preempt = preempt
        self.searcher = searcher


def _dummy_init(*, checkpoint_storage: Optional[str] = None) -> Context:
    if checkpoint_storage is not None:
        raise NotImplementedError(
            "checkpoint storage is not ported yet (the checkpoint-"
            "interchange slice)"
        )
    return Context(
        distributed=DummyDistributedContext(),
        train=DummyTrainContext(),
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
