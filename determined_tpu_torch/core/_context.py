"""core.Context: the composition of the sub-contexts, and init().

Port of ``determined_tpu/core/_context.py``. ``init()`` decides the mode
from the environment:

- on a cluster (``DTPU_MASTER`` set by the launcher, read through
  ``_info.get_cluster_info``): one master ``Session`` with a generous
  retry budget (``max_retries=12``, enough to ride out a master restart),
  and the live contexts built from ``ClusterInfo`` — metrics, progress and
  heartbeats to the trial and allocation routes, checkpoints registered
  with the master, the searcher's operation stream, the preemption
  long-poll. Checkpoints go to the cluster's ``checkpoint_storage``.
  A rendezvous of more than one process is refused by name: a
  multi-process gang comes with the multi-device slice (ROADMAP queue 1,
  item 4);
- off-cluster: dummy contexts (``_dummy_init``), the official way to run
  trial code outside a cluster (notebooks, tests, ``chip_smoke.py``):
  metrics are kept in memory, checkpoints go to ``checkpoint_storage`` or
  ``~/.dtpu/checkpoints``, the searcher hands out one operation and
  preemption never fires.

Both install the debug hooks: SIGUSR1 dumps every thread's stack to
stderr, ``DTPU_DEBUG`` turns on DEBUG logging.
"""
from __future__ import annotations

import logging
import os
from typing import Any, Optional

from determined_tpu_torch import _info
from determined_tpu_torch.common.api_session import Session
from determined_tpu_torch.core._checkpoint import (
    CheckpointContext,
    DummyCheckpointContext,
)
from determined_tpu_torch.core._distributed import DummyDistributedContext
from determined_tpu_torch.core._preempt import (
    DummyPreemptContext,
    PreemptContext,
)
from determined_tpu_torch.core._searcher import (
    DummySearcherContext,
    SearcherContext,
)
from determined_tpu_torch.core._train import DummyTrainContext, TrainContext
from determined_tpu_torch.storage import from_config as storage_from_config

logger = logging.getLogger("determined_tpu_torch.core")


class Context:
    def __init__(
        self,
        *,
        distributed: DummyDistributedContext,
        train: TrainContext,
        checkpoint: CheckpointContext,
        preempt: PreemptContext,
        searcher: SearcherContext,
        info: Optional[_info.ClusterInfo] = None,
        session: Optional[Session] = None,
    ) -> None:
        self.distributed = distributed
        self.train = train
        self.checkpoint = checkpoint
        self.preempt = preempt
        self.searcher = searcher
        #: the cluster's view of this task (trial id, config, latest
        #: checkpoint); None off-cluster.
        self.info = info
        self._session = session

    def close(self) -> None:
        self.preempt.close()
        self.distributed.close()

    def __enter__(self) -> "Context":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def _dummy_init(*, checkpoint_storage: Optional[str] = None,
                searcher_length: int = 1) -> Context:
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
        preempt=DummyPreemptContext(dist),
        searcher=DummySearcherContext(dist, length=searcher_length),
    )


def _install_debug_hooks() -> None:
    """Live-debug probes for wedged trials: SIGUSR1 dumps every thread's
    stack to stderr without killing the process (``kill -USR1 <pid>``),
    and ``DTPU_DEBUG`` sets the port's loggers to DEBUG."""
    import faulthandler
    import signal as signal_mod

    if hasattr(signal_mod, "SIGUSR1"):
        try:
            # chain=False: SIGUSR1's default disposition is terminate; the
            # probe must leave the trial running.
            faulthandler.register(
                signal_mod.SIGUSR1, all_threads=True, chain=False
            )
        except (ValueError, RuntimeError):
            pass  # non-main thread / exotic runtime: the probe is optional
    if os.environ.get("DTPU_DEBUG"):
        logging.getLogger("determined_tpu_torch").setLevel(logging.DEBUG)


def init(*, checkpoint_storage: Optional[str] = None) -> Context:
    _install_debug_hooks()
    info = _info.get_cluster_info()
    if info is None:
        logger.info("no cluster detected; core.init() in dummy (off-cluster) mode")
        return _dummy_init(checkpoint_storage=checkpoint_storage)
    rdzv = info.rendezvous
    if rdzv is not None and rdzv.num_processes > 1:
        raise NotImplementedError(
            f"core.init() for a gang of {rdzv.num_processes} processes: a "
            "multi-process gang comes with the multi-device slice (ROADMAP "
            "queue 1, item 4)"
        )

    # Generous retry budget: the task's session must ride out a master
    # restart (tens of seconds of connection errors).
    session = Session(info.master_url, token=info.session_token,
                      max_retries=12)
    distributed = DummyDistributedContext()
    storage = storage_from_config(info.checkpoint_storage, checkpoint_storage)
    trial_id = info.trial.trial_id if info.trial else 0
    run_id = info.trial.trial_run_id if info.trial else 0
    return Context(
        distributed=distributed,
        train=TrainContext(session, trial_id, run_id,
                           allocation_id=info.allocation_id,
                           rank=distributed.rank),
        checkpoint=CheckpointContext(
            distributed, storage, session=session, task_id=info.task_id,
            allocation_id=info.allocation_id, trial_id=trial_id,
        ),
        preempt=PreemptContext(session, info.allocation_id, distributed),
        searcher=SearcherContext(session, distributed, trial_id),
        info=info,
        session=session,
    )
