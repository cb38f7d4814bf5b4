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
  A rendezvous of more than one process makes a gang (``_init_gang``, the
  counterpart of the reference's ``_maybe_init_jax_distributed``): one
  process per device, the local rank's ``cuda:<local_rank>`` (or the CPU
  when the caller passes ``device="cpu"``), ``torch.distributed`` joined
  at the chief's coordinator address with an explicit timeout — NCCL on
  the cards, gloo on the CPU, and gloo on the cards when a host's ranks
  outnumber its cards (NCCL puts no two ranks on one device; the ranks
  then share the cards round-robin) — and the ``DistributedContext`` on
  gloo groups of its own. ``close()`` leaves the
  groups on every exit path, so a failing rank does not strand its
  peers;
- off-cluster: dummy contexts (``_dummy_init``), the official way to run
  trial code outside a cluster (notebooks, tests, ``chip_smoke.py``):
  metrics are kept in memory, checkpoints go to ``checkpoint_storage`` or
  ``~/.dtpu/checkpoints``, the searcher hands out one operation and
  preemption never fires.

Both install the debug hooks: SIGUSR1 dumps every thread's stack to
stderr, ``DTPU_DEBUG`` turns on DEBUG logging.
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import Any, Optional, Union

import torch

from determined_tpu_torch import _info
from determined_tpu_torch._device import resolve_device
from determined_tpu_torch.common.api_session import Session
from determined_tpu_torch.core._checkpoint import (
    CheckpointContext,
    DummyCheckpointContext,
)
from determined_tpu_torch.core._distributed import (
    DEFAULT_TIMEOUT_S,
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
)
from determined_tpu_torch.core._train import DummyTrainContext, TrainContext
from determined_tpu_torch.storage import from_config as storage_from_config

logger = logging.getLogger("determined_tpu_torch.core")


class Context:
    def __init__(
        self,
        *,
        distributed: DistributedContext,
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


def _dummy_init(*, distributed: Optional[DistributedContext] = None,
                checkpoint_storage: Optional[str] = None,
                searcher_length: int = 1) -> Context:
    dist = distributed or DummyDistributedContext()
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


def _init_gang(rdzv: _info.RendezvousInfo,
               device: Optional[Union[str, torch.device]]
               ) -> DistributedContext:
    """Join the gang of the rendezvous table: this process drives
    ``cuda:<local_rank>`` over NCCL, or the CPU over gloo when the caller
    asked for it; the coordinator (the chief's address) hosts the store."""
    import torch.distributed as dist

    dev = resolve_device(device)
    kwargs: dict = {}
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        mine = rdzv.container_addrs[rdzv.container_rank]
        if rdzv.container_addrs.count(mine) > cards:
            torch.cuda.set_device(rdzv.local_rank % cards)
            backend = "gloo"
        else:
            torch.cuda.set_device(rdzv.local_rank)
            backend = "nccl"
            kwargs["device_id"] = torch.device("cuda", rdzv.local_rank)
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"a gang runs on CUDA or the CPU, not {dev}")
    dist.init_process_group(
        backend, init_method=f"tcp://{rdzv.coordinator_address}",
        rank=rdzv.process_index, world_size=rdzv.num_processes,
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S), **kwargs,
    )
    try:
        return DistributedContext(rank=rdzv.process_index,
                                  size=rdzv.num_processes,
                                  own_default_group=True)
    except BaseException:
        dist.destroy_process_group()
        raise


def init(*, distributed: Optional[DistributedContext] = None,
         checkpoint_storage: Optional[str] = None,
         device: Optional[Union[str, torch.device]] = None) -> Context:
    """The contexts of this task: on a cluster the live ones (a gang's
    when the rendezvous table has more than one process; `device` picks
    its backend, CUDA unless ``"cpu"``), off it the dummy ones
    (`distributed` is the caller's gang, if any)."""
    _install_debug_hooks()
    info = _info.get_cluster_info()
    if info is None:
        logger.info("no cluster detected; core.init() in dummy (off-cluster) mode")
        return _dummy_init(distributed=distributed,
                           checkpoint_storage=checkpoint_storage)

    # Generous retry budget: the task's session must ride out a master
    # restart (tens of seconds of connection errors).
    session = Session(info.master_url, token=info.session_token,
                      max_retries=12)
    if distributed is None:
        rdzv = info.rendezvous
        if rdzv is not None and rdzv.num_processes > 1:
            distributed = _init_gang(rdzv, device)
        else:
            distributed = DummyDistributedContext()
    try:
        return _cluster_context(info, session, distributed,
                                checkpoint_storage)
    except BaseException:
        distributed.close()
        raise


def _cluster_context(info: _info.ClusterInfo, session: Session,
                     distributed: DistributedContext,
                     checkpoint_storage: Optional[str]) -> Context:
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
