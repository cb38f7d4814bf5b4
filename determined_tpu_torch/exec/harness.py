"""Trial harness: entrypoint class → core.init() → Trainer.fit (port of
``determined_tpu/exec/harness.py``).

Imports the trial class named by the entrypoint ("pkg.module:TrialClass"),
builds the Trainer from the experiment config's searcher / period /
observability / health sections, and trains until the searcher closes
the trial. Exit code 0 on a clean finish or a graceful preemption (the
trial checkpoints, acknowledges and exits); 1, with the traceback logged
as "trial failed", when the trial raises.

The trial comes from the ``DTPU_*`` variables that ``ClusterInfo.to_env()``
writes. With ``DTPU_MASTER`` set it runs on ``core.init()``'s cluster
contexts: the master's searcher operations, metrics, heartbeats,
registered checkpoints and preemption, inside the ``trial.run`` span (a
child of ``DTPU_TRACEPARENT``), with the continuous profiler
(``DTPU_PROFILE=1``) and the structured log shipper (``DTPU_LOG_SHIP=1``)
started for the identity ``trial:<id>.r<rank>`` and flushed, with the span
shipper, on the way out. Without it the path is the off-cluster one: one
searcher operation of ``searcher.max_length`` (one batch without it) and
checkpoints in the ``shared_fs`` directory of ``DTPU_CHECKPOINT_STORAGE``.

The device follows ``DTPU_JAX_PLATFORM`` (the variable the master sets
from ``environment.jax_platform``): ``cpu`` runs the plain PyTorch path
on the CPU; unset runs on the card (no card: ``CudaUnavailableError``,
exit 1).

A gang (``DTPU_RENDEZVOUS_INFO`` of more than one process, as
``prep_and_run`` writes it) joins ``torch.distributed`` in ``core.init()``
and trains on the device mesh of the hparams' or the config's ``mesh``
section (``resolve_mesh``: a ``MeshConfig`` over the gang, a process
alone joining a group of one for it; without one, the Trainer's default,
data over the whole gang).

The elastic resize loop: a resize directive leaves ``Trainer.fit`` by
``ElasticResizeExit``. A rank the directive dropped exits 0. Any other
tears the old gang down (the contexts' groups, the mesh's and the
default group: ``_teardown_groups``), re-enters the rendezvous under the
new generation (``prep_and_run.apply_resize``), resets the cluster-info
cache and builds ``core.init()``, the mesh (refitted to the new world by
``MeshConfig.refit`` when the configured one no longer fits) and the
Trainer anew in the same process, which restores the gang's last
verified checkpoint onto the new layout with ``resume_event="resize"``.
The default group may change backend on the way (gloo for two ranks on
one card, NCCL for one). A trial that fails on
a replica divergence (``ReplicaDivergenceError``) is reported to the
master before the exit (``_report_divergence``: ``POST
/api/v1/trials/<id>/status`` with ``{"event": "divergence", "detail":
...}``).

Refused by name: a mesh the port leaves out (an expert axis beside a
pipeline axis above 1, as the reference) and checkpoint storage other
than ``shared_fs``.

Launch: ``DTPU_ENTRYPOINT=pkg.module:Trial DTPU_TRIAL_ID=1 ...
python -m determined_tpu_torch.exec.harness``; under the reference's
agent, an experiment whose entrypoint is ``env
DTPU_ENTRYPOINT=pkg.module:Trial python -m
determined_tpu_torch.exec.harness``.
"""
from __future__ import annotations

import gc
import importlib
import json
import logging
import os
import sys
import tempfile
from typing import Any, Dict, Optional

import torch

from determined_tpu_torch import _info, core, storage
from determined_tpu_torch.common import logship, profiling, trace
from determined_tpu_torch.common.api_session import Session
from determined_tpu_torch.parallel.mesh import (
    MeshConfig,
    make_mesh,
    refuse_later_axes,
)
from determined_tpu_torch.trainer import (
    Batch,
    ElasticResizeExit,
    Epoch,
    Trainer,
)
from determined_tpu_torch.trainer._sentinel import ReplicaDivergenceError
from determined_tpu_torch.trainer._units import TrainUnit

logger = logging.getLogger("determined_tpu_torch.exec")


def import_entrypoint(entrypoint: str) -> Any:
    module_name, _, attr = entrypoint.partition(":")
    module = importlib.import_module(module_name)
    return getattr(module, attr)


def resolve_mesh(hparams: Dict[str, Any], cfg: Dict[str, Any],
                 device: Optional[str] = None, elastic: bool = False) -> Any:
    """The mesh from hparams or config (hparams first, so a searcher can
    sweep layouts) over the gang ``core.init()`` joined, on the
    reference's six axes: None without one. A process
    alone joins a group of one (``_join_alone``).

    `elastic`: the gang was resized, so the configured layout may no
    longer fit the world; it is refitted (``MeshConfig.refit``: the
    model-parallel degrees kept, data and fsdp absorb the change)."""
    import torch.distributed as dist

    mesh_cfg = hparams.get("mesh") or cfg.get("mesh")
    if not mesh_cfg:
        return None
    config = MeshConfig(**mesh_cfg)
    refuse_later_axes(config)
    _join_alone(device)
    if elastic:
        world = dist.get_world_size()
        try:
            config.resolve(world)
        except ValueError:
            refitted = config.refit(world)
            logger.warning(
                "elastic resize: configured mesh %s does not fit %d "
                "process(es); refitted to %s", mesh_cfg, world, refitted)
            config = refitted
    return make_mesh(config, device=device)


def _join_alone(device: Optional[str]) -> None:
    """A process with no gang joins a group of one (NCCL on the card,
    gloo on the CPU), so that it has a mesh; ``_teardown_groups`` leaves
    it."""
    import torch.distributed as dist

    global _joined_alone
    if dist.is_initialized():
        return
    if device == "cpu":
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dev = torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1, device_id=dev)
    _joined_alone = True


#: whether this process joined its group of one (``_join_alone``)
_joined_alone = False


def _teardown_groups(everything: bool = False) -> None:
    """Leave the group of one this process joined, or, `everything`
    (after a resize), every process group it is still in: the default
    one with the rest (the mesh's, any a context left)."""
    import torch.distributed as dist

    global _joined_alone
    if (everything or _joined_alone) and dist.is_initialized():
        dist.destroy_process_group()
    _joined_alone = False


def parse_unit(spec: Any) -> Optional[TrainUnit]:
    """expconf-style length: {"batches": N} | {"epochs": N} | int (batches)."""
    if spec is None:
        return None
    if isinstance(spec, int):
        return Batch(spec)
    if "batches" in spec:
        return Batch(int(spec["batches"]))
    if "epochs" in spec:
        return Epoch(int(spec["epochs"]))
    raise ValueError(f"bad train-unit spec {spec!r}")


def _device() -> Optional[str]:
    """``DTPU_JAX_PLATFORM`` → the Trainer's device: "cpu", or None (the
    card)."""
    plat = os.environ.get("DTPU_JAX_PLATFORM")
    if not plat:
        return None
    if plat == "cpu":
        return "cpu"
    raise ValueError(
        f"DTPU_JAX_PLATFORM={plat!r}: the port runs on the card (unset) "
        "or on the CPU ('cpu')"
    )


def _checkpoint_dir() -> Optional[str]:
    """The ``shared_fs`` directory of ``DTPU_CHECKPOINT_STORAGE`` (None:
    core.init's default)."""
    raw = os.environ.get("DTPU_CHECKPOINT_STORAGE")
    if not raw:
        return None
    config = json.loads(raw)
    if config.get("type", "shared_fs") != "shared_fs":
        storage.from_config(config)  # refuses every other type
    return config.get("host_path")


def _report_divergence(cluster: Optional[_info.ClusterInfo],
                       info: _info.TrialInfo, exc: BaseException) -> None:
    """Name a replica-divergence failure to the master on the way down
    (the exit report carries only the exit code). Best effort: a master
    that is gone does not change the exit."""
    if not isinstance(exc, ReplicaDivergenceError) or cluster is None:
        return
    try:
        Session(cluster.master_url, token=cluster.session_token).post(
            f"/api/v1/trials/{info.trial_id}/status",
            json_body={"event": "divergence", "detail": str(exc)[:500]},
        )
    except Exception:  # noqa: BLE001 — reporting must not mask the exit
        logger.warning("could not report divergence to the master",
                       exc_info=True)


def run(entrypoint: str) -> int:
    _info.reset_cluster_info_cache()
    cluster = _info.get_cluster_info()
    info = cluster.trial if cluster is not None else _info.TrialInfo.from_env()
    if info is None:
        raise RuntimeError("harness needs a trial env (DTPU_TRIAL_ID is not set)")
    device = _device()
    # The profiling and structured-log planes, when the master enabled
    # them in the task env; both resolve no destination off the cluster.
    rank = int(os.environ.get("DTPU_ALLOC_RANK", "0"))
    target = f"trial:{info.trial_id}.r{rank}"
    master_url = cluster.master_url if cluster is not None else None
    token = cluster.session_token if cluster is not None else ""
    profiling.maybe_start_from_env(target=target, master_url=master_url,
                                   token=token)
    logship.maybe_start_from_env(
        target=target, master_url=master_url, token=token,
        labels={"experiment": str(info.experiment_id),
                "trial": str(info.trial_id), "rank": str(rank),
                "task": str(cluster.task_id if cluster else "")},
    )
    try:
        return _run(entrypoint, cluster, info, device)
    finally:
        # Ship the tail now: trial.run must reach the master's trace store
        # before this short-lived process exits (atexit is the backstop).
        trace.flush_shipper()
        profiling.flush_profiler()
        logship.flush_shipping()


def _run(entrypoint: str, cluster: Optional[_info.ClusterInfo],
         info: _info.TrialInfo, device: Optional[str]) -> int:
    """The resize loop: one leg a gang, each a fit; a resize rebuilds
    everything in this process and resumes from the gang's last verified
    checkpoint."""
    from determined_tpu_torch.exec import prep_and_run

    resume_ckpt: Optional[str] = None
    resume_event = "restart"
    while True:
        try:
            _fit(entrypoint, info, device, resume_ckpt, resume_event)
            return 0
        except ElasticResizeExit as rz:
            directive, dropped = rz.directive, rz.dropped
            resume_ckpt = rz.restore_from
        except Exception as e:  # noqa: BLE001 — the trial's failure is the exit code
            logger.exception("trial failed")
            _report_divergence(cluster, info, e)
            return 1
        finally:
            _teardown_groups()
        _teardown_groups(everything=True)
        if dropped:
            logger.info("elastic resize dropped this rank (%s); exiting "
                        "cleanly", directive.get("reason", ""))
            return 0
        # the old leg's trainer and state go before the new one is built
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        master_url = cluster.master_url if cluster is not None else ""
        try:
            if not prep_and_run.apply_resize(master_url, directive):
                return 0
        except Exception:  # noqa: BLE001 — a failed re-entry fails the rank
            logger.exception("trial failed")
            return 1
        _info.reset_cluster_info_cache()
        cluster = _info.get_cluster_info()
        if cluster is not None and cluster.trial is not None:
            info = cluster.trial
        resume_event = "resize"


def _fit(entrypoint: str, info: _info.TrialInfo, device: Optional[str],
         resume_ckpt: Optional[str], resume_event: str) -> None:
    """One leg: core.init() → the mesh → the Trainer → fit."""
    cfg: Dict[str, Any] = info.config
    scfg = cfg.get("searcher", {})
    trial_cls = import_entrypoint(entrypoint)
    trial = trial_cls(info.hparams)
    task_id = os.environ.get("DTPU_TASK_ID") or f"trial-{info.trial_id}"
    # any generation past 0 is an elastic leg (a newcomer to a resized
    # gang too): the configured mesh may not fit it
    elastic = (resume_event == "resize"
               or int(os.environ.get("DTPU_ALLOC_GENERATION", "0")) > 0)
    # Trial lifecycle span: a child of the DTPU_TRACEPARENT the launch
    # chain injected, and the ambient parent of every master call the
    # trial makes.
    with trace.span("trial.run", {"trial.id": info.trial_id,
                                  "task.id": task_id}), \
            core.init(checkpoint_storage=_checkpoint_dir(),
                      device=device) as ctx:
        mesh = resolve_mesh(info.hparams, cfg, device, elastic=elastic)
        tb_dir = None
        if cfg.get("tensorboard", True):
            tb_dir = os.path.join(tempfile.gettempdir(), f"dtpu-tb-{task_id}")
        trainer = Trainer(
            trial,
            ctx,
            device=device,
            mesh=mesh,
            seed=info.trial_seed,
            searcher_metric=scfg.get("metric", "loss"),
            smaller_is_better=bool(scfg.get("smaller_is_better", True)),
            profiling=bool(cfg.get("profiling", {}).get("enabled", False)),
            tensorboard_dir=tb_dir,
            health=cfg.get("health"),
            resume_event=resume_event,
        )
        logger.info("trial %d rank %d entering fit (%s) on %s",
                    info.trial_id,
                    int(os.environ.get("DTPU_ALLOC_RANK", "0")),
                    resume_event, trainer.device)
        trainer.fit(
            max_length=parse_unit(scfg.get("max_length")),
            validation_period=parse_unit(cfg.get("min_validation_period")),
            checkpoint_period=parse_unit(cfg.get("min_checkpoint_period")),
            report_period=parse_unit(cfg.get("scheduling_unit")) or Batch(10),
            latest_checkpoint=resume_ckpt or info.latest_checkpoint,
        )


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    sys.exit(run(os.environ["DTPU_ENTRYPOINT"]))


if __name__ == "__main__":
    main()
