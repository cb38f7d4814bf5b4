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
section (``resolve_mesh``: a ``MeshConfig`` over the gang; without one,
the Trainer's default, data over the whole gang). A trial that fails on
a replica divergence (``ReplicaDivergenceError``) is reported to the
master before the exit (``_report_divergence``: ``POST
/api/v1/trials/<id>/status`` with ``{"event": "divergence", "detail":
...}``).

Refused by name: a mesh with pipeline or expert above 1 (ROADMAP queue
1, item 4, part 3) and checkpoint storage other than ``shared_fs``. Not ported: the elastic resize loop (item 5).

Launch: ``DTPU_ENTRYPOINT=pkg.module:Trial DTPU_TRIAL_ID=1 ...
python -m determined_tpu_torch.exec.harness``; under the reference's
agent, an experiment whose entrypoint is ``env
DTPU_ENTRYPOINT=pkg.module:Trial python -m
determined_tpu_torch.exec.harness``.
"""
from __future__ import annotations

import importlib
import json
import logging
import os
import sys
import tempfile
from typing import Any, Dict, Optional

from determined_tpu_torch import _info, core, storage
from determined_tpu_torch.common import logship, profiling, trace
from determined_tpu_torch.common.api_session import Session
from determined_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from determined_tpu_torch.trainer import Batch, Epoch, Trainer
from determined_tpu_torch.trainer._sentinel import ReplicaDivergenceError
from determined_tpu_torch.trainer._units import TrainUnit

logger = logging.getLogger("determined_tpu_torch.exec")


def import_entrypoint(entrypoint: str) -> Any:
    module_name, _, attr = entrypoint.partition(":")
    module = importlib.import_module(module_name)
    return getattr(module, attr)


def resolve_mesh(hparams: Dict[str, Any], cfg: Dict[str, Any],
                 device: Optional[str] = None) -> Any:
    """The mesh from hparams or config (hparams first, so a searcher can
    sweep layouts) over the gang ``core.init()`` joined, on any of the
    data, fsdp, context and tensor axes: None without one."""
    mesh_cfg = hparams.get("mesh") or cfg.get("mesh")
    if not mesh_cfg:
        return None
    return make_mesh(MeshConfig(**mesh_cfg), device=device)


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
    cfg: Dict[str, Any] = info.config
    scfg = cfg.get("searcher", {})
    trial_cls = import_entrypoint(entrypoint)
    trial = trial_cls(info.hparams)
    task_id = os.environ.get("DTPU_TASK_ID") or f"trial-{info.trial_id}"
    try:
        # Trial lifecycle span: a child of the DTPU_TRACEPARENT the launch
        # chain injected, and the ambient parent of every master call the
        # trial makes.
        with trace.span("trial.run", {"trial.id": info.trial_id,
                                      "task.id": task_id}), \
                core.init(checkpoint_storage=_checkpoint_dir(),
                          device=device) as ctx:
            mesh = resolve_mesh(info.hparams, cfg, device)
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
            )
            logger.info("trial %d rank %d entering fit (restart) on %s",
                        info.trial_id,
                        int(os.environ.get("DTPU_ALLOC_RANK", "0")),
                        trainer.device)
            trainer.fit(
                max_length=parse_unit(scfg.get("max_length")),
                validation_period=parse_unit(cfg.get("min_validation_period")),
                checkpoint_period=parse_unit(cfg.get("min_checkpoint_period")),
                report_period=parse_unit(cfg.get("scheduling_unit")) or Batch(10),
                latest_checkpoint=info.latest_checkpoint,
            )
        return 0
    except Exception as e:  # noqa: BLE001 — the trial's failure is the exit code
        logger.exception("trial failed")
        _report_divergence(cluster, info, e)
        return 1


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    sys.exit(run(os.environ["DTPU_ENTRYPOINT"]))


if __name__ == "__main__":
    main()
