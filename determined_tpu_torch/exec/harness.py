"""Trial harness, off the cluster: entrypoint class → core.init() →
Trainer.fit (port of ``determined_tpu/exec/harness.py``).

Imports the trial class named by the entrypoint ("pkg.module:TrialClass"),
builds the Trainer from the experiment config's searcher / period /
observability / health sections, and trains to the searcher's length.
Exit code 0 on a clean finish; 1, with the traceback logged as "trial
failed", when the trial raises.

The trial comes from the same ``DTPU_*`` variables that
``ClusterInfo.to_env()`` writes (``_info.TrialInfo.from_env``), without
``DTPU_MASTER``, and runs against the off-cluster core contexts — the
path ``core.init()`` takes without a master, reached through the harness.
So the searcher is one operation of ``searcher.max_length`` (the length a
``single`` search gives its one trial; one batch without it), and
checkpoints go to the ``shared_fs`` directory of
``DTPU_CHECKPOINT_STORAGE``.

The device follows ``DTPU_JAX_PLATFORM`` (the variable the master sets
from ``environment.jax_platform``): ``cpu`` runs the plain PyTorch path
on the CPU; unset runs on the card (no card: ``CudaUnavailableError``,
exit 1).

Refused by name: ``DTPU_MASTER`` (the master session, the trial spans and
the on-cluster contexts come with the exec slice on the cluster, ROADMAP
queue 1, item 3), the profile and log shippers (``DTPU_PROFILE=1``,
``DTPU_LOG_SHIP=1``; item 3), a device mesh (item 4) and checkpoint
storage other than ``shared_fs``. Not ported: the elastic resize loop
(items 3 and 5) and the divergence report to the master (item 4).

Launch: ``DTPU_ENTRYPOINT=pkg.module:Trial DTPU_TRIAL_ID=1 ...
python -m determined_tpu_torch.exec.harness``.
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
from determined_tpu_torch.trainer import Batch, Epoch, Trainer
from determined_tpu_torch.trainer._units import TrainUnit

logger = logging.getLogger("determined_tpu_torch.exec")


def import_entrypoint(entrypoint: str) -> Any:
    module_name, _, attr = entrypoint.partition(":")
    module = importlib.import_module(module_name)
    return getattr(module, attr)


def resolve_mesh(hparams: Dict[str, Any], cfg: Dict[str, Any]) -> None:
    """The mesh from hparams or config (hparams first, so a searcher can
    sweep layouts): None without one; a mesh is refused by name until the
    multi-device slice."""
    mesh_cfg = hparams.get("mesh") or cfg.get("mesh")
    if not mesh_cfg:
        return None
    raise NotImplementedError(
        f"mesh {mesh_cfg!r}: a device mesh comes with the multi-device "
        "slice (ROADMAP queue 1, item 4); the harness runs on one device"
    )


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


def _refuse_cluster() -> None:
    if os.environ.get("DTPU_MASTER") is not None:
        raise NotImplementedError(
            "the harness on a cluster (DTPU_MASTER is set) is not ported "
            "yet: the master session, the trial spans and the on-cluster "
            "contexts come with the exec slice on the cluster (ROADMAP "
            "queue 1, item 3); unset DTPU_MASTER to run off the cluster"
        )
    for var, plane in (("DTPU_PROFILE", "continuous-profiling"),
                       ("DTPU_LOG_SHIP", "structured log")):
        if os.environ.get(var) == "1":
            raise NotImplementedError(
                f"{var}=1: the {plane} shipper sends to the master and "
                "comes with the exec slice on the cluster (ROADMAP queue "
                "1, item 3)"
            )


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


def run(entrypoint: str) -> int:
    _refuse_cluster()
    info = _info.TrialInfo.from_env()
    if info is None:
        raise RuntimeError("harness needs a trial env (DTPU_TRIAL_ID is not set)")
    device = _device()
    cfg: Dict[str, Any] = info.config
    scfg = cfg.get("searcher", {})
    trial_cls = import_entrypoint(entrypoint)
    trial = trial_cls(info.hparams)
    task_id = os.environ.get("DTPU_TASK_ID") or f"trial-{info.trial_id}"
    try:
        ctx = core.init(checkpoint_storage=_checkpoint_dir())
        mesh = resolve_mesh(info.hparams, cfg)
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
                    info.trial_id, int(os.environ.get("DTPU_ALLOC_RANK", "0")),
                    trainer.device)
        trainer.fit(
            max_length=parse_unit(scfg.get("max_length")),
            validation_period=parse_unit(cfg.get("min_validation_period")),
            checkpoint_period=parse_unit(cfg.get("min_checkpoint_period")),
            report_period=parse_unit(cfg.get("scheduling_unit")) or Batch(10),
            latest_checkpoint=info.latest_checkpoint,
        )
        return 0
    except Exception:  # noqa: BLE001 — the trial's failure is the exit code
        logger.exception("trial failed")
        return 1


def main() -> None:
    logging.basicConfig(level=logging.INFO)
    sys.exit(run(os.environ["DTPU_ENTRYPOINT"]))


if __name__ == "__main__":
    main()
