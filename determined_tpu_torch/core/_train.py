"""TrainContext: reporting metrics, progress and heartbeats to the master.

Port of ``determined_tpu/core/_train.py``: metrics go to ``POST
/api/v1/trials/<id>/metrics`` (group, steps, trial run id, report time),
progress and status to their trial routes, and the heartbeat to ``POST
/api/v1/allocations/<id>/progress``, whose response may carry an
operator's ``profile_capture`` directive (latched, popped by the trainer
at its report boundary through ``take_profile_capture``) or an elastic
``resize`` directive (returned; the trainer folds it into the boundary's
preemption broadcast and leaves ``fit`` through ``ElasticResizeExit``).

``DummyTrainContext`` is the off-cluster one: reports are logged and kept
in ``_reported`` as (group, steps_completed, metrics), heartbeats in
``_heartbeats``; no capture is ever pending and no best validation is
known.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from determined_tpu_torch.common.api_session import Session

logger = logging.getLogger("determined_tpu_torch.core")


class TrainContext:
    def __init__(
        self,
        session: Session,
        trial_id: int,
        run_id: int = 0,
        allocation_id: str = "",
        rank: int = 0,
    ) -> None:
        self._session = session
        self._trial_id = trial_id
        self._run_id = run_id
        self._allocation_id = allocation_id
        self._rank = rank
        self._heartbeat_warned = False
        #: capture directive latched off a heartbeat response; the trainer
        #: pops it at its report boundary via take_profile_capture().
        self._pending_capture: Optional[Dict[str, Any]] = None

    def _report(self, group: str, steps_completed: int,
                metrics: Dict[str, Any]) -> None:
        self._session.post(
            f"/api/v1/trials/{self._trial_id}/metrics",
            json_body={
                "group": group,
                "steps_completed": steps_completed,
                "trial_run_id": self._run_id,
                "metrics": metrics,
                "report_time": time.time(),
            },
        )

    def report_training_metrics(self, steps_completed: int,
                                metrics: Dict[str, Any]) -> None:
        self._report("training", steps_completed, metrics)

    def report_validation_metrics(self, steps_completed: int,
                                  metrics: Dict[str, Any]) -> None:
        self._report("validation", steps_completed, metrics)

    def report_metrics(self, group: str, steps_completed: int,
                       metrics: Dict[str, Any]) -> None:
        self._report(group, steps_completed, metrics)

    def report_progress(self, progress: float) -> None:
        self._session.post(
            f"/api/v1/trials/{self._trial_id}/progress",
            json_body={"progress": float(progress)},
        )

    def heartbeat_step(self, steps_completed: int) -> Optional[Dict[str, Any]]:
        """Gang-progress beat to the master's stall watchdog. Advisory: a
        failed beat never fails the step loop. Returns a pending resize
        directive, else None."""
        if not self._allocation_id:
            return None
        try:
            resp = self._session.post(
                f"/api/v1/allocations/{self._allocation_id}/progress",
                json_body={
                    "rank": int(self._rank),
                    "step": int(steps_completed),
                    "generation": int(
                        os.environ.get("DTPU_ALLOC_GENERATION", "0")
                    ),
                },
            )
            self._heartbeat_warned = False
            if isinstance(resp, dict) and resp.get("profile_capture"):
                # One-shot latch, popped by the trainer at its next boundary.
                self._pending_capture = resp["profile_capture"]
            if isinstance(resp, dict) and resp.get("resize"):
                return resp["resize"]
        except Exception as e:  # noqa: BLE001 — advisory beat, never fatal
            if not self._heartbeat_warned:
                self._heartbeat_warned = True
                logger.warning(
                    "progress heartbeat failed at step %d: %s (suppressing "
                    "until one succeeds)", steps_completed, e,
                )
        return None

    def take_profile_capture(self) -> Optional[Dict[str, Any]]:
        """Pop the latched profile-capture directive, if any (one-shot)."""
        cap, self._pending_capture = self._pending_capture, None
        return cap

    def set_status(self, status: str) -> None:
        self._session.post(
            f"/api/v1/trials/{self._trial_id}/status",
            json_body={"status": status},
        )

    def get_experiment_best_validation(self) -> Optional[float]:
        resp = self._session.get(
            f"/api/v1/trials/{self._trial_id}/best_validation")
        return resp.get("best")


class DummyTrainContext(TrainContext):
    """Off-cluster mode: log metrics instead of reporting them."""

    def __init__(self) -> None:  # noqa: super not called on purpose
        self._reported: List[Tuple[str, int, Dict[str, Any]]] = []
        self._heartbeats: List[int] = []

    def _report(self, group: str, steps_completed: int,
                metrics: Dict[str, Any]) -> None:
        self._reported.append((group, steps_completed, metrics))
        logger.info("[dummy] %s metrics @%d: %s", group, steps_completed,
                    metrics)

    def report_progress(self, progress: float) -> None:
        logger.info("[dummy] progress: %.3f", progress)

    def heartbeat_step(self, steps_completed: int) -> Optional[Dict[str, Any]]:
        self._heartbeats.append(int(steps_completed))
        return None

    def take_profile_capture(self) -> Optional[Dict[str, Any]]:
        return None

    def set_status(self, status: str) -> None:
        logger.info("[dummy] status: %s", status)

    def get_experiment_best_validation(self) -> Optional[float]:
        return None
