"""Metric reporting off-cluster (port of ``determined_tpu/core/
_train.py``'s ``DummyTrainContext``): reports are logged and kept in
``_reported`` as (group, steps_completed, metrics), heartbeats in
``_heartbeats``. ``report_metrics(group, ...)`` carries the ``profiling``
group (the timeline and the profiler agent); there is no master, so no
profile capture is ever pending and no best validation is known."""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger("determined_tpu_torch.core")


class DummyTrainContext:
    def __init__(self) -> None:
        self._reported: List[Tuple[str, int, Dict[str, Any]]] = []
        self._heartbeats: List[int] = []

    def _report(self, group: str, steps_completed: int,
                metrics: Dict[str, Any]) -> None:
        self._reported.append((group, steps_completed, metrics))
        logger.info("[dummy] %s metrics @%d: %s", group, steps_completed,
                    metrics)

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
        logger.info("[dummy] progress: %.3f", progress)

    def heartbeat_step(self, steps_completed: int) -> None:
        self._heartbeats.append(int(steps_completed))

    def take_profile_capture(self) -> Optional[Dict[str, Any]]:
        return None

    def set_status(self, status: str) -> None:
        logger.info("[dummy] status: %s", status)

    def get_experiment_best_validation(self) -> Optional[float]:
        return None
