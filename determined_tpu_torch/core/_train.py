"""Metric reporting off-cluster (port of ``determined_tpu/core/
_train.py``'s ``DummyTrainContext``, trimmed to what ``Trainer.fit``
calls): reports are logged and kept in ``_reported`` as (group,
steps_completed, metrics), heartbeats in ``_heartbeats``."""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Tuple

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

    def heartbeat_step(self, steps_completed: int) -> None:
        self._heartbeats.append(int(steps_completed))
