"""Preemption off-cluster: never preempted (port of
``determined_tpu/core/_preempt.py``'s ``DummyPreemptContext``, trimmed to
what ``Trainer.fit`` calls)."""
from __future__ import annotations


class DummyPreemptContext:
    def should_preempt(self) -> bool:
        return False
