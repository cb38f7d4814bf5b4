"""The process gang of the port: one process (port of
``determined_tpu/core/_distributed.py``'s ``DummyDistributedContext``,
trimmed to what the trainer and the core contexts read). A multi-process
gang comes with the multi-device slice (ROADMAP queue 1, item 4)."""
from __future__ import annotations


class DummyDistributedContext:
    """The chief of a gang of one."""

    rank = 0
    size = 1

    @property
    def is_chief(self) -> bool:
        return True

    def close(self) -> None:
        pass
