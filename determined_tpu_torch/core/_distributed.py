"""The process gang of the port: one process (port of
``determined_tpu/core/_distributed.py``'s ``DummyDistributedContext``,
trimmed to what ``Trainer.fit`` reads). A multi-process gang comes with
the multi-device slice."""
from __future__ import annotations


class DummyDistributedContext:
    """The chief of a gang of one."""

    @property
    def is_chief(self) -> bool:
        return True

    @property
    def size(self) -> int:
        return 1
