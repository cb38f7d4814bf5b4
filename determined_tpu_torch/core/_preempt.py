"""PreemptContext: the master's cooperative preemption signal.

Port of ``determined_tpu/core/_preempt.py``: the chief runs a daemon
thread that long-polls ``GET /api/v1/allocations/<id>/signals/preemption``
(60 s held by the master, 70 s client timeout) and latches ``preempt:
true``; the trainer asks ``should_preempt()`` at its report boundaries —
in a gang a collective: the chief's answer is broadcast, so every rank
stops at the same boundary — and the chief acknowledges the signal
(``POST .../signals/ack_preemption``) the first time it answers True.
An elastic ``resize`` directive on the same channel is refused by name:
in-place resize comes with the elastic slice (ROADMAP queue 1, item 5).

``DummyPreemptContext`` is the off-cluster one: never preempted.
"""
from __future__ import annotations

import logging
import os
import threading
from typing import Any, Optional

from determined_tpu_torch.common.api_session import Session

logger = logging.getLogger("determined_tpu_torch.core")


def refuse_resize(directive: dict) -> None:
    """An elastic resize directive from the master: refused by name."""
    raise NotImplementedError(
        f"elastic resize directive {directive!r}: an in-place gang resize "
        "comes with the elastic slice (ROADMAP queue 1, item 5)"
    )


class _PreemptionWatcher(threading.Thread):
    """Long-polls the master for the allocation's preemption signal; a
    latched signal (or resize directive) ends the watcher."""

    def __init__(self, session: Session, allocation_id: str,
                 generation: int = 0) -> None:
        super().__init__(daemon=True, name="preemption-watcher")
        self._session = session
        self._allocation_id = allocation_id
        self._generation = int(generation)
        self._should_preempt = False
        self._should_quit = False
        self.resize: Optional[dict] = None

    def run(self) -> None:
        while (
            not self._should_quit
            and not self._should_preempt
            and self.resize is None
        ):
            try:
                resp = self._session.get(
                    f"/api/v1/allocations/{self._allocation_id}"
                    "/signals/preemption",
                    params={
                        "timeout_seconds": 60,
                        "generation": self._generation,
                    },
                    timeout=70,
                )
                if resp.get("preempt"):
                    self._should_preempt = True
                if resp.get("resize"):
                    self.resize = resp["resize"]
            except Exception as e:  # noqa: BLE001 — keep polling
                logger.warning("preemption poll failed: %s", e)
                if self._should_quit:
                    return
                threading.Event().wait(5)

    @property
    def should_preempt(self) -> bool:
        return self._should_preempt

    def close(self) -> None:
        self._should_quit = True


class PreemptContext:
    def __init__(self, session: Session, allocation_id: str,
                 distributed: Any) -> None:
        self._session = session
        self._allocation_id = allocation_id
        self._dist = distributed
        self._ack_sent = False
        self._watcher: Optional[_PreemptionWatcher] = None
        if distributed.is_chief:
            self._watcher = _PreemptionWatcher(
                session, allocation_id,
                generation=int(os.environ.get("DTPU_ALLOC_GENERATION", "0")),
            )
            self._watcher.start()

    def should_preempt(self, auto_ack: bool = True,
                       resize_hint: Optional[dict] = None) -> bool:
        """Has the master asked this allocation to stop? Checked at step
        boundaries (a collective in a gang: the chief's answer is
        broadcast); the chief acknowledges the signal the first time it is
        seen (``auto_ack``)."""
        flag, directive = False, resize_hint
        if self._dist.is_chief:
            assert self._watcher is not None
            flag = self._watcher.should_preempt
            directive = self._watcher.resize or resize_hint
        if self._dist.size > 1:
            flag, chief_directive = self._dist.broadcast(
                (flag, directive) if self._dist.is_chief else None)
            directive = chief_directive or directive
        if directive is not None:
            refuse_resize(directive)
        if flag and auto_ack and self._dist.is_chief and not self._ack_sent:
            self.acknowledge_preemption_signal()
        return bool(flag)

    def acknowledge_preemption_signal(self) -> None:
        self._ack_sent = True
        self._session.post(
            f"/api/v1/allocations/{self._allocation_id}"
            "/signals/ack_preemption"
        )

    def close(self) -> None:
        if self._watcher is not None:
            self._watcher.close()


class DummyPreemptContext(PreemptContext):
    """Off-cluster: never preempted."""

    def __init__(self, distributed: Any = None) -> None:  # noqa
        self._dist = distributed

    def should_preempt(self, auto_ack: bool = True,
                       resize_hint: Optional[dict] = None) -> bool:
        return False

    def acknowledge_preemption_signal(self) -> None:
        pass

    def close(self) -> None:
        pass
