"""PreemptContext: the master's cooperative preemption signal.

Port of ``determined_tpu/core/_preempt.py``: the chief runs a daemon
thread that long-polls ``GET /api/v1/allocations/<id>/signals/preemption``
(60 s held by the master, 70 s client timeout) and latches ``preempt:
true``; the trainer asks ``should_preempt()`` at its report boundaries —
in a gang a collective: the chief's answer is broadcast, so every rank
stops at the same boundary — and the chief acknowledges the signal
(``POST .../signals/ack_preemption``) the first time it answers True.

The same channel carries the elastic resize: the poll sends this
process's rendezvous generation, and the master answers early with a
``resize`` directive once a resize leaves it behind. The watcher latches
it; ``should_preempt(resize_hint=)`` folds it (or the boundary beat's) into
the chief's broadcast, and ``take_resize`` hands it to the trainer.
A worker whose hint drops the chief acts on it alone (no broadcast is
coming), and a broadcast that fails because a peer died falls back to
asking the master (``directive_after_failure``): only the master's
directive turns a failure into a resize.

``DummyPreemptContext`` is the off-cluster one: never preempted.
"""
from __future__ import annotations

import logging
import os
import threading
from typing import Any, Optional

from determined_tpu_torch.common.api_session import Session

logger = logging.getLogger("determined_tpu_torch.core")


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
        self._generation = int(os.environ.get("DTPU_ALLOC_GENERATION", "0"))
        #: the directive latched by the last should_preempt round; the
        #: trainer takes it (take_resize) at the same boundary
        self._pending_resize: Optional[dict] = None
        #: how long a rank whose collective failed waits on the master
        #: for a directive before the failure stands (seconds)
        self._resize_wait_s = float(
            os.environ.get("DTPU_ELASTIC_CTL_TIMEOUT_S", "20"))
        self._watcher: Optional[_PreemptionWatcher] = None
        if distributed.is_chief:
            self._watcher = _PreemptionWatcher(
                session, allocation_id, generation=self._generation)
            self._watcher.start()

    def should_preempt(self, auto_ack: bool = True,
                       resize_hint: Optional[dict] = None) -> bool:
        """Has the master asked this allocation to stop? Checked at step
        boundaries (a collective in a gang: the chief's answer is
        broadcast); the chief acknowledges the signal the first time it is
        seen (``auto_ack``). A resize directive (the watcher's, or the
        caller's `resize_hint`, the boundary beat's answer) rides the same
        broadcast; take it with ``take_resize``."""
        directive: Optional[dict] = None
        flag = False
        if self._dist.is_chief:
            assert self._watcher is not None
            flag = self._watcher.should_preempt
            directive = self._watcher.resize or resize_hint
        if self._dist.size > 1:
            if (not self._dist.is_chief and resize_hint is not None
                    and not self._chief_survives(resize_hint)):
                # The master dropped the chief: no broadcast is coming.
                flag, directive = False, resize_hint
            else:
                try:
                    flag, directive = self._dist.broadcast(
                        (flag, directive) if self._dist.is_chief else None)
                except RuntimeError as e:
                    flag, directive = False, self.directive_after_failure(e)
                    if directive is None:
                        raise
        elif directive is None:
            directive = resize_hint
        self._pending_resize = directive
        if flag and auto_ack and self._dist.is_chief and not self._ack_sent:
            self.acknowledge_preemption_signal()
        return bool(flag)

    @staticmethod
    def _chief_survives(directive: dict) -> bool:
        return "0" in (directive.get("rank_map") or {})

    def directive_after_failure(self, error: BaseException
                                ) -> Optional[dict]:
        """A collective of the gang failed (a peer died): the master's
        resize directive for this process's generation, long-polled for
        up to ``DTPU_ELASTIC_CTL_TIMEOUT_S`` seconds (the master answers
        as soon as it resizes), or None."""
        logger.warning("a collective of the gang failed (%s); asking the "
                       "master for a resize directive", error)
        try:
            resp = self._session.get(
                f"/api/v1/allocations/{self._allocation_id}"
                "/signals/preemption",
                params={"timeout_seconds": self._resize_wait_s,
                        "generation": self._generation},
                timeout=self._resize_wait_s + 10,
            )
        except Exception as e:  # noqa: BLE001 — the failure stands
            logger.warning("resize poll after the failure failed: %s", e)
            return None
        return (resp or {}).get("resize")

    def take_resize(self) -> Optional[dict]:
        """Pop the directive latched by the last should_preempt round."""
        directive, self._pending_resize = self._pending_resize, None
        return directive

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

    def take_resize(self) -> Optional[dict]:
        return None

    def directive_after_failure(self, error: BaseException
                                ) -> Optional[dict]:
        return None

    def acknowledge_preemption_signal(self) -> None:
        pass

    def close(self) -> None:
        pass
