"""The retry policy of the port's storage transfers.

A copy of ``determined_tpu/common/resilience.py``'s ``RetryPolicy`` and
``STORAGE_RETRY``: exponential backoff with **deterministic jitter** (a
sha256 of ``(key, attempt)``, so tests see reproducible timing), attempt
and deadline caps, and a retryable-exception predicate. Left out until
their slices land: the circuit breakers and the HTTP ``Retry-After``
pacing (the master session, exec slice) and the ``dtpu_retries_total``
counter (the metrics plane, ``ROADMAP.md`` queue 1, item 5).
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple, Type

from determined_tpu_torch.common.faults import InjectedFault

# Transient-infrastructure default: connection resets, timeouts, filesystem
# hiccups, and injected faults.
DEFAULT_RETRYABLE: Tuple[Type[BaseException], ...] = (
    ConnectionError,
    TimeoutError,
    OSError,
    InjectedFault,
)

# Deterministic OS failures a retry cannot heal: a missing file stays
# missing, EACCES stays denied. Excluded from the OSError umbrella above so
# they propagate at once.
NON_RETRYABLE_OS: Tuple[Type[BaseException], ...] = (
    FileNotFoundError,
    PermissionError,
    IsADirectoryError,
    NotADirectoryError,
)


def _jitter_fraction(key: str, attempt: int) -> float:
    """Deterministic uniform-ish [0, 1) from (key, attempt)."""
    digest = hashlib.sha256(f"{key}:{attempt}".encode()).digest()
    return int.from_bytes(digest[:8], "big") / 2**64


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic jitter and caps.

    ``max_attempts`` counts total tries (1 = no retry). ``deadline_s``
    bounds the policy's own sleeping: a retry whose backoff would cross
    the deadline is not taken. ``jitter`` spreads each delay over
    ``[delay * (1 - jitter), delay]``.
    """

    max_attempts: int = 5
    base_delay: float = 0.1
    multiplier: float = 2.0
    max_delay: float = 5.0
    deadline_s: Optional[float] = None
    jitter: float = 0.5
    retryable: Tuple[Type[BaseException], ...] = DEFAULT_RETRYABLE

    def delay(self, attempt: int, key: str = "") -> float:
        """Backoff before retry number `attempt` (0-based)."""
        try:
            raw = min(self.base_delay * (self.multiplier ** attempt),
                      self.max_delay)
        except OverflowError:
            raw = self.max_delay
        if self.jitter > 0:
            raw *= 1.0 - self.jitter * _jitter_fraction(key, attempt)
        return raw

    def should_retry(self, exc: BaseException) -> bool:
        if isinstance(exc, NON_RETRYABLE_OS) and not isinstance(
            exc, InjectedFault
        ):
            return False
        return isinstance(exc, self.retryable)

    def call(
        self,
        fn: Callable[[], Any],
        *,
        key: str = "",
        retry_if: Optional[Callable[[BaseException], bool]] = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ) -> Any:
        """Run `fn` under this policy; `retry_if` overrides the
        exception-class predicate. The final failure propagates as-is."""
        predicate = retry_if or self.should_retry
        start = clock()
        attempt = 0
        while True:
            try:
                return fn()
            except BaseException as e:  # noqa: BLE001 — predicate filters
                if not predicate(e):
                    raise
                if attempt + 1 >= self.max_attempts:
                    raise
                pause = self.delay(attempt, key=key)
                if (
                    self.deadline_s is not None
                    and clock() - start + pause > self.deadline_s
                ):
                    raise
                sleep(pause)
                attempt += 1


#: Object-store transfers: per-file retries; the caller (the checkpoint
#: writer) runs on a background thread, so a longer tail is affordable.
STORAGE_RETRY = RetryPolicy(max_attempts=8, base_delay=0.05, max_delay=2.0,
                            deadline_s=120.0)
