"""Retry policies and circuit breakers of the port.

A copy of ``determined_tpu/common/resilience.py`` for the storage
transfers and the master session (``common/api_session.py``):

- ``RetryPolicy``: exponential backoff with **deterministic jitter** (a
  sha256 of ``(key, attempt)``, so tests see reproducible timing), attempt
  and deadline caps, and a retryable-exception predicate; a 429 or 503
  carrying ``Retry-After`` sets the pause (``retry_after_hint``), clamped
  to the policy's ``max_delay``. Every retry taken counts in
  ``dtpu_retries_total{key}``.
- ``CircuitBreaker``: per-endpoint closed → open → half-open over
  consecutive failures; an open circuit fails fast with
  ``CircuitOpenError``. Transitions into open count in
  ``dtpu_circuit_opens_total{endpoint}``, the state sits in
  ``dtpu_circuit_state{endpoint}``.
- ``CircuitBreakerRegistry``: the thread-safe per-key breaker map (the
  Session keys by route shape).
- ``shed_backoff``: the pause a telemetry shipper honours after a 429.

Sleeps and clocks are injectable. Left out: the agents' never-give-up
supervision policy and its ``Backoff`` sequence (the agent is not ported).
"""
from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple, Type

from determined_tpu_torch.common.faults import InjectedFault
from determined_tpu_torch.common.metrics import REGISTRY

RETRIES = REGISTRY.counter(
    "dtpu_retries_total",
    "Retry attempts taken by RetryPolicy.call, by policy key.",
    labels=("key",),
)
CIRCUIT_STATE = REGISTRY.gauge(
    "dtpu_circuit_state",
    "Circuit-breaker state per endpoint: 0 closed, 1 half-open, 2 open.",
    labels=("endpoint",),
)
CIRCUIT_OPENS = REGISTRY.counter(
    "dtpu_circuit_opens_total",
    "Circuit-breaker transitions into the open state, by endpoint.",
    labels=("endpoint",),
)
_STATE_CODE = {"closed": 0.0, "half-open": 1.0, "open": 2.0}

# Transient-infrastructure default: connection resets, timeouts, filesystem
# hiccups, and injected faults. The session's HTTP errors subclass OSError,
# so its transport failures are covered too.
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


def retry_after_hint(exc: BaseException) -> Optional[float]:
    """The ``Retry-After`` seconds carried by a 429 or 503 response
    (``exc.response``), else None. Junk values — the HTTP-date form,
    non-numeric strings, negatives — yield None, and the caller's own
    backoff computes the pause."""
    resp = getattr(exc, "response", None)
    if resp is None or getattr(resp, "status_code", None) not in (429, 503):
        return None
    headers = getattr(resp, "headers", None)
    if headers is None:
        return None
    try:
        raw = headers.get("Retry-After")
    except Exception:  # noqa: BLE001 — malformed mapping: no hint
        return None
    if raw is None:
        return None
    try:
        value = float(raw)
    except (TypeError, ValueError):
        return None
    return value if value >= 0 else None


def shed_backoff(
    exc: BaseException, *, default_s: float = 1.0, cap_s: float = 5.0
) -> Optional[float]:
    """Pause (seconds) a shipper honours when `exc` is an ingest shed — an
    HTTP 429 from the master's admission layer, or the
    ``client.ingest_backoff`` fault site — else None. A 429 without a
    parseable ``Retry-After`` still backs off ``default_s``; the hint is
    clamped to ``cap_s``."""
    if (
        isinstance(exc, InjectedFault)
        and getattr(exc, "site", "") == "client.ingest_backoff"
    ):
        return default_s
    resp = getattr(exc, "response", None)
    if getattr(resp, "status_code", None) != 429:
        return None
    hint = retry_after_hint(exc)
    return min(hint, cap_s) if hint is not None else default_s


class CircuitOpenError(ConnectionError):
    """Fail-fast: the endpoint's circuit is open (recent consecutive
    failures). Subclasses ConnectionError so transport-failure handlers
    treat it as the outage it signals."""

    def __init__(self, key: str, retry_at: float) -> None:
        super().__init__(f"circuit open for {key}")
        self.key = key
        self.retry_at = retry_at


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
        if isinstance(exc, CircuitOpenError):
            return False  # fail fast: the breaker's whole point
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
        exception-class predicate (the Session's status-code rules). The
        final failure propagates as-is."""
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
                # Server-provided pacing wins over the computed backoff,
                # clamped to this policy's own ceiling.
                hint = retry_after_hint(e)
                if hint is not None:
                    pause = min(hint, self.max_delay)
                if (
                    self.deadline_s is not None
                    and clock() - start + pause > self.deadline_s
                ):
                    raise
                RETRIES.labels(key or "unkeyed").inc()
                sleep(pause)
                attempt += 1


@dataclass
class _BreakerState:
    failures: int = 0
    state: str = "closed"         # closed | open | half-open
    opened_at: float = 0.0
    probing: bool = False


class CircuitBreaker:
    """Closed/open/half-open breaker over consecutive failures. The caller
    decides what counts as a failure: an HTTP 404 is a healthy endpoint
    giving an unwelcome answer."""

    def __init__(
        self,
        key: str = "",
        failure_threshold: int = 8,
        reset_timeout: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.key = key
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self._clock = clock
        self._s = _BreakerState()
        self._lock = threading.Lock()

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._s.state

    def _maybe_half_open(self) -> None:
        if (
            self._s.state == "open"
            and self._clock() - self._s.opened_at >= self.reset_timeout
        ):
            self._s.state = "half-open"
            self._s.probing = False
            self._set_state_gauge()

    def _set_state_gauge(self) -> None:
        if self.key:
            CIRCUIT_STATE.labels(self.key).set(_STATE_CODE[self._s.state])

    def open_until(self) -> float:
        """Clock time when the next half-open probe is admitted (0.0 when
        the circuit is closed)."""
        with self._lock:
            if self._s.state == "closed":
                return 0.0
            return self._s.opened_at + self.reset_timeout

    def allow(self) -> bool:
        """May a call proceed now? In half-open exactly one probe is
        admitted until its outcome is recorded."""
        with self._lock:
            self._maybe_half_open()
            if self._s.state == "closed":
                return True
            if self._s.state == "half-open" and not self._s.probing:
                self._s.probing = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            was_open = self._s.state != "closed"
            self._s = _BreakerState()
            if was_open:
                self._set_state_gauge()

    def record_failure(self) -> None:
        with self._lock:
            self._s.failures += 1
            self._s.probing = False
            if self._s.state == "half-open" or (
                self._s.state == "closed"
                and self._s.failures >= self.failure_threshold
            ):
                self._s.state = "open"
                self._s.opened_at = self._clock()
                self._set_state_gauge()
                if self.key:
                    CIRCUIT_OPENS.labels(self.key).inc()

    def call(self, fn: Callable[[], Any]) -> Any:
        """Run `fn` through the breaker: CircuitOpenError when open;
        records success or failure from the call's outcome."""
        if not self.allow():
            raise CircuitOpenError(self.key, self.open_until())
        try:
            result = fn()
        except BaseException:
            self.record_failure()
            raise
        self.record_success()
        return result


class CircuitBreakerRegistry:
    """Thread-safe per-key breaker map (one breaker per endpoint)."""

    def __init__(
        self,
        failure_threshold: int = 8,
        reset_timeout: float = 5.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._kw = dict(
            failure_threshold=failure_threshold,
            reset_timeout=reset_timeout,
            clock=clock,
        )
        self._breakers: dict = {}
        self._lock = threading.Lock()

    def get(self, key: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(key)
            if b is None:
                b = CircuitBreaker(key, **self._kw)  # type: ignore[arg-type]
                self._breakers[key] = b
            return b


#: Control-plane HTTP (Session): quick first retry, bounded tail.
API_RETRY = RetryPolicy(max_attempts=6, base_delay=0.1, max_delay=5.0)

#: Object-store transfers: per-file retries; the caller (the checkpoint
#: writer) runs on a background thread, so a longer tail is affordable.
STORAGE_RETRY = RetryPolicy(max_attempts=8, base_delay=0.05, max_delay=2.0,
                            deadline_s=120.0)
