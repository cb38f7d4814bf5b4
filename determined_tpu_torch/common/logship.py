"""Structured log plane: the client half, a copy of
``determined_tpu/common/logship.py``.

The shipping side of the master's structured log store. A
`logging.Handler` renders stdlib log records into structured lines
tagged with process identity (`target`), stable labels
(experiment/trial/rank), level, logger name, and the ACTIVE trace/span
id — harvested from the ambient `common/trace.py` context of the
emitting thread (the same thread registry the sampling profiler reads),
so a log line lands inside the distributed trace that produced it.

Lines reach the master one of two ways:

- `LogShipper`: batch POST to `POST /api/v1/logs/ingest` with the
  SpanShipper discipline verbatim — bounded buffer dropping OLDEST,
  every loss counted at ``dtpu_log_lines_dropped_total{reason}``,
  resilient short-timeout Session, atexit tail flush, never blocks and
  never raises into the logging process;
- a ``sink`` callable (the master itself: ``logstore.ingest``) — the
  in-process path, no HTTP loopback.

Tasks launched by the platform auto-configure from their env
(`DTPU_LOG_SHIP=1` + `DTPU_MASTER`/`DTPU_SESSION_TOKEN`, injected by the
master's `_build_task_env` from the `logs:` masterconf section); daemons
(agent) attach handlers explicitly.
"""
from __future__ import annotations

import atexit
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

from determined_tpu_torch.common import faults
from determined_tpu_torch.common import trace as trace_mod
from determined_tpu_torch.common.metrics import REGISTRY as METRICS

logger = logging.getLogger("determined_tpu_torch.common")

#: Log-ingest endpoint override: a base URL ships there instead of
#: DTPU_MASTER; the literal "off" disables shipping for the process.
LOG_INGEST_ENV = "DTPU_LOG_INGEST"
#: "1" (injected by the master when the `logs:` plane is enabled) opts a
#: launched task into structured log shipping.
LOG_SHIP_ENV = "DTPU_LOG_SHIP"
#: Level floor a record must reach to ship (name, default INFO) — the
#: master pushes the `logs.ship_level` knob to every task env.
LOG_LEVEL_ENV = "DTPU_LOG_SHIP_LEVEL"

LINES_SHIPPED = METRICS.counter(
    "dtpu_log_lines_shipped_total",
    "Structured log lines accepted by the master's log-ingest endpoint "
    "from this process.",
)
LINES_DROPPED = METRICS.counter(
    "dtpu_log_lines_dropped_total",
    "Structured log lines LOST on the way to (or inside) the log store "
    "— shipper-buffer overflow, ship failures, re-entrant emits, "
    "malformed records, store caps. Every loss is counted under a "
    "reason; a level-floor filter is policy, not loss.",
    labels=("reason",),
)
SHIP_BACKOFFS = METRICS.counter(
    "dtpu_log_ship_backoffs_total",
    "Flush pauses honoring the master's 429 + Retry-After ingest shed "
    "(the batch is re-queued, not lost — loss still counts under "
    "dtpu_log_lines_dropped_total).",
)

#: Level-name → numeric severity for floors (stdlib values; unknown
#: names clamp to INFO so a typo'd knob never silences the plane).
LEVELS = {"DEBUG": 10, "INFO": 20, "WARNING": 30, "ERROR": 40,
          "CRITICAL": 50}


def level_no(name: Any, default: int = 20) -> int:
    if not isinstance(name, str):
        return default
    return LEVELS.get(name.strip().upper(), default)


class LogShipper:
    """Batch structured log lines to the master's log-ingest endpoint
    from a daemon flush thread — the SpanShipper discipline verbatim.
    Never blocks and never raises into the logging process: a full
    buffer or a failed ship drops lines and COUNTS the loss
    (dtpu_log_lines_dropped_total) — log loss is survivable, a wedged
    workload is not."""

    def __init__(
        self,
        master_url: str,
        token: str = "",
        *,
        batch_size: int = 256,
        flush_interval_s: float = 2.0,
        max_buffer: int = 8192,
        timeout_s: float = 5.0,
    ) -> None:
        # Lazy import: api_session logs through handlers that may enqueue
        # here.
        from determined_tpu_torch.common.api_session import Session

        self.master_url = master_url
        self._session = Session(
            master_url, token=token, max_retries=1, timeout=timeout_s
        )
        self._batch_size = int(batch_size)
        self._interval = float(flush_interval_s)
        self._buffer: Deque[Dict[str, Any]] = deque()
        self._max_buffer = int(max_buffer)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        # Monotonic deadline while honoring a 429 shed's Retry-After; the
        # buffer keeps absorbing (drop-oldest) until it passes.
        self._paused_until = 0.0
        self._thread = threading.Thread(
            target=self._run, name="dtpu-log-shipper", daemon=True
        )
        self._thread.start()

    def enqueue(self, line: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._buffer) >= self._max_buffer:
                # Drop the OLDEST: under sustained backpressure the
                # newest lines (what the process is doing NOW) are what
                # a debugger will want.
                self._buffer.popleft()
                LINES_DROPPED.labels("buffer_overflow").inc()
            self._buffer.append(line)
            full = len(self._buffer) >= self._batch_size
        if full:
            self._wake.set()

    def flush(self) -> None:
        """Ship everything buffered, synchronously. One POST per batch;
        a failed batch is counted lost and NOT retried here (the Session
        already retried transport blips) — flush must terminate. The one
        exception is an admission shed (429 + Retry-After): the batch is
        re-queued at the FRONT of the buffer and flushing pauses until
        the advertised deadline — backoff, not loss."""
        # Lazy import: resilience logs through handlers that may enqueue
        # here.
        from determined_tpu_torch.common.resilience import shed_backoff

        if time.monotonic() < self._paused_until:
            return  # honoring a shed pause; buffer keeps absorbing
        while True:
            with self._lock:
                if not self._buffer:
                    return
                batch = [
                    self._buffer.popleft()
                    for _ in range(min(self._batch_size, len(self._buffer)))
                ]
            try:
                faults.inject("client.ingest_backoff")
                faults.inject("client.log_ship")
                self._session.post(
                    "/api/v1/logs/ingest", json_body={"lines": batch}
                )
                LINES_SHIPPED.inc(len(batch))
            except Exception as e:  # noqa: BLE001 — loss, never propagation
                pause = shed_backoff(e)
                if pause is not None:
                    # Shed, not failure: put the batch back in order and
                    # stand down. Re-queueing may overflow the bound —
                    # that loss is the normal drop-oldest discipline.
                    with self._lock:
                        self._buffer.extendleft(reversed(batch))
                        while len(self._buffer) > self._max_buffer:
                            self._buffer.popleft()
                            LINES_DROPPED.labels("buffer_overflow").inc()
                    self._paused_until = time.monotonic() + pause
                    SHIP_BACKOFFS.inc()
                    logger.debug("log ship shed by %s; backing off %.2fs",
                                 self.master_url, pause)
                    return
                LINES_DROPPED.labels("ship_failed").inc(len(batch))
                logger.debug("log ship to %s failed: %s",
                             self.master_url, e)

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=self._interval)
            self._wake.clear()
            if self._stop.is_set():
                return  # stop() does the final flush
            self.flush()

    def stop(self, flush: bool = True) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=5)
        if flush:
            # Final drain ignores any shed pause — one last attempt; if
            # the master is still shedding, the leftovers are LOSS and
            # must be counted (the process is going away with them).
            self._paused_until = 0.0
            self.flush()
            with self._lock:
                leftover = len(self._buffer)
                self._buffer.clear()
            if leftover:
                LINES_DROPPED.labels("ship_failed").inc(leftover)


class StructuredLogHandler(logging.Handler):
    """Render stdlib records into the plane's wire shape and hand them
    to a ``sink`` callable (master in-process) or a `LogShipper` — the
    process's view of the structured log plane. Emits must NEVER block
    or raise into the logging code path: failures are counted and
    swallowed, and a re-entrant emit (the ship path logging about
    itself) is cut, counted, not looped."""

    def __init__(
        self,
        target: str,
        labels: Optional[Dict[str, Any]] = None,
        *,
        sink: Optional[Callable[[List[Dict[str, Any]]], Any]] = None,
        shipper: Optional[LogShipper] = None,
        level: int = logging.INFO,
        context_fn: Optional[Callable[[], Any]] = None,
    ) -> None:
        super().__init__(level=level)
        self.target = target
        self.labels = {str(k): str(v) for k, v in (labels or {}).items()}
        self._sink = sink
        self._shipper = shipper
        # Extra (trace_id, span_id) resolver consulted FIRST — the master
        # passes its own tracer's ambient-span accessor
        # (master/tracing.current_context), which common/ cannot import.
        self._context_fn = context_fn
        self._tls = threading.local()

    def render(self, record: logging.LogRecord) -> Dict[str, Any]:
        try:
            # Handler.format appends the exc_info traceback — a trial's
            # stack trace is exactly the line the plane exists for.
            message = self.format(record)
        except Exception:  # noqa: BLE001 — bad %-format args, still ship
            message = str(record.msg)
        # Trace correlation: the ambient context of the EMITTING thread —
        # an active span() block (contextvar), the thread registry the
        # profiler also reads, or the process's inherited DTPU_TRACEPARENT.
        ctx = None
        if self._context_fn is not None:
            try:
                ctx = self._context_fn()
            except Exception:  # noqa: BLE001 — correlation is best-effort
                ctx = None
        ctx = (ctx
               or trace_mod.span_for_thread(record.thread or 0)
               or trace_mod.current())
        return {
            "ts": record.created,
            "level": record.levelname,
            "logger": record.name,
            "message": message,
            "target": self.target,
            **({"labels": self.labels} if self.labels else {}),
            **({"trace": ctx[0], "span": ctx[1]} if ctx else {}),
        }

    def emit(self, record: logging.LogRecord) -> None:
        if getattr(self._tls, "emitting", False):
            # The sink/ship path logged about itself (Session debug, a
            # store complaint): enqueueing it would recurse forever.
            LINES_DROPPED.labels("reentrant").inc()
            return
        self._tls.emitting = True
        try:
            line = self.render(record)
            if self._sink is not None:
                self._sink([line])
            elif self._shipper is not None:
                self._shipper.enqueue(line)
            else:
                LINES_DROPPED.labels("no_sink").inc()
        except Exception:  # noqa: BLE001 — logging must never break the app
            LINES_DROPPED.labels("emit_error").inc()
        finally:
            self._tls.emitting = False

    def close(self) -> None:
        shipper, self._shipper = self._shipper, None
        if shipper is not None:
            shipper.stop(flush=True)
        super().close()


# -- module-level singleton (the process's shipping handler) -----------------

_handler: Optional[StructuredLogHandler] = None
_handler_logger: Optional[logging.Logger] = None
_handler_lock = threading.Lock()
_atexit_registered = False


def _register_atexit() -> None:
    global _atexit_registered
    if not _atexit_registered:
        # Flush the tail batch at interpreter exit: a short-lived trial
        # subprocess's final lines (the traceback it died with) must not
        # die with the flush thread.
        atexit.register(flush_shipping)
        _atexit_registered = True


def start_shipping(
    target: str,
    *,
    master_url: Optional[str] = None,
    token: str = "",
    labels: Optional[Dict[str, Any]] = None,
    attach_to: str = "",
    level: Optional[int] = None,
    **shipper_kw: Any,
) -> Optional[StructuredLogHandler]:
    """Attach (or replace) this process's structured-log shipping
    handler on the ``attach_to`` logger ("" = root, so user training
    code's records ship too). The destination resolves like the span
    shipper's: explicit ``master_url``, else DTPU_LOG_INGEST (the
    literal "off" disables), else DTPU_MASTER; token from
    DTPU_SESSION_TOKEN. Returns None — and ships nothing — when no
    destination can be resolved."""
    global _handler, _handler_logger
    ingest = os.environ.get(LOG_INGEST_ENV, "")
    if ingest.lower() == "off":
        return None
    url = master_url or ingest or os.environ.get("DTPU_MASTER")
    if not url:
        return None
    token = token or os.environ.get("DTPU_SESSION_TOKEN", "")
    if level is None:
        level = level_no(os.environ.get(LOG_LEVEL_ENV, "INFO"))
    try:
        handler = StructuredLogHandler(
            target, labels,
            shipper=LogShipper(url, token, **shipper_kw), level=level,
        )
    except Exception:  # noqa: BLE001 — log shipping never breaks the task
        logger.debug("log shipper config failed", exc_info=True)
        return None
    target_logger = logging.getLogger(attach_to or None)
    with _handler_lock:
        old, old_logger = _handler, _handler_logger
        _handler, _handler_logger = handler, target_logger
    if old is not None and old_logger is not None:
        old_logger.removeHandler(old)
        old.close()
    # Level floor: stdlib filters records at the LOGGER's effective level
    # before any handler runs — in a process that never configured
    # logging that's WARNING, silently violating the master's ship_level
    # policy. Handlers attached alongside keep their own levels.
    if target_logger.getEffectiveLevel() > level:
        target_logger.setLevel(level)
    target_logger.addHandler(handler)
    _register_atexit()
    return handler


def maybe_start_from_env(target: str, **kw: Any) -> Optional[StructuredLogHandler]:
    """The task-process entry: attaches the shipping handler iff the
    launch env enables the plane (DTPU_LOG_SHIP=1, injected by the
    master's _build_task_env from the `logs:` masterconf section)."""
    if os.environ.get(LOG_SHIP_ENV, "0") != "1":
        return None
    return start_shipping(target, **kw)


def stop_shipping(flush: bool = True) -> None:
    global _handler, _handler_logger
    with _handler_lock:
        handler, _handler = _handler, None
        attached, _handler_logger = _handler_logger, None
    if handler is None:
        return
    if attached is not None:
        attached.removeHandler(handler)
    shipper, handler._shipper = handler._shipper, None
    if shipper is not None:
        shipper.stop(flush=flush)


def flush_shipping() -> None:
    """Synchronously drain the shipping handler if one is attached
    (harness/agent shutdown paths, atexit)."""
    handler = _handler
    if handler is not None and handler._shipper is not None:
        try:
            handler._shipper.flush()
        except Exception:  # noqa: BLE001
            logger.debug("log shipper flush failed", exc_info=True)


def reset_shipping() -> None:
    """Tests / devcluster stop: detach without flushing."""
    stop_shipping(flush=False)
