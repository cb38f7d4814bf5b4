"""W3C trace-context propagation for the task/client plane: a copy of
``determined_tpu/common/trace.py``.

The master's span pipeline lives in `master/tracing.py` (OTLP-shaped
exporters); this module is the THIN half every other process shares —
CLI, SDK, agent, trial harness:

- `parse_traceparent` / `format_traceparent`: the W3C `traceparent`
  header (`00-<trace_id:32hex>-<span_id:16hex>-01`), the same contract
  the reference gets from otelgin's propagators;
- an ambient trace context: a contextvar seeded (lazily) from the
  `DTPU_TRACEPARENT` env var — the launch layer injects it into every
  task env, so a trial process is born INSIDE the trace that submitted
  its experiment;
- `span()`: a lightweight client-side span that derives a child context
  (new span id, inherited trace id) and makes it ambient for the block.
  When `DTPU_TRACE_FILE` is set the finished span is appended as one
  OTLP-shaped JSON line (the same wire shape as the master's
  JsonlExporter, so one `cat */spans.jsonl | sort` reassembles the whole
  distributed trace); without it the span exists only as propagated ids
  — zero I/O on the hot path;
- `SpanShipper`: the ONLINE half of the trace plane. Finished spans
  batch-POST to the master's `POST /api/v1/traces/ingest` (resilient
  Session, short timeouts — trace loss is acceptable, blocking the
  workload is not), where master/tracestore.py reassembles whole
  distributed traces and serves them at `GET /api/v1/traces/<id>`.
  Tail-based sampling happens HERE, at the shipper: errored spans and
  spans over the slowness threshold always ship; the rest head-sample
  by a trace-id hash, so a kept trace is kept in EVERY process
  (whole-trace consistency without coordination). Tasks auto-configure
  from their launch env (`DTPU_MASTER` + `DTPU_SESSION_TOKEN`);
  daemons (agent) call `configure_shipper` explicitly. `atexit` flushes
  the tail batch so short-lived trial subprocesses don't drop their
  final spans. `DTPU_TRACE_FILE` stays as the offline fallback.

`Session` (common/api_session.py) stamps `traceparent` from the ambient
context on every outgoing request, which is what parents the master's
request spans back to the caller.
"""
from __future__ import annotations

import atexit
import contextlib
import contextvars
import json
import logging
import os
import re
import secrets
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, Iterator, Optional, Tuple

from determined_tpu_torch.common import faults
from determined_tpu_torch.common.metrics import REGISTRY as METRICS

logger = logging.getLogger("determined_tpu_torch.common")

TRACEPARENT_ENV = "DTPU_TRACEPARENT"
TRACE_FILE_ENV = "DTPU_TRACE_FILE"
#: Span-ingest endpoint override: a base URL ships there instead of
#: DTPU_MASTER; the literal "off" disables shipping for the process.
TRACE_INGEST_ENV = "DTPU_TRACE_INGEST"
#: Head-sample rate for unremarkable spans, [0,1] (tail criteria — error,
#: slow — always ship). Whole-trace consistent: the keep/drop decision
#: hashes the trace id, so every process agrees per trace.
TRACE_SAMPLE_ENV = "DTPU_TRACE_SAMPLE"
#: Spans at least this long (ms) always ship, whatever the sample rate.
TRACE_SLOW_MS_ENV = "DTPU_TRACE_SLOW_MS"

DEFAULT_SLOW_MS = 500.0

SPANS_SHIPPED = METRICS.counter(
    "dtpu_trace_spans_shipped_total",
    "Spans accepted by the master's trace-ingest endpoint from this "
    "process.",
)
SPANS_DROPPED = METRICS.counter(
    "dtpu_trace_spans_dropped_total",
    "Spans LOST on the way to (or inside) the trace store — ship "
    "failures, shipper-buffer overflow, store caps. Sampling is not "
    "loss; see dtpu_trace_spans_sampled_out_total.",
    labels=("reason",),
)
SPANS_SAMPLED_OUT = METRICS.counter(
    "dtpu_trace_spans_sampled_out_total",
    "Spans intentionally not shipped by the tail-sampling policy "
    "(unremarkable and head-sampled out by trace-id hash).",
)
SHIP_BACKOFFS = METRICS.counter(
    "dtpu_trace_ship_backoffs_total",
    "Flush pauses honoring the master's 429 + Retry-After ingest shed "
    "(the batch is re-queued, not lost — loss still counts under "
    "dtpu_trace_spans_dropped_total).",
)

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)

#: (trace_id, span_id) of the current context, or None.
_current: contextvars.ContextVar = contextvars.ContextVar(
    "dtpu_trace_context", default=None
)

Context = Tuple[str, str]

#: thread-ident → active (trace_id, span_id), maintained by span() for
#: CROSS-thread readers: a contextvar is invisible outside its own
#: thread, and the sampling profiler (common/profiling.py) attributes
#: stacks from sys._current_frames() on its own daemon thread — this is
#: how a sample learns which span the sampled thread was inside. Plain
#: dict ops are GIL-atomic; the hot-path cost is two dict stores per
#: span() block.
_thread_spans: Dict[int, Context] = {}


def span_for_thread(ident: int) -> Optional[Context]:
    """The (trace_id, span_id) the given thread is currently inside —
    None when its active code is not under a span() block. Profiling-
    plane reader; snapshot semantics only (the span may end between the
    read and any use)."""
    return _thread_spans.get(ident)


def new_trace_id() -> str:
    return secrets.token_hex(16)


def new_span_id() -> str:
    return secrets.token_hex(8)


def format_traceparent(trace_id: str, span_id: str) -> str:
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(value: Optional[str]) -> Optional[Context]:
    """(trace_id, span_id) from a `traceparent` header, or None when the
    header is absent/malformed (a bad header must be ignored, never 400 —
    the W3C contract, and tracing must never break an API call)."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id, _flags = m.groups()
    if version == "ff":  # forbidden by the spec
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def current() -> Optional[Context]:
    """The ambient context: an active span() block, else the process's
    inherited DTPU_TRACEPARENT (how a launched task parents its first
    span back to the launch chain)."""
    ctx = _current.get()
    if ctx is not None:
        return ctx
    return parse_traceparent(os.environ.get(TRACEPARENT_ENV))


def traceparent() -> Optional[str]:
    ctx = current()
    return format_traceparent(*ctx) if ctx is not None else None


class SpanShipper:
    """Batch spans to the master's trace-ingest endpoint from a daemon
    flush thread (the client-side analog of the master Tracer's batching
    pipeline). Never blocks and never raises into the instrumented path:
    a full buffer or a failed ship drops spans and COUNTS the loss
    (dtpu_trace_spans_dropped_total) — trace loss is survivable, a
    wedged workload is not."""

    def __init__(
        self,
        master_url: str,
        token: str = "",
        *,
        batch_size: int = 128,
        flush_interval_s: float = 2.0,
        max_buffer: int = 4096,
        timeout_s: float = 5.0,
    ) -> None:
        # Lazy import: api_session imports this module at load time.
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
        #: monotonic deadline of a master-requested shed pause (429 +
        #: Retry-After): flush no-ops until then, the bounded buffer keeps
        #: absorbing with its usual drop-oldest discipline.
        self._paused_until = 0.0
        self._thread = threading.Thread(
            target=self._run, name="dtpu-span-shipper", daemon=True
        )
        self._thread.start()

    def enqueue(self, span: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._buffer) >= self._max_buffer:
                # Drop the OLDEST: under sustained backpressure the tail
                # of the trace (the part still being produced) is what a
                # debugger will want.
                self._buffer.popleft()
                SPANS_DROPPED.labels("buffer_overflow").inc()
            self._buffer.append(span)
            full = len(self._buffer) >= self._batch_size
        if full:
            self._wake.set()

    def flush(self) -> None:
        """Ship everything buffered, synchronously. One POST per batch;
        a failed batch is counted lost and NOT retried here (the Session
        already retried transport blips) — flush must terminate. The one
        exception is a 429 SHED from the master's admission layer: the
        batch re-queues at the buffer FRONT (order kept, loss still only
        through the counted drop-oldest cap) and flush pauses for the
        response's Retry-After."""
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
                faults.inject("client.trace_ship")
                self._session.post(
                    "/api/v1/traces/ingest", json_body={"spans": batch}
                )
                SPANS_SHIPPED.inc(len(batch))
            except Exception as e:  # noqa: BLE001 — loss, never propagation
                pause = shed_backoff(e)
                if pause is not None:
                    with self._lock:
                        self._buffer.extendleft(reversed(batch))
                        while len(self._buffer) > self._max_buffer:
                            self._buffer.popleft()
                            SPANS_DROPPED.labels("buffer_overflow").inc()
                    self._paused_until = time.monotonic() + pause
                    SHIP_BACKOFFS.inc()
                    logger.debug(
                        "span ship shed by %s; backing off %.2fs",
                        self.master_url, pause,
                    )
                    return
                SPANS_DROPPED.labels("ship_failed").inc(len(batch))
                logger.debug("span ship to %s failed: %s",
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
            # One final attempt regardless of a standing shed pause (the
            # process is exiting; the master may have recovered). If the
            # master sheds again, the leftover batch would vanish
            # uncounted — count it as ship loss.
            self._paused_until = 0.0
            self.flush()
            with self._lock:
                leftover = len(self._buffer)
                self._buffer.clear()
            if leftover:
                SPANS_DROPPED.labels("ship_failed").inc(leftover)


_shipper: Optional[SpanShipper] = None
_shipper_resolved = False  # auto-config from env attempted
_shipper_lock = threading.Lock()
_atexit_registered = False


def _register_atexit() -> None:
    global _atexit_registered
    if not _atexit_registered:
        # Flush the tail batch at interpreter exit: a short-lived trial
        # subprocess's final spans (trial.run itself) must not die with
        # the flush thread.
        atexit.register(flush_shipper)
        _atexit_registered = True


def configure_shipper(
    master_url: str, token: str = "", **kw: Any
) -> SpanShipper:
    """Explicitly point this process's span shipper at a master (agent
    daemon, tests). Tasks launched by the platform need not call this —
    the shipper self-configures from DTPU_MASTER/DTPU_SESSION_TOKEN."""
    global _shipper, _shipper_resolved
    with _shipper_lock:
        old, _shipper = _shipper, None
        _shipper_resolved = True
    if old is not None:
        old.stop(flush=False)
    shipper = SpanShipper(master_url, token, **kw)
    with _shipper_lock:
        _shipper = shipper
    _register_atexit()
    return shipper


def reset_shipper() -> None:
    """Drop any shipper and re-resolve from env on the next span (tests;
    also the hook a fork/exec wrapper would use)."""
    global _shipper, _shipper_resolved
    with _shipper_lock:
        old, _shipper = _shipper, None
        _shipper_resolved = False
    if old is not None:
        old.stop(flush=False)


def flush_shipper() -> None:
    """Synchronously drain the shipper if one is active (harness/agent
    shutdown paths, atexit)."""
    shipper = _shipper
    if shipper is not None:
        shipper.flush()


def _get_shipper() -> Optional[SpanShipper]:
    global _shipper, _shipper_resolved
    if _shipper is not None:
        return _shipper
    if _shipper_resolved:
        return None
    with _shipper_lock:
        if _shipper is not None or _shipper_resolved:
            return _shipper
        _shipper_resolved = True
        ingest = os.environ.get(TRACE_INGEST_ENV, "")
        if ingest.lower() == "off":
            return None
        url = ingest or os.environ.get("DTPU_MASTER")
        if not url:
            return None
        try:
            _shipper = SpanShipper(
                url, os.environ.get("DTPU_SESSION_TOKEN", "")
            )
        except Exception:  # noqa: BLE001 — tracing never breaks the task
            logger.debug("span shipper auto-config failed", exc_info=True)
            return None
    _register_atexit()
    return _shipper


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _keep_span(trace_id: str, error: bool, duration_s: float) -> bool:
    """The shipper's tail-sampling policy. Errors and slow spans ALWAYS
    ship (those are the traces anyone goes looking for); the rest
    head-sample by trace-id hash — deterministic and identical in every
    process, so a kept trace arrives whole."""
    if error:
        return True
    if duration_s * 1e3 >= _env_float(TRACE_SLOW_MS_ENV, DEFAULT_SLOW_MS):
        return True
    rate = _env_float(TRACE_SAMPLE_ENV, 1.0)
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    try:
        return int(trace_id[:8], 16) / float(0xFFFFFFFF) < rate
    except ValueError:
        return True  # unhashable id: keep rather than silently lose


def _export(
    name: str,
    trace_id: str,
    span_id: str,
    parent_span_id: Optional[str],
    start: float,
    end: float,
    attributes: Dict[str, Any],
    error: bool,
) -> None:
    path = os.environ.get(TRACE_FILE_ENV)
    shipper = _get_shipper()
    # Sampling decision BEFORE the span dict is built: in a heavily
    # sampled process with no file sink, a dropped span must not pay the
    # OTLP serialization on the instrumented path for nothing.
    ship = shipper is not None and _keep_span(trace_id, error, end - start)
    if shipper is not None and not ship:
        SPANS_SAMPLED_OUT.inc()
    if not path and not ship:
        return
    span = {
        "traceId": trace_id,
        "spanId": span_id,
        **({"parentSpanId": parent_span_id} if parent_span_id else {}),
        "name": name,
        "startTimeUnixNano": int(start * 1e9),
        "endTimeUnixNano": int(end * 1e9),
        "attributes": [
            {"key": k, "value": _attr_value(v)}
            for k, v in attributes.items()
        ],
        "status": {"code": 2 if error else 1},
    }
    if path:
        try:
            # Whole-line appends are atomic at this size on POSIX, so agent
            # and trial processes may share one file. The file fallback is
            # UNSAMPLED — offline capture keeps full fidelity.
            with open(path, "a") as f:
                f.write(json.dumps(span) + "\n")
        except OSError:  # tracing must never break the workload
            logger.debug("trace export to %s failed", path, exc_info=True)
    if ship:
        shipper.enqueue(span)


def _attr_value(v: Any) -> Dict[str, Any]:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def export_span(
    name: str,
    *,
    trace_id: str,
    span_id: str,
    start: float,
    end: float,
    parent_span_id: Optional[str] = None,
    attributes: Optional[Dict[str, Any]] = None,
    error: bool = False,
) -> None:
    """Export one finished span from explicit timestamps.

    For components that measure phases with their own clocks instead of a
    `with span()` block — the serving engine records submit/queue/prefill/
    first-token times across threads and emits the request's phase spans
    at completion. Same wire shape and DTPU_TRACE_FILE gating as span()."""
    _export(
        name, trace_id, span_id, parent_span_id, start, end,
        dict(attributes or {}), error,
    )


@contextlib.contextmanager
def span(
    name: str,
    attributes: Optional[Dict[str, Any]] = None,
    parent: Optional[Context] = None,
) -> Iterator[Context]:
    """Client-side span: child of `parent` (explicit) or the ambient
    context, root of a fresh trace otherwise. Yields (trace_id, span_id)
    — ambient for the duration, so nested spans and Session requests
    inherit it."""
    ctx = parent if parent is not None else current()
    trace_id = ctx[0] if ctx else new_trace_id()
    parent_span_id = ctx[1] if ctx else None
    span_id = new_span_id()
    token = _current.set((trace_id, span_id))
    ident = threading.get_ident()
    prev_thread_span = _thread_spans.get(ident)
    _thread_spans[ident] = (trace_id, span_id)
    start = time.time()
    error = False
    try:
        yield trace_id, span_id
    except BaseException:
        error = True
        raise
    finally:
        if prev_thread_span is not None:
            _thread_spans[ident] = prev_thread_span
        else:
            _thread_spans.pop(ident, None)
        _current.reset(token)
        _export(
            name, trace_id, span_id, parent_span_id, start, time.time(),
            dict(attributes or {}), error,
        )
