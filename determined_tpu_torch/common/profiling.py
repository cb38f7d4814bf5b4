"""Continuous sampling profiler + window shipper (the profiling plane's
client half), a copy of ``determined_tpu/common/profiling.py``.

Always-on wall-clock profiles: a daemon thread walks
`sys._current_frames()` at a configurable Hz and aggregates INTERNED
folded stacks per window (Brendan Gregg's `a;b;c count` format — the
flamegraph wire shape), tagging every sample with:

- the process identity (``master`` / ``agent:<id>`` / ``trial:<t>.r<k>``
  / ``serving:<task>``) — the store's per-target axis;
- the sampled thread's name;
- the span the thread was inside, via `trace.span_for_thread` (the
  cross-thread mirror of the ambient span contextvar) — this is what
  lets "p99 TTFT regressed" go exemplar → stored trace → the flamegraph
  of exactly that span's wall-clock;
- the trainer's current timeline phase (data_wait / h2d_put / step /
  checkpoint), marked by the hot loop through `set_phase()` — a
  thread-keyed dict write, no import of trainer code here.

Windows batch-ship to ``POST /api/v1/profiles/ingest`` with the
SpanShipper discipline (common/trace.py): daemon flush thread, bounded
buffer dropping OLDEST, atexit/harness/agent-stop flush, every loss
counted at ``dtpu_profile_windows_dropped_total{reason}`` — the sampled
process never blocks and never fails because of profiling. The master
profiles itself through a direct in-process ``sink`` (no HTTP loopback,
the StoreExporter precedent).

Env contract (injected by the master's launch layer, `_build_task_env`):
``DTPU_PROFILE`` (1/0), ``DTPU_PROFILE_HZ``, ``DTPU_PROFILE_WINDOW_S``,
``DTPU_PROFILE_INGEST`` (override URL, or the literal "off").
"""
from __future__ import annotations

import atexit
import contextlib
import logging
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional

from determined_tpu_torch.common import faults
from determined_tpu_torch.common import trace as trace_mod
from determined_tpu_torch.common.metrics import REGISTRY as METRICS

logger = logging.getLogger("determined_tpu_torch.common")

PROFILE_ENV = "DTPU_PROFILE"
PROFILE_HZ_ENV = "DTPU_PROFILE_HZ"
PROFILE_WINDOW_ENV = "DTPU_PROFILE_WINDOW_S"
#: Window-ingest endpoint override: a base URL ships there instead of
#: DTPU_MASTER; the literal "off" disables shipping for the process.
PROFILE_INGEST_ENV = "DTPU_PROFILE_INGEST"

DEFAULT_HZ = 19.0  # deliberately off every round frequency (lockstep bias)
DEFAULT_WINDOW_S = 10.0
#: Frames kept per stack (deepest dropped first — the root-side frames
#: are what merge across samples).
MAX_STACK_DEPTH = 64
#: Distinct (thread, span, phase, stack) groups aggregated per window;
#: beyond this a sample folds into the "(truncated)" stack so a stack-
#: cardinality explosion in the profiled process cannot grow the window.
MAX_WINDOW_GROUPS = 2000

WINDOWS_SHIPPED = METRICS.counter(
    "dtpu_profile_windows_shipped_total",
    "Profile windows accepted by the master's profile-ingest endpoint "
    "(or in-process sink) from this process.",
)
WINDOWS_DROPPED = METRICS.counter(
    "dtpu_profile_windows_dropped_total",
    "Profile windows LOST on the way to (or inside) the profile store — "
    "ship failures, shipper-buffer overflow, sink errors, store caps.",
    labels=("reason",),
)
SHIP_BACKOFFS = METRICS.counter(
    "dtpu_profile_ship_backoffs_total",
    "Flush pauses honoring the master's 429 + Retry-After ingest shed "
    "(the batch is re-queued, not lost — loss still counts under "
    "dtpu_profile_windows_dropped_total).",
)
SAMPLES_TAKEN = METRICS.counter(
    "dtpu_profile_samples_total",
    "Thread-stack samples taken by this process's sampling profiler.",
)
SAMPLER_STACKS = METRICS.gauge(
    "dtpu_profile_window_groups",
    "Distinct (thread, span, phase, stack) groups aggregated in the "
    "sampler's current window (bounded at the window-group cap).",
)
SAMPLER_OVERHEAD = METRICS.gauge(
    "dtpu_profile_sampler_walk_seconds",
    "Wall seconds the last sampler pass spent walking+folding all "
    "thread stacks (the whole plane's per-sample cost, on its own "
    "daemon thread).",
)

#: thread-ident → current timeline phase, written by the trainer's hot
#: loop (set_phase) and read by the sampler thread. Same GIL-atomic
#: plain-dict discipline as trace._thread_spans.
_thread_phase: Dict[int, str] = {}


def set_phase(name: Optional[str]) -> None:
    """Mark the CALLING thread's current timeline phase for the sampler
    (data_wait / h2d_put / report / checkpoint; None clears → samples
    fall back to the 'step' residual like the timeline itself). One dict
    store — cheap enough for the trainer hot loop."""
    ident = threading.get_ident()
    if name is None:
        _thread_phase.pop(ident, None)
    else:
        _thread_phase[ident] = name


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Phase-mark a block (trainer data_wait/h2d_put/checkpoint sites)."""
    ident = threading.get_ident()
    prev = _thread_phase.get(ident)
    _thread_phase[ident] = name
    try:
        yield
    finally:
        if prev is not None:
            _thread_phase[ident] = prev
        else:
            _thread_phase.pop(ident, None)


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


class ProfileShipper:
    """Batch profile windows to the master's profile-ingest endpoint from
    a daemon flush thread — the SpanShipper discipline verbatim: bounded
    buffer dropping OLDEST, counted loss, short-timeout Session, never
    blocks or raises into the profiled process."""

    def __init__(
        self,
        master_url: str,
        token: str = "",
        *,
        batch_size: int = 8,
        flush_interval_s: float = 5.0,
        max_buffer: int = 256,
        timeout_s: float = 5.0,
    ) -> None:
        # Lazy import: api_session imports common modules at load time.
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
            target=self._run, name="dtpu-profile-shipper", daemon=True
        )
        self._thread.start()

    def enqueue(self, window: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._buffer) >= self._max_buffer:
                # Drop the OLDEST window: under sustained backpressure
                # the most recent profile is what a debugger wants.
                self._buffer.popleft()
                WINDOWS_DROPPED.labels("buffer_overflow").inc()
            self._buffer.append(window)
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
                faults.inject("client.profile_ship")
                self._session.post(
                    "/api/v1/profiles/ingest", json_body={"windows": batch}
                )
                WINDOWS_SHIPPED.inc(len(batch))
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
                            WINDOWS_DROPPED.labels(
                                "buffer_overflow"
                            ).inc()
                    self._paused_until = time.monotonic() + pause
                    SHIP_BACKOFFS.inc()
                    logger.debug(
                        "profile ship shed by %s; backing off %.2fs",
                        self.master_url, pause,
                    )
                    return
                WINDOWS_DROPPED.labels("ship_failed").inc(len(batch))
                logger.debug("profile ship to %s failed: %s",
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
                WINDOWS_DROPPED.labels("ship_failed").inc(leftover)


def _thread_name(ident: int) -> str:
    t = threading._active.get(ident)  # noqa: SLF001 — O(1) vs enumerate()
    return t.name if t is not None else f"tid-{ident}"


def fold_frame(frame) -> str:
    """One folded stack (root-first, ';'-joined `file:func` frames) from
    a leaf frame. Interned per window by the aggregation dict; the store
    interns globally."""
    frames: List[str] = []
    depth = 0
    while frame is not None and depth < MAX_STACK_DEPTH:
        code = frame.f_code
        fname = code.co_filename
        # basename keeps cardinality down without losing the module —
        # two same-named files disambiguate by their parent directory.
        cut = fname.rfind("/", 0, fname.rfind("/"))
        frames.append(f"{fname[cut + 1:]}:{code.co_name}")
        frame = frame.f_back
        depth += 1
    frames.reverse()
    return ";".join(frames)


class SamplingProfiler:
    """The per-process continuous profiler: a daemon thread samples every
    thread's stack at `hz`, aggregates interned folded stacks per window,
    and emits closed windows to a ProfileShipper (HTTP) or a direct
    in-process `sink` callable (the master profiling itself). All
    failure modes are counted, none propagate."""

    def __init__(
        self,
        target: str,
        *,
        hz: Optional[float] = None,
        window_s: Optional[float] = None,
        shipper: Optional[ProfileShipper] = None,
        sink: Optional[Callable[[List[Dict[str, Any]]], Any]] = None,
    ) -> None:
        self.target = str(target)
        self.hz = float(hz if hz is not None
                        else _env_float(PROFILE_HZ_ENV, DEFAULT_HZ))
        self.hz = min(max(self.hz, 0.1), 1000.0)
        self.window_s = float(
            window_s if window_s is not None
            else _env_float(PROFILE_WINDOW_ENV, DEFAULT_WINDOW_S)
        )
        self.window_s = max(self.window_s, 0.1)
        self._shipper = shipper
        self._sink = sink
        # (thread_name, span_id, trace_id, phase, folded) -> count
        self._window: Dict[tuple, int] = {}
        self._window_start = time.time()
        self._truncated = 0
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "SamplingProfiler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="dtpu-profiler", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, flush: bool = True) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if flush:
            self._close_window(force=True)
            if self._shipper is not None:
                self._shipper.stop(flush=True)

    def flush(self) -> None:
        """Close the in-progress window and drain the shipper (harness /
        agent-stop / atexit path)."""
        self._close_window(force=True)
        if self._shipper is not None:
            self._shipper.flush()

    # -- sampling ------------------------------------------------------------
    def _sample_once(self) -> None:
        t0 = time.perf_counter()
        me = self._thread.ident if self._thread else None
        try:
            frames = sys._current_frames()  # noqa: SLF001 — the whole point
        except Exception:  # noqa: BLE001
            return
        taken = 0
        with self._lock:
            for ident, frame in frames.items():
                if ident == me:
                    continue  # never profiles itself into the data
                folded = fold_frame(frame)
                if not folded:
                    continue
                span = trace_mod.span_for_thread(ident)
                key = (
                    _thread_name(ident),
                    span[1] if span else "",
                    span[0] if span else "",
                    _thread_phase.get(ident, ""),
                    folded,
                )
                if key in self._window:
                    self._window[key] += 1
                elif len(self._window) < MAX_WINDOW_GROUPS:
                    self._window[key] = 1
                else:
                    self._truncated += 1
                taken += 1
            groups = len(self._window)
        SAMPLES_TAKEN.inc(taken)
        SAMPLER_STACKS.set(groups)
        SAMPLER_OVERHEAD.set(time.perf_counter() - t0)

    def _close_window(self, force: bool = False) -> None:
        now = time.time()
        with self._lock:
            if not force and now - self._window_start < self.window_s:
                return
            window, self._window = self._window, {}
            truncated, self._truncated = self._truncated, 0
            start, self._window_start = self._window_start, now
        if not window and not truncated:
            return
        samples = [
            {
                "thread": thread,
                **({"span": span} if span else {}),
                **({"trace": trace} if trace else {}),
                **({"phase": ph} if ph else {}),
                "stack": folded,
                "count": count,
            }
            for (thread, span, trace, ph, folded), count in window.items()
        ]
        if truncated:
            samples.append({
                "thread": "(all)", "stack": "(truncated)",
                "count": truncated,
            })
        doc = {
            "target": self.target,
            "start": start,
            "end": now,
            "hz": self.hz,
            "samples": samples,
        }
        if self._sink is not None:
            try:
                self._sink([doc])
                WINDOWS_SHIPPED.inc()
            except Exception:  # noqa: BLE001 — counted, never propagated
                WINDOWS_DROPPED.labels("sink_error").inc()
                logger.debug("profile sink failed", exc_info=True)
        elif self._shipper is not None:
            self._shipper.enqueue(doc)
        else:
            WINDOWS_DROPPED.labels("no_sink").inc()

    def _run(self) -> None:
        interval = 1.0 / self.hz
        while not self._stop_evt.wait(timeout=interval):
            try:
                self._sample_once()
                self._close_window()
            except Exception:  # noqa: BLE001 — profiling never kills a proc
                logger.debug("sampler pass failed", exc_info=True)


# -- module-level singleton (the process's profiler) -------------------------

_profiler: Optional[SamplingProfiler] = None
_profiler_lock = threading.Lock()
_atexit_registered = False


def _register_atexit() -> None:
    global _atexit_registered
    if not _atexit_registered:
        atexit.register(flush_profiler)
        _atexit_registered = True


def start_profiler(
    target: str,
    *,
    master_url: Optional[str] = None,
    token: str = "",
    sink: Optional[Callable[[List[Dict[str, Any]]], Any]] = None,
    hz: Optional[float] = None,
    window_s: Optional[float] = None,
    **shipper_kw: Any,
) -> Optional[SamplingProfiler]:
    """Start (or replace) this process's sampling profiler. With `sink`
    windows go straight to the callable (master in-process); otherwise a
    ProfileShipper is pointed at `master_url` (explicit, or resolved from
    DTPU_PROFILE_INGEST / DTPU_MASTER). Returns None — and profiles
    nothing — when no destination can be resolved."""
    global _profiler
    shipper = None
    if sink is None:
        ingest = os.environ.get(PROFILE_INGEST_ENV, "")
        if ingest.lower() == "off":
            return None
        url = master_url or ingest or os.environ.get("DTPU_MASTER")
        if not url:
            return None
        token = token or os.environ.get("DTPU_SESSION_TOKEN", "")
        try:
            shipper = ProfileShipper(url, token, **shipper_kw)
        except Exception:  # noqa: BLE001 — profiling never breaks the task
            logger.debug("profile shipper config failed", exc_info=True)
            return None
    prof = SamplingProfiler(
        target, hz=hz, window_s=window_s, shipper=shipper, sink=sink
    )
    with _profiler_lock:
        old, _profiler = _profiler, prof
    if old is not None:
        old.stop(flush=False)
    prof.start()
    _register_atexit()
    return prof


def maybe_start_from_env(target: str, **kw: Any) -> Optional[SamplingProfiler]:
    """The task-process entry: starts the profiler iff the launch env
    enables the plane (DTPU_PROFILE=1, injected by the master's
    _build_task_env from the `profiling:` masterconf section)."""
    if os.environ.get(PROFILE_ENV, "0") != "1":
        return None
    return start_profiler(target, **kw)


def stop_profiler(flush: bool = True) -> None:
    global _profiler
    with _profiler_lock:
        prof, _profiler = _profiler, None
    if prof is not None:
        prof.stop(flush=flush)


def flush_profiler() -> None:
    """Synchronously close the current window and drain the shipper
    (harness/agent shutdown, atexit)."""
    prof = _profiler
    if prof is not None:
        try:
            prof.flush()
        except Exception:  # noqa: BLE001
            logger.debug("profiler flush failed", exc_info=True)


def reset_profiler() -> None:
    """Tests / devcluster stop: drop the profiler without flushing."""
    stop_profiler(flush=False)
