"""The port's telemetry shippers and resilience layer against the
reference's, on the CPU.

- ``common/trace.py``: ``traceparent`` parsing over a grid of good and bad
  headers, the ambient context (``DTPU_TRACEPARENT`` inheritance, nested
  spans), the tail-sampling policy (``_keep_span`` under
  ``DTPU_TRACE_SAMPLE`` / ``DTPU_TRACE_SLOW_MS``) and the ``SpanShipper``'s
  ingest bodies: the same spans give the same ``POST
  /api/v1/traces/ingest`` bodies, field for field, and the same
  ``DTPU_TRACE_FILE`` lines.
- ``common/profiling.py``: the same sampled window gives the same ``POST
  /api/v1/profiles/ingest`` body; the sampler tags a sample with its
  thread, span and phase; ``set_phase`` / ``phase`` nest alike;
  ``maybe_start_from_env`` starts nothing without ``DTPU_PROFILE=1`` or a
  destination.
- ``common/logship.py``: the same record gives the same structured line
  and the same ``POST /api/v1/logs/ingest`` body; the level floor and the
  env gate match.
- ``common/resilience.py``: backoff delays, ``Retry-After`` hints,
  ``shed_backoff`` and the circuit breaker's transitions match the
  reference's under an injected clock.

The ingest bodies are read off ``chip_smoke.StandInMaster``, which
records every request.
"""
import logging
import sys
import threading
from pathlib import Path

import pytest
import requests

from determined_tpu.common import logship as jlogship
from determined_tpu.common import profiling as jprofiling
from determined_tpu.common import resilience as jres
from determined_tpu.common import trace as jtrace
from determined_tpu_torch.common import api_session as tsession
from determined_tpu_torch.common import logship as tlogship
from determined_tpu_torch.common import profiling as tprofiling
from determined_tpu_torch.common import resilience as tres
from determined_tpu_torch.common import trace as ttrace

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

TRACE = {"port": ttrace, "reference": jtrace}
PROF = {"port": tprofiling, "reference": jprofiling}
LOGS = {"port": tlogship, "reference": jlogship}
RES = {"port": tres, "reference": jres}


@pytest.fixture
def recorder():
    m = chip_smoke.StandInMaster()
    yield m
    m.stop()


def _bodies(master, path):
    return [b for m, p, h, b in master.requests if p == path]


# -- trace ----------------------------------------------------------------------

TRACEPARENTS = [
    "00-" + "0a" * 16 + "-" + "0b" * 8 + "-01",
    "00-" + "0A" * 16 + "-" + "0B" * 8 + "-00",
    "  00-" + "12" * 16 + "-" + "34" * 8 + "-01  ",
    "ff-" + "0a" * 16 + "-" + "0b" * 8 + "-01",
    "00-" + "0" * 32 + "-" + "0b" * 8 + "-01",
    "00-" + "0a" * 16 + "-" + "0" * 16 + "-01",
    "00-" + "0a" * 15 + "-" + "0b" * 8 + "-01",
    "00-" + "zz" * 16 + "-" + "0b" * 8 + "-01",
    "junk", "", None,
]


@pytest.mark.parametrize("header", TRACEPARENTS)
def test_traceparent_parsing_is_the_references(header):
    assert ttrace.parse_traceparent(header) == jtrace.parse_traceparent(header)
    got = ttrace.parse_traceparent(header)
    if got is not None:
        assert ttrace.format_traceparent(*got) == jtrace.format_traceparent(
            *got)


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_ambient_context_inherits_the_env_and_nests(pkg, monkeypatch):
    mod = TRACE[pkg]
    monkeypatch.delenv("DTPU_MASTER", raising=False)
    monkeypatch.setenv("DTPU_TRACE_INGEST", "off")
    mod.reset_shipper()
    tid, sid = "ab" * 16, "cd" * 8
    monkeypatch.setenv("DTPU_TRACEPARENT", f"00-{tid}-{sid}-01")
    assert mod.current() == (tid, sid)
    assert mod.traceparent() == f"00-{tid}-{sid}-01"
    with mod.span("outer") as (t1, s1):
        assert t1 == tid and s1 != sid
        assert mod.span_for_thread(threading.get_ident()) == (t1, s1)
        with mod.span("inner") as (t2, s2):
            assert t2 == tid and mod.current() == (t2, s2)
        assert mod.current() == (t1, s1)
    assert mod.current() == (tid, sid)
    assert mod.span_for_thread(threading.get_ident()) is None
    monkeypatch.delenv("DTPU_TRACEPARENT")
    assert mod.current() is None
    with mod.span("root", parent=("ef" * 16, "12" * 8)) as (t3, _):
        assert t3 == "ef" * 16
    mod.reset_shipper()


KEEP_GRID = [
    (rate, slow, tid, err, dur)
    for rate, slow in (("", ""), ("0.5", ""), ("0", "100"), ("0.25", "1"),
                       ("junk", "junk"))
    for tid in ("00" * 16, "7f" * 16, "ff" * 16, "zz" * 16)
    for err, dur in ((False, 0.0), (True, 0.0), (False, 0.2), (False, 1.0))
]


@pytest.mark.parametrize("rate,slow", sorted({(r, s) for r, s, *_ in
                                              KEEP_GRID}))
def test_tail_sampling_policy_is_the_references(rate, slow, monkeypatch):
    for name, value in (("DTPU_TRACE_SAMPLE", rate),
                        ("DTPU_TRACE_SLOW_MS", slow)):
        if value:
            monkeypatch.setenv(name, value)
        else:
            monkeypatch.delenv(name, raising=False)
    for r, s, tid, err, dur in KEEP_GRID:
        if (r, s) == (rate, slow):
            assert ttrace._keep_span(tid, err, dur) == jtrace._keep_span(
                tid, err, dur), (tid, err, dur)


SPANS = [
    dict(name="trial.first_step", trace_id="1a" * 16, span_id="2b" * 8,
         parent_span_id="3c" * 8, start=1700000000.25, end=1700000001.5,
         attributes={"step": 1, "ok": True, "rate": 0.5, "who": "x"}),
    dict(name="serving.request", trace_id="4d" * 16, span_id="5e" * 8,
         start=1700000002.0, end=1700000002.75, error=True,
         attributes={"serving.request_id": "req-1"}),
]


def test_span_ingest_bodies_are_the_references(recorder, monkeypatch,
                                               tmp_path):
    bodies = {}
    for pkg, mod in TRACE.items():
        path = tmp_path / f"{pkg}.jsonl"
        monkeypatch.setenv("DTPU_TRACE_FILE", str(path))
        mod.configure_shipper(recorder.url, "tok")
        try:
            for sp in SPANS:
                mod.export_span(**sp)
            mod.flush_shipper()
        finally:
            mod.reset_shipper()
        bodies[pkg] = (_bodies(recorder, "/api/v1/traces/ingest"),
                       path.read_text().splitlines())
        recorder.requests.clear()
    assert bodies["port"] == bodies["reference"]
    (sent,), lines = bodies["port"]
    assert [s["name"] for s in sent["spans"]] == [s["name"] for s in SPANS]
    assert len(lines) == 2


def test_span_shipper_counts_a_failed_ship_and_never_raises(monkeypatch):
    for mod in TRACE.values():
        shipper = mod.SpanShipper("http://127.0.0.1:9", timeout_s=0.5)
        fam = mod.SPANS_DROPPED.labels("ship_failed")
        before = fam.value
        shipper.enqueue({"traceId": "x"})
        shipper.stop(flush=True)
        assert fam.value == before + 1


# -- profiling ------------------------------------------------------------------


def test_profile_window_bodies_are_the_references(recorder, monkeypatch):
    window = {
        ("MainThread", "2b" * 8, "1a" * 16, "step", "a.py:main;b.py:f"): 7,
        ("worker", "", "", "", "a.py:main;c.py:g"): 2,
        ("MainThread", "", "", "checkpoint", "a.py:main;d.py:save"): 1,
    }
    bodies = {}
    for pkg, mod in PROF.items():
        shipper = mod.ProfileShipper(recorder.url, "tok")
        prof = mod.SamplingProfiler("trial:1.r0", hz=19.0, window_s=10.0,
                                    shipper=shipper)
        prof._window = dict(window)
        prof._truncated = 3
        prof._window_start = 1700000000.0
        monkeypatch.setattr(mod.time, "time", lambda: 1700000010.5)
        prof._close_window(force=True)
        monkeypatch.undo()
        shipper.stop(flush=True)
        bodies[pkg] = _bodies(recorder, "/api/v1/profiles/ingest")
        recorder.requests.clear()
    assert bodies["port"] == bodies["reference"]
    (sent,) = bodies["port"]
    (doc,) = sent["windows"]
    assert doc["target"] == "trial:1.r0" and len(doc["samples"]) == 4
    assert {s.get("phase") for s in doc["samples"]} == {"step", "checkpoint",
                                                         None}


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_sampler_tags_thread_span_and_phase(pkg):
    mod, tmod = PROF[pkg], TRACE[pkg]
    windows = []
    prof = mod.SamplingProfiler("t", hz=100.0, window_s=60.0,
                                sink=windows.extend)
    ready, done = threading.Event(), threading.Event()

    def work():
        with tmod.span("busy"), mod.phase("data_wait"):
            ready.set()
            done.wait(10)

    t = threading.Thread(target=work, name="tagged-worker")
    t.start()
    ready.wait(10)
    prof._sample_once()
    done.set()
    t.join()
    prof._close_window(force=True)
    (doc,) = windows
    (sample,) = [s for s in doc["samples"] if s["thread"] == "tagged-worker"]
    assert sample["phase"] == "data_wait" and sample["span"] and sample["trace"]
    assert sample["stack"].endswith("work") or ":work" in sample["stack"]


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_phase_tags_nest_and_clear(pkg):
    mod = PROF[pkg]
    ident = threading.get_ident()
    mod.set_phase("step")
    with mod.phase("checkpoint"):
        assert mod._thread_phase[ident] == "checkpoint"
    assert mod._thread_phase[ident] == "step"
    mod.set_phase(None)
    assert ident not in mod._thread_phase


def test_fold_frame_is_the_references():
    frame = sys._getframe()
    assert tprofiling.fold_frame(frame) == jprofiling.fold_frame(frame)


@pytest.mark.parametrize("env,master", [
    ({}, "http://127.0.0.1:9"),
    ({"DTPU_PROFILE": "0"}, "http://127.0.0.1:9"),
    ({"DTPU_PROFILE": "1", "DTPU_PROFILE_INGEST": "off"}, "http://127.0.0.1:9"),
    ({"DTPU_PROFILE": "1"}, None),
])
def test_profiler_env_gate_is_the_references(env, master, monkeypatch):
    for k in ("DTPU_PROFILE", "DTPU_PROFILE_INGEST", "DTPU_MASTER"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for mod in PROF.values():
        assert mod.maybe_start_from_env("t", master_url=master) is None


# -- structured logs ------------------------------------------------------------


def _record(msg="saved checkpoint %s at step %d", args=("abc", 4),
            level=logging.INFO):
    rec = logging.LogRecord("determined_tpu_torch.trainer", level, "f.py", 7,
                            msg, args, None)
    rec.created = 1700000003.125
    return rec


def test_log_line_bodies_are_the_references(recorder):
    ctx = ("1a" * 16, "2b" * 8)
    bodies = {}
    for pkg, mod in LOGS.items():
        shipper = mod.LogShipper(recorder.url, "tok")
        handler = mod.StructuredLogHandler(
            "trial:1.r0", {"trial": 1, "rank": 0}, shipper=shipper,
            context_fn=lambda: ctx)
        handler.emit(_record())
        handler.emit(_record("bad %d format", ("x",), logging.WARNING))
        shipper.stop(flush=True)
        bodies[pkg] = _bodies(recorder, "/api/v1/logs/ingest")
        recorder.requests.clear()
    assert bodies["port"] == bodies["reference"]
    (sent,) = bodies["port"]
    first = sent["lines"][0]
    assert first["message"] == "saved checkpoint abc at step 4"
    assert (first["trace"], first["span"]) == ctx
    assert first["labels"] == {"trial": "1", "rank": "0"}


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_log_line_takes_the_emitting_threads_span(pkg):
    mod, tmod = LOGS[pkg], TRACE[pkg]
    lines = []
    handler = mod.StructuredLogHandler("t", sink=lines.extend)
    with tmod.span("ctx") as (tid, sid):
        handler.emit(_record())
    handler.emit(_record())
    assert (lines[0]["trace"], lines[0]["span"]) == (tid, sid)
    assert "trace" not in lines[1] or lines[1]["trace"] != tid


@pytest.mark.parametrize("env", [
    {}, {"DTPU_LOG_SHIP": "0"}, {"DTPU_LOG_SHIP": "1", "DTPU_LOG_INGEST": "off"},
    {"DTPU_LOG_SHIP": "1"},
])
def test_log_shipping_env_gate_is_the_references(env, monkeypatch):
    for k in ("DTPU_LOG_SHIP", "DTPU_LOG_INGEST", "DTPU_MASTER"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for mod in LOGS.values():
        assert mod.maybe_start_from_env("t") is None
    for name in ("DEBUG", "warning", "Error", "nope", None, 5):
        assert tlogship.level_no(name) == jlogship.level_no(name)


# -- resilience -----------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {}, {"base_delay": 0.5, "multiplier": 3.0, "max_delay": 7.0},
    {"jitter": 0.0}, {"base_delay": 1.0, "max_delay": 1e308, "jitter": 0.9},
])
def test_backoff_delays_are_the_references(kw):
    ours, theirs = tres.RetryPolicy(**kw), jres.RetryPolicy(**kw)
    for key in ("", "api.post", "storage.upload"):
        assert [ours.delay(a, key) for a in range(12)] == [
            theirs.delay(a, key) for a in range(12)]
    assert tres.API_RETRY.max_attempts == jres.API_RETRY.max_attempts
    assert tres.API_RETRY.max_delay == jres.API_RETRY.max_delay
    assert tres.STORAGE_RETRY == tres.RetryPolicy(
        **{f: getattr(jres.STORAGE_RETRY, f) for f in (
            "max_attempts", "base_delay", "multiplier", "max_delay",
            "deadline_s", "jitter")})


def _http_error(pkg, status, retry_after):
    headers = {} if retry_after is None else {"Retry-After": retry_after}
    if pkg == "port":
        resp = tsession.Response(status, _Headers(headers), b"")
        return tsession.HTTPError("x", response=resp)
    resp = requests.Response()
    resp.status_code = status
    resp.headers.update(headers)
    return requests.HTTPError("x", response=resp)


class _Headers(dict):
    """A case-insensitive header map, as http.client's responses carry."""

    def get(self, key, default=None):
        for k, v in self.items():
            if k.lower() == key.lower():
                return v
        return default


@pytest.mark.parametrize("status,retry_after", [
    (429, "2"), (429, "0.25"), (429, None), (429, "Wed, 21 Oct 2015"),
    (429, "-1"), (429, "60"), (503, "3"), (502, "3"), (404, "1"),
])
def test_retry_after_and_shed_backoff_are_the_references(status, retry_after):
    ours = _http_error("port", status, retry_after)
    theirs = _http_error("reference", status, retry_after)
    assert tres.retry_after_hint(ours) == jres.retry_after_hint(theirs)
    assert tres.shed_backoff(ours) == jres.shed_backoff(theirs)


def test_injected_ingest_backoff_sheds_alike():
    from determined_tpu.common.faults import InjectedFault as JFault
    from determined_tpu_torch.common.faults import InjectedFault as TFault

    for site in ("client.ingest_backoff", "client.trace_ship"):
        assert tres.shed_backoff(TFault(site)) == jres.shed_backoff(
            JFault(site))


def test_circuit_breaker_transitions_are_the_references():
    clock = [0.0]
    states = {}
    for pkg, mod in RES.items():
        clock[0] = 0.0
        b = mod.CircuitBreaker("GET /x", failure_threshold=3,
                               reset_timeout=5.0, clock=lambda: clock[0])
        seen = []
        for event, dt in (("fail", 0), ("fail", 0), ("ok", 0), ("fail", 0),
                          ("fail", 0), ("fail", 0), ("allow", 0),
                          ("allow", 4.0), ("allow", 1.0), ("allow", 0),
                          ("fail", 0), ("allow", 5.0), ("ok", 0),
                          ("allow", 0)):
            clock[0] += dt
            if event == "fail":
                b.record_failure()
            elif event == "ok":
                b.record_success()
            else:
                seen.append(b.allow())
            seen.append((b.state, b.open_until()))
        states[pkg] = seen
    assert states["port"] == states["reference"]


def test_registry_keys_breakers_by_route_shape():
    for mod in RES.values():
        reg = mod.CircuitBreakerRegistry()
        assert reg.get("a") is reg.get("a") and reg.get("a") is not reg.get("b")
    from determined_tpu.common import api_session as jsession

    for path in ("/api/v1/trials/7/metrics", "/api/v1/checkpoints/ab-12",
                 "/api/v1/allocations/trial-7.0/progress", "/api/v1/master",
                 "/api/v2/x/v3"):
        assert tsession._endpoint_key("POST", path) == \
            jsession._endpoint_key("POST", path)


def test_policy_call_counts_retries_and_honours_the_hint():
    fam = tres.RETRIES.labels("unit.test")
    before = fam.value
    pauses = []
    calls = iter([_http_error("port", 429, "0.75"), ConnectionError("x")])

    def fn():
        e = next(calls, None)
        if e is not None:
            raise e
        return "ok"

    policy = tres.RetryPolicy(max_attempts=5, base_delay=0.01, jitter=0.0)
    assert policy.call(fn, key="unit.test", sleep=pauses.append) == "ok"
    assert pauses == [0.75, 0.02]
    assert fam.value == before + 2
    with pytest.raises(tres.CircuitOpenError):
        policy.call(lambda: (_ for _ in ()).throw(
            tres.CircuitOpenError("k", 1.0)), sleep=pauses.append)
    assert len(pauses) == 2  # a circuit-open error is never retried
