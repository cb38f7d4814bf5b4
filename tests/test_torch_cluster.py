"""The port's exec layer on the cluster against the reference's, on the CPU.

- The master session (``common/api_session.py``): the port's ``Session``
  on ``http.client`` and the reference's on ``requests`` go through the
  same drills against one live reference master (``DevCluster``), each
  parametrised over both packages: GET / POST / ``post_bytes`` / PATCH /
  DELETE round trips; a 503 whose mutation landed is retried with the
  same ``X-Request-Id`` and the master applies it once; a 429 with
  ``Retry-After`` is paced by it and counts as a breaker success; a 4xx
  raises at once with no breaker failure; a breaker opens on a dead route
  while a healthy one keeps flowing; ``traceparent`` comes from the
  ambient span, else the session root; TLS against the self-signed
  bootstrap (``DevCluster(tls=True)``); the ``api.*`` fault sites under
  ``DTPU_FAULT_PLAN``; ``dtpu_retries_total``. The 503, 429 and 502
  answers come from a relay in front of the master.
- The same calls through both sessions give the same results and the
  same side effects on the master.
- A port trial launched by the reference agent (``env
  DTPU_ENTRYPOINT=... python -m determined_tpu_torch.exec.harness``):
  a GPT-tiny-shaped fp32 trial warm-started from the reference trial's
  step-2 checkpoint, paused mid-run (preempted: it checkpoints and exits
  0) and activated again; the experiment completes, its losses match the
  reference trial's within 1e-5 relative, its checkpoints carry the
  reference's file names and manifests and verify, the searcher op is
  completed, and the master's trace store assembles submit → … →
  ``trial.run`` → ``trial.first_step``.
- A port SERVING command (``python -m determined_tpu_torch.serving.service
  --device cpu``) through the master's proxy: its SSE streams equal a
  reference replica's over the same fp32 weights, the trace store holds
  its request spans, and the preemption signal drains it (exit 0).
- ``chip_smoke.StandInMaster`` answers each route it serves with the live
  master's keys and value types.
- ``core.init()`` on a cluster returns the live contexts; a gang of two
  is refused by name. A heartbeat's profile-capture directive yields one
  uploaded ``torch.profiler`` trace and one ``complete`` POST, and the
  sampling profiler's windows carry the fit loop's phase tags.
- The launch chain (``python -m determined_tpu_torch.exec.prep_and_run``):
  a trial-class entrypoint runs through the harness, a shell entrypoint
  runs with its exit code, a gang of two rendezvouses through the
  stand-in's table (each process sees its rank and the chief's port), and
  the
  shipped context directory is extracted and made the import root. A
  serving replica's capture directive uploads its trace and reports it.
"""
import glob
import json
import os
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import urlparse

import http.client
import pytest
import requests

from determined_tpu.common import api_session as jsession
from determined_tpu.common import faults as jfaults
from determined_tpu.common import metrics as jmetrics
from determined_tpu.common import resilience as jres
from determined_tpu.common import trace as jtrace
from determined_tpu.devcluster import DevCluster
from determined_tpu_torch import _info as tinfo
from determined_tpu_torch import core as tcore
from determined_tpu_torch.common import api_session as tsession
from determined_tpu_torch.common import faults as tfaults
from determined_tpu_torch.common import metrics as tmetrics
from determined_tpu_torch.common import profiling as tprofiling
from determined_tpu_torch.common import resilience as tres
from determined_tpu_torch.common import trace as ttrace

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

PKGS = ("port", "reference")
MOD = {
    "port": dict(session=tsession, res=tres, faults=tfaults, trace=ttrace,
                 metrics=tmetrics, http_error=tsession.HTTPError,
                 conn_error=ConnectionError),
    "reference": dict(session=jsession, res=jres, faults=jfaults,
                      trace=jtrace, metrics=jmetrics,
                      http_error=requests.HTTPError,
                      conn_error=requests.ConnectionError),
}
PORT_ENTRY = ("env DTPU_ENTRYPOINT={} python -m "
              "determined_tpu_torch.exec.harness")

#: The GPT-tiny shape at fp32 in both packages (the built-in gpt-tiny
#: computes in bf16, whose CPU roundings differ across frameworks).
TRIALS = '''
import numpy as np
GPT_KW = dict(vocab_size=256, n_layers=2, n_heads=4, d_model=64, d_ff=256,
              seq_len=32, remat=False)
try:
    import jax.numpy as jnp
    from determined_tpu.exec.builtin_trials import SyntheticTrial as _J
    from determined_tpu.models import gpt as _jgpt

    class JaxTinyTrial(_J):
        def build_model(self, mesh=None):
            return _jgpt.GPT(_jgpt.GPTConfig(dtype=jnp.float32, **GPT_KW),
                             mesh=mesh)
except ImportError:
    pass
try:
    import torch
    from determined_tpu_torch.exec.builtin_trials import SyntheticTrial as _T
    from determined_tpu_torch.models import gpt as _tgpt

    class PortTinyTrial(_T):
        def build_model(self, device):
            return _tgpt.GPT(_tgpt.GPTConfig(dtype=torch.float32, **GPT_KW),
                             device=device)
except ImportError:
    pass
'''


def _wait(predicate, timeout, what):
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = predicate()
        if got:
            return got
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    with DevCluster(n_agents=1, slots_per_agent=1) as dc:
        _wait(lambda: len(dc.master.agent_hub.list()) == 1, 30, "the agent")
        yield dc


class Relay:
    """An HTTP relay in front of the live master. Each request is
    recorded (method, path, headers) and answered by the next scripted
    action for its path, else forwarded: ``"lost"`` forwards and answers
    503 (the mutation landed, the response was lost), ``("shed", s)``
    answers 429 with ``Retry-After: s``, ``"bad"`` answers 502."""

    def __init__(self, upstream):
        self.upstream = urlparse(upstream)
        self.seen = []
        self.script = {}
        relay = self

        class Handler(BaseHTTPRequestHandler):
            disable_nagle_algorithm = True

            def log_message(self, *a):
                pass

            def _handle(self):
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n else b""
                path = self.path.split("?")[0]
                relay.seen.append((self.command, path,
                                   dict(self.headers.items()), time.time()))
                actions = relay.script.get(path) or []
                action = actions.pop(0) if actions else "forward"
                extra = {}
                if action in ("forward", "lost"):
                    status, data, ctype = relay._forward(
                        self.command, self.path, body, self.headers)
                    if action == "lost":
                        status, data = 503, b'{"error": "lost"}'
                elif action == "bad":
                    status, data, ctype = 502, b"{}", "application/json"
                else:
                    status, data = 429, b'{"error": "shed"}'
                    ctype = "application/json"
                    extra["Retry-After"] = str(action[1])
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for k, v in extra.items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = do_PATCH = do_DELETE = _handle

        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._srv.daemon_threads = True
        threading.Thread(target=self._srv.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self._srv.server_address[1]}"

    def _forward(self, method, target, body, headers):
        conn = http.client.HTTPConnection(self.upstream.hostname,
                                          self.upstream.port, timeout=30)
        try:
            hdrs = {k: v for k, v in headers.items()
                    if k.lower() not in ("host", "connection")}
            conn.request(method, target, body=body or None, headers=hdrs)
            resp = conn.getresponse()
            return (resp.status, resp.read(),
                    resp.getheader("Content-Type") or "application/json")
        finally:
            conn.close()

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()


@pytest.fixture
def relay(cluster):
    r = Relay(cluster.api.url)
    yield r
    r.stop()


def _session(pkg, url, attempts=4, **kw):
    m = MOD[pkg]
    return m["session"].Session(url, retry_policy=m["res"].RetryPolicy(
        max_attempts=attempts, base_delay=0.01, max_delay=2.0, jitter=0.0),
        **kw)


def _retries(pkg, key):
    return MOD[pkg]["metrics"].REGISTRY.get("dtpu_retries_total").labels(
        key).value


# -- the master session ---------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_session_round_trips(cluster, pkg):
    s = MOD[pkg]["session"].Session(cluster.api.url)
    name = f"tmpl-{pkg}"
    assert s.post("/api/v1/templates",
                  json_body={"name": name, "config": {"a": 1}}) == {"name": name}
    assert s.get(f"/api/v1/templates/{name}")["config"] == {"a": 1}
    fid = s.post_bytes("/api/v1/files", b"\x00context-bytes\xff")["id"]
    assert s.get_bytes(f"/api/v1/files/{fid}") == b"\x00context-bytes\xff"
    ws = s.post("/api/v1/workspaces", json_body={"name": f"ws-rt-{pkg}"})
    assert s.get("/api/v1/workspaces", params={"unused": None})["workspaces"]
    assert s.delete(f"/api/v1/templates/{name}") is not None
    with pytest.raises(MOD[pkg]["http_error"]) as err:
        s.get(f"/api/v1/templates/{name}")
    assert err.value.response.status_code == 404
    exp = cluster.master.db
    assert ws["id"] in {w["id"] for w in exp.list_workspaces()}
    exp_id = exp.add_experiment({"description": "d"}, state="CANCELED")
    patched = s.patch(f"/api/v1/experiments/{exp_id}",
                      json_body={"description": f"by-{pkg}"})
    assert patched["experiment"]["description"] == f"by-{pkg}"
    assert exp.get_experiment(exp_id)["description"] == f"by-{pkg}"


@pytest.mark.parametrize("pkg", PKGS)
def test_lost_response_is_retried_with_one_request_id(cluster, relay, pkg):
    before = _retries(pkg, "api.post")
    relay.script["/api/v1/workspaces"] = ["lost"]
    name = f"ws-lost-{pkg}"
    out = _session(pkg, relay.url).post("/api/v1/workspaces",
                                        json_body={"name": name})
    posts = [h for m, p, h, _ in relay.seen if m == "POST"]
    assert len(posts) == 2
    assert posts[0]["X-Request-Id"] == posts[1]["X-Request-Id"]
    names = [w["name"] for w in cluster.master.db.list_workspaces()]
    assert names.count(name) == 1  # the master replayed, not re-applied
    assert out["id"] in {w["id"] for w in cluster.master.db.list_workspaces()}
    assert _retries(pkg, "api.post") == before + 1
    # a second logical POST carries a fresh id
    _session(pkg, relay.url).post("/api/v1/workspaces",
                                  json_body={"name": name + "-2"})
    assert relay.seen[-1][2]["X-Request-Id"] != posts[0]["X-Request-Id"]
    gets = [h for m, p, h, _ in relay.seen if m == "GET"]
    assert not gets
    _session(pkg, relay.url).get("/api/v1/workspaces")
    assert "X-Request-Id" not in relay.seen[-1][2]


@pytest.mark.parametrize("pkg", PKGS)
def test_shed_429_is_paced_by_retry_after(relay, pkg):
    relay.script["/api/v1/master"] = [("shed", 0.3)]
    s = _session(pkg, relay.url)
    assert "cluster_id" in s.get("/api/v1/master")
    (_, _, _, t0), (_, _, _, t1) = relay.seen
    assert 0.3 <= t1 - t0 < 1.5
    breaker = s._breakers.get(MOD[pkg]["session"]._endpoint_key(
        "GET", "/api/v1/master"))
    assert breaker.state == "closed" and breaker._s.failures == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_4xx_raises_at_once_without_a_breaker_failure(relay, pkg):
    s = _session(pkg, relay.url)
    with pytest.raises(MOD[pkg]["http_error"]) as err:
        s.get("/api/v1/trials/987654")
    assert err.value.response.status_code == 404
    assert len(relay.seen) == 1
    key = MOD[pkg]["session"]._endpoint_key("GET", "/api/v1/trials/987654")
    assert key == "GET /api/v1/trials/{id}"
    assert s._breakers.get(key)._s.failures == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_breaker_opens_on_a_dead_route_while_others_flow(relay, pkg):
    dead = "/api/v1/experiments/4242/trials"
    relay.script[dead] = ["bad"] * 8
    s = _session(pkg, relay.url, attempts=8)
    with pytest.raises(MOD[pkg]["http_error"]) as err:
        s.get(dead)
    assert err.value.response.status_code == 502
    t0 = time.monotonic()
    with pytest.raises(MOD[pkg]["res"].CircuitOpenError):
        s.get(dead)
    assert time.monotonic() - t0 < 0.5
    assert len([p for _, p, _, _ in relay.seen if p == dead]) == 8
    assert "cluster_id" in s.get("/api/v1/master")  # a healthy route


@pytest.mark.parametrize("pkg", PKGS)
def test_traceparent_from_the_span_else_the_session_root(relay, pkg):
    m = MOD[pkg]
    s = _session(pkg, relay.url)
    with m["trace"].span("client.op") as (trace_id, span_id):
        s.get("/api/v1/master")
    assert relay.seen[-1][2]["traceparent"] == f"00-{trace_id}-{span_id}-01"
    s.TRACE_ROOT_MAX_USES = 2
    s.get("/api/v1/master")
    s.get("/api/v1/master")
    s.get("/api/v1/master")
    roots = [m["trace"].parse_traceparent(h["traceparent"])
             for _, _, h, _ in relay.seen[-3:]]
    assert roots[0] == roots[1] != roots[2]
    assert roots[0][0] != trace_id


@pytest.mark.parametrize("pkg", PKGS)
def test_tls_self_signed_bootstrap(pkg):
    from determined_tpu.common.tls import CERT_ENV

    with DevCluster(n_agents=0, tls=True) as dc:
        url = dc.api.url
        assert url.startswith("https://")
        cert = os.environ[CERT_ENV]
        Session = MOD[pkg]["session"].Session
        assert "cluster_id" in Session(url).get("/api/v1/master")
        assert "cluster_id" in Session(url, cert=cert).get("/api/v1/master")
        assert "cluster_id" in Session(url, cert="noverify").get(
            "/api/v1/master")
        # the system store does not know the self-signed certificate
        with pytest.raises(Exception) as err:
            _session(pkg, url, attempts=1, cert="").get("/api/v1/master")
        assert "CERTIFICATE_VERIFY_FAILED" in str(err.value) or \
            "certificate verify failed" in str(err.value)


@pytest.mark.parametrize("pkg", PKGS)
def test_api_fault_sites_under_the_env_plan(relay, monkeypatch, pkg):
    fmod = MOD[pkg]["faults"]
    before = _retries(pkg, "api.post")
    monkeypatch.setenv("DTPU_FAULT_PLAN", json.dumps(
        {"api.post": {"failures": 2}, "api.get": {"failures": 1}}))
    fmod.clear()
    try:
        s = _session(pkg, relay.url)
        assert s.post("/api/v1/templates", json_body={
            "name": f"fault-{pkg}", "config": {}}) == {"name": f"fault-{pkg}"}
        assert "cluster_id" in s.get("/api/v1/master")
        stats = fmod.active().stats()
    finally:
        monkeypatch.delenv("DTPU_FAULT_PLAN")
        fmod.clear()
    assert stats["api.post"]["injected"] == 2
    assert stats["api.get"]["injected"] == 1
    # injected attempts never reach the wire
    assert [m for m, _, _, _ in relay.seen] == ["POST", "GET"]
    assert _retries(pkg, "api.post") == before + 2
    with fmod.plan_active(fmod.FaultPlan({"api.delete": fmod.FaultSpec(
            failures=5)})):
        with pytest.raises(fmod.InjectedFault):
            _session(pkg, relay.url, attempts=3).delete(
                f"/api/v1/templates/fault-{pkg}")


def _timeless(v):
    """`v` with its wall-clock stamps replaced by their types."""
    if isinstance(v, dict):
        return {k: type(x).__name__ if k.endswith("_at") or k == "last_seen"
                else _timeless(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_timeless(x) for x in v]
    return v


def test_sessions_agree_on_results_and_side_effects(cluster):
    db = cluster.master.db
    out = {}
    for pkg in PKGS:
        s = MOD[pkg]["session"].Session(cluster.api.url)
        res = [
            s.post("/api/v1/templates",
                   json_body={"name": "same", "config": {"k": [1, 2]}}),
            s.get("/api/v1/templates/same"),
            s.get("/api/v1/master"),
            s.post("/api/v1/workspaces", json_body={"name": f"ws-same-{pkg}"}),
            s.delete("/api/v1/templates/same"),
        ]
        res[3] = {k: type(v) for k, v in res[3].items()}
        out[pkg] = (_timeless(res), sorted(t["name"] for t in db.list_templates()))
    assert out["port"] == out["reference"]
    assert "same" not in out["port"][1]
    names = [w["name"] for w in db.list_workspaces()]
    assert names.count("ws-same-port") == names.count("ws-same-reference") == 1


# -- a port trial and a port serving replica as tasks of the master ------------


@pytest.fixture(scope="module")
def trial_module(tmp_path_factory):
    d = tmp_path_factory.mktemp("trials")
    (d / "tiny_trials.py").write_text(TRIALS)
    return str(d)


def _trial_config(tmp, trial_module, entrypoint, **hp):
    return {
        "entrypoint": entrypoint,
        "searcher": {"name": "single", "max_length": 6, "metric": "loss"},
        "hyperparameters": {"batch_size": 2, "seq_len": 32, "lr": 1e-2,
                            "model": "gpt-tiny", **hp},
        "resources": {"slots_per_trial": 1},
        "scheduling_unit": 1,
        "min_checkpoint_period": {"batches": 2},
        "checkpoint_storage": {"type": "shared_fs",
                               "host_path": str(tmp / "ckpt"),
                               "save_trial_latest": 10},
        "environment": {"jax_platform": "cpu", "variables": {
            "PYTHONPATH": f"{trial_module}{os.pathsep}{ROOT}",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=1"}},
        "max_restarts": 0,
    }


def _losses(db, trial_id):
    rows = db.get_metrics(trial_id, "training")
    return {r["steps_completed"]: r["body"]["loss"] for r in rows}


def _manifest_files(root, uuid):
    """{file: its size} of a checkpoint's manifest; the JSON metadata
    files' sizes follow their numbers, so only their names count."""
    with open(os.path.join(root, uuid, "manifest.json")) as f:
        return {name: entry.get("size") if name.endswith(".npy") else None
                for name, entry in json.load(f)["files"].items()}


def _spans(master, trace_id):
    """The spans of one assembled trace in the master's trace store."""
    out, todo = [], list((master.tracestore.get(trace_id) or {}).get(
        "tree", []))
    while todo:
        node = todo.pop()
        out.append(node)
        todo.extend(node["children"])
    return out


def _span_names(master, trace_id):
    return {s["name"] for s in _spans(master, trace_id)}


def _task_log(db, trial_id):
    return "\n".join(ln["log"] for ln in db.get_task_logs(
        f"trial-{trial_id}"))[-3000:]


def test_port_trial_runs_as_a_task_of_the_reference_agent(
        cluster, tmp_path, trial_module):
    from determined_tpu.storage.base import verify_checkpoint_dir

    master, db = cluster.master, cluster.master.db
    store = str(tmp_path / "ckpt")
    ref_id = cluster.create_experiment(_trial_config(
        tmp_path, trial_module, "tiny_trials:JaxTinyTrial"))
    state = cluster.wait_experiment(ref_id, timeout=240)
    (ref_trial,) = db.list_trials(ref_id)
    assert state == "COMPLETED", _task_log(db, ref_trial["id"])
    ref_ckpts = {c["steps_completed"]: c
                 for c in db.list_checkpoints(ref_trial["id"])}
    assert sorted(ref_ckpts) == [2, 4, 6]
    want = _losses(db, ref_trial["id"])
    assert sorted(want) == [1, 2, 3, 4, 5, 6]

    # the port trial: the same config on the port's entrypoint, warm-
    # started from the reference's step-2 checkpoint (as a fork does)
    sess = jsession.Session(cluster.api.url)
    submit_trace = sess._trace_root[0]
    cfg = _trial_config(tmp_path, trial_module,
                        PORT_ENTRY.format("tiny_trials:PortTinyTrial"),
                        sleep_s=1.0)
    cfg["warm_start_checkpoint"] = ref_ckpts[2]["uuid"]
    port_id = sess.post("/api/v1/experiments", json_body={"config": cfg})["id"]
    exp = master.get_experiment(port_id)
    trial_id = _wait(lambda: (db.list_trials(port_id) or [{}])[0].get("id"),
                     60, "the port trial")
    _wait(lambda: db.get_metrics(trial_id, "training")
          or exp.state not in ("ACTIVE", "RUNNING"), 120,
          "the port trial's first report")
    assert db.get_metrics(trial_id, "training"), (exp.state, _task_log(
        db, trial_id))
    exp.pause()  # preemption: the trial checkpoints and exits 0
    _wait(lambda: exp.state == "PAUSED" and db.get_trial(trial_id)[
        "latest_checkpoint"] and not master._trial_allocs.get(trial_id),
        120, "the preempted trial to drain")
    preempted = db.get_checkpoint(db.get_trial(trial_id)["latest_checkpoint"])
    assert 3 <= preempted["steps_completed"] < 6
    exp.activate()
    assert exp.wait_done(timeout=240) == "COMPLETED", _task_log(db, trial_id)
    row = db.get_trial(trial_id)
    assert row["state"] == "COMPLETED" and row["steps_completed"] == 6
    assert row["searcher_metric"] is not None  # searcher/completed
    rows = db.get_metrics(trial_id, "training")
    assert sorted(r["steps_completed"] for r in rows) == [3, 4, 5, 6]
    assert len({r["trial_run_id"] for r in rows}) == 2  # resumed once
    got = _losses(db, trial_id)
    for step in (3, 4, 5, 6):
        assert got[step] == pytest.approx(want[step], rel=1e-5), step
    ckpts = db.list_checkpoints(trial_id)
    assert {c["steps_completed"] for c in ckpts} >= {preempted[
        "steps_completed"], 6}
    ref_files = set(ref_ckpts[6]["resources"])
    ref_manifest = _manifest_files(store, ref_ckpts[6]["uuid"])
    for c in ckpts:
        assert set(c["resources"]) == ref_files, c["resources"]
        assert _manifest_files(store, c["uuid"]) == ref_manifest
        assert verify_checkpoint_dir(os.path.join(store, c["uuid"]))
    # one assembled lifecycle trace: submit → … → trial.run → first step
    names = _wait(lambda: {"trial.run", "trial.fit", "trial.first_step"}
                  <= _span_names(master, submit_trace) and _span_names(
                      master, submit_trace),
                  30, "the trial's spans in the trace store")
    assert any("POST" in n and n.endswith("experiments$") for n in names), \
        names
    segments = {s["segment"] for s in master.tracestore.critical_path(
        submit_trace)}
    assert {"submit", "first_step", "total"} <= segments, segments


FIXTURE_SERVING = {"model": "fixture", "page_size": 16, "num_pages": 65,
                   "max_pages_per_request": 4, "max_batch_size": 4,
                   "prefill_rows": 2, "prefill_seq": 64, "max_new_tokens": 16,
                   "max_queue_depth": 32}


def test_port_serving_command_through_the_master_proxy(
        cluster, tmp_path, monkeypatch):
    import jax

    from determined_tpu.models import gpt as jgpt
    from determined_tpu.serving import loadgen as jloadgen
    from determined_tpu.serving import service as jservice
    from determined_tpu.serving.fixture import fixture_model_config
    from determined_tpu.storage.base import MANIFEST_FILE, file_digest
    from determined_tpu.trainer import _checkpoint as jckpt
    from determined_tpu_torch.serving import loadgen

    master = cluster.master
    tree = jax.device_get(jgpt.GPT(fixture_model_config()).init(
        jax.random.PRNGKey(3)))
    written = jckpt.save_pytree(tree, str(tmp_path))
    (tmp_path / MANIFEST_FILE).write_text(json.dumps({"version": 1, "files": {
        r: file_digest(str(tmp_path / r)) for r in written}}))
    # The master keeps no DTPU_* variable of a task's config (nor the
    # DTPU_SERVING_CONFIG it sets itself), so the replica's serving section
    # and checkpoint ride its entrypoint.
    task_id = jsession.Session(cluster.api.url).post("/api/v1/commands",
                                                    json_body={"config": {
        "task_type": "SERVING",
        "entrypoint": (
            f"env DTPU_SERVING_CHECKPOINT={tmp_path} python -m "
            "determined_tpu_torch.serving.service --device cpu --config "
            f"'{json.dumps(FIXTURE_SERVING)}'"),
        "serving": FIXTURE_SERVING,
    }})["task_id"]
    cmd = lambda: next(c for c in master.list_commands()  # noqa: E731
                       if c["task_id"] == task_id)
    _wait(lambda: master.proxy.target(task_id) or cmd()["state"] ==
          "TERMINATED", 120, "the replica's proxy registration")
    assert master.proxy.target(task_id), "\n".join(
        ln["log"] for ln in master.db.get_task_logs(task_id))[-3000:]
    prompts = jloadgen.zipf_prefix_prompts(
        8, corpus_size=2, prefix_len=20, suffix_len=6, seed=3, vocab=1000)
    ours = loadgen.drive(f"{cluster.api.url}/proxy/{task_id}/", 8, 4,
                         max_new_tokens=8, prompts=prompts, timeout_s=120)
    assert ours.completed == 8, ([t.error for t in ours.traces], "\n".join(
        ln["log"] for ln in master.db.get_task_logs(task_id))[-3000:])
    # the reference replica over the same weights
    monkeypatch.setenv("DTPU_SERVING_CHECKPOINT", str(tmp_path))
    jeng = jservice.build_engine(FIXTURE_SERVING)
    jeng.start()
    srv = jservice.GenerationServer(jeng, host="127.0.0.1")
    srv.start()
    try:
        theirs = loadgen.drive(srv.url, 8, 4, max_new_tokens=8,
                               prompts=prompts, timeout_s=120)
    finally:
        srv.stop()
        jeng.stop()
    assert [t.token_ids for t in ours.traces] == [
        t.token_ids for t in theirs.traces]
    assert all(len(t.token_ids) == 8 for t in ours.traces)
    # the replica's request spans reached the trace store
    found = _wait(lambda: [t["trace_id"] for t in master.tracestore.search(
        limit=200) if "serving.request" in _span_names(
            master, t["trace_id"])], 30, "serving spans")
    assert {"serving.request", "serving.queue", "serving.prefill",
            "serving.decode"} <= _span_names(master, found[0])
    # preemption drains the replica: exit 0
    master.alloc_service.signal_preempt(cmd()["alloc_id"])
    _wait(lambda: cmd()["state"] == "TERMINATED", 60, "the replica to exit")
    assert cmd()["exit_code"] == 0


# -- the stand-in master stays honest ---------------------------------------------


def _shape(v):
    if isinstance(v, dict):
        return {k: _shape(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_shape(v[0])] if v else []
    return type(v).__name__


def test_stand_in_resize_answers_like_the_live_master(cluster):
    """The elastic resize's answers: the directive on a stale beat and on
    a stale preemption poll, and the 409 of both rendezvous routes, with
    the live master's keys and value types."""
    master = cluster.master
    alloc = "honest-resize.1.0"
    master.alloc_service.create(alloc, task_id="honest-resize",
                                trial_id=None, num_processes=2, slots=0,
                                rank_agents={0: "agent-0", 1: "agent-1"})
    stand_in = chip_smoke.StandInMaster()
    stand_in.rendezvous_size = 2
    try:
        for r in range(2):
            master.alloc_service.rendezvous_arrive(alloc, r, f"10.0.0.{r}",
                                                   generation=0)
        live = master.alloc_service.resize(alloc, lost_ranks=[1],
                                           reason="reclaimed")
        stand = stand_in.resize(alloc, [1], "reclaimed")
        assert stand == live
        calls = [
            ("POST", f"/api/v1/allocations/{alloc}/progress",
             {"rank": 0, "step": 3, "generation": 0}),
            ("GET", f"/api/v1/allocations/{alloc}/signals/preemption",
             {"timeout_seconds": 5, "generation": 0}),
            ("POST", f"/api/v1/allocations/{alloc}/rendezvous",
             {"rank": 0, "addr": "127.0.0.1:1:2", "generation": 0}),
            ("GET", f"/api/v1/allocations/{alloc}/rendezvous",
             {"timeout_seconds": 5, "generation": 0}),
        ]
        for method, path, body in calls:
            answers = []
            for url in (cluster.api.url, stand_in.url):
                s = tsession.Session(url, max_retries=0)
                t0 = time.time()
                try:
                    answers.append((200, s.get(path, params=body)
                                    if method == "GET"
                                    else s.post(path, json_body=body)))
                except tsession.HTTPError as e:
                    answers.append((e.response.status_code,
                                    e.response.json()))
                assert time.time() - t0 < 4, (url, path)  # no long-poll
            (live_code, live_body), (stand_code, stand_body) = answers
            assert stand_code == live_code, (path, answers)
            assert _shape(stand_body) == _shape(live_body), (path, answers)
            assert stand_body["resize"] == live, path
        assert live_code == 409 and stand_body["generation"] == 1
    finally:
        stand_in.stop()
        master.alloc_service.complete(alloc, exit_code=0, reason="")


def test_stand_in_master_answers_like_the_live_master(cluster, tmp_path,
                                                      trial_module):
    master = cluster.master
    exp_id = cluster.create_experiment(dict(_trial_config(
        tmp_path, trial_module, PORT_ENTRY.format(
            "tiny_trials:PortTinyTrial")), searcher={
        "name": "single", "max_length": 2, "metric": "loss"}))
    assert cluster.wait_experiment(exp_id, timeout=120) == "COMPLETED"
    (trial,) = master.db.list_trials(exp_id)
    tid = trial["id"]
    alloc = "honest.1.0"
    master.alloc_service.create(alloc, task_id="honest", trial_id=tid,
                                num_processes=1, slots=0)
    cap = master.profilestore.request_capture("trial", str(tid))
    assert master.profilestore.pop_capture("trial", str(tid))["id"] == \
        cap["id"]  # delivered, as a heartbeat would
    stand_in = chip_smoke.StandInMaster(op_length=2)
    try:
        calls = [
            ("POST", f"/api/v1/trials/{tid}/metrics", {
                "group": "training", "steps_completed": 1, "trial_run_id": 0,
                "metrics": {"loss": 1.0}, "report_time": time.time()}),
            ("POST", f"/api/v1/trials/{tid}/progress", {"progress": 0.5}),
            ("POST", f"/api/v1/trials/{tid}/status", {"status": "ok"}),
            ("POST", f"/api/v1/trials/{tid}/searcher/progress",
             {"progress": 1.0}),
            ("POST", "/api/v1/checkpoints", {
                "uuid": "0b0c0d0e-1111-2222-3333-444455556666",
                "task_id": "honest", "allocation_id": alloc, "trial_id": tid,
                "resources": ["a.npy", "metadata.json", "manifest.json"],
                "metadata": {"steps_completed": 1}, "state": "COMPLETED"}),
            ("GET", f"/api/v1/trials/{tid}/checkpoints", None),
            ("POST", f"/api/v1/allocations/{alloc}/progress",
             {"rank": 0, "step": 1, "generation": 0}),
            ("GET", f"/api/v1/allocations/{alloc}/signals/preemption?"
                    "timeout_seconds=0", None),
            ("POST", f"/api/v1/allocations/{alloc}/signals/ack_preemption",
             None),
            ("POST", f"/api/v1/allocations/{alloc}/proxy", {"port": 8123}),
            ("POST", f"/api/v1/allocations/{alloc}/rendezvous",
             {"rank": 0, "addr": "127.0.0.1:1:2", "generation": 0}),
            ("GET", f"/api/v1/allocations/{alloc}/rendezvous?"
                    "timeout_seconds=5&generation=0", None),
            ("POST", "/api/v1/traces/ingest", {"spans": []}),
            ("POST", "/api/v1/profiles/ingest", {"windows": []}),
            ("POST", "/api/v1/logs/ingest", {"lines": []}),
            ("POST", f"/api/v1/profiles/captures/{cap['id']}/complete",
             {"artifact": "profile-capture-x", "error": ""}),
            ("POST", f"/api/v1/trials/{tid}/searcher/completed",
             {"length": 2, "metric": 0.5}),
            ("GET", f"/api/v1/trials/{tid}/searcher/operation", None),
        ]
        served = {(m, p) for m, p, _ in chip_smoke.StandInMaster.ROUTES}
        import re

        covered = set()
        for method, path, body in calls:
            answers = []
            for url in (cluster.api.url, stand_in.url):
                s = tsession.Session(url)
                if method == "GET":
                    target, _, query = path.partition("?")
                    params = dict(q.split("=") for q in query.split("&")
                                  if q)
                    answers.append(s.get(target, params=params or None))
                else:
                    answers.append(s.post(path, json_body=body))
            live, stand = answers
            if path.endswith("/searcher/operation"):
                live = stand = {k: type(v).__name__ for k, v in live.items()}
            assert _shape(stand) == _shape(live), (method, path, live, stand)
            covered |= {(m, p) for m, p in served if m == method and
                        re.fullmatch(p, path.split("?")[0])}
        assert covered == served
        # the operation's shape while the searcher still has work
        live_op = {"op": {"length": 6}, "completed": False}
        assert _shape(tsession.Session(stand_in.url).get(
            "/api/v1/trials/5/searcher/operation")) == _shape(live_op)
    finally:
        stand_in.stop()
        master.alloc_service.complete(alloc, exit_code=0, reason="")


# -- core.init() on a cluster, the profile capture ----------------------------


def _cluster_env(monkeypatch, url, tmp_path, **extra):
    for k in [k for k in os.environ if k.startswith("DTPU_")]:
        monkeypatch.delenv(k)
    env = tinfo.ClusterInfo(
        master_url=url, cluster_id="c", agent_id="a", session_token="tok",
        task_id="trial-1", allocation_id="1.1.0", task_type="TRIAL",
        trial=tinfo.TrialInfo(trial_id=1, experiment_id=1, trial_seed=0,
                              hparams={}, config={}, latest_checkpoint=None),
        checkpoint_storage={"type": "shared_fs",
                            "host_path": str(tmp_path / "ckpt")}).to_env()
    for k, v in {**env, **extra}.items():
        monkeypatch.setenv(k, v)
    tinfo.reset_cluster_info_cache()


def test_core_init_on_a_cluster_returns_the_cluster_contexts(
        monkeypatch, tmp_path):
    stand_in = chip_smoke.StandInMaster(op_length=3)
    try:
        _cluster_env(monkeypatch, stand_in.url, tmp_path)
        with tcore.init() as ctx:
            assert isinstance(ctx.train, tcore.TrainContext)
            assert not isinstance(ctx.train, tcore.DummyTrainContext)
            assert isinstance(ctx.preempt, tcore.PreemptContext)
            assert isinstance(ctx.searcher, tcore.SearcherContext)
            assert ctx.info.trial.trial_id == 1 and ctx.info.master_url == \
                stand_in.url
            assert ctx.checkpoint._storage.base_path == str(tmp_path / "ckpt")
            assert [op.length for op in [next(iter(
                ctx.searcher.operations()))]] == [3]
            assert ctx.preempt.should_preempt() is False
            stand_in.preempt("1.1.0")
            _wait(ctx.preempt.should_preempt, 10, "the preemption signal")
            assert "1.1.0" in stand_in.acked
        assert all(h["Authorization"] == "Bearer tok"
                   for _, _, h, _ in stand_in.requests)
        # A rendezvous of two processes makes a gang: torch.distributed
        # joined at the coordinator with an explicit timeout, gloo on the
        # CPU, and no gang at all without a card unless the CPU is asked
        # for. (Gangs that run: tests/test_torch_gang.py and
        # tests/test_torch_rendezvous.py.)
        import datetime

        import torch
        import torch.distributed as tdist

        monkeypatch.setenv("DTPU_RENDEZVOUS_INFO", json.dumps({
            "container_addrs": ["a", "b"], "container_rank": 1,
            "coordinator_address": "a:1", "num_processes": 2}))
        tinfo.reset_cluster_info_cache()
        joined = []

        class Joined(Exception):
            pass

        def record(backend, **kw):
            joined.append((backend, kw))
            raise Joined

        monkeypatch.setattr(tdist, "init_process_group", record)
        with pytest.raises(Joined):
            tcore.init(device="cpu")
        assert joined == [("gloo", dict(
            init_method="tcp://a:1", rank=1, world_size=2,
            timeout=datetime.timedelta(seconds=600)))]
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        from determined_tpu_torch import CudaUnavailableError

        with pytest.raises(CudaUnavailableError):
            tcore.init()
        assert len(joined) == 1
    finally:
        stand_in.stop()
        tinfo.reset_cluster_info_cache()
    # off the cluster: the dummy contexts
    monkeypatch.delenv("DTPU_MASTER")
    monkeypatch.delenv("DTPU_RENDEZVOUS_INFO")
    tinfo.reset_cluster_info_cache()
    ctx = tcore.init()
    assert ctx.distributed.is_chief and ctx.info is None
    ctx = tcore._dummy_init(checkpoint_storage=str(tmp_path))
    assert ctx.checkpoint._storage.base_path == str(tmp_path)


def test_profile_capture_and_phase_tags_on_the_cpu(monkeypatch, tmp_path,
                                                   trial_module):
    sys.path.insert(0, trial_module)
    import tiny_trials

    from determined_tpu_torch.storage.base import verify_checkpoint_dir
    from determined_tpu_torch.trainer import Batch, Trainer

    stand_in = chip_smoke.StandInMaster(op_length=6)
    stand_in.capture_at_step, stand_in.capture_steps = 2, 2
    try:
        _cluster_env(monkeypatch, stand_in.url, tmp_path)
        ttrace.reset_shipper()  # re-resolved from this DTPU_MASTER
        prof = tprofiling.start_profiler("trial:1.r0", master_url=stand_in.url,
                                         token="tok", hz=200.0, window_s=0.2)
        with ttrace.span("test.root") as (trace_id, _):
            with tcore.init() as ctx:
                trainer = Trainer(tiny_trials.PortTinyTrial(
                    {"model": "gpt-tiny", "batch_size": 2, "seq_len": 32,
                     "sleep_s": 0.05}),
                    ctx, device="cpu")
                trainer.fit(checkpoint_period=Batch(3),
                            report_period=Batch(1))
        tprofiling.stop_profiler(flush=True)
        ttrace.flush_shipper()
    finally:
        stand_in.stop()
        tprofiling.reset_profiler()
        ttrace.reset_shipper()
        tinfo.reset_cluster_info_cache()
        sys.path.remove(trial_module)
    assert prof is not None
    (cid, cap), = stand_in.captures.items()
    assert cap["artifact"] == f"profile-capture-{cid}" and not cap["error"]
    files = glob.glob(str(tmp_path / "ckpt" / cap["artifact"] / "*.pt.trace.json"))
    assert len(files) == 1
    completes = [p for m, p, _, _ in stand_in.requests
                 if p.endswith("/complete")]
    assert completes == [f"/api/v1/profiles/captures/{cid}/complete"]
    phases = {s.get("phase") for w in stand_in.windows for s in w["samples"]}
    assert {"step", "data_wait", "report"} <= phases, phases
    # the live contexts did the rest: metrics, checkpoints, the searcher
    steps = [b["steps_completed"] for m, p, _, b in stand_in.requests
             if p == "/api/v1/trials/1/metrics" and b["group"] == "training"]
    assert steps == [1, 2, 3, 4, 5, 6]
    assert stand_in.completed[1]["length"] == 6
    assert sorted(b["metadata"]["steps_completed"]
                  for b in stand_in.checkpoints.values()) == [3, 6]
    for u in stand_in.checkpoints:
        assert verify_checkpoint_dir(str(tmp_path / "ckpt" / u))
    names = {s["name"] for s in stand_in.spans if s["traceId"] == trace_id}
    assert {"test.root", "trial.fit", "trial.first_step"} <= names


# -- the launch chain and the replica's capture --------------------------------


def test_prep_and_run_launches_a_trial_class_and_a_shell_command(tmp_path):
    stand_in = chip_smoke.StandInMaster(op_length=2)
    env = {k: v for k, v in os.environ.items() if not k.startswith("DTPU_")}
    env.update(
        DTPU_MASTER=stand_in.url, DTPU_SESSION_TOKEN="tok",
        DTPU_ALLOCATION_ID="1.1.0", DTPU_TASK_ID="trial-1",
        DTPU_JAX_PLATFORM="cpu", DTPU_TRIAL_ID="1", PYTHONPATH=str(ROOT),
        DTPU_HPARAMS=json.dumps({"model": "mnist-mlp", "batch_size": 4}),
        DTPU_EXPERIMENT_CONFIG=json.dumps({"scheduling_unit": 1,
                                           "tensorboard": False}),
        DTPU_CHECKPOINT_STORAGE=json.dumps(
            {"type": "shared_fs", "host_path": str(tmp_path)}),
        DTPU_RENDEZVOUS_INFO="stale", TMPDIR=str(tmp_path))
    cmd = [sys.executable, "-m", "determined_tpu_torch.exec.prep_and_run"]
    try:
        out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=120, env=dict(
            env, DTPU_ENTRYPOINT="determined_tpu_torch.exec.builtin_trials"
                                 ":SyntheticTrial"))
        assert out.returncode == 0, out.stderr[-3000:]
        assert stand_in.completed[1]["length"] == 2
        assert [b["metadata"]["steps_completed"]
                for b in stand_in.checkpoints.values()] == [2]
        shell = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                               timeout=60, env=dict(env, DTPU_ENTRYPOINT=(
            "python -c 'import os, sys; sys.exit(3 if \"DTPU_RENDEZVOUS_INFO\" "
            "not in os.environ and os.environ[\"DTPU_ALLOC_GENERATION\"] == "
            "\"0\" else 4)'")))
        assert shell.returncode == 3, shell.stderr[-3000:]
        # a gang of two: both processes rendezvous, and each entrypoint
        # sees the table with its own rank and the chief's port
        stand_in.rendezvous_size = 2
        check = (
            "python -c 'import json, os, sys; i = json.loads(os.environ["
            "\"DTPU_RENDEZVOUS_INFO\"]); sys.exit(3 if i[\"num_processes\"]"
            " == 2 and str(i[\"container_rank\"]) == os.environ["
            "\"DTPU_ALLOC_RANK\"] and os.environ[\"DTPU_CHIEF_PORT\"] "
            "else 4)'")
        gang = [subprocess.Popen(
            cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(env, DTPU_ALLOCATION_ID="1.2.0",
                                DTPU_ALLOC_NUM_PROCS="2",
                                DTPU_ALLOC_RANK=str(rank),
                                DTPU_ENTRYPOINT=check))
            for rank in range(2)]
        outs = [p.communicate(timeout=60) for p in gang]
        assert [p.returncode for p in gang] == [3, 3], outs
        assert len(stand_in.addrs["1.2.0"]) == 2
    finally:
        stand_in.stop()


def test_prepare_context_extracts_the_shipped_code(cluster, tmp_path,
                                                   monkeypatch):
    from determined_tpu.common.context_dir import bundle
    from determined_tpu_torch.exec import prep_and_run

    src = tmp_path / "src"
    (src / "pkg").mkdir(parents=True)
    (src / "pkg" / "model_def.py").write_text("VALUE = 41 + 1\n")
    fid = jsession.Session(cluster.api.url).post_bytes(
        "/api/v1/files", bundle(str(src)))["id"]
    monkeypatch.setenv("DTPU_CONTEXT_ID", fid)
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PYTHONPATH", "")
    prep_and_run.prepare_context(cluster.api.url)
    assert os.path.exists(os.path.join(os.getcwd(), "pkg", "model_def.py"))
    assert sys.path[0] == os.getcwd() == os.environ["PYTHONPATH"]


def test_replica_capture_uploads_and_reports(tmp_path):
    from determined_tpu_torch.profiler import run_bounded_capture

    stand_in = chip_smoke.StandInMaster()
    try:
        run_bounded_capture(
            tsession.Session(stand_in.url),
            {"id": "cap-1", "steps": 1,
             "storage": {"type": "shared_fs", "host_path": str(tmp_path)}},
            seconds=0.05)
        bad = {"id": "cap-2", "steps": 1, "storage": {"type": "gcs"}}
        run_bounded_capture(tsession.Session(stand_in.url), bad, seconds=0.05)
    finally:
        stand_in.stop()
    assert stand_in.captures["cap-1"]["artifact"] == "profile-capture-cap-1"
    assert glob.glob(str(tmp_path / "profile-capture-cap-1" /
                         "*.pt.trace.json"))
    assert "not ported" in stand_in.captures["cap-2"]["error"]


def test_a_resize_directive_leaves_fit_at_the_boundary(tmp_path,
                                                       trial_module):
    """A directive, from the beat or from the preemption poll, leaves
    ``fit`` at the report boundary by ``ElasticResizeExit`` with the last
    verified checkpoint; a rank it dropped is marked so, and one it could
    not map fails."""
    sys.path.insert(0, trial_module)
    import tiny_trials

    from determined_tpu_torch.core._preempt import PreemptContext
    from determined_tpu_torch.trainer import Batch, ElasticResizeExit, Trainer

    stand_in = chip_smoke.StandInMaster()
    stand_in.rendezvous_size = 2
    hp = {"model": "gpt-tiny", "batch_size": 2, "seq_len": 32}

    def trainer_with(beat, alloc):
        ctx = tcore._dummy_init(checkpoint_storage=str(tmp_path))
        ctx.train.heartbeat_step = beat
        ctx.preempt = PreemptContext(tsession.Session(stand_in.url), alloc,
                                     ctx.distributed)
        return ctx, Trainer(tiny_trials.PortTinyTrial(hp), ctx, device="cpu")

    try:
        directive = {"generation": 1, "num_processes": 1,
                     "rank_map": {"0": 0}, "reason": "reclaimed"}
        ctx, trainer = trainer_with(
            lambda step: directive if step >= 3 else None, "beat.1.0")
        with pytest.raises(ElasticResizeExit) as exit_:
            trainer.fit(max_length=Batch(6), report_period=Batch(1),
                        checkpoint_period=Batch(2))
        ctx.close()
        assert trainer.steps_completed == 3
        assert not exit_.value.dropped
        assert exit_.value.directive == directive
        with open(os.path.join(str(tmp_path), exit_.value.restore_from,
                               "metadata.json")) as f:
            assert json.load(f)["steps_completed"] == 2
        # the watcher's long-poll answers early with the master's directive
        ctx, trainer = trainer_with(lambda step: None, "poll.1.0")
        dropped = stand_in.resize("poll.1.0", [0], "reclaimed")
        stand_in.wait_for(lambda: ctx.preempt._watcher.resize is not None,
                          10, "the watcher's directive")
        with pytest.raises(ElasticResizeExit) as exit_:
            trainer.fit(max_length=Batch(6), report_period=Batch(1))
        ctx.close()
        assert exit_.value.dropped and exit_.value.directive == dropped
        assert trainer.steps_completed == 1
        ctx, trainer = trainer_with(
            lambda step: {"generation": 3, "rank_map": {},
                          "resync_only": True}, "gap.1.0")
        with pytest.raises(RuntimeError, match="could not map this rank"):
            trainer.fit(max_length=Batch(2), report_period=Batch(1))
        ctx.close()
    finally:
        stand_in.stop()
        sys.path.remove(trial_module)