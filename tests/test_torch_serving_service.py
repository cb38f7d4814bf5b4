"""The port's HTTP service and load generator (determined_tpu_torch.serving.
service and loadgen) against the JAX package's, on the CPU at fp32.

One port ``GenerationServer`` and one reference server, each over an
engine with the same tiny weights, prefix cache and ngram speculation on,
are given the same request list through each package's own
``loadgen.drive``: the token streams are identical (the port's from its
SSE parse, the reference's from its engine's requests), the
``/api/v1/stats`` keys are the same (the port adds three of its own), the
same inputs answer 400, and 503 with the same ``Retry-After``, and the
port's ``/metrics`` body parses under the reference's strict parser.
``main`` serves off the cluster until SIGTERM (on the cluster:
``tests/test_torch_cluster.py``).
"""
import http.client
import json
import urllib.request

import pytest
import torch

import jax
import jax.numpy as jnp

from determined_tpu.common import faults as jfaults
from determined_tpu.common.metrics import parse_exposition
from determined_tpu.models import gpt as jgpt
from determined_tpu.serving import GenerationEngine as JaxEngine
from determined_tpu.serving import config as jconfig
from determined_tpu.serving import loadgen as jloadgen
from determined_tpu.serving.service import GenerationServer as JaxServer
from determined_tpu_torch.common import faults
from determined_tpu_torch.models import gpt as tgpt
from determined_tpu_torch.serving import (
    GenerationEngine,
    GenerationServer,
    ServingConfig,
    loadgen,
    service,
)

ENGINE_KW = dict(
    page_size=16, num_pages=65, max_pages_per_request=4, max_batch_size=4,
    max_new_tokens=32, prefill_rows=2, prefill_seq=32, max_queue_depth=32,
    default_deadline_s=300.0, prefix_cache="on",
    speculation={"mode": "ngram", "draft_len": 4, "min_match": 2},
)
MODEL_KW = dict(vocab_size=256, n_layers=2, n_heads=4, d_model=64, d_ff=256,
                seq_len=128, remat=False)
#: keys the port's stats() adds to the reference's snapshot.
PORT_STATS = {"decode_iterations", "decode_seconds", "prefill_batches"}


@pytest.fixture(scope="module")
def servers():
    jmodel = jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **MODEL_KW))
    params = jmodel.init(jax.random.PRNGKey(0))
    jeng = JaxEngine(jmodel, params, jconfig.ServingConfig(**ENGINE_KW))
    model = tgpt.GPT(tgpt.GPTConfig(dtype=torch.float32, **MODEL_KW),
                     device="cpu")
    teng = GenerationEngine(model, jax.device_get(params),
                            ServingConfig(**ENGINE_KW), device="cpu")
    submitted = []
    submit = jeng.submit

    def recording_submit(*args, **kwargs):
        req = submit(*args, **kwargs)
        submitted.append(req)
        return req

    jeng.submit = recording_submit
    out = {}
    for name, eng, cls in (("jax", jeng, JaxServer),
                           ("port", teng, GenerationServer)):
        eng.start()
        srv = cls(eng)
        srv.start()
        out[name] = (eng, srv)
    out["jax_requests"] = submitted
    yield out
    for name in ("jax", "port"):
        eng, srv = out[name]
        srv.stop()
        eng.stop()


def _post(url, body, headers=None):
    """→ (status, headers, body bytes) of one POST /api/v1/generate."""
    target = urllib.request.urlparse(url)
    conn = http.client.HTTPConnection(target.hostname, target.port,
                                      timeout=120)
    try:
        conn.request("POST", "/api/v1/generate",
                     body=body if isinstance(body, bytes)
                     else json.dumps(body),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return r.read()


def test_drive_streams_match_reference(servers):
    prompts = loadgen.zipf_prefix_prompts(
        12, corpus_size=2, prefix_len=20, suffix_len=6, seed=7)
    assert prompts == jloadgen.zipf_prefix_prompts(
        12, corpus_size=2, prefix_len=20, suffix_len=6, seed=7)
    ours = loadgen.drive(servers["port"][1].url, 12, 4, max_new_tokens=8,
                         prompts=prompts, timeout_s=120)
    theirs = jloadgen.drive(servers["jax"][1].url, 12, 4, max_new_tokens=8,
                            prompts=prompts, timeout_s=120)
    assert ours.completed == theirs.completed == 12, [
        t.error for t in ours.traces + theirs.traces]
    assert ours.total_tokens == theirs.total_tokens == 96
    streams = {tuple(r.prompt): list(r.tokens)
               for r in servers["jax_requests"]}
    for prompt, trace in zip(prompts, ours.traces):
        assert trace.token_ids == streams[tuple(prompt)]
    summary = ours.summary()
    assert set(summary) == set(theirs.summary())
    assert summary["p99_ttft_ms"] >= summary["p50_ttft_ms"] > 0
    port_stats = servers["port"][0].stats()
    assert port_stats["prefix_cache"]["hits"] > 0
    assert (port_stats["speculation"]
            == servers["jax"][0].stats()["speculation"])


def test_stats_keys_match_reference(servers):
    ours = json.loads(_get(servers["port"][1].url, "/api/v1/stats"))
    theirs = json.loads(_get(servers["jax"][1].url, "/api/v1/stats"))
    assert set(ours) - PORT_STATS == set(theirs)
    for section in ("speculation", "prefix_cache"):
        assert set(ours[section]) == set(theirs[section])
    health = json.loads(_get(servers["port"][1].url, "/healthz"))
    assert health["status"] == "ok"


CLIENT_ERRORS = {
    "over-prefill": {"prompt": list(range(100))},
    "no-prompt": {"nope": 1},
    "bad-ids": {"prompt": ["a"]},
    "bool-ids": {"prompt": [True]},
    "empty": {"prompt": []},
    "deadline-text": {"prompt": [1], "deadline_ms": "soon"},
    "max-new-text": {"prompt": [1], "max_new_tokens": "many"},
    "temperature-text": {"prompt": [1], "temperature": "warm"},
    "text-not-str": {"text": 5},
    "over-prefill-text": {"text": "x" * 40},
    "bad-json": b"{nope",
    "not-object": b"[1, 2]",
}


@pytest.mark.parametrize("case", sorted(CLIENT_ERRORS))
def test_client_errors_match(servers, case):
    got = [_post(servers[n][1].url, CLIENT_ERRORS[case])
           for n in ("port", "jax")]
    assert got[0][0] == got[1][0] == 400
    assert json.loads(got[0][2]) == json.loads(got[1][2])


@pytest.mark.parametrize("case", ["fault", "deadline"])
def test_shed_is_503_with_retry_after(servers, case):
    body = {"prompt": [1, 2], "max_new_tokens": 1}
    got = []
    for name, mod in (("port", faults), ("jax", jfaults)):
        plan = mod.FaultPlan({"serving.admission": mod.FaultSpec(
            failures=1 if case == "fault" else 0)})
        with mod.plan_active(plan):
            got.append(_post(servers[name][1].url,
                             {**body, "deadline_ms": -1} if case == "deadline"
                             else body))
    (s_t, h_t, b_t), (s_j, h_j, b_j) = got
    assert s_t == s_j == 503
    assert h_t["Retry-After"] == h_j["Retry-After"]
    assert float(h_t["Retry-After"]) > 0
    assert json.loads(b_t) == json.loads(b_j)


def test_text_prompt_non_streaming_and_404(servers):
    outs = [json.loads(_post(servers[n][1].url, {
        "text": "hi", "max_new_tokens": 2, "stream": False})[2])
        for n in ("port", "jax")]
    assert outs[0]["tokens"] == outs[1]["tokens"]
    assert len(outs[0]["tokens"]) == 2
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(servers["port"][1].url, "/nope")
    assert err.value.code == 404


def test_metrics_body_parses(servers):
    _post(servers["port"][1].url, {"prompt": [5, 6, 7], "max_new_tokens": 2,
                                   "stream": False},
          headers={"traceparent":
                   "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"})
    body = _get(servers["port"][1].url, "/metrics").decode()
    samples = parse_exposition(body)
    names = {name for name, _ in samples}
    for want in ("dtpu_serving_ttft_seconds_count",
                 "dtpu_serving_tokens_total",
                 "dtpu_serving_spec_proposed_tokens_total",
                 "dtpu_serving_prefix_cache_hits_total",
                 "dtpu_serving_pages_in_use",
                 "dtpu_serving_api_requests_total"):
        assert want in names, want
    assert "# EXEMPLAR dtpu_serving_ttft_seconds_bucket" in body
    assert "ab" * 16 in body


def test_parse_traceparent():
    good = "00-" + "0a" * 16 + "-" + "0b" * 8 + "-01"
    assert service.parse_traceparent(good) == ("0a" * 16, "0b" * 8)
    assert service.parse_traceparent("junk") is None
    assert service.parse_traceparent(None) is None


def test_main_serves_off_cluster_until_sigterm():
    """``python -m determined_tpu_torch.serving.service`` on the CPU:
    serves the port's load generator, then drains and exits 0 on SIGTERM."""
    import os
    import signal
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items()
           if k not in ("DTPU_MASTER", "DTPU_ALLOCATION_ID")}
    env["PYTHONPATH"] = str(root)
    proc = subprocess.Popen(
        [sys.executable, "-m", "determined_tpu_torch.serving.service",
         "--host", "127.0.0.1", "--device", "cpu", "--config",
         json.dumps({"model": "tiny", "prefill_seq": 64,
                     "speculation": {"mode": "ngram"}})],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("generation service on http://"), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        report = loadgen.drive(line.split()[-1], 4, 4, max_new_tokens=6,
                               timeout_s=120)
        assert report.completed == 4, [t.error for t in report.traces]
        assert all(len(t.token_ids) == 6 for t in report.traces)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
