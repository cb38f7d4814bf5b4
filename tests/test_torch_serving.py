"""The port's serving engine (determined_tpu_torch.serving) against the
JAX package's, on the CPU at fp32 with the same tiny model weights.

The late-join/early-free churn scenario of tests/test_serving.py runs on
the JAX engine and on the port engine (device="cpu") with the paged and
the gather decode paths: greedy token streams must be identical (exact
equality — fp32 on both sides, and greedy argmax is insensitive to the
last-digit differences of summation order unless two logits tie), and
every page must return to the pool. Admission errors, sheds and config
validation behave the same; a checkpoint that fails verification is
refused at startup, and build_engine without a device refuses a machine
without CUDA. The prefix cache, speculation and the HTTP service have
their own files (test_torch_prefix_cache.py, test_torch_speculation.py,
test_torch_serving_service.py).
"""
import json

import pytest
import torch

import jax
import jax.numpy as jnp

from determined_tpu.models import gpt as jgpt
from determined_tpu.serving import GenerationEngine as JaxEngine
from determined_tpu.serving import config as jconfig
from determined_tpu_torch import CudaUnavailableError
from determined_tpu_torch.models import gpt as tgpt
from determined_tpu_torch.serving import (
    GenerationEngine,
    PromptTooLong,
    ServingConfig,
    Shed,
    build_engine,
)
from determined_tpu_torch.serving import config as tconfig

ENGINE_KW = dict(
    page_size=16, num_pages=33, max_pages_per_request=4, max_batch_size=4,
    max_new_tokens=32, prefill_rows=2, prefill_seq=32, max_queue_depth=8,
    default_deadline_s=300.0,
)
MODEL_KW = dict(vocab_size=256, n_layers=2, n_heads=4, d_model=64, d_ff=256,
                seq_len=128, remat=False)


@pytest.fixture(scope="module")
def weights():
    model = jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **MODEL_KW))
    params = model.init(jax.random.PRNGKey(0))
    return model, params, jax.device_get(params)


def _port_engine(tree, **overrides):
    model = tgpt.GPT(tgpt.GPTConfig(dtype=torch.float32, **MODEL_KW),
                     device="cpu")
    return GenerationEngine(model, tree, ServingConfig(**{**ENGINE_KW,
                                                          **overrides}),
                            device="cpu")


def _jax_engine(weights, **overrides):
    model, params, _ = weights
    return JaxEngine(model, params,
                     jconfig.ServingConfig(**{**ENGINE_KW, **overrides}))


def _drive(eng):
    """The churn scenario of tests/test_serving.py: a long request
    mid-flight, two late joiners that finish first, and a follow-up that
    reuses the freed (now shuffled) pages."""
    eng.start()
    try:
        long_req = eng.submit([1, 2, 3, 4], max_new_tokens=24)
        stream = long_req.stream(timeout=180)
        kind, _ = next(stream)
        assert kind == "token"
        short = eng.submit([9, 8], max_new_tokens=3)
        tiny = eng.submit([42], max_new_tokens=2)
        assert short.result(timeout=180)["reason"] == "length"
        assert tiny.result(timeout=180)["reason"] == "length"
        late = eng.submit([7, 7, 2], max_new_tokens=4)
        assert late.result(timeout=180)["reason"] == "length"
        for _kind, _payload in stream:
            pass
        assert long_req.finish_reason == "length"
        assert eng.pool.pages_in_use == 0
    finally:
        eng.stop()
    return {
        "long": list(long_req.tokens), "short": list(short.tokens),
        "tiny": list(tiny.tokens), "late": list(late.tokens),
    }


@pytest.fixture(scope="module")
def jax_streams(weights):
    return _drive(_jax_engine(weights))


@pytest.mark.parametrize("paged_env", ["1", "0"], ids=["paged", "gather"])
def test_churn_streams_match_jax_engine(weights, jax_streams, paged_env,
                                        monkeypatch):
    monkeypatch.setenv("DTPU_PAGED_ATTN", paged_env)
    eng = _port_engine(weights[2])
    assert eng.stats()["decode_kernel"] == (
        "paged" if paged_env == "1" else "gather")
    assert eng.stats()["decode_backend"] == "plain"
    streams = _drive(eng)
    assert streams == jax_streams
    # greedy parity with one full-context forward of the port
    for prompt, key in (([1, 2, 3, 4], "long"), ([7, 7, 2], "late")):
        seq = prompt + streams[key]
        logits = eng.model.apply(torch.tensor([seq]))
        for i in range(len(prompt) - 1, len(seq) - 1):
            assert int(logits[0, i].argmax()) == seq[i + 1], i


SUBMITS = {  # case: (submit kwargs, engine overrides)
    "empty": (dict(prompt=[]), {}),
    "over-prefill": (dict(prompt=list(range(33))), {}),
    "over-context": (dict(prompt=list(range(30)), max_new_tokens=8),
                     {"max_pages_per_request": 2}),
}


@pytest.mark.parametrize("case", sorted(SUBMITS))
def test_prompt_too_long_matches(weights, case):
    kw, overrides = SUBMITS[case]
    with pytest.raises(PromptTooLong) as err_t:
        _port_engine(weights[2], **overrides).submit(**kw)
    with pytest.raises(Exception) as err_j:
        _jax_engine(weights, **overrides).submit(**kw)
    assert type(err_j.value).__name__ == "PromptTooLong"
    assert str(err_t.value) == str(err_j.value)


@pytest.mark.parametrize("reason", ["queue_full", "deadline"])
def test_shed_matches(weights, reason):
    def shed(eng):
        if reason == "deadline":
            eng.submit([1, 2], deadline_s=-1.0)
        for _ in range(ENGINE_KW["max_queue_depth"] + 1):
            eng.submit([1, 2])  # never started: the queue fills

    with pytest.raises(Shed) as err_t:
        shed(_port_engine(weights[2]))
    with pytest.raises(Exception) as err_j:
        shed(_jax_engine(weights))
    assert type(err_j.value).__name__ == "Shed"
    assert str(err_t.value) == str(err_j.value)
    assert err_t.value.retry_after == err_j.value.retry_after


BAD_CONFIGS = {
    "unknown-key": {"page_sizes": 64},
    "geometry": {"num_pages": 4, "max_pages_per_request": 8},
    "int-fields": {"page_size": 0, "max_batch_size": True},
    "lane-granule": {"decode_kernel": "paged", "page_size": 96},
    "kernel-name": {"decode_kernel": "fast"},
    "speculation": {"speculation": {"mode": "eagle", "draft_len": 99}},
    "model": {"model": "gpt5"},
}


@pytest.mark.parametrize("case", sorted(BAD_CONFIGS))
def test_config_errors_match(case):
    d = BAD_CONFIGS[case]
    errs = tconfig.validate_serving(d)
    assert errs and errs == jconfig.validate_serving(d)
    with pytest.raises(ValueError) as err:
        ServingConfig.from_dict(d)
    assert str(err.value) == "invalid serving config: " + "; ".join(errs)


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_entry_points_refuse_missing_cuda(device, monkeypatch):
    """No GPU and no explicit CPU request: a named error, never a silent
    fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CudaUnavailableError):
        build_engine({"model": "tiny"}, device=device)
    with pytest.raises(CudaUnavailableError):
        tgpt.GPT(tgpt.tiny(), device=device)


@pytest.mark.parametrize("cfg,env", [
    pytest.param({"model": "fixture"}, {}, id="fixture-model"),
    pytest.param({"model": "tiny"}, {"DTPU_SERVING_CHECKPOINT": "/nonexistent"},
                 id="checkpoint"),
])
def test_build_engine_refuses_checkpoints(cfg, env, monkeypatch, tmp_path):
    """A checkpoint that fails verification is a named refusal at startup:
    the fixture model from a torn one (CorruptCheckpointError), and a
    directory that does not exist (no manifest, no leaves)."""
    from determined_tpu_torch.storage import CorruptCheckpointError
    from determined_tpu_torch.storage.base import MANIFEST_FILE, file_digest
    from determined_tpu_torch.trainer import _checkpoint as ckpt_io

    if not env:
        model = tgpt.GPT(tgpt.GPTConfig(
            vocab_size=1024, n_layers=2, n_heads=4, d_model=128, d_ff=512,
            seq_len=256, remat=False, dtype=torch.float32), device="cpu")
        written = ckpt_io.save_pytree(
            ckpt_io.nest(dict(model.named_parameters())), str(tmp_path))
        files = {r: file_digest(str(tmp_path / r)) for r in written}
        (tmp_path / MANIFEST_FILE).write_text(json.dumps({"version": 1,
                                                          "files": files}))
        torn = tmp_path / "blocks__wqkv.npy"
        torn.write_bytes(torn.read_bytes()[:200])
        env = {"DTPU_SERVING_CHECKPOINT": str(tmp_path)}
        err = CorruptCheckpointError
    else:
        err = FileNotFoundError
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(err):
        build_engine(cfg, device="cpu")


def test_build_engine_serves_on_cpu():
    eng = build_engine({"model": "tiny", "prefill_seq": 64}, device="cpu")
    eng.start()
    try:
        out = eng.submit([3, 1, 4, 1, 5], max_new_tokens=4,
                         temperature=0.7).result(timeout=120)
    finally:
        eng.stop()
    assert out["reason"] == "length" and len(out["tokens"]) == 4
    assert all(0 <= t < 256 for t in out["tokens"])
    stats = eng.stats()
    assert stats["pages_in_use"] == 0 and stats["prefill_batches"] == 1
    assert stats["decode_iterations"] == 3


def test_decode_latency_compare_runs_both_paths(weights):
    """Both kernel paths time over copies of the pool: the keys are the
    reference's, the times positive, the live pool untouched."""
    eng = _port_engine(weights[2])
    pool_before = eng.cache_k.clone()
    out = eng.decode_latency_compare(iters=2)
    assert set(out) == {"s_max", "batch", "decode_iter_ms_paged",
                        "decode_iter_ms_gather"}
    assert out["s_max"] == 64 and out["batch"] == 4
    assert out["decode_iter_ms_paged"] > 0 and out["decode_iter_ms_gather"] > 0
    assert torch.equal(eng.cache_k, pool_before)
