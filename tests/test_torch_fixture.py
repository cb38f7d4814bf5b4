"""The pre-trained serving fixture (determined_tpu_torch.serving.fixture)
and serving from a checkpoint (``build_engine`` with
``DTPU_SERVING_CHECKPOINT``) against the JAX package, on the CPU at fp32.

- The corpus, the fingerprint, the cache path and the training batches
  equal the reference's, so both packages share one cache directory.
- The port's training recipe (``optim.adam`` on ``GPT.loss``) from the
  reference's ``GPT.init`` (carried by ``load_jax_params``; the port's own
  init draws from torch's generator) ends 20 steps on the reference's
  ``train_fixture(steps=20)`` parameters within 5e-5, but for the few
  elements whose gradient is within a few eps of 0, where Adam's update
  hinges on rounding (see the test).
- A fixture directory written by either package is loaded by the
  other's ``ensure_fixture`` without retraining, bitwise; a corrupt cache
  is retrained.
- Served from one fixture checkpoint, the port's engine and the JAX
  engine emit identical greedy streams (the fp32 greedy contract of
  tests/test_torch_serving.py); a ``gpt.tiny()`` checkpoint goes live
  bit for bit; every new entry point refuses a machine without CUDA.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax

from determined_tpu.models import gpt as jgpt
from determined_tpu.serving import fixture as jfixture
from determined_tpu.serving import service as jservice
from determined_tpu.trainer import _checkpoint as jckpt
from determined_tpu_torch import CudaUnavailableError
from determined_tpu_torch.models import gpt as tgpt
from determined_tpu_torch.serving import build_engine
from determined_tpu_torch.serving import fixture as tfixture
from determined_tpu_torch.storage.base import MANIFEST_FILE, file_digest
from determined_tpu_torch.trainer import _checkpoint as ckpt_io

STEPS = 20


def test_corpus_fingerprint_and_cache_path_match(monkeypatch, tmp_path):
    assert tfixture.fixture_phrases() == jfixture.fixture_phrases()
    assert tfixture._fingerprint() == jfixture._fingerprint()
    monkeypatch.setenv("DTPU_FIXTURE_CACHE", str(tmp_path))
    assert tfixture.default_cache_dir() == jfixture.default_cache_dir()
    phrases = tfixture.fixture_phrases()
    rt, rj = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(4):
        np.testing.assert_array_equal(
            tfixture._corpus_batch(rt, phrases, 8, 64),
            jfixture._corpus_batch(rj, phrases, 8, 64))
    cfg, jcfg = tfixture.fixture_model_config(), jfixture.fixture_model_config()
    for f in ("vocab_size", "n_layers", "n_heads", "d_model", "d_ff",
              "seq_len", "remat"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.dtype == torch.float32


@pytest.fixture(scope="module")
def jax_trained():
    _model, params = jfixture.train_fixture(steps=STEPS)
    return jax.device_get(params)


def test_port_recipe_matches_the_reference(jax_trained):
    """Every parameter within 5e-5 of the reference's after 20 steps, but
    where Adam divides rounding noise by eps: an element whose first-step
    gradient is nonzero but below 3·eps = 3e-8 (the key bias, whose true gradient is
    0: softmax ignores a shift shared by all keys; and a few elements of
    ~1e-8) gets an update lr·g/(|g| + eps) that hinges on the gradient's
    last bits (the fp32 gradients differ by ~1e-9 here). Those may drift by
    at most lr a step, and are fewer than 1 in 1000. (A gradient of exactly
    0, as the position rows past the corpus's 64 tokens get, moves
    nothing on either side.)"""
    import jax.numpy as jnp

    jmodel = jgpt.GPT(jfixture.fixture_model_config())
    init = jax.device_get(jmodel.init(jax.random.PRNGKey(tfixture.TRAIN_SEED)))
    first = tfixture._corpus_batch(np.random.default_rng(tfixture.TRAIN_SEED),
                                   tfixture.fixture_phrases(),
                                   tfixture.TRAIN_BATCH, tfixture.TRAIN_SEQ)
    grads = dict(tgpt._flatten(jax.device_get(jax.grad(
        lambda p: jmodel.loss(p, {"tokens": jnp.asarray(first)}, None)[0]
    )(init))))
    model = tgpt.GPT(tfixture.fixture_model_config(), device="cpu")
    tgpt.load_jax_params(model, init)
    loss = tfixture._fit(model, STEPS)
    assert np.isfinite(loss)
    want = dict(tgpt._flatten(jax_trained))
    noisy = 0
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        eps_bound = (grads[name] != 0) & (np.abs(grads[name]) < 3e-8)
        noisy += int(eps_bound.sum())
        np.testing.assert_allclose(got[~eps_bound], want[name][~eps_bound],
                                   atol=5e-5, rtol=0, err_msg=name)
        np.testing.assert_allclose(got[eps_bound], want[name][eps_bound],
                                   atol=STEPS * tfixture.TRAIN_LR, rtol=0,
                                   err_msg=name)
    assert 0 < noisy < sum(p.numel() for p in model.parameters()) / 1000


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """A fixture directory written by each package (STEPS steps)."""
    jdir = str(tmp_path_factory.mktemp("fx") / "jax")
    tdir = str(tmp_path_factory.mktemp("fx") / "port")
    jfixture.ensure_fixture(jdir, steps=STEPS)
    tfixture.ensure_fixture(tdir, steps=STEPS, device="cpu")
    return {"jax": jdir, "port": tdir}


def _no_training(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("retrained a valid cache")

    monkeypatch.setattr(tfixture, "_fit", refuse)
    monkeypatch.setattr(jfixture, "train_fixture", refuse)


def _npy(directory):
    return {f[:-4]: np.load(os.path.join(directory, f))
            for f in os.listdir(directory) if f.endswith(".npy")}


def test_both_packages_write_the_same_names(caches):
    for name in ("tree.json",):
        with open(os.path.join(caches["jax"], name)) as fj, \
                open(os.path.join(caches["port"], name)) as ft:
            assert json.load(ft) == json.load(fj)
    assert sorted(os.listdir(caches["port"])) == sorted(
        os.listdir(caches["jax"]))


def test_port_loads_the_jax_fixture_without_retraining(caches, monkeypatch):
    _no_training(monkeypatch)
    model, params, path = tfixture.ensure_fixture(caches["jax"], device="cpu")
    assert path == caches["jax"]
    files = _npy(caches["jax"])
    flat = ckpt_io.unnest(params)
    assert len(flat) == len(files)
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      files[name.replace(".", "__")],
                                      err_msg=name)
        assert flat[name] is p


def test_jax_loads_the_port_fixture_without_retraining(caches, monkeypatch):
    _no_training(monkeypatch)
    _model, params, path = jfixture.ensure_fixture(caches["port"])
    files = _npy(caches["port"])
    for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        np.testing.assert_array_equal(np.asarray(leaf),
                                      files[jckpt._leaf_name(kp)])


def test_corrupt_cache_is_retrained(caches, tmp_path, monkeypatch):
    import shutil

    path = str(tmp_path / "fx")
    shutil.copytree(caches["port"], path)
    victim = os.path.join(path, "blocks__wqkv.npy")
    data = bytearray(open(victim, "rb").read())
    data[-1] ^= 0x40
    with open(victim, "wb") as f:
        f.write(bytes(data))
    calls = []
    real_fit = tfixture._fit
    monkeypatch.setattr(tfixture, "_fit",
                        lambda model, steps: calls.append(steps)
                        or real_fit(model, steps))
    tfixture.ensure_fixture(path, steps=2, device="cpu")
    assert calls == [2]
    from determined_tpu_torch.storage import verify_checkpoint_dir

    assert verify_checkpoint_dir(path)


def _streams(engine, prompts, new_tokens):
    engine.start()
    try:
        reqs = [engine.submit(p, max_new_tokens=new_tokens) for p in prompts]
        return [r.result(timeout=300)["tokens"] for r in reqs]
    finally:
        engine.stop()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_greedy_streams_from_a_fixture_checkpoint_match_jax(
        caches, writer, monkeypatch):
    monkeypatch.setenv("DTPU_SERVING_CHECKPOINT", caches[writer])
    prompts = [p * 2 for p in tfixture.fixture_phrases()[:6]]
    got = _streams(build_engine({"model": "fixture"}, device="cpu"),
                   prompts, 12)
    want = _streams(jservice.build_engine({"model": "fixture"}), prompts, 12)
    assert got == want
    assert all(len(s) == 12 for s in got)


def test_tiny_checkpoint_goes_live_bitwise(tmp_path, monkeypatch):
    tree = jax.device_get(jgpt.GPT(jgpt.tiny()).init(jax.random.PRNGKey(1)))
    written = jckpt.save_pytree(tree, str(tmp_path))
    files = {r: file_digest(str(tmp_path / r)) for r in written}
    (tmp_path / MANIFEST_FILE).write_text(
        json.dumps({"version": 1, "files": files}))
    monkeypatch.setenv("DTPU_SERVING_CHECKPOINT", str(tmp_path))
    eng = build_engine({"model": "tiny", "prefill_seq": 64}, device="cpu")
    want = dict(tgpt._flatten(tree))
    for name, p in eng.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name],
                                      err_msg=name)
    assert _streams(eng, [[3, 1, 4, 1, 5]], 4)[0].__len__() == 4


@pytest.mark.parametrize("entry", ["train_fixture", "ensure_fixture",
                                   "build_engine"])
def test_entry_points_refuse_missing_cuda(entry, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CudaUnavailableError):
        if entry == "train_fixture":
            tfixture.train_fixture(steps=1)
        elif entry == "ensure_fixture":
            tfixture.ensure_fixture(str(tmp_path), steps=1)
        else:
            monkeypatch.setenv("DTPU_SERVING_CHECKPOINT", str(tmp_path))
            build_engine({"model": "fixture"})
    assert not os.listdir(tmp_path)


def test_cli_prints_the_cache_path(monkeypatch, tmp_path, capsys, caches):
    import shutil

    monkeypatch.setenv("DTPU_FIXTURE_CACHE", str(tmp_path))
    shutil.copytree(caches["port"], tfixture.default_cache_dir())
    _no_training(monkeypatch)
    real = tfixture.ensure_fixture
    monkeypatch.setattr(tfixture, "ensure_fixture",
                        lambda: real(device="cpu"))
    assert tfixture.main() == 0
    assert capsys.readouterr().out.strip() == tfixture.default_cache_dir()
