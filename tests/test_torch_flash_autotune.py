"""The port's flash block-size autotuner (``ops/flash_autotune.py``)
against the reference's (``determined_tpu/ops/flash_autotune.py``).

On the CPU neither probes: the candidate sets and the off-device returns
are compared directly. The cache, the knobs and the route grouping run
with the card and the probe faked (``device="cuda"``, ``_device_kind``
and ``_probe_ms`` patched), as the reference's own tests fake the TPU.
``GPT._flash_blocks`` is held against the reference's by the arguments
each passes its tuner, with both tuners patched.
"""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from determined_tpu.ops import flash_autotune as ref_fat
from determined_tpu_torch.ops import _build
from determined_tpu_torch.ops import flash_autotune as fat
from determined_tpu_torch.ops.flash_attention import _bwd_route

SHAPE = dict(n_heads=2, head_dim=16)


@pytest.mark.parametrize("s_q,s_k", [(64, 64), (96, 96), (1024, 1024),
                                     (512, 1536), (1448, 1448),
                                     (4096, 4096), (16384, 16384)])
@pytest.mark.parametrize("want", [(1024, 1024), (512, 256), (64, 32)])
def test_candidates_equal_the_references(s_q, s_k, want):
    assert fat.candidate_blocks(s_q, s_k, *want) == \
        ref_fat.candidate_blocks(s_q, s_k, *want)


@pytest.mark.parametrize("kw", [
    dict(s_q=96, want_q=1024, want_k=512),
    dict(s_q=1024, s_k=2048, want_q=512, want_k=1024, causal=False),
    dict(s_q=128, want_q=64, want_k=64, window=16, segments=True),
])
def test_cpu_returns_the_references_off_tpu_answer(tmp_path, kw):
    """On a CPU device no probe runs and no cache is touched: the wanted
    blocks fitted to the sequence, as the reference off the TPU."""
    cache = tmp_path / "cache.json"
    got = fat.tune_flash_blocks(**SHAPE, **kw, cache_file=str(cache),
                                device="cpu")
    want = ref_fat.tune_flash_blocks(**SHAPE, **kw, cache_file=str(cache))
    assert got == want
    assert not cache.exists()


@pytest.fixture
def fake_card(monkeypatch):
    """The tuner believes it runs on a card named "fake-card"; returns
    the probe's call log, the probe's time per (bq, bk) set by the test
    (default: block_q ms)."""
    calls = []
    times = {}
    monkeypatch.setattr(fat, "_device_kind", lambda dev: "fake-card")

    def probe(bq, bk, **kw):
        calls.append(((bq, bk), kw))
        return times.get((bq, bk), float(bq))

    monkeypatch.setattr(fat, "_probe_ms", probe)
    return types.SimpleNamespace(calls=calls, times=times)


def _tune(cache, **kw):
    args = dict(SHAPE, s_q=64, want_q=64, want_k=64, device="cuda",
                cache_file=str(cache))
    args.update(kw)
    return fat.tune_flash_blocks(**args)


def test_probes_once_then_caches(tmp_path, fake_card):
    cache = tmp_path / "cache.json"
    # at s 1024 the candidates take two routes: mono (1024, 1024) and the
    # blocked forward + fused backward; the blocked one is faster here
    fake_card.times.update({(1024, 1024): 2.0, (256, 256): 1.0})
    got = _tune(cache, s_q=1024, want_q=1024, want_k=1024)
    assert got == (256, 256)
    assert [c for c, _ in fake_card.calls] == [(1024, 1024), (256, 256)]
    data = json.loads(cache.read_text())
    assert list(data.values()) == [[256, 256]]
    fake_card.calls.clear()
    assert _tune(cache, s_q=1024, want_q=1024, want_k=1024) == (256, 256)
    assert fake_card.calls == []  # a cache hit probes nothing
    # another mask mode is another key: probes again
    _tune(cache, s_q=1024, want_q=1024, want_k=1024, window=16)
    assert fake_card.calls


def test_one_probe_per_distinct_route(tmp_path, fake_card, monkeypatch):
    """Every candidate of one route launches the same kernels, so the
    tuner times each route once, at its first candidate, and returns the
    first candidate of the fastest route; the wanted pair wins ties."""
    # S 16384, B 1, H 12, D 64: block_k 1024 keeps the fused backward
    # (0.81 GB of dq partials), 512 and 256 go past the 1 GiB cap
    kw = dict(s_q=16384, n_heads=12, head_dim=64, want_q=1024,
              want_k=1024)
    cands = fat.candidate_blocks(16384, 16384)
    routes = {c: fat.candidate_route(*c, s_q=16384, s_k=16384, n_heads=12,
                                     head_dim=64) for c in cands}
    assert {r for r in routes.values()} == {("flash_fwd", "fused"),
                                            ("flash_fwd", "two_pass")}
    assert routes[(1024, 1024)] == ("flash_fwd", "fused")
    assert routes[(512, 512)] == routes[(256, 256)] == ("flash_fwd",
                                                        "two_pass")
    for c in cands:
        fake_card.times[c] = 5.0  # a tie: the wanted pair's route wins
    got = _tune(tmp_path / "a.json", **kw)
    assert got == (1024, 1024)
    assert [c for c, _ in fake_card.calls] == [(1024, 1024), (256, 256)]
    fake_card.calls.clear()
    fake_card.times[(256, 256)] = 4.0
    assert _tune(tmp_path / "b.json", **kw) == (256, 256)
    assert len(fake_card.calls) == 2
    # B8 S1024: mono for (1024, 1024), flash_fwd + fused for the rest;
    # packed, mono declines segment ids: one route, one probe
    fake_card.calls.clear()
    assert _tune(tmp_path / "c.json", s_q=1024, n_heads=12, head_dim=64,
                 batch=8, want_q=1024, want_k=1024,
                 segments=True) == (1024, 1024)
    assert [c for c, _ in fake_card.calls] == [(1024, 1024)]
    assert fake_card.calls[0][1]["segments"] is True


def test_routes_are_the_dispatchs(monkeypatch):
    """``candidate_route`` is what ``flash_attention`` launches: the mono
    forward exactly where ``_mono_ok`` holds, the backward by
    ``_bwd_route``, the cap read at call time."""
    assert fat.candidate_route(1024, 1024, s_q=1024, s_k=1024, n_heads=12,
                               head_dim=64, batch=8) == ("flash_fwd_mono",
                                                         "mono")
    assert fat.candidate_route(1024, 1024, s_q=1024, s_k=1024, n_heads=12,
                               head_dim=64, window=256) == ("flash_fwd",
                                                            "fused")
    monkeypatch.setattr("determined_tpu_torch.ops.flash_attention."
                        "_FUSED_BWD_PARTIALS_CAP", 0)
    assert fat.candidate_route(512, 512, s_q=1024, s_k=1024, n_heads=12,
                               head_dim=64, batch=8) == ("flash_fwd",
                                                         "two_pass")
    assert _bwd_route(96, 1024, 1024, 64, 512, 512) == "two_pass"


def test_env_kill_switch(tmp_path, fake_card, monkeypatch):
    monkeypatch.setenv("DTPU_FLASH_AUTOTUNE", "0")
    assert _tune(tmp_path / "c.json", s_q=128) == (64, 64)
    assert fake_card.calls == []
    assert not (tmp_path / "c.json").exists()


def test_corrupt_cache_degrades_to_probe(tmp_path, fake_card):
    cache = tmp_path / "cache.json"
    cache.write_text("{not json")
    fake_card.times.update({(1024, 1024): 9.0, (256, 256): 1.0})
    assert _tune(cache, s_q=1024, want_q=1024, want_k=1024) == (256, 256)
    json.loads(cache.read_text())  # rewritten as valid json


def test_all_probes_out_of_memory_not_cached(tmp_path, fake_card):
    """Every route out of memory: the fallback for this process, not
    pinned into the cache."""
    for c in fat.candidate_blocks(1024, 1024):
        fake_card.times[c] = float("inf")
    cache = tmp_path / "cache.json"
    assert _tune(cache, s_q=1024, want_q=512, want_k=512) == (512, 512)
    assert not cache.exists()


def test_segments_probe_and_key_apart(tmp_path, fake_card):
    cache = tmp_path / "cache.json"
    _tune(cache)
    assert fake_card.calls and all(kw["segments"] is False
                                   for _, kw in fake_card.calls)
    fake_card.calls.clear()
    _tune(cache, segments=True)
    assert fake_card.calls and all(kw["segments"] is True
                                   for _, kw in fake_card.calls)
    data = json.loads(cache.read_text())
    assert len(data) == 2
    assert any("seg1" in k for k in data) and any("seg0" in k for k in data)


def test_key_holds_the_card_the_torch_version_and_the_sources(tmp_path,
                                                               fake_card):
    cache = tmp_path / "cache.json"
    _tune(cache, dtype=torch.float32)
    (key,) = json.loads(cache.read_text())
    assert f"v{fat.CACHE_VERSION}" in key and "fake-card" in key
    assert f"torch{torch.__version__}" in key
    assert f"src{_build.sources_digest()}" in key
    assert "float32" in key


def test_source_digest_follows_the_kernel_sources(tmp_path, monkeypatch):
    """A redesigned kernel changes the digest (and so every key)."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("one")
    (csrc / "h.cuh").write_text("header")
    monkeypatch.setattr(_build, "CSRC", csrc)
    a = _build.sources_digest()
    (csrc / "h.cuh").write_text("header, redesigned")
    assert _build.sources_digest() != a


def test_a_probe_error_propagates(tmp_path, monkeypatch):
    """Only running out of memory makes a candidate lose; any other
    error of a probe (a build or a launch that failed) reaches the
    caller."""
    monkeypatch.setattr(fat, "_device_kind", lambda dev: "fake-card")

    def broken(*a, **k):
        raise _build.CudaKernelError("flash_fwd: launch failed")

    monkeypatch.setattr(fat, "_probe_ms", broken)
    with pytest.raises(_build.CudaKernelError):
        _tune(tmp_path / "c.json")


def test_probe_scores_out_of_memory_inf_and_raises_the_rest(monkeypatch):
    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("out of memory")

    monkeypatch.setattr(fat, "flash_attention", oom)
    kw = dict(s_q=64, s_k=64, n_heads=2, head_dim=16, batch=1,
              dtype=torch.float32, causal=True, window=None,
              segments=True, device="cpu")
    assert fat._probe_ms(16, 16, **kw) == float("inf")

    def fails(*a, **k):
        raise _build.CudaKernelError("flash_bwd_blocked: launch failed")

    monkeypatch.setattr(fat, "flash_attention", fails)
    with pytest.raises(_build.CudaKernelError):
        fat._probe_ms(16, 16, **kw)


def test_paged_block_h_is_the_default_and_probes_nothing(tmp_path):
    from determined_tpu.ops.paged_attention import (
        default_paged_block_h as ref_default,
    )

    for h, d, page in ((12, 64, 128), (4, 16, 16), (16, 128, 256)):
        got = fat.tune_paged_block_h(
            n_heads=h, head_dim=d, page_size=page, num_pages=64,
            pages_per_slot=8, batch=8, q_rows=5,
            cache_file=str(tmp_path / "c.json"))
        assert got == ref_default(h, d, page, "bfloat16")
    assert not (tmp_path / "c.json").exists()


# ---------------------------------------------------------------------------
# GPT._flash_blocks against the reference's
# ---------------------------------------------------------------------------
def _port_mesh(**sizes):
    from determined_tpu_torch.parallel.mesh import AXIS_NAMES

    return types.SimpleNamespace(
        mesh_dim_names=AXIS_NAMES, device_type="cpu",
        shape=tuple(sizes.get(a, 1) for a in AXIS_NAMES),
        get_coordinate=lambda: (0,) * 6, get_group=lambda axis: None)


@pytest.mark.parametrize("sizes,fields", [
    ({}, {}),
    ({"context": 2}, {}),
    ({"tensor": 2}, {"attn_window": 16}),
    ({"context": 2, "tensor": 2}, {"flash_block_q": 32, "flash_block_k": 16}),
    ({"context": 4}, {"attn_window": 8}),
])
def test_gpt_probes_the_references_per_device_shapes(monkeypatch, sizes,
                                                     fields):
    """Both tuners patched: the port's GPT asks its tuner for what the
    reference's GPT asks its own (the per-device sequence and heads, the
    window, the wanted blocks, the dtype) on its own device, and
    ``_attn_half`` trains on the answer."""
    import jax.numpy as jnp

    from determined_tpu.models import gpt as ref_gpt
    from determined_tpu_torch.models import gpt

    asked = {}

    def recorder(side, answer):
        def tune(**kw):
            asked[side] = kw
            return answer
        return tune

    monkeypatch.setattr(ref_fat, "tune_flash_blocks", recorder("ref", (8, 8)))
    monkeypatch.setattr(fat, "tune_flash_blocks", recorder("port", (16, 8)))
    ref_cfg = dataclasses.replace(ref_gpt.tiny(seq_len=64),
                                  flash_autotune=True, dtype=jnp.bfloat16,
                                  **fields)
    ref_gpt.GPT(ref_cfg, mesh=types.SimpleNamespace(shape=dict(sizes)))
    cfg = dataclasses.replace(gpt.tiny(seq_len=64), flash_autotune=True,
                              **fields)
    model = gpt.GPT(cfg, device="cpu", mesh=_port_mesh(**sizes))
    port = dict(asked["port"])
    assert port.pop("device") == model.device
    assert str(port.pop("dtype")) == "torch.bfloat16"
    ref = dict(asked["ref"])
    assert jnp.dtype(ref.pop("dtype")).name == "bfloat16"
    assert port == ref
    assert model._flash_blocks() == (16, 8)
    assert model._flash_blocks() is model._resolved_flash_blocks


def test_gpt_keeps_the_config_blocks_without_autotune(monkeypatch):
    from determined_tpu_torch.models import gpt

    monkeypatch.setattr(fat, "tune_flash_blocks",
                        lambda **kw: pytest.fail("probed without autotune"))
    m = gpt.GPT(gpt.tiny(seq_len=64), device="cpu")
    assert m._flash_blocks() == (1024, 1024)
    assert m._flash_blocks() is m._resolved_flash_blocks


def test_autotuned_gpt_trains_on_its_resolved_blocks(monkeypatch):
    """On the CPU the tuner returns the fitted wanted blocks, so the
    autotuned model's loss is the plain one's bit for bit; ``_attn_half``
    passes the resolved pair to attention."""
    from determined_tpu_torch.models import attention as attn_mod
    from determined_tpu_torch.models import gpt

    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, 256, (2, 64)))
    plain = gpt.GPT(gpt.tiny(seq_len=64), device="cpu")
    tuned = gpt.GPT(dataclasses.replace(gpt.tiny(seq_len=64),
                                        flash_autotune=True), device="cpu")
    assert tuned._flash_blocks() == (64, 64)
    a, _ = plain.loss({"tokens": tokens})
    b, _ = tuned.loss({"tokens": tokens})
    assert torch.equal(a, b)
    seen = []
    real = attn_mod.attention

    def spy(*args, **kw):
        seen.append((kw["block_q"], kw["block_k"]))
        return real(*args, **kw)

    monkeypatch.setattr(attn_mod, "attention", spy)
    tuned._resolved_flash_blocks = (32, 16)
    tuned.loss({"tokens": tokens})
    assert seen and set(seen) == {(32, 16)}


def test_engine_resolves_block_h_through_the_tuner(monkeypatch):
    """The engine asks ``tune_paged_block_h`` for the one-token step and,
    apart, for the speculative verify's draft_len + 1 rows, as the
    reference's engine does, and passes each answer to the paged kernel
    as ``block_h``."""
    from determined_tpu_torch.serving import service

    asked = []

    def tune(**kw):
        asked.append(kw)
        return 2 if kw["q_rows"] == 1 else 1

    monkeypatch.setattr(fat, "tune_paged_block_h", tune)
    eng = service.build_engine(
        {"model": "tiny", "speculation": {"mode": "ngram", "draft_len": 3}},
        device="cpu")
    c, cfg = eng.model.config, eng.cfg
    common = dict(n_heads=c.n_heads, head_dim=c.head_dim,
                  page_size=cfg.page_size, num_pages=cfg.num_pages,
                  pages_per_slot=cfg.max_pages_per_request,
                  batch=cfg.max_batch_size, dtype=c.dtype)
    assert asked == [dict(common, q_rows=1), dict(common, q_rows=4)]
    assert (eng._paged_block_h, eng._spec_block_h) == (2, 1)
    seen = []
    real = eng.model.decode_kv_spec

    def spy(*args, **kw):
        seen.append(kw["block_h"])
        return real(*args, **kw)

    monkeypatch.setattr(eng.model, "decode_kv_spec", spy)
    eng.start()
    try:
        out = eng.submit([1, 2, 3, 1, 2, 3, 1, 2], max_new_tokens=4).result(
            timeout=120)
    finally:
        eng.stop()
    assert len(out["tokens"]) == 4
    assert seen and set(seen) == {1}
