"""The port's speculative decoding (determined_tpu_torch.serving.
speculation, ``GPT.decode_kv_spec`` and the engine's verify branch)
against the JAX package's, on the CPU at fp32.

- ``propose_ngram_draft`` equals the reference's on seeded histories;
- ``GPT.decode_kv_spec`` logits and pools match the JAX method within
  1e-5: the paged path through the port's plain version against the
  Pallas kernel in interpret mode, the gather path through flash;
- spec-on greedy streams equal the JAX engine's on the churn scenario for
  draft_len 1, 4 and 8 on both decode paths (cache off and on), with
  drafts accepted; forced-wrong drafts rewind to the never-speculated
  streams; a ``serving.speculation`` fault degrades to counted plain
  decode; ``DTPU_SPEC_DECODE`` 0 and 1 mean what they mean in the
  reference.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from determined_tpu.batch_inference import pack_sequences
from determined_tpu.models import gpt as jgpt
from determined_tpu.serving import GenerationEngine as JaxEngine
from determined_tpu.serving import config as jconfig
from determined_tpu.serving.speculation import (
    propose_ngram_draft as ref_propose,
)
from determined_tpu_torch.common import faults
from determined_tpu_torch.models import gpt as tgpt
from determined_tpu_torch.serving import GenerationEngine, ServingConfig
from determined_tpu_torch.serving import engine as engine_mod
from determined_tpu_torch.serving.speculation import propose_ngram_draft

ENGINE_KW = dict(
    page_size=16, num_pages=33, max_pages_per_request=4, max_batch_size=4,
    max_new_tokens=32, prefill_rows=2, prefill_seq=32, max_queue_depth=8,
    default_deadline_s=300.0,
)
MODEL_KW = dict(vocab_size=256, n_layers=2, n_heads=4, d_model=64, d_ff=256,
                seq_len=128, remat=False)
SPEC = {"mode": "ngram", "draft_len": 4, "min_match": 2}
#: n-gram-rich prompts: trailing grams recur inside each prompt, so the
#: proposer fires from the first decode iteration.
LONG_PROMPT = [1, 2, 3, 4, 1, 2, 3, 4, 1, 2]
SHORT_PROMPT = [9, 8, 9, 8, 9]
LATE_PROMPT = [7, 7, 2, 7, 7]


@pytest.fixture(scope="module")
def weights():
    model = jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **MODEL_KW))
    params = model.init(jax.random.PRNGKey(0))
    return model, params, jax.device_get(params)


def _port_model(tree):
    model = tgpt.GPT(tgpt.GPTConfig(dtype=torch.float32, **MODEL_KW),
                     device="cpu")
    tgpt.load_jax_params(model, tree, serving_copy=True)
    return model


def _port_engine(tree, **overrides):
    model = tgpt.GPT(tgpt.GPTConfig(dtype=torch.float32, **MODEL_KW),
                     device="cpu")
    return GenerationEngine(model, tree, ServingConfig(**{**ENGINE_KW,
                                                          **overrides}),
                            device="cpu")


# -- the proposer -----------------------------------------------------------------
@pytest.mark.parametrize("seed,vocab,min_match", [
    (0, 3, 1), (1, 4, 2), (2, 8, 2), (3, 5, 3), (4, 2 ** 31 - 1, 1),
    (5, 6, 4),
])
def test_proposer_equals_reference(seed, vocab, min_match):
    rng = np.random.default_rng(seed)
    fired = 0
    for _ in range(200):
        n = int(rng.integers(0, 40))
        if vocab > 2 ** 16:   # int32 values whose bytes overlap unaligned
            hist = [int(x) for x in rng.choice(
                [0x01000000, 0x00000001, 0x00010000, 0x00000100], size=n)]
        else:
            hist = [int(x) for x in rng.integers(0, vocab, size=n)]
        draft_len = int(rng.integers(0, 9))
        got = propose_ngram_draft(hist, draft_len, min_match)
        assert got == ref_propose(hist, draft_len, min_match)
        fired += bool(got)
    assert fired > 0


def test_proposer_units():
    assert propose_ngram_draft([1, 2, 3, 4, 1, 2], 4, 2) == [3, 4, 1, 2]
    assert propose_ngram_draft([1, 2, 9, 1, 2, 7, 1, 2], 3, 2) == [7, 1, 2]
    assert propose_ngram_draft([1, 2, 3, 4, 5], 4, 2) == []
    assert propose_ngram_draft([5, 1, 5], 4, 1) == [1, 5]
    assert propose_ngram_draft([3, 3, 3, 3], 4, 2) == [3]


# -- decode_kv_spec against the JAX method ---------------------------------------
def _spec_state(jmodel, params):
    """Two slots prefilled into pages (slot 0 at length 4 on pages 1-4,
    slot 1 at length 2 on pages 5-8), a third slot inactive."""
    cfg = jmodel.config
    ck = np.zeros((cfg.n_layers, 33, 16, cfg.n_heads, cfg.head_dim),
                  np.float32)
    cv = np.zeros_like(ck)
    batch = list(pack_sequences([[1, 2, 3, 4], [9, 8]], 32, 2,
                                overflow="error"))[0]
    positions = np.zeros_like(batch["tokens"])
    positions[0, :4] = np.arange(4)
    positions[1, :2] = np.arange(2)
    _logits, k_l, v_l = jmodel.prefill_kv(
        params, jnp.asarray(batch["tokens"]), jnp.asarray(positions),
        jnp.asarray(batch["segment_ids"]))
    for row, page in ((0, 1), (1, 5)):
        ck[:, page] = np.asarray(k_l)[:, row, :16]
        cv[:, page] = np.asarray(v_l)[:, row, :16]
    pt = np.zeros((3, 4), np.int32)
    pt[0] = [1, 2, 3, 4]
    pt[1] = [5, 6, 7, 8]
    return ck, cv, pt


@pytest.mark.parametrize("kernel", ["paged", "gather"])
@pytest.mark.parametrize("lengths,q_lens", [
    ((4, 2, 0), (5, 1, 1)),      # a full draft beside a plain slot
    ((14, 30, 0), (3, 2, 1)),    # drafts crossing a page boundary
])
def test_decode_kv_spec_matches_jax(weights, kernel, lengths, q_lens):
    jmodel, params, tree = weights
    ck, cv, pt = _spec_state(jmodel, params)
    rng = np.random.default_rng(sum(lengths))
    toks = rng.integers(1, 256, size=(3, 5)).astype(np.int32)
    args = (toks, np.array(lengths, np.int32), np.array(q_lens, np.int32),
            np.array([1, 1, 0], bool))
    want, wk, wv = jmodel.decode_kv_spec(
        params, *(jnp.asarray(a) for a in args), jnp.asarray(ck),
        jnp.asarray(cv), jnp.asarray(pt), q_pad=1, kernel=kernel,
        interpret=kernel == "paged")
    model = _port_model(tree)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, gk, gv = model.decode_kv_spec(
        *(torch.from_numpy(a) for a in args), tk, tv, torch.from_numpy(pt),
        q_pad=1, kernel=kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # pools: every page but scratch page 0, where dead rows collide
    for g, w in ((gk, wk), (gv, wv)):
        np.testing.assert_allclose(g.numpy()[:, 1:], np.asarray(w)[:, 1:],
                                   atol=1e-5, rtol=1e-5)


def test_verify_rows_are_plain_decode(weights):
    """decode_kv_spec's greedy rows over the TRUE continuation equal the
    plain decode stream, and after a rejected tail plain decode from the
    rewound length rejoins it (the never-speculated state)."""
    jmodel, params, tree = weights
    ck, cv, pt = _spec_state(jmodel, params)
    model = _port_model(tree)
    active = torch.tensor([1, 1, 0], dtype=torch.bool)

    def plain(ckx, cvx, lengths, last, steps):
        stream = []
        for _ in range(steps):
            lg, ckx, cvx = model.decode_kv(
                torch.tensor(last), torch.tensor(lengths), active, ckx, cvx,
                torch.from_numpy(pt), kernel="gather")
            last = lg.argmax(-1).tolist()
            stream.append(last[0])
            lengths = [n + 1 for n in lengths]
        return stream

    base = plain(torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()),
                 [4, 2, 0], [7, 9, 0], 5)
    toks = torch.tensor([[7, *base[:3]], [9, 0, 0, 0], [0, 0, 0, 0]])
    toks[0, 2] = (toks[0, 2] + 1) % 256           # corrupt draft row 2
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    lg, tk, tv = model.decode_kv_spec(
        toks, torch.tensor([4, 2, 0]), torch.tensor([4, 1, 1]), active, tk,
        tv, torch.from_numpy(pt), kernel="gather")
    assert lg.argmax(-1)[0, :2].tolist() == base[:2]
    assert plain(tk, tv, [5, 3, 0], [base[0], 0, 0], 3)[:3] == base[1:4]


# -- the engine: churn streams against the JAX engine ------------------------------
def _churn(eng):
    """tests/test_speculation.py's late-join/early-free churn scenario
    (plus a prefix-cache hit when the cache is on)."""
    eng.start()
    try:
        long_req = eng.submit(LONG_PROMPT, max_new_tokens=24)
        stream = long_req.stream(timeout=180)
        kind, _ = next(stream)
        assert kind == "token"
        short = eng.submit(SHORT_PROMPT, max_new_tokens=3)
        tiny = eng.submit([42], max_new_tokens=2)
        assert short.result(timeout=180)["reason"] == "length"
        assert tiny.result(timeout=180)["reason"] == "length"
        late = eng.submit(LATE_PROMPT, max_new_tokens=6)
        assert late.result(timeout=180)["reason"] == "length"
        for _kind, _payload in stream:
            pass
        assert long_req.finish_reason == "length"
        out = {"long": list(long_req.tokens), "short": list(short.tokens),
               "tiny": list(tiny.tokens), "late": list(late.tokens)}
        if eng.prefix_cache is not None:
            hit = eng.submit((LONG_PROMPT + out["long"])[:18],
                             max_new_tokens=4)
            assert hit.result(timeout=180)["reason"] == "length"
            assert eng.prefix_cache.hits > 0, "prefix cache never hit"
            out["hit"] = list(hit.tokens)
        held = len(eng.prefix_cache) if eng.prefix_cache is not None else 0
        assert eng.pool.pages_in_use == held
        stats = eng.stats()["speculation"]
    finally:
        eng.stop()
    return out, stats


_JAX = {}


def _jax_streams(weights, cache, spec):
    key = (cache, spec["mode"])
    if key not in _JAX:
        model, params, _ = weights
        _JAX[key] = _churn(JaxEngine(model, params, jconfig.ServingConfig(
            **ENGINE_KW, prefix_cache=cache, speculation=spec)))
    return _JAX[key]


@pytest.mark.parametrize("draft_len", [1, 4, 8])
@pytest.mark.parametrize("paged_env", ["1", "0"], ids=["paged", "gather"])
def test_spec_streams_match_jax_engine(weights, paged_env, draft_len,
                                       monkeypatch):
    monkeypatch.setenv("DTPU_PAGED_ATTN", paged_env)
    base, _ = _jax_streams(weights, "off", {"mode": "off"})
    streams, stats = _churn(_port_engine(weights[2], speculation={
        "mode": "ngram", "draft_len": draft_len, "min_match": 2}))
    assert streams == base
    assert stats["proposed_tokens"] > 0, "speculation never proposed"
    assert stats["accepted_tokens"] > 0, "speculation never accepted"
    assert stats["proposed_tokens"] == (stats["accepted_tokens"]
                                        + stats["rollback_tokens"])


@pytest.mark.parametrize("paged_env", ["1", "0"], ids=["paged", "gather"])
def test_spec_with_cache_matches_jax_spec_engine(weights, paged_env,
                                                 monkeypatch):
    """Cache on and speculation on: the port's streams AND speculation
    counters equal the JAX engine's under the same settings."""
    monkeypatch.setenv("DTPU_PAGED_ATTN", "0")
    want, want_stats = _jax_streams(weights, "on", SPEC)
    monkeypatch.setenv("DTPU_PAGED_ATTN", paged_env)
    streams, stats = _churn(_port_engine(weights[2], prefix_cache="on",
                                         speculation=SPEC))
    assert streams == want
    assert stats == want_stats
    assert stats["accepted_tokens"] > 0


def test_forced_wrong_drafts_rewind(weights, monkeypatch):
    """Every draft is made wrong: every iteration writes a draft K/V
    tail, rejects it and rewinds. The stream equals the never-speculated
    one, the counters show pure rollback and no page leaks."""
    prompt = [3, 1, 4, 1, 5]
    eng = _port_engine(weights[2])
    eng.start()
    try:
        base = eng.submit(prompt, max_new_tokens=8).result(
            timeout=180)["tokens"]
    finally:
        eng.stop()

    def wrong_draft(history, draft_len, min_match):
        k = len(history) - len(prompt)
        return [] if k >= len(base) else [(base[k] + 1) % 256]

    monkeypatch.setattr(engine_mod, "propose_ngram_draft", wrong_draft)
    eng = _port_engine(weights[2], speculation=SPEC)
    eng.start()
    try:
        out = eng.submit(prompt, max_new_tokens=8).result(timeout=180)
        stats = eng.stats()["speculation"]
    finally:
        eng.stop()
    assert out["tokens"] == base
    assert stats["proposed_tokens"] > 0 and stats["accepted_tokens"] == 0
    assert stats["rollback_tokens"] == stats["proposed_tokens"]
    assert eng.pool.pages_in_use == 0


def test_fault_degrades_to_counted_plain_decode(weights, monkeypatch):
    monkeypatch.setenv("DTPU_PAGED_ATTN", "0")
    base, _ = _jax_streams(weights, "off", {"mode": "off"})
    before = engine_mod.SPEC_FALLBACKS.value
    plan = faults.FaultPlan({"serving.speculation": faults.FaultSpec(
        failures=2)})
    with faults.plan_active(plan):
        streams, stats = _churn(_port_engine(weights[2], speculation=SPEC))
    assert streams == base
    assert stats["fallbacks"] == 2
    assert engine_mod.SPEC_FALLBACKS.value == before + 2
    assert stats["proposed_tokens"] > 0


def test_mixed_batch_sampled_and_greedy_slots(weights):
    """Sampled slots never speculate but ride the same verify call
    (q_lens = 1); greedy batch-mates keep their streams."""
    outs = {}
    for spec in ({"mode": "off"}, SPEC):
        eng = _port_engine(weights[2], speculation=spec)
        eng.start()
        try:
            greedy = eng.submit(LONG_PROMPT, max_new_tokens=10)
            hot = eng.submit([6, 6, 6], max_new_tokens=8, temperature=0.7)
            assert greedy.result(timeout=180)["reason"] == "length"
            assert hot.result(timeout=180)["reason"] == "length"
            outs[spec["mode"]] = (list(greedy.tokens), list(hot.tokens))
        finally:
            eng.stop()
    assert outs["off"][0] == outs["ngram"][0]
    assert len(outs["ngram"][1]) == 8
    assert all(0 <= t < 256 for t in outs["ngram"][1])


@pytest.mark.parametrize("env,spec,mode", [
    ("0", SPEC, "off"), ("1", {"mode": "off"}, "ngram"), ("", SPEC, "ngram"),
])
def test_spec_decode_env(weights, env, spec, mode, monkeypatch):
    monkeypatch.setenv("DTPU_SPEC_DECODE", env)
    model, params, tree = weights
    ref = JaxEngine(model, params, jconfig.ServingConfig(
        **ENGINE_KW, speculation=spec)).stats()["speculation"]
    got = _port_engine(tree, speculation=spec).stats()["speculation"]
    assert got == ref and got["mode"] == mode
