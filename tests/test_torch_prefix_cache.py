"""The port's prefix cache (determined_tpu_torch.serving.kv_cache and the
engine's cached-tail path) against the JAX package's, on the CPU at fp32.

- ``prefix_block_hashes`` is byte-identical to the reference's (the
  master's router hashes prompts with the reference's function to pick the
  replica that holds the pages);
- the radix-tree cases of tests/test_prefix_cache.py run against the
  port's ``PrefixCache`` and ``PagePool``;
- ``GPT.prefill_kv_cached`` matches the JAX method within 1e-5 on the same
  numpy parameters and gathered prefix;
- the churn scenario with ``prefix_cache: on`` streams what the JAX engine
  streams, on the paged and the gather decode path, with hits > 0; the
  engine-level cases (page reuse, the boundary prompt, eviction under pool
  pressure, the fault drills) hold for the port engine.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from determined_tpu.models import gpt as jgpt
from determined_tpu.serving import GenerationEngine as JaxEngine
from determined_tpu.serving import config as jconfig
from determined_tpu.serving import kv_cache as jkv
from determined_tpu_torch.common import faults
from determined_tpu_torch.models import gpt as tgpt
from determined_tpu_torch.serving import GenerationEngine, ServingConfig
from determined_tpu_torch.serving.kv_cache import (
    PagePool,
    PoolExhausted,
    PrefixCache,
    prefix_block_hashes,
)

ENGINE_KW = dict(
    page_size=16, num_pages=33, max_pages_per_request=4, max_batch_size=4,
    max_new_tokens=32, prefill_rows=2, prefill_seq=32, max_queue_depth=8,
    default_deadline_s=300.0,
)
MODEL_KW = dict(vocab_size=256, n_layers=2, n_heads=4, d_model=64, d_ff=256,
                seq_len=128, remat=False)
PREFIX = [(3 * i) % 200 + 1 for i in range(16)]   # one full page


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


def _assert_greedy(model, prompt, generated):
    """One full-context forward of the port argmax-predicts every
    emitted token."""
    seq = list(prompt) + list(generated)
    logits = model.apply(torch.tensor([seq]))
    for i in range(len(prompt) - 1, len(seq) - 1):
        assert int(logits[0, i].argmax()) == seq[i + 1], i


# -- chain hashes ---------------------------------------------------------------
@pytest.mark.parametrize("block,n,max_blocks,seed", [
    (2, 9, None, 0), (16, 100, None, 1), (128, 700, 3, 2), (4, 3, None, 3),
    (16, 64, 0, 4),
])
def test_block_hashes_equal_reference(block, n, max_blocks, seed):
    rng = np.random.default_rng(seed)
    for _ in range(4):
        toks = [int(t) for t in rng.integers(0, 50304, size=n)]
        assert (prefix_block_hashes(toks, block, max_blocks)
                == jkv.prefix_block_hashes(toks, block, max_blocks))


def test_chain_commits_to_whole_prefix():
    a = prefix_block_hashes([1, 2, 3, 4, 9, 9], 2)
    c = prefix_block_hashes([5, 6, 3, 4, 9, 9], 2)
    assert len(a) == 3 and a[0] != c[0]
    assert a[1] != c[1], "same block, different prefix, same hash"
    assert len(prefix_block_hashes([1, 2, 3], 2)) == 1
    assert prefix_block_hashes([1], 2) == []


# -- the radix tree (tests/test_prefix_cache.py's cases) ----------------------
def _cache(num_pages=9):
    pool = PagePool(num_pages)
    return pool, PrefixCache(pool, 4)


def _retire(cache, tokens, pages, matched=(), cacheable=True):
    cache.finish(list(tokens), list(pages), list(matched), cacheable)


def test_insert_then_match_leaves_a_tail():
    pool, cache = _cache()
    toks = [1, 2, 3, 4, 5, 6, 7, 8]
    _retire(cache, toks, pool.alloc(3))         # 2 full pages cached
    assert len(cache) == 2
    assert pool.free_pages == 8 - 2             # spare page went back
    assert len(cache.match(toks + [9])) == 2
    # a prompt ENDING on the boundary keeps its last page as tail
    assert len(cache.match(toks)) == 1
    assert len(cache.match([1, 2, 3, 4])) == 0
    assert len(cache.match([1, 2, 3, 4, 9, 9, 9, 9, 9])) == 1


def test_refcounted_page_never_evicted():
    pool, cache = _cache(num_pages=5)           # 4 allocatable
    _retire(cache, list(range(8)), pool.alloc(3))
    nodes = cache.match(list(range(8)) + [99])
    assert len(nodes) == 2
    cache.acquire(nodes)
    with pytest.raises(PoolExhausted):
        pool.alloc(3)                           # both cached pages pinned
    assert pool.free_pages == 2 and len(cache) == 2
    cache.release(nodes)
    assert len(pool.alloc(3)) == 3              # evicts one cached page
    assert cache.evictions == 1 and len(cache) == 1


def test_eviction_is_leaf_first_lru():
    pool, cache = _cache(num_pages=9)
    base = [1, 2, 3, 4]
    _retire(cache, base + [5, 6, 7, 8], pool.alloc(3))      # A -> B
    _retire(cache, base + [9, 10, 11, 12], pool.alloc(3))   # A -> C
    assert len(cache) == 3
    root_page = cache.match(base + [0])[0].page
    nodes = cache.match(base + [5, 6, 7, 8, 0])   # touch A->B: C is LRU
    cache.acquire(nodes)
    cache.release(nodes)
    freed = cache.evict(1)
    assert len(freed) == 1 and freed[0] != root_page
    assert cache.match(base + [9, 10, 11, 12, 0])[-1].page == root_page
    freed = cache.evict(2)
    assert root_page == freed[-1] and len(cache) == 0


def test_duplicate_insert_dedupes():
    pool, cache = _cache()
    toks = [1, 2, 3, 4, 5, 6, 7, 8]
    _retire(cache, toks, pool.alloc(2))
    free_before = pool.free_pages
    _retire(cache, toks, pool.alloc(2))
    assert len(cache) == 2 and pool.free_pages == free_before


def test_flush_returns_everything():
    pool, cache = _cache()
    _retire(cache, list(range(8)), pool.alloc(2))
    cache.flush()
    assert len(cache) == 0 and pool.free_pages == 8


def test_uncacheable_retire_frees_fresh_pages_only():
    pool, cache = _cache()
    _retire(cache, list(range(8)), pool.alloc(2))
    nodes = cache.match(list(range(8)) + [9])
    cache.acquire(nodes)
    fresh = pool.alloc(2)
    _retire(cache, list(range(9)), [n.page for n in nodes] + fresh,
            matched=nodes, cacheable=False)
    assert len(cache) == 2 and pool.free_pages == 6


def test_page_alloc_fault_is_exhaustion():
    pool = PagePool(9)
    plan = faults.FaultPlan({"serving.page_alloc": faults.FaultSpec(
        failures=1)})
    with faults.plan_active(plan):
        with pytest.raises(PoolExhausted):
            pool.alloc(1)
        assert pool.alloc(1)                    # the budget of 1 is spent
    assert pool.pages_in_use == 1


def test_stats_match_reference_tree():
    """The same operations on the port's tree and the reference's give
    the same stats and page ids."""
    out = []
    for kv in (jkv, None):
        mod_pool = (kv.PagePool if kv else PagePool)(9)
        cache = (kv.PrefixCache if kv else PrefixCache)(mod_pool, 4)
        cache.finish(list(range(12)), mod_pool.alloc(3), [], True)
        nodes = cache.match(list(range(12)) + [5])
        cache.acquire(nodes)
        cache.note_hit(len(nodes))
        cache.note_miss()
        fresh = mod_pool.alloc(5)               # evicts nothing: pinned
        cache.finish(list(range(12)) + [5, 6, 7, 8],
                     [n.page for n in nodes] + fresh, nodes, True)
        mod_pool.alloc(6)                       # now evicts
        out.append((cache.stats(), [n.page for n in nodes], fresh,
                    mod_pool.free_pages))
    assert out[0] == out[1]


# -- prefill_kv_cached against the JAX method ----------------------------------
@pytest.mark.parametrize("prefix_lens,tail_lens", [
    ((16, 48), (32, 5)), ((64, 0), (1, 17)),
])
def test_prefill_kv_cached_matches_jax(weights, prefix_lens, tail_lens):
    jmodel, params, tree = weights
    cfg = jmodel.config
    rows, seq, sp = 2, 32, 64
    rng = np.random.default_rng(sum(prefix_lens))
    tokens = np.zeros((rows, seq), np.int32)
    positions = np.zeros((rows, seq), np.int32)
    segs = np.zeros((rows, seq), np.int32)
    for r, (pl, tl) in enumerate(zip(prefix_lens, tail_lens)):
        tokens[r, :tl] = rng.integers(1, 256, size=tl)
        positions[r, :tl] = pl + np.arange(tl)
        segs[r, :tl] = 1
    shape = (cfg.n_layers, rows, sp, cfg.n_heads, cfg.head_dim)
    pk = rng.standard_normal(shape).astype(np.float32)
    pv = rng.standard_normal(shape).astype(np.float32)
    prefix_seg = (np.arange(sp)[None, :]
                  < np.array(prefix_lens)[:, None]).astype(np.int32)
    want = jmodel.prefill_kv_cached(
        params, *(jnp.asarray(a) for a in (tokens, positions, segs, pk, pv,
                                           prefix_seg)))
    model = tgpt.GPT(tgpt.GPTConfig(dtype=torch.float32, **MODEL_KW),
                     device="cpu")
    tgpt.load_jax_params(model, tree, serving_copy=True)
    got = model.prefill_kv_cached(
        *(torch.from_numpy(a) for a in (tokens, positions, segs, pk, pv,
                                        prefix_seg)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


# -- the engine ---------------------------------------------------------------
def _churn(eng):
    """tests/test_prefix_cache.py's parity scenario: a warm request
    mid-decode, late joiners sharing its prefix page, early finishers
    retired into the cache, then reuse after the churn."""
    eng.start()
    try:
        warm = eng.submit(PREFIX + [5], max_new_tokens=10)
        stream = warm.stream(timeout=180)
        kind, _ = next(stream)
        assert kind == "token"
        a = eng.submit(PREFIX + [7, 8, 9], max_new_tokens=3)
        b = eng.submit(PREFIX + [11], max_new_tokens=2)
        assert a.result(timeout=180)["reason"] == "length"
        assert b.result(timeout=180)["reason"] == "length"
        c = eng.submit(PREFIX + [7, 8, 9], max_new_tokens=4)
        assert c.result(timeout=180)["reason"] == "length"
        for _ in stream:
            pass
        assert warm.finish_reason == "length"
        held = len(eng.prefix_cache) if eng.prefix_cache is not None else 0
        assert eng.pool.pages_in_use == held
        stats = eng.stats()
    finally:
        eng.stop()
    return {"warm": list(warm.tokens), "a": list(a.tokens),
            "b": list(b.tokens), "c": list(c.tokens)}, stats


@pytest.fixture(scope="module")
def jax_streams(weights):
    model, params, _ = weights
    eng = JaxEngine(model, params, jconfig.ServingConfig(
        **ENGINE_KW, prefix_cache="on"))
    streams, stats = _churn(eng)
    assert stats["prefix_cache"]["hits"] > 0
    return streams


@pytest.mark.parametrize("paged_env", ["1", "0"], ids=["paged", "gather"])
@pytest.mark.parametrize("cache", ["on", "off"])
def test_churn_streams_match_jax_engine(weights, jax_streams, paged_env,
                                        cache, monkeypatch):
    monkeypatch.setenv("DTPU_PAGED_ATTN", paged_env)
    eng = _port_engine(weights[2], prefix_cache=cache)
    streams, stats = _churn(eng)
    assert streams == jax_streams
    if cache == "on":
        assert stats["prefix_cache"]["hits"] > 0
        assert stats["cache_hit_rate"] > 0
    _assert_greedy(eng.model, PREFIX + [5], streams["warm"])
    _assert_greedy(eng.model, PREFIX + [7, 8, 9], streams["c"])


def _run(eng, prompt, mnt=5):
    out = eng.submit(list(prompt), max_new_tokens=mnt).result(timeout=180)
    assert "error" not in out, out
    return out["tokens"]


def test_hit_reuses_pages_and_streams_match(weights):
    eng = _port_engine(weights[2], prefix_cache="on")
    eng.start()
    try:
        a = _run(eng, PREFIX + [7, 8, 9])
        b = _run(eng, PREFIX + [7, 8, 9])
        c = _run(eng, PREFIX + [11])
        st = eng.stats()
        assert st["prefix_cache"]["hits"] >= 2
        assert st["prefix_cache"]["pages_reused"] >= 2
        assert a == b
        _assert_greedy(eng.model, PREFIX + [7, 8, 9], a)
        _assert_greedy(eng.model, PREFIX + [11], c)
    finally:
        eng.stop()
    assert eng.pool.pages_in_use == len(eng.prefix_cache)


def test_boundary_prompt_still_prefills_a_tail(weights):
    eng = _port_engine(weights[2], prefix_cache="on")
    eng.start()
    try:
        prompt = [(5 * i) % 150 + 1 for i in range(32)]  # 2 pages
        a = _run(eng, prompt)
        b = _run(eng, prompt)
        assert a == b
        _assert_greedy(eng.model, prompt, a)
        assert eng.stats()["prefix_cache"]["pages_reused"] <= 1
    finally:
        eng.stop()


def test_pool_pressure_evicts_before_failing(weights):
    eng = _port_engine(weights[2], prefix_cache="on", num_pages=9,
                       max_pages_per_request=4, max_new_tokens=8)
    eng.start()
    try:
        for base in (1, 60, 120, 180):
            _run(eng, [base + i for i in range(30)], mnt=3)
        assert len(eng.prefix_cache) > 0
        before = eng.prefix_cache.evictions
        assert len(_run(eng, [200 + i for i in range(30)], mnt=3)) == 3
        assert eng.prefix_cache.evictions > before
        assert eng.stats()["shed"] == 0
    finally:
        eng.stop()


def test_fault_drill_falls_back_to_full_prefill(weights):
    eng = _port_engine(weights[2], prefix_cache="on")
    eng.start()
    try:
        warm = _run(eng, PREFIX + [7, 8])
        plan = faults.FaultPlan(
            {"serving.prefix_cache": faults.FaultSpec(failures=1)})
        with faults.plan_active(plan):
            drilled = _run(eng, PREFIX + [7, 8])
        assert drilled == warm
        st = eng.stats()["prefix_cache"]
        assert st["fallbacks"] == 1 and st["hits"] == 0
        assert _run(eng, PREFIX + [7, 8]) == warm
        assert eng.stats()["prefix_cache"]["hits"] == 1
    finally:
        eng.stop()


def test_decode_fault_does_not_cache_suspect_pages(weights):
    eng = _port_engine(weights[2], prefix_cache="on")
    eng.start()
    try:
        plan = faults.FaultPlan({"serving.decode": faults.FaultSpec(
            failures=1)})
        with faults.plan_active(plan):
            out = eng.submit([1, 2, 3, 4] * 5, max_new_tokens=6).result(
                timeout=180)
        assert "error" in out
        assert len(eng.prefix_cache) == 0 and eng.pool.pages_in_use == 0
    finally:
        eng.stop()
