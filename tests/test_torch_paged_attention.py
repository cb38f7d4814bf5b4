"""The port's paged decode attention (determined_tpu_torch.ops.
paged_attention) against the JAX package's Pallas kernel in interpret
mode, on the CPU at fp32: shuffled pools, ragged lengths (0 and the full
window included), an inactive slot, and ragged q_lens with q_rows > 1.

Tolerance: atol 2e-5 — both sides compute fp32 scores and accumulators;
the reference accumulates page by page (online softmax), the plain
version in one dense softmax, so only the summation order differs.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

jpa = importlib.import_module("determined_tpu.ops.paged_attention")
tpa = importlib.import_module("determined_tpu_torch.ops.paged_attention")

ATOL = 2e-5
NUM_PAGES, PAGE_SIZE, H, D, B, P = 21, 16, 2, 16, 5, 4


def _state(seed, q_rows, ragged_q):
    rng = np.random.default_rng(seed)
    kp = rng.normal(size=(NUM_PAGES, PAGE_SIZE, H, D)).astype(np.float32)
    vp = rng.normal(size=(NUM_PAGES, PAGE_SIZE, H, D)).astype(np.float32)
    pt = rng.permutation(np.arange(1, NUM_PAGES))[:B * P].reshape(B, P)
    pt = pt.astype(np.int32)
    q_lens = (rng.integers(1, q_rows + 1, size=B) if ragged_q
              else np.ones(B, np.int64)).astype(np.int32)
    s_max = P * PAGE_SIZE
    lengths = np.array([0, 17, s_max - q_lens[2], 5, 40], np.int32)
    lengths = np.minimum(lengths, s_max - q_lens)
    active = np.array([1, 1, 1, 0, 1], np.int32)
    q = rng.normal(size=(B, q_rows, H, D)).astype(np.float32)
    return q, kp, vp, pt, lengths, active, q_lens


def _torch(q, kp, vp, pt, lengths, active, q_lens, **kw):
    t = torch.from_numpy
    return tpa.paged_attention(
        t(q), t(kp), t(vp), t(pt), t(lengths), t(active),
        q_lens=None if q_lens is None else t(q_lens), **kw,
    ).numpy()


def _jax(q, kp, vp, pt, lengths, active, q_lens, **kw):
    j = jnp.asarray
    return np.asarray(jpa.paged_attention(
        j(q), j(kp), j(vp), j(pt), j(lengths), j(active),
        q_lens=None if q_lens is None else j(q_lens), interpret=True, **kw,
    ))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("q_rows,ragged_q", [
    pytest.param(1, False, id="decode"),
    pytest.param(4, False, id="qpad4"),
    pytest.param(4, True, id="verify-ragged4"),
])
def test_matches_pallas_interpret(q_rows, ragged_q, seed):
    state = _state(seed, q_rows, ragged_q)
    q_lens = state[-1] if ragged_q else None
    out_t = _torch(*state[:-1], q_lens)
    out_j = _jax(*state[:-1], q_lens)
    np.testing.assert_allclose(out_t, out_j, atol=ATOL, rtol=0)
    assert (out_t[3] == 0).all(), "inactive slot must output zeros"


def test_dead_table_entries_never_dereferenced():
    """Entries past a slot's live pages may hold anything, even ids
    outside the pool: the plain version clamps them onto the last live
    page, as the kernel never reads them."""
    q, kp, vp, pt, lengths, active, q_lens = _state(2, 4, True)
    live = (lengths + q_lens - 1) // PAGE_SIZE + 1
    poisoned = pt.copy()
    for b in range(B):
        poisoned[b, live[b]:] = 10 ** 6
    np.testing.assert_array_equal(
        _torch(q, kp, vp, poisoned, lengths, active, q_lens),
        _torch(q, kp, vp, pt, lengths, active, q_lens),
    )


BAD_CALLS = {
    "pool-heads": dict(pool_heads=H + 1),
    "table-batch": dict(table_rows=B - 1),
    "block-h-divides": dict(block_h=3),
}


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_validation_errors_match(case):
    kw = dict(BAD_CALLS[case])
    q, kp, vp, pt, lengths, active, _ = _state(0, 1, False)
    if "pool_heads" in kw:
        shape = (NUM_PAGES, PAGE_SIZE, kw.pop("pool_heads"), D)
        kp = vp = np.zeros(shape, np.float32)
    if "table_rows" in kw:
        pt = pt[:kw.pop("table_rows")]
    with pytest.raises(ValueError) as err_t:
        _torch(q, kp, vp, pt, lengths, active, None, **kw)
    with pytest.raises(ValueError) as err_j:
        _jax(q, kp, vp, pt, lengths, active, None, **kw)
    assert str(err_t.value) == str(err_j.value)


@pytest.mark.parametrize("with_q_lens", [False, True])
def test_pages_read_matches(with_q_lens):
    _, _, _, _, lengths, active, q_lens = _state(3, 4, True)
    ql = q_lens if with_q_lens else None
    assert tpa.paged_pages_read(lengths, active, PAGE_SIZE, q_lens=ql) == \
        jpa.paged_pages_read(lengths, active, PAGE_SIZE, q_lens=ql)


@pytest.mark.parametrize("n_heads,head_dim,page_size", [
    (12, 64, 128), (16, 64, 256), (4, 16, 16),
])
def test_default_block_h_matches(n_heads, head_dim, page_size):
    for t_dtype, j_dtype in ((torch.float32, jnp.float32),
                             (torch.bfloat16, jnp.bfloat16)):
        assert tpa.default_paged_block_h(n_heads, head_dim, page_size,
                                         t_dtype) == \
            jpa.default_paged_block_h(n_heads, head_dim, page_size, j_dtype)
    assert tpa.LANE_GRANULE == jpa.LANE_GRANULE
