"""The paged CUDA kernel's split page walk and rank-order merge, in its
plain PyTorch form (``_paged_split_plain``), against the JAX package's
Pallas ``_paged_kernel`` in interpret mode and against the port's dense
plain version (``_paged_ref``), on the CPU at fp32.

The kernel gives each (slot, head) a cluster of C = min(4, P) CTAs; rank
c walks the live pages c, c + C, ... and the ranks' (m, l, acc) are
merged in rank order. The cases are the ones that split makes risky:
ranks with no live page (short slots), ranks walking several pages (P =
8 and 11), one rank (C = 1), more ranks than pages, a slot of length 0,
an inactive slot (every rank empty), and ragged q_lens with padding
rows.

Tolerance: atol 2e-5 — fp32 scores and accumulators on every side; the
reference accumulates page by page, ``_paged_ref`` in one dense softmax
and the split version per rank, so only the summation order differs.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

jpa = importlib.import_module("determined_tpu.ops.paged_attention")
tpa = importlib.import_module("determined_tpu_torch.ops.paged_attention")

ATOL = 2e-5
PAGE_SIZE, H, D, B = 16, 2, 16, 5


def _state(seed, p, q_rows, ragged_q):
    """Pools, a shuffled page table of width p, ragged lengths (0, one
    page, the full window and two short slots) and slot 3 inactive."""
    rng = np.random.default_rng(seed)
    num_pages = B * p + 1
    kp = rng.normal(size=(num_pages, PAGE_SIZE, H, D)).astype(np.float32)
    vp = rng.normal(size=(num_pages, PAGE_SIZE, H, D)).astype(np.float32)
    pt = rng.permutation(np.arange(1, num_pages))[:B * p].reshape(B, p)
    q_lens = (rng.integers(1, q_rows + 1, size=B) if ragged_q
              else np.ones(B, np.int64)).astype(np.int32)
    s_max = p * PAGE_SIZE
    lengths = np.array([0, PAGE_SIZE + 1, s_max - q_lens[2], 5, 3 * PAGE_SIZE],
                       np.int32)
    lengths = np.minimum(lengths, s_max - q_lens)
    active = np.array([1, 1, 1, 0, 1], np.int32)
    q = rng.normal(size=(B, q_rows, H, D)).astype(np.float32)
    return q, kp, vp, pt.astype(np.int32), lengths, active, q_lens


def _split(state, n_ranks=None):
    t = torch.from_numpy
    return tpa._paged_split_plain(*(t(x) for x in state),
                                  n_ranks=n_ranks).numpy()


def _dense(state):
    t = torch.from_numpy
    return tpa.paged_attention(*(t(x) for x in state[:-1]),
                               q_lens=t(state[-1])).numpy()


def _pallas(state):
    j = jnp.asarray
    return np.asarray(jpa.paged_attention(
        *(j(x) for x in state[:-1]), q_lens=j(state[-1]), interpret=True))


@pytest.mark.parametrize("p,q_rows,ragged_q", [
    pytest.param(8, 1, False, id="decode-empty-ranks"),
    pytest.param(11, 1, False, id="decode-ranks-walk-pages"),
    pytest.param(8, 5, True, id="ragged-qlens"),
    pytest.param(11, 16, True, id="ragged-qlens-16"),
])
def test_split_merge_matches_pallas_interpret(p, q_rows, ragged_q):
    """C = min(4, P) ranks: the split walk and its rank-order merge give
    the Pallas kernel's output (interpret mode) and the dense plain one."""
    state = _state(p + q_rows, p, q_rows, ragged_q)
    got = _split(state)
    np.testing.assert_allclose(got, _pallas(state), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, _dense(state), atol=ATOL, rtol=0)
    assert (got[3] == 0).all(), "inactive slot: every rank empty, o = 0"


@pytest.mark.parametrize("n_ranks", [1, 3, 8, 16])
def test_split_merge_any_rank_count(n_ranks):
    """The merge is exact for any split, including more ranks than live
    pages (empty ranks with m = NEG_INF, l = 0) and a single rank."""
    state = _state(7, 11, 4, True)
    np.testing.assert_allclose(_split(state, n_ranks), _dense(state),
                               atol=ATOL, rtol=0)


def test_split_merge_fully_masked_slot_is_zero_not_nan():
    """A slot whose ranks all hold nothing (inactive) merges to zeros,
    not NaN, whatever its pages hold; the live slots are unaffected."""
    state = list(_state(3, 8, 2, True))
    state[1] = state[1].copy()
    state[1][state[3][3]] = np.inf  # slot 3's pages: never read
    got = _split(tuple(state))
    assert np.isfinite(got).all() and (got[3] == 0).all()
    np.testing.assert_allclose(got, _dense(tuple(state)), atol=ATOL, rtol=0)


def test_split_merge_never_reads_dead_entries():
    """Dead page-table entries may hold −1 or ids past the pool: the split
    walk, as the kernel, stops at the last live page."""
    state = list(_state(5, 8, 3, True))
    q_lens, lengths = state[6], state[4]
    live = (lengths + q_lens - 1) // PAGE_SIZE + 1
    pt = state[3].copy()
    for b in range(B):
        pt[b, live[b]:] = -1 if b % 2 else state[1].shape[0] + 7
    want = _split(tuple(state))
    state[3] = pt
    np.testing.assert_array_equal(_split(tuple(state)), want)
