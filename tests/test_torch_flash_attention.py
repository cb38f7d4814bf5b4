"""The port's flash attention (determined_tpu_torch.ops.flash_attention)
against the JAX package's, on the CPU at fp32.

On CPU tensors the port runs its plain version (the blockwise scan); the
reference runs its own blockwise scan on the CPU, and a few cases also go
through the Pallas forward kernel in interpret mode. Same inputs, made
with numpy from a seed.

Tolerances: o atol 2e-5, lse atol 1e-5 — both sides compute fp32 scores,
probabilities and accumulators; only the summation order differs.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# The reference's ops package re-exports the function under the module's
# name, so the module is fetched by its full name.
jfa = importlib.import_module("determined_tpu.ops.flash_attention")
tfa = importlib.import_module("determined_tpu_torch.ops.flash_attention")

B, H, D = 2, 2, 16
O_ATOL, LSE_ATOL = 2e-5, 1e-5


def _packed_ids(rng, b, s):
    """Per row: 2-3 documents back to back, then a padding tail (id 0)."""
    ids = np.zeros((b, s), np.int32)
    for r in range(b):
        pos, doc = 0, 1
        while doc <= 3 and pos < s - 4:
            ln = int(rng.integers(3, s // 3))
            ids[r, pos:pos + ln] = doc
            pos += ln
            doc += 1
    return ids


def _inputs(seed, s_q, s_k, segments):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, s_q, H, D)).astype(np.float32)
    k = rng.normal(size=(B, s_k, H, D)).astype(np.float32)
    v = rng.normal(size=(B, s_k, H, D)).astype(np.float32)
    qseg = kseg = None
    if segments:
        kseg = _packed_ids(rng, B, s_k)
        qseg = kseg[:, s_k - s_q:]  # bottom-aligned, like decode layouts
    return q, k, v, qseg, kseg


def _torch_call(q, k, v, qseg, kseg, **kw):
    t = torch.from_numpy
    return tfa.flash_attention_lse(
        t(q), t(k), t(v),
        segment_ids=None if qseg is None else t(qseg),
        kv_segment_ids=None if kseg is None else t(kseg), **kw,
    )


def _jax_call(q, k, v, qseg, kseg, **kw):
    j = jnp.asarray
    return jfa.flash_attention_lse(
        j(q), j(k), j(v),
        segment_ids=None if qseg is None else j(qseg),
        kv_segment_ids=None if kseg is None else j(kseg), **kw,
    )


MASKS = [
    pytest.param(False, None, id="full"),
    pytest.param(True, None, id="causal"),
    pytest.param(True, 8, id="causal-window8"),
]


@pytest.mark.parametrize("kv_offset", [0, 16])
@pytest.mark.parametrize("segments", [False, True], ids=["noseg", "seg"])
@pytest.mark.parametrize("causal,window", MASKS)
def test_matches_jax_blockwise(causal, window, segments, kv_offset):
    s_k = 32
    s_q = s_k - kv_offset
    q, k, v, qseg, kseg = _inputs(7 + kv_offset, s_q, s_k, segments)
    kw = dict(causal=causal, window=window, kv_offset=kv_offset,
              block_q=8, block_k=8)
    o_t, lse_t = _torch_call(q, k, v, qseg, kseg, **kw)
    o_j, lse_j = _jax_call(q, k, v, qseg, kseg, **kw)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=O_ATOL, rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                               atol=LSE_ATOL, rtol=1e-6)


@pytest.mark.parametrize("causal,window,kv_offset,segments", [
    pytest.param(True, None, 0, True, id="causal-seg"),
    pytest.param(True, 8, 16, True, id="window-offset-seg"),
    pytest.param(False, None, 0, False, id="full"),
])
def test_matches_pallas_fwd_interpret(causal, window, kv_offset, segments):
    """Against the TPU kernel itself (_fwd_kernel, interpret mode)."""
    s_k = 32
    s_q = s_k - kv_offset
    q, k, v, qseg, kseg = _inputs(11, s_q, s_k, segments)
    o_t, lse_t = _torch_call(q, k, v, qseg, kseg, causal=causal,
                             window=window, kv_offset=kv_offset,
                             block_q=8, block_k=8)

    def fold(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, x.shape[1], D))

    def fold_seg(seg):
        return jnp.asarray(np.repeat(seg[:, None, :], H, axis=1)
                           .reshape(B * H, -1).astype(np.float32))

    segs = (fold_seg(qseg), fold_seg(kseg)) if segments else None
    o_p, lse_p = jfa._flash_fwd_pallas(
        fold(q), fold(k), fold(v), scale=1.0 / D ** 0.5, causal=causal,
        block_q=8, block_k=8, interpret=True, window=window,
        kv_offset=kv_offset, segs=segs,
    )
    o_p = np.asarray(o_p).reshape(B, H, s_q, D).transpose(0, 2, 1, 3)
    lse_p = np.asarray(lse_p).reshape(B, H, s_q).transpose(0, 2, 1)
    np.testing.assert_allclose(o_t.numpy(), o_p, atol=O_ATOL, rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), lse_p, atol=LSE_ATOL, rtol=1e-6)


def test_fully_masked_row_gives_zero_and_neg_inf():
    """A query whose segment id matches no key: o = 0, lse = −1e30, no
    NaN — on both packages."""
    q, k, v, _, _ = _inputs(3, 16, 16, False)
    qseg = np.ones((B, 16), np.int32)
    kseg = np.ones((B, 16), np.int32)
    qseg[:, 5] = 9  # row 5 sees nothing
    o_t, lse_t = _torch_call(q, k, v, qseg, kseg, causal=True,
                             block_q=8, block_k=8)
    o_j, lse_j = _jax_call(q, k, v, qseg, kseg, causal=True,
                           block_q=8, block_k=8)
    assert torch.isfinite(o_t).all()
    assert (o_t[:, 5] == 0).all()
    np.testing.assert_allclose(lse_t[:, 5].numpy(), tfa.NEG_INF, rtol=1e-6)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=O_ATOL, rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                               atol=LSE_ATOL, rtol=1e-6)


BAD_CALLS = {
    "negative-offset": dict(s_q=8, s_k=8, kv_offset=-1),
    "window-needs-causal": dict(s_q=8, s_k=8, causal=False, window=4),
    "window-zero": dict(s_q=8, s_k=8, window=0),
    "causal-unaligned": dict(s_q=4, s_k=8),
    "seg-needs-kv-ids": dict(s_q=4, s_k=8, kv_offset=4, qseg=(B, 4)),
    "kv-ids-alone": dict(s_q=8, s_k=8, kseg=(B, 8)),
    "blocks-divide": dict(s_q=12, s_k=12, block_q=8, block_k=8),
    "seg-shape": dict(s_q=8, s_k=8, qseg=(B, 7)),
}


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_validation_errors_match(case):
    kw = dict(BAD_CALLS[case])
    s_q, s_k = kw.pop("s_q"), kw.pop("s_k")
    qseg_shape, kseg_shape = kw.pop("qseg", None), kw.pop("kseg", None)
    q, k, v, _, _ = _inputs(0, s_q, s_k, False)
    qseg = None if qseg_shape is None else np.ones(qseg_shape, np.int32)
    kseg = None if kseg_shape is None else np.ones(kseg_shape, np.int32)
    with pytest.raises(ValueError) as err_t:
        _torch_call(q, k, v, qseg, kseg, **kw)
    with pytest.raises(ValueError) as err_j:
        _jax_call(q, k, v, qseg, kseg, **kw)
    assert str(err_t.value) == str(err_j.value)


@pytest.mark.parametrize("args", [
    (1024, 1024, 1024, 1024, {}),
    (2048, 2048, 512, 512, {}),
    (2048, 2048, 512, 512, {"window": 600}),
    (1, 1024, 128, 512, {"kv_offset": 1023}),
    (1536, 1536, 1024, 1024, {"causal": False}),
])
def test_block_skip_stats_match(args):
    s_q, s_k, bq, bk, kw = args
    assert tfa.block_skip_stats(s_q, s_k, bq, bk, **kw) == \
        jfa.block_skip_stats(s_q, s_k, bq, bk, **kw)
    assert tfa.fit_block(s_q, bq) == jfa.fit_block(s_q, bq)
