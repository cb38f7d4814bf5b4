"""The blocked forward kernel's plain formula (``_blocked_fwd_plain``, what
``csrc/flash_fwd.cu`` is held against on the card) against the TPU kernel
itself (``_fwd_kernel`` through ``_flash_fwd_pallas`` in interpret mode)
and against the port's own blockwise scan, on the CPU; and the pure-Python
TMA predicate of the bf16 kernels' wrappers.

Same inputs, made with numpy from a seed; in bf16 both sides get the same
rounded values.

Tolerances:
- fp32, against the Pallas kernel and against ``flash_attention_lse_plain``:
  o and lse atol 1e-5 (the same fp32 arithmetic in another summation order).
- bf16, against the Pallas kernel: o atol 1.6e-2 (two bf16 ulps at
  magnitude 1–2), lse atol 1e-5. Both round p to bf16 before p·v, but the
  Pallas kernel rounds p = exp(s − m) against the running max of the
  blocks seen so far and rescales later, the plain formula against the
  row's final max: the rounded values differ by up to one ulp of p, which
  moves o by about one ulp, and o itself is rounded to bf16 on both sides.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

jfa = importlib.import_module("determined_tpu.ops.flash_attention")
tfa = importlib.import_module("determined_tpu_torch.ops.flash_attention")

B, H, D, S_K = 2, 2, 16, 32

MASKS = [  # causal, window, kv_offset, segments
    pytest.param(c, w, off, seg,
                 id=f"{name}-off{off}-{'seg' if seg else 'noseg'}")
    for name, c, w in (("full", False, None), ("causal", True, None),
                       ("window8", True, 8))
    for off in (0, 16) for seg in (False, True)
]


def _inputs(seed, kv_offset, segments):
    rng = np.random.default_rng(seed)
    s_q = S_K - kv_offset
    q = rng.normal(size=(B, s_q, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S_K, H, D)).astype(np.float32)
    v = rng.normal(size=(B, S_K, H, D)).astype(np.float32)
    kseg = None
    if segments:
        kseg = np.zeros((B, S_K), np.int32)
        for r in range(B):
            cuts = np.sort(rng.choice(np.arange(2, S_K - 2), 2, replace=False))
            for i, (lo, hi) in enumerate(zip([0, *cuts], [*cuts, S_K])):
                kseg[r, lo:hi] = i + 1
    return q, k, v, kseg


def _fold(x):
    """[B, S, H, D] numpy → [B·H, S, D]."""
    return x.transpose(0, 2, 1, 3).reshape(B * H, x.shape[1], D)


def _fold_seg(seg):
    return np.repeat(seg[:, None, :], H, axis=1).reshape(B * H, -1).astype(
        np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,kv_offset,segments", MASKS)
def test_plain_matches_pallas_fwd_interpret(dtype, causal, window, kv_offset,
                                            segments):
    q, k, v, kseg = _inputs(3 + kv_offset, kv_offset, segments)
    segs = None
    if segments:
        segs = (_fold_seg(kseg[:, kv_offset:]), _fold_seg(kseg))
    tdt = getattr(torch, dtype)
    o_t, lse_t = tfa._blocked_fwd_plain(
        *(torch.from_numpy(_fold(x)).to(tdt) for x in (q, k, v)),
        scale=1.0 / D ** 0.5, causal=causal, window=window,
        kv_offset=kv_offset,
        segs=None if segs is None else tuple(map(torch.from_numpy, segs)))
    o_j, lse_j = jfa._flash_fwd_pallas(
        *(jnp.asarray(_fold(x), dtype=getattr(jnp, dtype)) for x in (q, k, v)),
        scale=1.0 / D ** 0.5, causal=causal, block_q=16, block_k=16,
        interpret=True, window=window, kv_offset=kv_offset,
        segs=None if segs is None else tuple(map(jnp.asarray, segs)))
    assert o_t.dtype == tdt and lse_t.dtype == torch.float32
    atol = 1e-5 if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(o_t.float().numpy(),
                               np.asarray(o_j.astype(jnp.float32)),
                               atol=atol, rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j).reshape(
        lse_t.shape), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("causal,window,kv_offset,segments", MASKS)
def test_plain_matches_blockwise_scan_fp32(causal, window, kv_offset,
                                           segments):
    """``flash_fwd_plain`` (the kernel level, [B, S, H, D]) against the
    port's CPU path, ``flash_attention_lse_plain``."""
    q, k, v, kseg = _inputs(5 + kv_offset, kv_offset, segments)
    t = torch.from_numpy
    kw = dict(causal=causal, window=window, kv_offset=kv_offset)
    if segments:
        kw.update(segment_ids=t(kseg[:, kv_offset:]), kv_segment_ids=t(kseg))
    o_k, lse_k = tfa.flash_fwd_plain(t(q), t(k), t(v), **kw)
    o_r, lse_r = tfa.flash_attention_lse_plain(t(q), t(k), t(v), block_q=8,
                                               block_k=8, **kw)
    np.testing.assert_allclose(o_k.numpy(), o_r.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse_k.numpy(), lse_r.numpy(), atol=1e-5,
                               rtol=1e-6)
    # on CPU tensors the kernel-level wrapper runs the plain version
    o_w, lse_w = tfa.flash_fwd(t(q), t(k), t(v), **kw)
    assert torch.equal(o_w, o_k) and torch.equal(lse_w, lse_k)


def test_fully_masked_rows_give_zero_and_neg_inf():
    q, k, v, kseg = _inputs(9, 0, True)
    qseg = kseg.copy()
    qseg[:, :4] = 99  # matches no key
    t = torch.from_numpy
    o, lse = tfa.flash_fwd_plain(t(q), t(k), t(v), causal=True,
                                 segment_ids=t(qseg), kv_segment_ids=t(kseg))
    assert torch.equal(o[:, :4], torch.zeros_like(o[:, :4]))
    assert (lse[:, :4] == tfa.NEG_INF).all()
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_no_keys_give_zero_and_neg_inf(dtype):
    """With no keys every row is fully masked: o = 0, lse = NEG_INF, and
    the backward's dq is zero."""
    rng = np.random.default_rng(11)
    q, do = (torch.from_numpy(rng.standard_normal((B, 8, H, D),
                                                  np.float32)).to(dtype)
             for _ in range(2))
    k = v = torch.zeros((B, 0, H, D), dtype=dtype)
    o, lse = tfa.flash_fwd(q, k, v, causal=False)
    assert o.shape == q.shape and o.dtype == dtype
    assert torch.equal(o, torch.zeros_like(o))
    assert (lse == tfa.NEG_INF).all()
    delta = (do.float() * o.float()).sum(-1)
    dq, dk, dv = tfa.flash_bwd_blocked_plain(q, k, v, do, lse, delta,
                                             causal=False)
    assert torch.equal(dq, torch.zeros_like(q))
    assert dk.shape == dv.shape == k.shape


def _view(kind):
    """A [2, 10, 3, 8] bf16 view of a kind the kernels' wrappers meet."""
    base = torch.zeros(2 * 10 * 3 * 3 * 8 + 64, dtype=torch.bfloat16)
    qkv = base[:2 * 10 * 3 * 3 * 8].view(2, 10, 3, 3, 8)
    if kind == "contiguous":
        return torch.zeros(2, 10, 3, 8, dtype=torch.bfloat16)
    if kind == "qkv-slice":          # q/k/v of the [B, S, 3, H, D] projection
        return qkv[:, :, 1]
    if kind == "offset-rows":        # q = qkv[:, kv_offset:, 0]
        return qkv[:, 3:, 0]
    if kind == "odd-base":           # base 2 bytes past 16-byte alignment
        return base[1:1 + 2 * 10 * 3 * 8].view(2, 10, 3, 8)
    if kind == "odd-stride":         # rows padded to D + 1 elements
        return base[:2 * 10 * 3 * 9].view(2, 10, 3, 9)[..., :8]
    if kind == "one-head":           # a size-1 dim: its stride is free
        return base.as_strided((2, 10, 1, 8), (80, 8, 3, 1))
    raise ValueError(kind)


@pytest.mark.parametrize("kind,ready", [
    ("contiguous", True), ("qkv-slice", True), ("offset-rows", True),
    ("odd-base", False), ("odd-stride", False), ("one-head", True),
])
def test_tma_predicate(kind, ready):
    x = _view(kind)
    assert tfa._tma_ready(x) is ready
    (y,) = tfa._tma_inputs(1, x)  # the bf16 kernels' view of x
    assert tfa._tma_ready(y)
    assert (y is x) is ready
    assert torch.equal(y, x)
    assert tfa._tma_inputs(0, x)[0] is x  # fp32 kernels read strides
