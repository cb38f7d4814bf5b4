"""The port's flash-attention backward against the JAX package's, on the
CPU at fp32.

- The mono kernels' plain versions (``_mono_fwd_plain``,
  ``_mono_bwd_plain``) against the TPU kernels themselves
  (``_fwd_kernel_mono`` / ``_bwd_kernel_mono`` through
  ``_flash_fwd_pallas`` / ``_flash_bwd_pallas`` at block == seq, in
  interpret mode), with and without the lse cotangent.
- ``torch.autograd.grad`` through the port's ``flash_attention_lse`` —
  both outputs, a nonzero lse cotangent — against ``jax.grad`` through
  the reference's, over the mask grid causal × window × segment ids ×
  kv_offset.
- The backward's routing at the shapes the mono kernels refuse and
  accept: ``_bwd_route`` keeps the reference's predicate (the blocked
  route's own grid is in ``test_torch_flash_blocked_backward.py``).

Same inputs, made with numpy from a seed. Tolerances: 2e-5 absolute on
outputs and gradients (fp32 on both sides; only the summation order
differs), 1e-5 on lse.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

jfa = importlib.import_module("determined_tpu.ops.flash_attention")
tfa = importlib.import_module("determined_tpu_torch.ops.flash_attention")

ATOL = 2e-5


@pytest.mark.parametrize("s", [64, 256])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_mono_plain_matches_pallas_interpret(s, causal):
    rng = np.random.default_rng(s + causal)
    bh, d = 3, 16
    q, k, v, do = (rng.normal(size=(bh, s, d)).astype(np.float32)
                   for _ in range(4))
    dlse = rng.normal(size=(bh, s)).astype(np.float32)
    scale = 1.0 / d ** 0.5
    j, t = jnp.asarray, torch.from_numpy
    o_j, lse_j = jfa._flash_fwd_pallas(j(q), j(k), j(v), scale=scale,
                                       causal=causal, block_q=s, block_k=s,
                                       interpret=True)
    o_t, lse_t = tfa._mono_fwd_plain(t(q), t(k), t(v), scale=scale,
                                     causal=causal)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-5,
                               rtol=1e-6)
    o, lse = np.array(o_j), np.array(lse_j)
    delta = (do * o).sum(-1)
    for cot in (None, dlse):
        want = jfa._flash_bwd_pallas(
            j(q), j(k), j(v), j(o), j(lse), j(do), scale=scale, causal=causal,
            block_q=s, block_k=s, interpret=True,
            dlse=None if cot is None else j(cot),
        )
        got = tfa._mono_bwd_plain(
            t(q), t(k), t(v), t(do), t(lse), t(delta),
            torch.zeros(bh, s) if cot is None else t(cot),
            scale=scale, causal=causal,
        )
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                       rtol=0, err_msg=name)


def test_mono_wrappers_run_the_plain_version_on_cpu():
    """flash_fwd_mono / flash_bwd_mono on CPU tensors are their plain
    versions, in the [B, S, H, D] layout, and launch nothing."""
    rng = np.random.default_rng(5)
    b, s, h, d = 2, 48, 3, 16
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, s, h, d))
                                    .astype(np.float32)) for _ in range(4))
    before = (tfa.FLASH_FWD_MONO.launches, tfa.FLASH_BWD_MONO.launches)
    o, lse = tfa.flash_fwd_mono(q, k, v)
    o_p, lse_p = tfa.flash_fwd_mono_plain(q, k, v)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    assert o.shape == (b, s, h, d) and lse.shape == (b, s, h)
    o_ref, lse_ref = tfa.flash_attention_lse(q, k, v, block_q=s, block_k=s)
    np.testing.assert_allclose(o.numpy(), o_ref.numpy(), atol=ATOL, rtol=0)
    delta = (do * o).sum(-1)
    grads = tfa.flash_bwd_mono(q, k, v, do, lse, delta)
    assert [g.shape for g in grads] == [q.shape] * 3
    assert (tfa.FLASH_FWD_MONO.launches, tfa.FLASH_BWD_MONO.launches) == before


B, H, D = 2, 2, 16
MASKS = [
    pytest.param(False, None, id="full"),
    pytest.param(True, None, id="causal"),
    pytest.param(True, 8, id="causal-window8"),
]


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


@pytest.mark.parametrize("block", [8, None], ids=["blocked", "mono"])
@pytest.mark.parametrize("kv_offset", [0, 16])
@pytest.mark.parametrize("segments", [False, True], ids=["noseg", "seg"])
@pytest.mark.parametrize("causal,window", MASKS)
def test_grad_matches_jax(causal, window, segments, kv_offset, block):
    s_k = 32
    s_q = s_k - kv_offset
    rng = np.random.default_rng(3 + kv_offset + 2 * segments)
    q = rng.normal(size=(B, s_q, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, s_k, H, D)).astype(np.float32)
            for _ in range(2))
    do = rng.normal(size=(B, s_q, H, D)).astype(np.float32)
    dlse = rng.normal(size=(B, s_q, H)).astype(np.float32)
    kseg = _packed_ids(rng, B, s_k) if segments else None
    qseg = kseg[:, s_k - s_q:] if segments else None
    kw = dict(causal=causal, window=window, kv_offset=kv_offset,
              block_q=block or s_q, block_k=block or s_k)

    def jloss(q_, k_, v_):
        o, lse = jfa.flash_attention_lse(
            q_, k_, v_, segment_ids=None if qseg is None else jnp.asarray(qseg),
            kv_segment_ids=None if kseg is None else jnp.asarray(kseg), **kw)
        return jnp.sum(o * do) + jnp.sum(lse * dlse)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o, lse = tfa.flash_attention_lse(
        *xs, segment_ids=None if qseg is None else torch.from_numpy(qseg),
        kv_segment_ids=None if kseg is None else torch.from_numpy(kseg), **kw)
    got = torch.autograd.grad(
        (o * torch.from_numpy(do)).sum() + (lse * torch.from_numpy(dlse)).sum(),
        xs)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0,
                                   err_msg=name)


def test_grad_of_o_alone_and_lse_alone():
    """A missing cotangent counts as zeros: o alone and lse alone each
    match jax.grad of the same reduction."""
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(size=(B, 32, H, D)).astype(np.float32)
               for _ in range(3))
    for pick in (0, 1):
        def jloss(*xs):
            return jnp.sum(jfa.flash_attention_lse(*xs, block_q=8,
                                                   block_k=8)[pick] ** 2)

        want = jax.grad(jloss, argnums=(0, 1, 2))(
            *(jnp.asarray(x) for x in (q, k, v)))
        xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = tfa.flash_attention_lse(*xs, block_q=8, block_k=8)[pick]
        got = torch.autograd.grad((out ** 2).sum(), xs)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                       rtol=0)


def test_segment_ids_get_no_gradient():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(B, 16, H, D)).astype(np.float32))
    q.requires_grad_()
    segs = torch.from_numpy(_packed_ids(rng, B, 16))
    o = tfa.flash_attention(q, q.detach(), q.detach(), segment_ids=segs,
                            block_q=8, block_k=8)
    (g,) = torch.autograd.grad(o.sum(), [q])
    assert torch.isfinite(g).all()


@pytest.mark.parametrize("kw", [
    dict(s_q=1024, s_k=1024, block_q=1024, block_k=1024),
    dict(s_q=200, s_k=200, block_q=200, block_k=200),
])
def test_cuda_backward_route_accepts_mono_shapes(kw):
    s_q, s_k, bq, bk = kw["s_q"], kw["s_k"], kw["block_q"], kw["block_k"]
    assert tfa._mono_ok(s_q, s_k, bq, bk) == jfa._mono_ok(s_q, s_k, bq, bk)
    assert tfa._bwd_route(24, s_q, s_k, 64, bq, bk) == "mono"


@pytest.mark.parametrize("kw", [
    dict(s=2048, block=512),                      # seq > block
    dict(s=2048, block=2048),                     # past the score cap
    dict(s=1024, block=1024, window=128),
    dict(s=1024, block=1024, has_segments=True),  # packed documents
    dict(s=1024, block=1024, kv_offset=8),
])
def test_non_mono_shapes_route_to_blocked_kernels(kw, monkeypatch):
    """The mono kernels decline these shapes by the reference's predicate,
    and the backward goes to the blocked kernels the reference would run:
    fused, since the dq partials stay under the cap, or two-pass with the
    cap at 0."""
    kw = dict(kw)
    s, block = kw.pop("s"), kw.pop("block")
    assert not tfa._mono_ok(s, s, block, block, **kw)
    assert not jfa._mono_ok(s, s, block, block, **kw)
    nk = s // block
    assert 24 * nk * s * 64 * 4 <= jfa._FUSED_BWD_PARTIALS_CAP
    assert tfa._bwd_route(24, s, s, 64, block, block, **kw) == "fused"
    monkeypatch.setattr(tfa, "_FUSED_BWD_PARTIALS_CAP", 0)
    assert tfa._bwd_route(24, s, s, 64, block, block, **kw) == "two_pass"
