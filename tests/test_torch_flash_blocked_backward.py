"""The port's blocked flash-attention backward against the JAX package's
TPU kernels, on the CPU.

- ``_blocked_bwd_plain`` (the dense formula the three blocked CUDA kernels
  are held against on the card) and the kernel-level plain wrappers
  ``flash_bwd_blocked_plain``, ``flash_bwd_dq_plain`` and
  ``flash_bwd_dkv_plain`` against ``_flash_bwd_pallas(...,
  interpret=True)``: the fused blocked kernel
  (``_bwd_fused_blocked_kernel``) and, with the partials cap patched to
  0, the two-pass ``_bwd_dq_kernel`` + ``_bwd_dkv_kernel``. Grid: causal /
  full × window None / 16 × segment ids × kv_offset 0 / 16, with a
  nonzero lse cotangent, b=1, s=64, h=2, d=16, block 16.
- The kernel-level wrappers on CPU tensors are their plain versions and
  launch nothing.
- ``_bwd_route`` against the reference's predicate (``_flash_bwd_pallas``:
  mono, fused under ``_FUSED_BWD_PARTIALS_CAP``, two-pass past it) at the
  GPT-2 training shapes, read from the module global at call time.

Tolerances: fp32 5e-5 absolute (same arithmetic, other summation order;
measured ~1e-6). bf16 2e-2 absolute and relative: the inputs, p and ds
are rounded to bf16 at the same places on both sides, and a sum that
lands beside a rounding boundary in one order flips one bf16 ulp (2^-7
at magnitude 1-2) in the outputs.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

jfa = importlib.import_module("determined_tpu.ops.flash_attention")
tfa = importlib.import_module("determined_tpu_torch.ops.flash_attention")

B, S, H, D, BLOCK = 1, 64, 2, 16, 16
MASKS = [
    pytest.param(False, None, id="full"),
    pytest.param(True, None, id="causal"),
    pytest.param(True, 16, id="causal-window16"),
]


def _case(seed, kv_offset, segments, dtype=np.float32):
    """Inputs [B, S, H, D] in `dtype` (q has S − kv_offset rows), the
    lse cotangent, and segment ids (two to four documents per row)."""
    rng = np.random.default_rng(seed)
    s_q = S - kv_offset
    q = rng.normal(size=(B, s_q, H, D))
    k, v = (rng.normal(size=(B, S, H, D)) for _ in range(2))
    do = rng.normal(size=(B, s_q, H, D))
    dlse = rng.normal(size=(B, s_q, H)).astype(np.float32)
    kseg = None
    if segments:
        kseg = np.sort(rng.integers(1, 5, (B, S)), axis=1).astype(np.int32)
    cast = (lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16))) \
        if dtype == "bf16" else (lambda x: x.astype(np.float32))
    return [cast(x) for x in (q, k, v, do)], dlse, kseg


def _fold_np(x):
    """[B, S, H, ...] → [B·H, S, ...]."""
    return np.swapaxes(x, 1, 2).reshape(B * H, x.shape[1], *x.shape[3:])


def _reference(q, k, v, do, dlse, kseg, *, causal, window, kv_offset, cap):
    """(o, lse, dq, dk, dv) of the JAX package: the blockwise forward, then
    the Pallas backward kernels in interpret mode, in [B, S, H, ...]."""
    j = jnp.asarray
    scale = 1.0 / D ** 0.5
    qf, kf, vf, dof = (j(_fold_np(x)) for x in (q, k, v, do))
    segs = None
    if kseg is not None:
        ks = np.repeat(kseg.astype(np.float32), H, axis=0)
        segs = (j(ks[:, kv_offset:]), j(ks))
    o, lse = jfa._blockwise_fwd_ref(qf, kf, vf, scale=scale, causal=causal,
                                    block_k=BLOCK, window=window,
                                    kv_offset=kv_offset, segs=segs)
    prev = jfa._FUSED_BWD_PARTIALS_CAP
    jfa._FUSED_BWD_PARTIALS_CAP = cap
    try:
        grads = jfa._flash_bwd_pallas(
            qf, kf, vf, o, lse, dof, scale=scale, causal=causal,
            block_q=BLOCK, block_k=BLOCK, interpret=True,
            dlse=j(_fold_np(dlse)), window=window, kv_offset=kv_offset,
            segs=segs)
    finally:
        jfa._FUSED_BWD_PARTIALS_CAP = prev

    def unfold(x):
        x = np.array(x.astype(jnp.float32))  # writable, for torch
        return np.swapaxes(x.reshape(B, H, *x.shape[1:]), 1, 2)

    return (unfold(o), unfold(lse), *(unfold(g) for g in grads))


def _torch(x):
    if x.dtype == np.float32 or x.dtype == np.int32:
        return torch.from_numpy(np.ascontiguousarray(x))
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _port_grads(q, k, v, do, dlse, kseg, o, lse, *, causal, window,
                kv_offset):
    """The three plain wrappers → (dq, dk, dv) from the blocked one and
    (dq, dk, dv) from the two-pass pair, in fp32 numpy."""
    tq, tk, tv, tdo = (_torch(x) for x in (q, k, v, do))
    lse_t = torch.from_numpy(lse)
    # delta = Σ do·o in fp32 (the reference forms it inside its backward)
    delta = (tdo.float() * torch.from_numpy(np.array(o))).sum(-1)
    kw = dict(causal=causal, window=window, kv_offset=kv_offset)
    if kseg is not None:
        kw.update(segment_ids=torch.from_numpy(kseg[:, kv_offset:]),
                  kv_segment_ids=torch.from_numpy(kseg))
    args = (tq, tk, tv, tdo, lse_t, delta, torch.from_numpy(dlse))
    fused = tfa.flash_bwd_blocked_plain(*args, **kw)
    two_pass = (tfa.flash_bwd_dq_plain(*args, **kw),
                *tfa.flash_bwd_dkv_plain(*args, **kw))
    for g, x in zip(fused, (tq, tk, tv)):
        assert g.dtype == x.dtype and g.shape == x.shape
    return ([g.float().numpy() for g in fused],
            [g.float().numpy() for g in two_pass])


@pytest.mark.parametrize("route", ["fused", "two_pass"])
@pytest.mark.parametrize("kv_offset", [0, 16])
@pytest.mark.parametrize("segments", [False, True], ids=["noseg", "seg"])
@pytest.mark.parametrize("causal,window", MASKS)
def test_blocked_plain_matches_pallas_interpret(causal, window, segments,
                                               kv_offset, route):
    (q, k, v, do), dlse, kseg = _case(
        7 + kv_offset + 2 * segments + (window or 0), kv_offset, segments)
    o, lse, *want = _reference(
        q, k, v, do, dlse, kseg, causal=causal, window=window,
        kv_offset=kv_offset, cap=jfa._FUSED_BWD_PARTIALS_CAP
        if route == "fused" else 0)
    fused, two_pass = _port_grads(q, k, v, do, dlse, kseg, o, lse,
                                  causal=causal, window=window,
                                  kv_offset=kv_offset)
    for name, g, w in zip(("dq", "dk", "dv"),
                          fused if route == "fused" else two_pass, want):
        np.testing.assert_allclose(g, w, atol=5e-5, rtol=0, err_msg=name)
    # The dense formula behind both wrappers, on the folded layout.
    t = torch.from_numpy
    segs = None
    if kseg is not None:
        ks = np.repeat(kseg.astype(np.float32), H, axis=0)
        segs = (t(ks[:, kv_offset:]), t(ks))
    delta = (do * o).sum(-1)
    dense = tfa._blocked_bwd_plain(
        *(t(_fold_np(x)) for x in (q, k, v, do, lse, delta, dlse)),
        scale=1.0 / D ** 0.5, causal=causal, window=window,
        kv_offset=kv_offset, segs=segs)
    for g, w in zip(dense, want):
        np.testing.assert_allclose(g.numpy(), _fold_np(w), atol=5e-5, rtol=0)


@pytest.mark.parametrize("causal,window,segments,kv_offset,route", [
    (True, None, False, 0, "fused"),
    (True, 16, True, 16, "fused"),
    (False, None, True, 0, "two_pass"),
    (True, 16, False, 16, "two_pass"),
])
def test_blocked_plain_matches_pallas_interpret_bf16(causal, window,
                                                    segments, kv_offset,
                                                    route):
    """bf16 inputs: p rounded before pᵀ·do, ds before ds·k and dsᵀ·q, on
    both sides."""
    (q, k, v, do), dlse, kseg = _case(11 + kv_offset, kv_offset, segments,
                                      dtype="bf16")
    o, lse, *want = _reference(
        q, k, v, do, dlse, kseg, causal=causal, window=window,
        kv_offset=kv_offset, cap=jfa._FUSED_BWD_PARTIALS_CAP
        if route == "fused" else 0)
    # o as the bf16 forward returns it, so delta matches the reference's
    o = np.asarray(jnp.asarray(o, jnp.bfloat16).astype(jnp.float32))
    fused, two_pass = _port_grads(q, k, v, do, dlse, kseg, o, lse,
                                  causal=causal, window=window,
                                  kv_offset=kv_offset)
    for name, g, w in zip(("dq", "dk", "dv"),
                          fused if route == "fused" else two_pass, want):
        np.testing.assert_allclose(g, w, atol=2e-2, rtol=2e-2, err_msg=name)


def test_kernel_wrappers_run_the_plain_version_on_cpu():
    """flash_bwd_blocked / _dq / _dkv on CPU tensors are their plain
    versions, in the [B, S, H, D] layout, and launch nothing."""
    (q, k, v, do), dlse, kseg = _case(3, 16, True)
    t = torch.from_numpy
    lse = torch.randn(B, S - 16, H)
    delta = torch.randn(B, S - 16, H)
    kw = dict(causal=True, window=16, kv_offset=16,
              segment_ids=t(kseg[:, 16:]), kv_segment_ids=t(kseg))
    args = (t(q), t(k), t(v), t(do), lse, delta, t(dlse))
    kernels = (tfa.FLASH_BWD_BLOCKED, tfa.FLASH_BWD_DQ, tfa.FLASH_BWD_DKV)
    before = [kern.launches for kern in kernels]
    fused = tfa.flash_bwd_blocked(*args, **kw)
    dq = tfa.flash_bwd_dq(*args, **kw)
    dk, dv = tfa.flash_bwd_dkv(*args, **kw)
    want = tfa.flash_bwd_blocked_plain(*args, **kw)
    for got in (fused, (dq, dk, dv)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert [kern.launches for kern in kernels] == before
    # dlse None counts as zeros
    no_dlse = tfa.flash_bwd_blocked(*args[:6], **kw)
    zeros = tfa.flash_bwd_blocked(*args[:6], torch.zeros_like(lse), **kw)
    for g, w in zip(no_dlse, zeros):
        assert torch.equal(g, w)


def _reference_route(bh, s, d, block, **kw):
    """The reference's choice in _flash_bwd_pallas, written out."""
    if jfa._mono_ok(s, s, block, block, **kw):
        return "mono"
    nk = -(-s // block)
    if bh * nk * s * d * 4 <= jfa._FUSED_BWD_PARTIALS_CAP:
        return "fused"
    return "two_pass"


@pytest.mark.parametrize("bh,s,block,kw,want", [
    (12, 16384, 1024, {}, "fused"),         # the long-context rung
    (12, 32768, 1024, {}, "two_pass"),      # its 32k point
    (96, 1024, 1024, dict(has_segments=True), "fused"),  # packed documents
    (96, 1024, 1024, dict(window=256), "fused"),
    (96, 1024, 1024, {}, "mono"),           # the headline rung
    (12, 18432, 1024, {}, "fused"),         # 1.02e9 bytes: under the cap
    (12, 19456, 1024, {}, "two_pass"),      # 1.14e9 bytes: past it
])
def test_bwd_route_is_the_references(bh, s, block, kw, want):
    assert tfa._FUSED_BWD_PARTIALS_CAP == jfa._FUSED_BWD_PARTIALS_CAP
    assert _reference_route(bh, s, 64, block, **kw) == want
    assert tfa._bwd_route(bh, s, s, 64, block, block, **kw) == want


def test_bwd_route_reads_the_cap_at_call_time(monkeypatch):
    assert tfa._bwd_route(12, 16384, 16384, 64, 1024, 1024) == "fused"
    monkeypatch.setattr(tfa, "_FUSED_BWD_PARTIALS_CAP", 0)
    assert tfa._bwd_route(12, 16384, 16384, 64, 1024, 1024) == "two_pass"
    assert tfa._bwd_route(96, 1024, 1024, 64, 1024, 1024) == "mono"
