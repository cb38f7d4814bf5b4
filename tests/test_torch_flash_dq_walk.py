"""The bf16 dq kernel's tile walk (``_bwd_dq_walk_plain``, the plain copy
of ``csrc/flash_bwd_dq.cu``'s q-major walk) against the JAX package's
``_bwd_dq_kernel`` run in interpret mode (``_flash_bwd_pallas`` with the
partials cap patched to 0, the two-pass route), on the CPU.

The walk takes 128-row blocks and key tiles of 64 as the kernel does, and
also 32-row blocks and 16-key tiles so that a tiny case walks many tiles.
Grid: causal, a 24-key window, segment ids, kv_offset with s_q < s_k,
s_q ≠ s_k without a mask, and a window with s_q > s_k whose last row
blocks see no key (their dq must be exactly 0); ragged throughout (200
rows or keys are not a multiple of the tiles), with a nonzero lse
cotangent, b=1, h=2, d=16, fp32 and bf16.

Tolerances: fp32 5e-5 absolute (same arithmetic, other summation order;
measured ~1e-6). bf16 2e-2 absolute and relative: the inputs, p and ds
are rounded to bf16 at the same places on both sides, and a sum that
lands beside a rounding boundary in one order flips one bf16 ulp (2^-7
at magnitude 1-2) in the output. The walk also matches the dense formula
(``flash_bwd_dq_plain``) within the same tolerances.
"""
import functools
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

jfa = importlib.import_module("determined_tpu.ops.flash_attention")
tfa = importlib.import_module("determined_tpu_torch.ops.flash_attention")

H, D = 2, 16
#: name → (s_q, s_k, causal, window, kv_offset, segments, reference block)
CASES = {
    "causal-ragged": (200, 200, True, None, 0, False, 40),
    "window24": (200, 200, True, 24, 0, False, 40),
    "segments": (200, 200, True, None, 0, True, 40),
    "kv-offset": (120, 200, True, None, 80, False, 40),
    "sq-ne-sk-full": (80, 200, False, None, 0, False, 40),
    "empty-row-blocks": (200, 80, True, 16, 0, False, 40),
}
TILES = [pytest.param((128, 64), id="kernel-tiles"),
         pytest.param((32, 16), id="small-tiles")]


def _fold_np(x):
    """[1, S, H, ...] → [H, S, ...]."""
    return np.swapaxes(x, 1, 2).reshape(H, x.shape[1], *x.shape[3:])


def _unfold_np(x):
    x = np.array(x.astype(jnp.float32))  # writable, for torch
    return np.swapaxes(x.reshape(1, H, *x.shape[1:]), 1, 2)


@functools.lru_cache(maxsize=None)
def _reference(name, dtype):
    """Seeded inputs of the case and the JAX package's dq: the blockwise
    forward, then the Pallas backward in interpret mode past the partials
    cap → (inputs, kseg, o, lse, dq), numpy in [1, S, H, ...]."""
    s_q, s_k, causal, window, kv_offset, segments, block = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q = rng.normal(size=(1, s_q, H, D))
    k, v = (rng.normal(size=(1, s_k, H, D)) for _ in range(2))
    do = rng.normal(size=(1, s_q, H, D))
    dlse = rng.normal(size=(1, s_q, H)).astype(np.float32)
    kseg = None
    if segments:
        kseg = np.sort(rng.integers(1, 5, (1, s_k)), axis=1).astype(np.int32)
    cast = (lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16))) \
        if dtype == "bf16" else (lambda x: x.astype(np.float32))
    q, k, v, do = (cast(x) for x in (q, k, v, do))
    j = jnp.asarray
    segs = None
    if kseg is not None:
        ks = np.repeat(kseg.astype(np.float32), H, axis=0)
        segs = (j(ks[:, s_k - s_q:]), j(ks))
    qf, kf, vf, dof = (j(_fold_np(x)) for x in (q, k, v, do))
    scale = 1.0 / D ** 0.5
    o, lse = jfa._blockwise_fwd_ref(qf, kf, vf, scale=scale, causal=causal,
                                    block_k=block, window=window,
                                    kv_offset=kv_offset, segs=segs)
    prev = jfa._FUSED_BWD_PARTIALS_CAP
    jfa._FUSED_BWD_PARTIALS_CAP = 0
    try:
        dq, _, _ = jfa._flash_bwd_pallas(
            qf, kf, vf, o, lse, dof, scale=scale, causal=causal,
            block_q=block, block_k=block, interpret=True,
            dlse=j(_fold_np(dlse)), window=window, kv_offset=kv_offset,
            segs=segs)
    finally:
        jfa._FUSED_BWD_PARTIALS_CAP = prev
    return (q, k, v, do, dlse), kseg, _unfold_np(o), _unfold_np(lse), \
        _unfold_np(dq)


def _torch(x):
    if x.dtype == np.float32 or x.dtype == np.int32:
        return torch.from_numpy(np.ascontiguousarray(x))
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_dq_walk_matches_pallas_interpret(name, dtype, tiles):
    (q, k, v, do, dlse), kseg, o, lse, want = _reference(name, dtype)
    s_q, s_k, causal, window, kv_offset, _, _ = CASES[name]
    tq, tk, tv, tdo = (_torch(x) for x in (q, k, v, do))
    # delta = Σ do·o in fp32 over o as the forward returns it (the
    # reference forms it inside its backward)
    o32 = o if dtype == "fp32" else np.array(
        jnp.asarray(o, jnp.bfloat16).astype(jnp.float32))
    delta = (tdo.float() * torch.from_numpy(o32)).sum(-1)
    kw = dict(causal=causal, window=window, kv_offset=kv_offset)
    if kseg is not None:
        kw.update(segment_ids=torch.from_numpy(kseg[:, s_k - s_q:]),
                  kv_segment_ids=torch.from_numpy(kseg))
    args = (tq, tk, tv, tdo, torch.from_numpy(lse), delta,
            torch.from_numpy(dlse))
    got = tfa._bwd_dq_walk_plain(*args, block_q=tiles[0], block_k=tiles[1],
                                 **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    dense = tfa.flash_bwd_dq_plain(*args, **kw)
    tol = dict(atol=5e-5, rtol=0) if dtype == "fp32" else dict(atol=2e-2,
                                                              rtol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    np.testing.assert_allclose(got.float().numpy(), dense.float().numpy(),
                               **tol)
    if name == "empty-row-blocks":  # rows past s_k + window − 1 see no key
        dead = s_k + window - 1
        assert (got[:, dead:] == 0).all() and (want[:, dead:] == 0).all()
        assert (got[:, :dead].abs().amax(dim=(0, 2, 3)) > 0).all()
