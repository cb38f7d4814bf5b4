"""The mono pair's plain versions against the JAX package's TPU kernels,
on the CPU, at the shapes of the card grid (``MONO_TMA_CASES`` in
``test_torch_cuda_kernels.py``), and the mono wrappers' input
preparation.

- ``_mono_fwd_plain`` and ``_mono_bwd_plain`` (what the persistent
  wgmma/TMA kernels ``flash_fwd_mono.cu`` / ``flash_bwd_mono.cu`` are held
  against on the card) against ``_fwd_kernel_mono`` / ``_bwd_kernel_mono``
  through ``_flash_fwd_pallas`` / ``_flash_bwd_pallas`` at block == seq,
  in interpret mode: ragged s (200), s_q ≠ s_k both ways, causal
  (top-left: row r sees keys <= r) and full, head dim 16/32/64/128, with
  and without the lse cotangent. With the card grid holding each kernel
  against the same plain version at the same shapes, the chain card
  kernel ↔ plain ↔ JAX holds.
- ``_sm90_inputs``, the mono wrappers' input preparation: a bf16 view
  that breaks TMA's 16-byte rules is copied (same values, TMA-ready), the
  GPT QKV views pass uncopied, and fp32 views pass as they are (the fp32
  kernels read through strides).

Same inputs, made with numpy from a seed. Tolerances: 2e-5 absolute on
o and gradients (fp32 on both sides; only the summation order differs),
1e-5 on lse.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

jfa = importlib.import_module("determined_tpu.ops.flash_attention")
tfa = importlib.import_module("determined_tpu_torch.ops.flash_attention")

ATOL = 2e-5
BH = 2

#: (s_q, s_k) of the card grid's shape cases, cut to the CPU's size.
SHAPES = [
    pytest.param(200, 200, id="ragged-200"),
    pytest.param(96, 300, id="sq-lt-sk"),
    pytest.param(300, 96, id="sq-gt-sk"),
]


@pytest.mark.parametrize("head_dim", [16, 32, 64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s_q,s_k", SHAPES)
def test_mono_plain_matches_pallas_interpret(s_q, s_k, causal, head_dim):
    rng = np.random.default_rng(s_q + 7 * s_k + head_dim + causal)
    q, do = (rng.normal(size=(BH, s_q, head_dim)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(BH, s_k, head_dim)).astype(np.float32)
            for _ in range(2))
    dlse = rng.normal(size=(BH, s_q)).astype(np.float32)
    scale = 1.0 / head_dim ** 0.5
    j, t = jnp.asarray, torch.from_numpy
    kw = dict(scale=scale, causal=causal, block_q=s_q, block_k=s_k,
              interpret=True)
    o_j, lse_j = jfa._flash_fwd_pallas(j(q), j(k), j(v), **kw)
    o_t, lse_t = tfa._mono_fwd_plain(t(q), t(k), t(v), scale=scale,
                                     causal=causal)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=1e-5,
                               rtol=1e-6)
    o, lse = np.array(o_j), np.array(lse_j)
    delta = (do * o).sum(-1)
    for cot in (None, dlse):
        want = jfa._flash_bwd_pallas(
            j(q), j(k), j(v), j(o), j(lse), j(do),
            dlse=None if cot is None else j(cot), **kw)
        got = tfa._mono_bwd_plain(
            t(q), t(k), t(v), t(do), t(lse), t(delta),
            torch.zeros(BH, s_q) if cot is None else t(cot),
            scale=scale, causal=causal)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                       rtol=0, err_msg=name)


def _views(layout, dtype, b=2, s=24, h=3, d=16):
    """q/k/v as the mono kernels meet them ("qkv": strided views of one
    [B, S, 3, H, D] projection, as GPT passes them; "odd-base": contiguous
    tensors one element past 16-byte alignment; "odd-stride": rows padded
    to D + 1 elements) and do (contiguous beside the QKV views, else in
    the same layout)."""
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dtype)

    if layout == "qkv":
        qkv = randn(b, s, 3, h, d)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], randn(b, s, h, d)
    if layout == "odd-base":
        n = b * s * h * d
        flat = randn(4 * n + 1)
        return tuple(flat[1 + i * n:1 + (i + 1) * n].view(b, s, h, d)
                     for i in range(4))
    return tuple(randn(b, s, h, d + 1)[..., :d] for _ in range(4))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("layout", ["qkv", "odd-base", "odd-stride"])
def test_sm90_inputs_copy_only_what_tma_refuses(layout, dtype):
    xs = _views(layout, dtype)
    code, *prepared = tfa._sm90_inputs(*xs)
    assert code == (1 if dtype == torch.bfloat16 else 0)
    for x, y in zip(xs, prepared):
        assert torch.equal(x, y) and y.stride(-1) == 1
        if dtype == torch.bfloat16:
            assert tfa._tma_ready(y)
        uncopied = dtype == torch.float32 or layout == "qkv"
        assert (y.data_ptr() == x.data_ptr()) == uncopied, layout
    if dtype == torch.bfloat16:
        assert tfa._tma_ready(xs[0]) == (layout == "qkv")


def test_sm90_inputs_cast_do_to_the_compute_dtype():
    q, k, v, do = _views("qkv", torch.bfloat16)
    _, *_, do_p = tfa._sm90_inputs(q, k, v, do.float())
    assert do_p.dtype == torch.bfloat16 and torch.equal(do_p, do)
