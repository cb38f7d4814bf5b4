"""The port's chunked cross-entropy (determined_tpu_torch.ops.
fused_cross_entropy) against the JAX package's op and against the port's
dense loss sums, on the CPU.

- ``_chunk_count`` over vocab sizes padded and not.
- ``fused_next_token_sums``: the five sums (objective, nll, z, correct,
  n) and the gradients of the objective in x and w, against
  ``jax.grad`` of the reference's op and against ``_aligned_token_sums``
  over dense logits (the port's dense path), with and without z_loss,
  over several chunks and one.

Tolerances: fp32 sums 1e-5 relative and gradients 1e-6 absolute (fp32 on
both sides, other summation order; the gradients are O(1e-2)). bf16
inputs: the sums 1e-5 relative (the logits are fp32 on both sides, from
exact products), the gradients 2e-2 relative to their largest magnitude
(d_logits is rounded to bf16 on both sides before its products, and so
are dx and dw).
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

jce = importlib.import_module("determined_tpu.ops.fused_cross_entropy")
tce = importlib.import_module("determined_tpu_torch.ops.fused_cross_entropy")
tgpt = importlib.import_module("determined_tpu_torch.models.gpt")

B, S, D, V = 2, 24, 32, 256


@pytest.mark.parametrize("vocab,target", [
    (50304, 8192), (50257, 8192), (256, 8192), (256, 64), (32000, 8192),
    (1000, 100), (97, 16),
])
def test_chunk_count_matches_reference(vocab, target):
    assert tce._chunk_count(vocab, target) == jce._chunk_count(vocab, target)


def _inputs(seed, dtype):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    w = (0.3 * rng.normal(size=(D, V))).astype(np.float32)
    targets = rng.integers(0, V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.25).astype(np.float32)
    if dtype == "bf16":
        x, w = (np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in (x, w))
    return x, w, targets, mask


def _jax(x, w, targets, mask, *, z_loss, chunk, dtype):
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32

    def obj(x_, w_):
        return jce.fused_next_token_sums(
            x_, w_, jnp.asarray(targets), jnp.asarray(mask), z_loss=z_loss,
            target_chunk=chunk)

    xs = (jnp.asarray(x, jd), jnp.asarray(w, jd))
    sums = obj(*xs)
    gx, gw = jax.grad(lambda a, b: obj(a, b)[0], argnums=(0, 1))(*xs)
    return ([float(v) for v in sums],
            np.asarray(gx.astype(jnp.float32)),
            np.asarray(gw.astype(jnp.float32)))


def _port(x, w, targets, mask, *, z_loss, chunk, dtype):
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    xs = [torch.from_numpy(a).to(td).requires_grad_() for a in (x, w)]
    sums = tce.fused_next_token_sums(
        *xs, torch.from_numpy(targets), torch.from_numpy(mask),
        z_loss=z_loss, target_chunk=chunk)
    gx, gw = torch.autograd.grad(sums[0], xs)
    assert gx.dtype == gw.dtype == td
    return ([float(v.detach()) for v in sums], gx.float().numpy(),
            gw.float().numpy())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("chunk", [64, 8192], ids=["4-chunks", "1-chunk"])
def test_fused_sums_and_gradients_match_jax(chunk, z_loss, dtype):
    x, w, targets, mask = _inputs(int(chunk + 1e4 * z_loss), dtype)
    kw = dict(z_loss=z_loss, chunk=chunk, dtype=dtype)
    (want, wgx, wgw), (got, ggx, ggw) = (_jax(x, w, targets, mask, **kw),
                                         _port(x, w, targets, mask, **kw))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    if dtype == "fp32":
        np.testing.assert_allclose(ggx, wgx, atol=1e-6, rtol=0)
        np.testing.assert_allclose(ggw, wgw, atol=1e-6, rtol=0)
    else:
        for g, w_ in ((ggx, wgx), (ggw, wgw)):
            np.testing.assert_allclose(g, w_, atol=2e-2 * np.abs(w_).max(),
                                       rtol=0)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_fused_sums_match_the_dense_path(z_loss):
    """The chunked op is the dense ``_aligned_token_sums`` over x·w: the
    same sums, and the same gradients of nll + z_loss·z."""
    x, w, targets, mask = _inputs(3, "fp32")
    t = torch.from_numpy
    xs = [t(a).requires_grad_() for a in (x, w)]
    fused = tce.fused_next_token_sums(*xs, t(targets), t(mask),
                                      z_loss=z_loss, target_chunk=64)
    g_fused = torch.autograd.grad(fused[0], xs)
    nll, z, acc, n = tgpt._aligned_token_sums(xs[0] @ xs[1], t(targets),
                                              t(mask))
    g_dense = torch.autograd.grad(nll + z_loss * z, xs)
    np.testing.assert_allclose(
        [float(v.detach()) for v in fused[1:]],
        [float(v.detach()) for v in (nll, z, acc, n)], rtol=1e-5)
    for g, w_ in zip(g_fused, g_dense):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), atol=1e-6, rtol=0)
