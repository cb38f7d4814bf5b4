"""The port's GPT training path (determined_tpu_torch.models.gpt.loss and
models.attention) against the JAX package's, on the CPU at fp32 and tiny
size: weights carried over with load_jax_params from the reference's
GPT.init, then the loss, its metrics and EVERY gradient leaf
(torch.autograd.grad against jax.grad of GPT.loss) for plain next-token
batches, a loss_mask with packed segment_ids, and pre-shifted targets,
with remat off and on.

Tolerances: loss and metrics 1e-5 relative; gradients 1e-6 absolute
(leaves are O(1e-2) or smaller; fp32 on both sides, only the summation
order differs — the measured gap is ~5e-8).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from determined_tpu.models import gpt as jgpt
from determined_tpu.parallel.ring import reference_attention as jref_attention
from determined_tpu_torch.models import attention as tattn
from determined_tpu_torch.models import gpt as tgpt

KW = dict(vocab_size=256, n_layers=2, n_heads=4, d_model=64, d_ff=256,
          seq_len=64)
B, S = 4, 64


def _batches():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    segs = np.sort(rng.integers(0, 3, (B, S)), axis=1).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    targets = rng.integers(0, 256, (B, S)).astype(np.int32)
    return {
        "tokens": {"tokens": tokens},
        "masked-packed": {"tokens": tokens, "loss_mask": mask,
                          "segment_ids": segs},
        "pre-shifted": {"tokens": tokens, "targets": targets,
                        "loss_mask": mask},
    }


@pytest.fixture(scope="module", params=[False, True], ids=["remat-off",
                                                            "remat-on"])
def pair(request):
    remat = request.param
    jm = jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, remat=remat, **KW))
    params = jm.init(jax.random.PRNGKey(0))
    tm = tgpt.load_jax_params(
        tgpt.GPT(tgpt.GPTConfig(dtype=torch.float32, remat=remat, **KW),
                 device="cpu"),
        jax.device_get(params))
    return jm, params, tm


@pytest.mark.parametrize("name", sorted(_batches()))
def test_loss_metrics_and_every_gradient_match(pair, name):
    jm, params, tm = pair
    batch = _batches()[name]

    def jloss(p):
        return jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, None)

    (jl, jmet), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    tl, tmet = tm.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(tmet) == set(jmet) == {"loss", "accuracy", "tokens"}
    for k in tmet:
        np.testing.assert_allclose(float(tmet[k].detach()), float(jmet[k]),
                                   rtol=1e-5, atol=0, err_msg=k)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(tl, list(tm.parameters()))
    want = dict(tgpt._flatten(jax.device_get(jg)))
    assert set(names) == set(want)
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[n], atol=1e-6, rtol=0,
                                   err_msg=n)


def test_eval_metrics_match(pair):
    jm, params, tm = pair
    batch = _batches()["masked-packed"]
    want = jm.eval_metrics(params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = tm.eval_metrics({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)


def test_training_forward_reads_the_live_parameters():
    """The training forward casts the live parameters inside the graph:
    an in-place change (an optimizer step) shows at once, even with a
    serving copy cached; so does ``apply``, the same forward without a
    graph."""
    cfg = tgpt.GPTConfig(**KW)  # bf16 compute: the serving copy is a cast
    model = tgpt.GPT(cfg, device="cpu")
    model.cache_compute_weights()
    tokens = torch.from_numpy(_batches()["tokens"]["tokens"])
    before, _ = model.loss({"tokens": tokens})
    served = model.apply(tokens)
    with torch.no_grad():
        model.blocks["wi"].mul_(3.0)
    after, _ = model.loss({"tokens": tokens})
    assert float(after.detach()) != float(before.detach())
    assert not torch.equal(model.apply(tokens), served)
    (g,) = torch.autograd.grad(after, [model.blocks["wi"]])
    assert g.dtype == torch.float32 and float(g.abs().sum()) > 0


def test_config_arithmetic_matches_reference():
    for name in ("small", "medium", "tiny"):
        jc, tc = getattr(jgpt, name)(), getattr(tgpt, name)()
        assert tc.n_params() == jc.n_params()
        assert tc.train_flops_per_token() == jc.train_flops_per_token()


@pytest.mark.parametrize("field,value", [
    ("fused_loss", True), ("remat_attention", True), ("seq_len", 32768),
])
def test_loss_refuses_later_slices_by_name(field, value):
    cfg = tgpt.GPTConfig(**{**KW, field: value, "n_layers": 1})
    model = tgpt.GPT(cfg, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(NotImplementedError,
                       match="fused_loss" if field == "fused_loss"
                       else "remat_attention"):
        model.loss({"tokens": tokens})


@pytest.mark.parametrize("causal,window,segments", [
    (True, None, False), (False, None, False), (True, 5, False),
    (True, None, True), (True, 5, True),
])
def test_attention_dense_and_flash_match_reference(causal, window, segments):
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(2, 24, 3, 16)).astype(np.float32)
               for _ in range(3))
    segs = np.sort(rng.integers(1, 4, (2, 24)), axis=1).astype(np.int32) \
        if segments else None
    want = np.asarray(jref_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, segment_ids=None if segs is None else jnp.asarray(segs)))
    t = torch.from_numpy
    for impl in ("dense", "flash", "auto"):
        got = tattn.attention(t(q), t(k), t(v), causal=causal, impl=impl,
                              block_q=8, block_k=8, window=window,
                              segment_ids=None if segs is None else t(segs))
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0,
                                   err_msg=impl)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_attention_refuses_sharded_impls(impl):
    x = torch.zeros((1, 8, 2, 16))
    with pytest.raises(NotImplementedError, match="multi-device slice"):
        tattn.attention(x, x, x, impl=impl)


def test_gpt_loss_through_dense_attention_matches_flash():
    """attn_impl='dense' trains the same function as the flash path."""
    base = tgpt.GPT(tgpt.GPTConfig(dtype=torch.float32, **KW), device="cpu")
    dense = tgpt.GPT(dataclasses.replace(base.config, attn_impl="dense"),
                     device="cpu")
    dense.load_state_dict(base.state_dict())
    batch = {"tokens": torch.from_numpy(_batches()["tokens"]["tokens"])}
    np.testing.assert_allclose(float(dense.loss(batch)[0].detach()),
                               float(base.loss(batch)[0].detach()), rtol=1e-6)
