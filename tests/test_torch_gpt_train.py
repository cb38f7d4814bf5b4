"""The port's GPT training path (determined_tpu_torch.models.gpt.loss and
models.attention) against the JAX package's, on the CPU at fp32 and tiny
size: weights carried over with load_jax_params from the reference's
GPT.init, then the loss, its metrics and EVERY gradient leaf
(torch.autograd.grad against jax.grad of GPT.loss) for plain next-token
batches, a loss_mask with packed segment_ids, and pre-shifted targets,
with remat off and on; then the long-context configurations: the chunked
loss (fused_loss), rematted attention (remat_attention, and the auto
switch past 16384 tokens) and a sliding window.

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


def test_cpu_gradients_repeat_bit_for_bit():
    """Three backward passes of one batch give the same gradient leaves
    bit for bit on a multi-threaded CPU: the embedding's backward (tied
    token rows, repeated ids) sums in a fixed order. At the fixture's
    geometry (vocab 1024, d 128, 8 × 64 tokens of a phrase corpus) the
    token rows repeat enough for an unordered sum to show."""
    from determined_tpu_torch.serving import fixture as tfixture

    model = tgpt.GPT(tfixture.fixture_model_config(), device="cpu")
    tokens = torch.from_numpy(tfixture._corpus_batch(
        np.random.default_rng(0), tfixture.fixture_phrases(),
        tfixture.TRAIN_BATCH, tfixture.TRAIN_SEQ))
    params = list(model.parameters())
    first = None
    for _ in range(3):
        loss, _ = model.loss({"tokens": tokens})
        grads = torch.autograd.grad(loss, params)
        if first is None:
            first = grads
        for (name, _), g, f in zip(model.named_parameters(), grads, first):
            assert torch.equal(g, f), name


def test_config_arithmetic_matches_reference():
    for name in ("small", "medium", "tiny"):
        jc, tc = getattr(jgpt, name)(), getattr(tgpt, name)()
        assert tc.n_params() == jc.n_params()
        assert tc.train_flops_per_token() == jc.train_flops_per_token()


def _check_against_jax(cfg_kw, batch, model=None):
    """Loss, metrics and every gradient leaf of the port's GPT.loss
    against jax.grad of the reference's, from the same GPT.init
    parameters, at fp32."""
    jm = jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **cfg_kw))
    params = jm.init(jax.random.PRNGKey(0))
    tm = tgpt.load_jax_params(
        tgpt.GPT(tgpt.GPTConfig(dtype=torch.float32, **cfg_kw), device="cpu"),
        jax.device_get(params))
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                          None), has_aux=True)(params)
    tl, tmet = tm.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "accuracy", "tokens"):
        np.testing.assert_allclose(float(tmet[k].detach()), float(jmet[k]),
                                   rtol=1e-5, atol=0, err_msg=k)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    want = dict(tgpt._flatten(jax.device_get(jg)))
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(tl, list(tm.parameters()))
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[n], atol=1e-6, rtol=0,
                                   err_msg=n)


@pytest.mark.parametrize("field,value", [
    ("fused_loss", True), ("remat_attention", True), ("seq_len", 32768),
])
def test_long_context_knobs_match_reference(field, value):
    """The long-context knobs match the reference: the chunked loss and
    rematted attention match the reference on packed documents, and
    seq_len past 16384 turns rematted attention on by itself
    (layer_loop="auto"), as in the reference."""
    if field == "seq_len":
        cfg = tgpt.GPTConfig(**{**KW, field: value, "n_layers": 1})
        assert tgpt.remat_attention(cfg)
        assert not tgpt.remat_attention(
            dataclasses.replace(cfg, layer_loop="scan"))
        assert not tgpt.remat_attention(dataclasses.replace(cfg,
                                                            seq_len=16384))
        model = tgpt.GPT(cfg, device="cpu")
        plain = tgpt.GPT(dataclasses.replace(cfg, remat=False), device="cpu")
        plain.load_state_dict(model.state_dict())
        tokens = torch.from_numpy(_batches()["tokens"]["tokens"][:1, :16])
        loss = model.loss({"tokens": tokens})[0]
        np.testing.assert_allclose(
            float(loss.detach()),
            float(plain.loss({"tokens": tokens})[0].detach()),
            rtol=1e-6)
        (g,) = torch.autograd.grad(loss, [model.blocks["wqkv"]])
        assert torch.isfinite(g).all() and float(g.abs().sum()) > 0
        return
    _check_against_jax({**KW, field: value}, _batches()["masked-packed"])


@pytest.mark.parametrize("batch", ["masked-packed", "pre-shifted"])
@pytest.mark.parametrize("cfg", [
    dict(fused_loss=True),
    dict(remat_attention=True, attn_window=16),
    dict(fused_loss=True, remat_attention=True, attn_window=16, z_loss=0.0),
], ids=["fused", "remat-attn-window", "fused-remat-attn-window"])
def test_long_context_losses_match_jax(cfg, batch):
    _check_against_jax({**KW, **cfg}, _batches()[batch])


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
    """Without a mesh the sharded impls are refused, as in the reference
    (the context axis: tests/test_torch_ring.py, test_torch_context.py)."""
    x = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match=f"{impl} attention needs a mesh"):
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
