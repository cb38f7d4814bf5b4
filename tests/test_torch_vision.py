"""The port's vision models (``determined_tpu_torch.models.vision``) against
the JAX package's, on the CPU.

Weights drawn by the reference's ``init`` are carried across
(``load_jax_params``); the same seeded NHWC batch goes through both. The
logits, the loss, the accuracy and every gradient leaf (``jax.grad``
against ``torch.autograd``) must agree in fp32 within 1e-5 of each
array's largest magnitude: the same arithmetic summed in other orders
(XLA's convolution and dot against oneDNN's) moves fp32 results by
~1e-7 relative; a wrong layout, padding or pooling window moves them by
O(1). The port's own init must draw glorot_normal: a std within 5% of
sqrt(1/fan_avg), truncated at two of its σ.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_tpu.models import vision as jvision
from determined_tpu_torch.models import vision as tvision
from determined_tpu_torch.models.base import _flatten

B = 6
TOL = 1e-5

MODELS = {
    "mnist-mlp": (jvision.MnistMLP, tvision.MnistMLP, (28, 28, 1), {}),
    "mnist-mlp-narrow": (jvision.MnistMLP, tvision.MnistMLP, (28, 28, 1),
                         dict(hidden=32)),
    "cifar-cnn": (jvision.CifarCNN, tvision.CifarCNN, (32, 32, 3), {}),
    "cifar-cnn-narrow": (jvision.CifarCNN, tvision.CifarCNN, (32, 32, 3),
                         dict(channels=(4, 8, 8), hidden=16)),
}


def _configs(name):
    jcls, tcls, _, kw = MODELS[name]
    jcfg = (jvision.MLPConfig if jcls is jvision.MnistMLP
            else jvision.CNNConfig)(**kw)
    tcfg = (tvision.MLPConfig if tcls is tvision.MnistMLP
            else tvision.CNNConfig)(**kw)
    return jcls(jcfg), tcls(tcfg, device="cpu")


def _batch(shape, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(B, *shape)).astype(np.float32),
            "label": rng.integers(0, 10, (B,)).astype(np.int32)}


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: max |Δ| {err:.3g} > {TOL} × {scale:.3g}"


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_loss_and_gradients_match_jax(name):
    jmodel, tmodel = _configs(name)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tvision.load_jax_params(tmodel, np_params)
    batch = _batch(MODELS[name][2])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    _close(tmodel.apply(tbatch["image"]).detach().numpy(),
           jax.jit(jmodel.apply)(params, jbatch["image"]), "logits")

    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, None), has_aux=True))(params)
    tloss, tmetrics = tmodel.loss(tbatch)
    assert tloss.dtype == torch.float32
    names = [n for n, _ in tmodel.named_parameters()]
    tgrads = torch.autograd.grad(tloss, list(tmodel.parameters()))
    _close(tloss.item(), float(jloss), "loss")
    assert tmetrics["accuracy"].item() == float(jmetrics["accuracy"])
    want = dict(_flatten(jax.device_get(jgrads)))
    assert sorted(want) == sorted(names)
    for n, g in zip(names, tgrads):
        _close(g.numpy(), want[n], f"grad {n}")


@pytest.mark.parametrize("name", ["mnist-mlp", "cifar-cnn"])
def test_parameter_names_and_shapes_are_the_references(name):
    jmodel, tmodel = _configs(name)
    want = {k: v.shape for k, v in _flatten(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))}
    got = {n: tuple(p.shape) for n, p in tmodel.named_parameters()}
    assert got == want


def test_init_draws_glorot_normal():
    model = tvision.MnistMLP(device="cpu", seed=7)
    for name, fan_in, fan_out in (("w1", 784, 256), ("w2", 256, 10)):
        w = getattr(model, name).detach()
        sigma = math.sqrt(2.0 / (fan_in + fan_out))
        if w.numel() > 10_000:
            assert abs(w.std().item() / sigma - 1) < 0.05, name
        # truncated at ±2 of the untruncated normal's σ (σ / 0.8796)
        assert w.abs().max().item() <= 2 * sigma / 0.87962566103423978
    assert not model.b1.detach().any() and not model.b2.detach().any()
    cnn = tvision.CifarCNN(device="cpu", seed=7)
    w = cnn.conv1.w.detach()   # [3, 3, 32, 64]: fans 9·32, 9·64
    assert abs(w.std().item() / math.sqrt(2.0 / (9 * 96)) - 1) < 0.05
    # the seed decides the draw
    again = tvision.MnistMLP(device="cpu", seed=7)
    other = tvision.MnistMLP(device="cpu", seed=8)
    assert torch.equal(again.w1, model.w1)
    assert not torch.equal(other.w1, model.w1)


def test_load_jax_params_checks_keys_and_shapes():
    model = tvision.MnistMLP(tvision.MLPConfig(hidden=8), device="cpu")
    tree = {"w1": np.zeros((784, 8)), "b1": np.zeros(8),
            "w2": np.zeros((8, 10)), "b2": np.zeros(10)}
    before = model.w1.detach().clone()
    with pytest.raises(KeyError, match="missing.*b2"):
        tvision.load_jax_params(model, {k: v for k, v in tree.items()
                                        if k != "b2"})
    with pytest.raises(ValueError, match="w2"):
        tvision.load_jax_params(model, dict(tree, w2=np.zeros((10, 8))))
    assert torch.equal(model.w1, before)  # nothing written on a bad tree
    tvision.load_jax_params(model, tree)
    assert not model.w1.detach().any()
