"""The generative pair (``determined_tpu_torch/models/generative.py``: DDPM
and DCGAN) and its trials against the JAX package, on the CPU.

Every model is filled from the reference's own ``init`` tree through
``load_jax_params`` (fp32).

- ``DDPM.apply``, ``DCGAN.generate`` and ``DCGAN.discriminate``: outputs
  within 1e-5, the gradients of a fixed projection of each within 1e-4 of
  their largest magnitude, at a tiny width and at the examples' 32 × 32.
  The projection's weights are positive (``_weights``): a bias's gradient
  sums B·H·W terms, and with weights of both signs the sum cancels to a
  small value whose fp32 rounding (which differs with the summation
  order) is no longer small beside it.
- The losses given the reference's own draws (DDPM: t and ε from
  ``split(rng)``; DCGAN: z): the loss and metrics within 1e-5 relative,
  every gradient within 1e-4 of its largest magnitude; the GAN's
  stop-gradients as ``detach``: the generator's gradient is that of
  ``g_loss`` alone, the discriminator's that of ``d_loss`` alone.
- ``DDPM.sample`` at 10 timesteps given the reference's x_T and per-step
  noises (``fold_in(rng, t)``): within 1e-4.
- The transposed convolution (``lax.conv_transpose``, "SAME",
  ``transpose_kernel=False``) at 8 × 8 and 32 × 32, and the strided
  "SAME" convolution.
- ``get_model("ddpm" | "dcgan")`` builds; both trials run 5 steps through
  ``harness.run`` and a run resumed from the step-2 checkpoint ends on
  the uninterrupted run's step-5 parameters bit for bit (the draws are a
  function of the step).
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from determined_tpu.models import generative as jgen
from determined_tpu_torch import models as tmodels
from determined_tpu_torch.exec import harness as tharness
from determined_tpu_torch.models import generative as tgen
from determined_tpu_torch.models.base import _flatten

TRIALS = "determined_tpu_torch.examples.generative_trials"
TINY_DDPM = dict(image_size=8, channels=1, hidden=(8, 16), timesteps=10)
TINY_GAN = dict(image_size=8, channels=1, latent_dim=8, g_hidden=8,
                d_hidden=8)
#: name → (the reference's config fields; the port's are the same)
WIDTHS = {"tiny": (TINY_DDPM, TINY_GAN), "examples": ({}, {})}


def _pair(kind, fields, seed=0):
    """The reference model, its init tree (numpy) and the port's model
    filled from it."""
    jcls, jcfg, tcls, tcfg = {
        "ddpm": (jgen.DDPM, jgen.DDPMConfig, tgen.DDPM, tgen.DDPMConfig),
        "dcgan": (jgen.DCGAN, jgen.GANConfig, tgen.DCGAN, tgen.GANConfig),
    }[kind]
    jmodel = jcls(jcfg(**fields))
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    tmodel = tgen.load_jax_params(tcls(tcfg(**fields), "cpu"), tree)
    return jmodel, tree, tmodel


def _images(b, size, channels, seed=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (b, size, size, channels)).astype(np.float32)


def _weights(shape, seed):
    """A projection's weights, in [0.5, 1.5)."""
    return np.random.default_rng(seed).uniform(0.5, 1.5, shape).astype(
        np.float32)


def _hold_grads(got, want, what):
    for name, g in _flatten(want):
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(got[name].detach().numpy(), g, rtol=0,
                                   atol=1e-4 * scale, err_msg=f"{what} {name}")


def _port_grads(model, scalar, params=None):
    names, ps = zip(*[(n, p) for n, p in model.named_parameters()
                      if params is None or n.startswith(params)])
    grads = torch.autograd.grad(scalar, ps, allow_unused=True,
                                retain_graph=True)
    return {n: (torch.zeros_like(p) if g is None else g)
            for n, p, g in zip(names, ps, grads)}


# ---------------------------------------------------------------------------
# The forward and its gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("width", list(WIDTHS))
def test_ddpm_apply_matches_the_reference(width):
    fields = WIDTHS[width][0]
    jmodel, tree, tmodel = _pair("ddpm", fields)
    c = tmodel.config
    x = _images(4, c.image_size, c.channels)
    t = np.array([0, 3, c.timesteps - 1, 7], np.int32)
    cot = _weights((4, c.image_size, c.image_size, c.channels), 4)

    def f(p):
        out = jmodel.apply(p, jnp.asarray(x), jnp.asarray(t))
        return jnp.sum(out * cot), out

    (_, want), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    got = tmodel.apply(torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    _hold_grads(_port_grads(tmodel, (got * torch.from_numpy(cot)).sum()),
                jax.device_get(grads), f"ddpm {width}")


@pytest.mark.parametrize("width", list(WIDTHS))
def test_dcgan_generate_and_discriminate_match_the_reference(width):
    fields = WIDTHS[width][1]
    jmodel, tree, tmodel = _pair("dcgan", fields)
    c = tmodel.config
    z = np.random.default_rng(5).normal(size=(4, c.latent_dim)).astype(
        np.float32)
    x = _images(4, c.image_size, c.channels)
    cot = _weights((4, c.image_size, c.image_size, c.channels), 6)
    params = jax.tree.map(jnp.asarray, tree)

    def gen(p):
        out = jmodel.generate(p, jnp.asarray(z))
        return jnp.sum(out * cot), out

    (_, want_img), want_g = jax.jit(jax.value_and_grad(gen, has_aux=True))(
        params["gen"])
    img = tmodel.generate(torch.from_numpy(z))
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(want_img),
                               rtol=0, atol=1e-5)
    _hold_grads(_port_grads(tmodel, (img * torch.from_numpy(cot)).sum(),
                            "gen."), {"gen": jax.device_get(want_g)},
                f"generate {width}")
    w = _weights((4,), 7)

    def disc(p):
        out = jmodel.discriminate(p, jnp.asarray(x))
        return jnp.sum(out * w), out

    (_, want_d), want_dg = jax.jit(jax.value_and_grad(disc, has_aux=True))(
        params["disc"])
    logits = tmodel.discriminate(torch.from_numpy(x))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want_d),
                               rtol=0, atol=1e-5)
    _hold_grads(_port_grads(tmodel, (logits * torch.from_numpy(w)).sum(),
                            "disc."), {"disc": jax.device_get(want_dg)},
                f"discriminate {width}")


# ---------------------------------------------------------------------------
# The losses, given the reference's draws
# ---------------------------------------------------------------------------
def test_ddpm_loss_matches_the_reference_given_its_draws():
    jmodel, tree, tmodel = _pair("ddpm", TINY_DDPM)
    c = tmodel.config
    x0 = _images(6, c.image_size, c.channels)
    rng = jax.random.PRNGKey(11)
    # the reference's own draws (DDPM.loss)
    kt, keps = jax.random.split(rng)
    t = np.asarray(jax.random.randint(kt, (6,), 0, c.timesteps))
    eps = np.asarray(jax.random.normal(keps, x0.shape, jnp.float32))
    (want, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, {"image": jnp.asarray(x0)}, rng),
        has_aux=True))(jax.tree.map(jnp.asarray, tree))
    loss, got = tmodel.loss_given(torch.from_numpy(x0), torch.from_numpy(t),
                                  torch.from_numpy(eps))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(got["loss"].detach()),
                               float(metrics["loss"]), rtol=1e-5)
    _hold_grads(_port_grads(tmodel, loss), jax.device_get(grads), "ddpm loss")


def test_dcgan_loss_matches_the_reference_given_its_draws():
    jmodel, tree, tmodel = _pair("dcgan", TINY_GAN)
    c = tmodel.config
    real = _images(6, c.image_size, c.channels)
    rng = jax.random.PRNGKey(12)
    z = np.asarray(jax.random.normal(rng, (6, c.latent_dim), jnp.float32))
    (want, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, {"image": jnp.asarray(real)}, rng),
        has_aux=True))(jax.tree.map(jnp.asarray, tree))
    loss, got = tmodel.loss_given(torch.from_numpy(real), torch.from_numpy(z))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[k].detach()), float(v),
                                   rtol=1e-5, err_msg=k)
    total = _port_grads(tmodel, loss)
    _hold_grads(total, jax.device_get(grads), "dcgan loss")
    # the stop-gradients: G's gradient is g_loss's alone, D's d_loss's
    g_only = _port_grads(tmodel, got["g_loss"])
    d_only = _port_grads(tmodel, got["d_loss"])
    for name, g in total.items():
        mine, other = ((g_only, d_only) if name.startswith("gen.")
                       else (d_only, g_only))
        assert torch.equal(g, mine[name]), name
        assert not other[name].any(), name


def test_ddpm_sample_matches_the_reference_given_its_noises():
    jmodel, tree, tmodel = _pair("ddpm", TINY_DDPM)
    c = tmodel.config
    n, rng = 3, jax.random.PRNGKey(13)
    shape = (n, c.image_size, c.image_size, c.channels)
    # the reference's draws (DDPM.sample): x_T from rng, step t's noise
    # from fold_in(rng, t)
    x_t = np.asarray(jax.random.normal(rng, shape, jnp.float32))
    noises = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(rng, t), shape, jnp.float32))
        for t in range(c.timesteps)])
    want = jmodel.sample(jax.tree.map(jnp.asarray, tree), rng, n)
    got = tmodel.sample_given(torch.from_numpy(x_t), torch.from_numpy(noises))
    assert c.timesteps == 10
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    # the port's own draws: finite, of the shape
    drawn = tmodel.sample(n, torch.Generator().manual_seed(0))
    assert drawn.shape == shape and torch.isfinite(drawn).all()


# ---------------------------------------------------------------------------
# The convolutions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("size,k,stride", [
    (8, 4, 2), (32, 4, 2), (8, 3, 1), (8, 3, 2), (7, 5, 2),
])
def test_transposed_convolution_is_lax_conv_transpose(size, k, stride):
    from jax import lax

    rng = np.random.default_rng(size + k)
    x = rng.normal(size=(2, size, size, 5)).astype(np.float32)
    w = rng.normal(size=(k, k, 5, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    want = lax.conv_transpose(
        jnp.asarray(x), jnp.asarray(w), strides=(stride, stride),
        padding="SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    got = tgen._conv_t(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b), stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("size,k,stride", [
    (8, 4, 2), (32, 4, 2), (7, 4, 2), (8, 3, 1),
])
def test_strided_convolution_is_the_references(size, k, stride):
    rng = np.random.default_rng(size * k)
    x = rng.normal(size=(2, size, size, 4)).astype(np.float32)
    w = rng.normal(size=(k, k, 4, 6)).astype(np.float32)
    b = rng.normal(size=(6,)).astype(np.float32)
    want = jgen._conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride)
    got = tgen._conv(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b), stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_logical_axes_are_the_references():
    for kind, fields in (("ddpm", {}), ("dcgan", {})):
        jmodel, _, tmodel = _pair(kind, fields)
        want = dict(_flatten(jmodel.logical_axes()))
        got = dict(_flatten(tmodel.logical_axes()))
        assert got == want, kind


# ---------------------------------------------------------------------------
# The registry and the trials
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,cls", [("ddpm", tgen.DDPM),
                                      ("dcgan", tgen.DCGAN)])
def test_get_model_builds_the_generative_pair(name, cls):
    torch.manual_seed(3)
    a = tmodels.get_model(name, "cpu")
    torch.manual_seed(3)
    b = tmodels.get_model(name, "cpu")
    assert isinstance(a, cls)
    jmodel = {"ddpm": jgen.DDPM, "dcgan": jgen.DCGAN}[name]()
    want = {n: np.shape(v) for n, v in _flatten(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))}
    got = {n: tuple(p.shape) for n, p in a.named_parameters()}
    assert got == want
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n


def _checkpoints(root):
    """{checkpoint directory: steps_completed} under `root`."""
    out = {}
    for md in glob.glob(os.path.join(root, "*", "metadata.json")):
        with open(md) as f:
            out[os.path.dirname(md)] = json.load(f)["steps_completed"]
    return out


def _params(path):
    return {os.path.basename(p): np.load(p)
            for p in glob.glob(os.path.join(path, "params__*.npy"))}


@pytest.mark.parametrize("trial,fields", [
    ("DiffusionTrial", TINY_DDPM), ("DCGANTrial", TINY_GAN),
])
def test_trials_train_and_resume_through_the_harness(trial, fields,
                                                     monkeypatch, tmp_path):
    for k in [k for k in os.environ if k.startswith("DTPU_")]:
        monkeypatch.delenv(k)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    root = tmp_path / "ckpt"
    env = {
        "DTPU_TRIAL_ID": "1",
        "DTPU_HPARAMS": json.dumps({"model_config": dict(
            fields, **({"hidden": list(fields["hidden"])}
                       if "hidden" in fields else {})),
            "batch_size": 4, "lr": 2e-4}),
        "DTPU_EXPERIMENT_CONFIG": json.dumps({
            "searcher": {"name": "single", "metric": "loss",
                         "max_length": {"batches": 5}},
            "scheduling_unit": 1, "tensorboard": False,
            "min_checkpoint_period": {"batches": 2}}),
        "DTPU_CHECKPOINT_STORAGE": json.dumps(
            {"type": "shared_fs", "host_path": str(root)}),
        "DTPU_JAX_PLATFORM": "cpu",
    }
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tharness.run(f"{TRIALS}:{trial}") == 0
    first = {s: d for d, s in _checkpoints(root).items()}
    assert sorted(first) == [2, 4, 5]
    moved = _params(first[5])
    start = _params(first[2])
    assert all(np.isfinite(v).all() for v in moved.values())
    assert any(not np.array_equal(moved[k], start[k]) for k in moved)
    monkeypatch.setenv("DTPU_LATEST_CHECKPOINT",
                       os.path.basename(first[2]))
    assert tharness.run(f"{TRIALS}:{trial}") == 0
    resumed = {s: d for d, s in _checkpoints(root).items()
               if d not in first.values()}
    assert sorted(resumed) == [4, 5]
    again = _params(resumed[5])
    assert sorted(again) == sorted(moved)
    for k in moved:
        assert np.array_equal(again[k], moved[k]), k
