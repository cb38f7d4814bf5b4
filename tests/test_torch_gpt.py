"""The port's GPT (determined_tpu_torch.models.gpt) against the JAX
package's, on the CPU at fp32 and tiny size: weights carried over with
load_jax_params from the reference's GPT.init, then the dense forward,
the packed prefill (logits and every layer's K/V) and one decode step on
both kernels (paged, gather) compared on the same inputs.

Tolerance: atol 1e-4 on logits, K/V and the updated pool — fp32 through
two layers; the packages differ in summation order only.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from determined_tpu.models import gpt as jgpt
from determined_tpu_torch.models import gpt as tgpt

ATOL = 1e-4


def _configs():
    kw = dict(vocab_size=256, n_layers=2, n_heads=4, d_model=64, d_ff=256,
              seq_len=128, remat=False)
    return (jgpt.GPTConfig(dtype=jnp.float32, **kw),
            tgpt.GPTConfig(dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _configs()
    jmodel = jgpt.GPT(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.device_get(params)
    tmodel = tgpt.load_jax_params(tgpt.GPT(tcfg, device="cpu"), tree)
    return jmodel, params, tmodel, tree


def test_apply_matches(pair):
    jmodel, params, tmodel, _ = pair
    tokens = np.random.default_rng(0).integers(0, 256, size=(2, 32)).astype(np.int32)
    ref = np.asarray(jmodel.apply(params, jnp.asarray(tokens)))
    out = tmodel.apply(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def test_prefill_kv_matches(pair):
    from determined_tpu_torch.batch_inference import pack_sequences

    jmodel, params, tmodel, _ = pair
    rng = np.random.default_rng(1)
    docs = [list(rng.integers(1, 256, size=n)) for n in (9, 14, 5, 20)]
    batch = next(pack_sequences(docs, 32, 2))
    segs = batch["segment_ids"]
    positions = np.zeros_like(segs)
    for r in range(segs.shape[0]):
        for doc in np.unique(segs[r][segs[r] > 0]):
            idx = np.nonzero(segs[r] == doc)[0]
            positions[r, idx] = np.arange(len(idx))
    args = (batch["tokens"], positions, segs)
    ref = jmodel.prefill_kv(params, *(jnp.asarray(a) for a in args))
    out = tmodel.prefill_kv(*(torch.from_numpy(a) for a in args))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL, rtol=0)


@pytest.mark.parametrize("kernel", ["paged", "gather"])
def test_decode_kv_matches(pair, kernel):
    jmodel, params, tmodel, _ = pair
    c = tmodel.config
    rng = np.random.default_rng(2)
    n_pages, ps, b, p = 9, 16, 3, 2
    pool = rng.normal(size=(2, c.n_layers, n_pages, ps, c.n_heads,
                            c.head_dim)).astype(np.float32)
    pt = rng.permutation(np.arange(1, n_pages))[:b * p].reshape(b, p)
    pt = pt.astype(np.int32)
    lengths = np.array([0, 20, 31], np.int32)
    active = np.array([True, False, True])
    last = np.array([5, 7, 200], np.int32)
    j = jnp.asarray
    ref_logits, ref_k, ref_v = jmodel.decode_kv(
        params, j(last), j(lengths), j(active), j(pool[0]), j(pool[1]),
        j(pt), kernel=kernel, interpret=kernel == "paged",
    )
    t = torch.from_numpy
    ck, cv = t(pool[0].copy()), t(pool[1].copy())
    logits, ck2, cv2 = tmodel.decode_kv(
        t(last), t(lengths), t(active), ck, cv, t(pt), kernel=kernel,
    )
    assert ck2 is ck and cv2 is cv, "the pool is updated in place"
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(ck.numpy(), np.asarray(ref_k), atol=ATOL, rtol=0)
    np.testing.assert_allclose(cv.numpy(), np.asarray(ref_v), atol=ATOL, rtol=0)


def test_parameter_names_and_shapes_match_reference(pair):
    _, _, tmodel, tree = pair
    flat = dict(tgpt._flatten(tree))
    assert {n: tuple(p.shape) for n, p in tmodel.named_parameters()} == \
        {n: tuple(a.shape) for n, a in flat.items()}


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape"])
def test_load_jax_params_rejects_mismatch(pair, fault):
    _, _, _, tree = pair
    bad = {k: (dict(v) if isinstance(v, dict) else v) for k, v in tree.items()}
    if fault == "missing":
        del bad["blocks"]["wo"]
        err = KeyError
    elif fault == "unexpected":
        bad["head"] = np.zeros((64, 256), np.float32)
        err = KeyError
    else:
        bad["pos_embed"] = np.zeros((64, 64), np.float32)
        err = ValueError
    _, tcfg = _configs()
    with pytest.raises(err):
        tgpt.load_jax_params(tgpt.GPT(tcfg, device="cpu"), bad)


def test_serving_copy_keeps_the_numbers(pair):
    """The bf16 serving copy is the per-call cast done once: the engine's
    prefill (logits and K/V) is bitwise that of the per-call path, and of
    the full-sequence forward."""
    _, _, _, tree = pair
    _, tcfg = _configs()
    cfg = tgpt.GPTConfig(**{**tcfg.__dict__, "dtype": torch.bfloat16})
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, size=(1, 16)))
    positions = torch.arange(16)[None]
    segs = torch.ones((1, 16), dtype=torch.int32)
    per_call = tgpt.load_jax_params(tgpt.GPT(cfg, device="cpu"), tree)
    cached = tgpt.load_jax_params(tgpt.GPT(cfg, device="cpu"), tree,
                                  serving_copy=True)
    assert cached._compute and not per_call._compute
    want = per_call.prefill_kv(tokens, positions, segs)
    got = cached.prefill_kv(tokens, positions, segs)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    assert torch.equal(got[0], cached.apply(tokens))


def test_refuses_configs_of_later_slices():
    """What the port leaves out: experts beside pipeline stages (the
    reference's own limit). Beside a tensor axis they build, their
    ``mlp`` dimension split over it."""
    import types

    from determined_tpu_torch.parallel.mesh import AXIS_NAMES

    _, tcfg = _configs()
    with pytest.raises(NotImplementedError,
                       match=r"MoE\+pipeline composition not supported yet"):
        tgpt.GPT(tgpt.GPTConfig(**{**tcfg.__dict__, "n_experts": 4,
                                   "pipeline_stages": 2}), device="cpu")
    tensor2 = types.SimpleNamespace(
        mesh_dim_names=AXIS_NAMES, device_type="cpu",
        shape=(1, 1, 1, 1, 1, 2), get_coordinate=lambda: (0,) * 6,
        get_group=lambda axis: None)
    model = tgpt.GPT(tgpt.GPTConfig(**{**tcfg.__dict__, "n_experts": 4}),
                     device="cpu", mesh=tensor2)
    assert model.tensor_dims() == {
        **{k: v for k, v in model.tensor_dims().items()
           if not k.startswith("blocks.we_") and k != "blocks.be_in"},
        "blocks.we_in": 3, "blocks.be_in": 2, "blocks.we_out": 2}
    assert model.blocks["we_in"].shape[-1] == tcfg.d_ff // 2
    # the zigzag layout needs a sharded context axis (tests/test_torch_context.py)
    with pytest.raises(ValueError, match="sharded context axis"):
        tgpt.GPT(tgpt.GPTConfig(**{**tcfg.__dict__,
                                   "sequence_layout": "zigzag"}),
                 device="cpu")
