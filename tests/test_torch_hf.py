"""The HF integration (``integrations/hf.py``) against the reference's Flax
wrappers, at the reference tests' tiny GPT-2 and BERT configs.

transformers' Flax models (the reference's) and PyTorch models (the
port's) are built once each for the module (one JAX run per model); the
reference's Flax parameters are carried across by ``load_flax_params``
(``kernel`` transposed, ``scale`` / ``embedding`` → ``weight``, GPT-2's
tied head from ``wte``). With the dropout probabilities at 0, in fp32:
the logits within 1e-5 of the largest, the loss within 1e-4 relative and
one step's gradient within 1e-4 of each leaf's largest magnitude.
``logical_axes`` equal the reference's after the name map and the
transposes, at ``fsdp`` 1 and 2. ``HFTrial`` memorizes as the
reference's test does, the classifier learns its separable stream, and
the classifier's dropout is on in ``loss`` (drawn from the Trainer's
generator) and off in ``eval_metrics``.
"""
import types

import numpy as np
import pytest

pytest.importorskip("transformers")

GPT2 = {"n_layer": 2, "n_head": 2, "n_embd": 64, "n_positions": 64,
        "vocab_size": 128}
BERT = {"num_hidden_layers": 2, "num_attention_heads": 2,
        "hidden_size": 64, "intermediate_size": 128,
        "max_position_embeddings": 64, "vocab_size": 128}
NO_DROPOUT = {"gpt2": {"resid_pdrop": 0.0, "embd_pdrop": 0.0,
                       "attn_pdrop": 0.0},
              "bert": {"hidden_dropout_prob": 0.0,
                       "attention_probs_dropout_prob": 0.0}}


def _models(kind, overrides=None, fsdp=None):
    """(reference wrapper, port wrapper) in fp32, on the CPU."""
    import jax.numpy as jnp
    import torch

    from determined_tpu.integrations import hf as ref
    from determined_tpu_torch.integrations import hf as port

    cfg = dict(GPT2 if kind == "gpt2" else BERT, **(overrides or {}))
    ref_mesh = port_mesh = None
    if fsdp is not None:
        from determined_tpu_torch.parallel.mesh import AXIS_NAMES

        ref_mesh = types.SimpleNamespace(shape={"fsdp": fsdp})
        port_mesh = types.SimpleNamespace(
            mesh_dim_names=AXIS_NAMES, device_type="cpu",
            shape=tuple(fsdp if a == "fsdp" else 1 for a in AXIS_NAMES),
            get_coordinate=lambda: (0,) * 6, get_group=lambda axis: None)
    if kind == "gpt2":
        return (ref.HFFlaxModel("gpt2", cfg, dtype=jnp.float32,
                                mesh=ref_mesh),
                port.HFFlaxModel("gpt2", cfg, dtype=torch.float32,
                                 mesh=port_mesh, device="cpu"))
    return (ref.HFFlaxClassifier("bert", cfg, num_labels=3,
                                 dtype=jnp.float32, mesh=ref_mesh),
            port.HFFlaxClassifier("bert", cfg, num_labels=3,
                                  dtype=torch.float32, mesh=port_mesh,
                                  device="cpu"))


def _batch(kind):
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 128, (2, 16)).astype(np.int32)}
    if kind == "bert":
        batch["label"] = np.array([0, 2], np.int32)
    return batch


@pytest.fixture(scope="module")
def pairs():
    """Each kind: the two models without dropout, the port holding the
    reference's parameters, and the reference's logits, loss and
    gradient (flattened by Flax path)."""
    import jax
    from flax.traverse_util import flatten_dict

    from determined_tpu_torch.integrations.hf import load_flax_params

    out = {}
    for kind in ("gpt2", "bert"):
        ref, port = _models(kind, NO_DROPOUT[kind])
        params = ref.init(jax.random.PRNGKey(0))
        load_flax_params(port, jax.device_get(params))
        batch = _batch(kind)
        rng = jax.random.PRNGKey(1)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: ref.loss(p, batch, rng), has_aux=True))(params)
        out[kind] = dict(
            port=port,
            logits=np.asarray(jax.jit(ref.apply)(params, batch["tokens"])),
            loss=float(loss),
            grads={".".join(k): np.asarray(v)
                   for k, v in flatten_dict(jax.device_get(grads)).items()})
    return out


def _torch_batch(kind):
    import torch

    return {k: torch.as_tensor(v) for k, v in _batch(kind).items()}


@pytest.mark.parametrize("kind", ["gpt2", "bert"])
def test_logits_match_the_reference(pairs, kind):
    import torch

    case = pairs[kind]
    with torch.no_grad():
        got = case["port"].apply(_torch_batch(kind)["tokens"]).numpy()
    want = case["logits"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("kind", ["gpt2", "bert"])
def test_loss_and_gradient_match_the_reference(pairs, kind):
    import torch

    case = pairs[kind]
    port = case["port"]
    loss, _ = port.loss(_torch_batch(kind), torch.Generator().manual_seed(0))
    assert abs(loss.item() - case["loss"]) <= 1e-4 * abs(case["loss"])
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, list(port.parameters()))
    layout = port._flax_layout()
    assert sorted(p for p, _ in layout.values()) == sorted(case["grads"])
    largest = max(np.abs(g).max() for g in case["grads"].values())
    for name, g in zip(names, grads):
        path, flip = layout[name]
        want = case["grads"][path]
        got = g.numpy().T if flip else g.numpy()
        if name.endswith("key.bias"):
            # softmax does not see a key bias: both gradients are
            # rounding noise around 0 (as the gang tests leave it out)
            assert np.abs(got).max() <= 1e-6 * largest, name
            continue
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(got - want).max() <= 1e-4 * scale, name


@pytest.mark.parametrize("fsdp", [None, 2])
@pytest.mark.parametrize("kind,overrides", [
    ("gpt2", {}), ("bert", {}), ("gpt2", {"vocab_size": 50257})])
def test_logical_axes_match_after_the_name_map(kind, overrides, fsdp):
    from flax.traverse_util import flatten_dict

    from determined_tpu_torch.models.base import _flatten

    ref, port = _models(kind, overrides, fsdp)
    want = {".".join(k): v for k, v in flatten_dict(
        ref.logical_axes(), is_leaf=lambda k, x: isinstance(x, tuple)
    ).items()}
    got = dict(_flatten(port.logical_axes()))
    layout = port._flax_layout()
    assert sorted(got) == sorted(layout)
    for name, axes in got.items():
        path, flip = layout[name]
        assert (axes[::-1] if flip else axes) == want[path], name
    if overrides.get("vocab_size") == 50257 and fsdp == 2:
        # the indivisible vocabulary stays replicated
        assert got["transformer.wte.weight"] == (None, None)


def _fit(trial, steps):
    from determined_tpu_torch import core
    from determined_tpu_torch.trainer import Batch, Trainer

    ctx = core._dummy_init()
    trainer = Trainer(trial, ctx, device="cpu")
    trainer.fit(max_length=Batch(steps), report_period=Batch(5))
    return trainer, [m for g, _, m in ctx.train._reported if g == "training"]


def test_hf_trial_memorizes():
    """The reference test's recipe (bf16 compute, one fixed structured
    batch): the loss falls well below ln(vocab) in 25 steps."""
    from determined_tpu_torch.integrations.hf import HFTrial

    base = np.tile(np.arange(32), 8).reshape(8, 32).astype(np.int32)

    class MemorizableHFTrial(HFTrial):
        def build_training_data(self):
            while True:
                yield {"tokens": base}

        def build_validation_data(self):
            return [{"tokens": base}]

    trial = MemorizableHFTrial({"hf_model_type": "gpt2", "hf_config": GPT2,
                                "batch_size": 8, "seq_len": 32, "lr": 3e-3})
    trainer, reports = _fit(trial, 25)
    assert trainer.steps_completed == 25
    assert reports[-1]["loss"] < 1.0, reports[-1]


def test_classifier_learns_the_separable_stream():
    import torch

    from determined_tpu_torch.integrations.hf import HFClassifierTrial

    trial = HFClassifierTrial({
        "hf_model_type": "bert", "hf_config": BERT, "num_labels": 2,
        "batch_size": 16, "seq_len": 32, "lr": 3e-3})
    trainer, _ = _fit(trial, 30)
    batch = trainer._put_batch(trial.build_validation_data()[0])
    with torch.no_grad():
        metrics = trainer.model.eval_metrics(batch)
    # the class is written into token 0: must beat chance
    assert float(metrics["accuracy"]) > 0.7


def test_classifier_dropout_on_in_loss_off_in_eval():
    """``loss`` draws dropout from the generator it is given (the same
    seed, the same loss; another seed, another), whatever mode the module
    is in; ``eval_metrics`` runs without dropout, as ``apply``; the causal
    LM's loss runs without dropout (the reference's ``train=False``)."""
    import torch

    _, model = _models("bert")
    batch = _torch_batch("bert")
    gen = torch.Generator()
    model.eval()
    a, _ = model.loss(batch, gen.manual_seed(1))
    model.train()
    b, _ = model.loss(batch, gen.manual_seed(1))
    c, _ = model.loss(batch, gen.manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert model.training  # the mode is restored
    with torch.no_grad():
        e1 = model.eval_metrics(batch)
        e2 = model.eval_metrics(batch)
        plain = model._metrics(model.apply(batch["tokens"]), batch["label"])
    assert torch.equal(e1["loss"], e2["loss"])
    assert torch.equal(e1["loss"], plain["loss"])
    assert not torch.equal(e1["loss"], a.detach())

    _, lm = _models("gpt2")
    tokens = _torch_batch("gpt2")
    lm.train()
    x, _ = lm.loss(tokens, gen.manual_seed(1))
    y, _ = lm.loss(tokens, gen.manual_seed(2))
    lm.eval()
    z, _ = lm.loss(tokens)
    assert torch.equal(x, y) and torch.equal(x, z)


def test_checkpoint_names_are_transformers_torch_names():
    """The Trainer's named state: transformers' torch names, the tied
    head once (under ``wte``)."""
    _, model = _models("gpt2")
    names = [n for n, _ in model.named_parameters()]
    assert "transformer.wte.weight" in names
    assert "transformer.h.0.attn.c_attn.weight" in names
    assert not any(n.startswith("lm_head") for n in names)



def test_tied_head_reads_the_gathered_embedding():
    """On an fsdp axis the Trainer swaps a split leaf's gathered whole
    into its module for the forward (``MeshLayout.gathered_into``, under
    the leaf's one name, ``transformer.wte.weight``); GPT-2's tied head
    must read that tensor too, and hold its own parameter again after."""
    import torch

    _, model = _models("gpt2", NO_DROPOUT["gpt2"])
    tokens = _torch_batch("gpt2")["tokens"].long()
    wte = model.transformer.wte
    block = wte._parameters["weight"]
    whole = block.detach() * 2.0
    wte._parameters["weight"] = whole
    try:
        with torch.no_grad():
            got = model.apply(tokens)
            hidden = model.transformer(input_ids=tokens).last_hidden_state
    finally:
        wte._parameters["weight"] = block
    torch.testing.assert_close(got, hidden @ whole.T, rtol=1e-5, atol=1e-5)
    assert model.lm_head._parameters["weight"] is block
