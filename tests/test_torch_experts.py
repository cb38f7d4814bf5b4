"""The top-1 mixture of experts: on one device and over the expert axis,
a 4-process port gang on the CPU (gloo), against the JAX package.

The gang is spawned once for the file by a module-scoped fixture (the
pattern of ``tests/test_torch_tensor.py``, whose optimizer chain and
report tolerances this file reuses); the JAX references run in the test
process meanwhile. Every join has a timeout. The GPT is 2 layers, d 64,
4 heads, d_ff 128, vocab 128, S 32, 4 experts, fp32, from one numpy
parameter tree.

- One device, against the reference's ``GPT(n_experts=4)`` at capacity
  factor 1.25 and 0.5 (where tokens are dropped, asserted): loss and
  accuracy within 1e-5 relative, the experts' aux loss within 1e-5, the
  logits within 1e-4, every gradient leaf within 1e-4 of its largest
  magnitude. The packed prefill (logits, K/V) and a decode step (paged and
  gather) within 1e-4, the capacity taken from each call's own tokens.
- The index dispatch (the main path) against the dense one-hot einsums
  (the plain version, the reference's form): loss, aux, accuracy and
  logits bit for bit, fp32 and bf16; every gradient within rounding (1e-6
  of its largest magnitude in fp32, two bf16 ulps in bf16: the gate's
  gradient is a dot product over D, a matmul in the dense form's einsum
  and a reduction in the index form).
- The gang at ``data=2 × expert=2`` and ``expert=4``, capacity 0.5: the
  loss over the global batch within 1e-5 relative, every rank's gradient
  (its experts' slices) within 1e-4 of the leaf's largest magnitude, and
  the tokens dropped over the ranks' rows the one-device count, layer by
  layer (the capacity is global: a rank's tokens are dropped for the
  rows before them). ``Trainer.fit`` for 3 steps at ``data=2 ×
  expert=2`` and at ``fsdp=2 × expert=2`` (ZeRO-3 blocks of the experts'
  slices) against the JAX ``Trainer`` on one device (rtol 1e-5 / 1e-4).
- A sharded save at ``fsdp=2 × expert=2``: the experts' offsets in the
  file names; restored onto one rank, it trains on with the gang's losses.
- The layouts beside the tensor and context axes build
  (``tests/test_torch_experts_split.py`` trains them); what is left out
  is refused by name: experts beside a pipeline axis (the reference's
  own limit); an expert axis that does not divide the experts; the
  serving methods on an expert mesh.
"""
import glob
import json
import os
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_gang import CLIP, LR, STEPS, _hold_reports, _numpy_tree

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
JOIN_S = 150
KW = dict(vocab_size=128, n_layers=2, n_heads=4, d_model=64, d_ff=128,
          seq_len=32, remat=False, n_experts=4)
#: the gang's capacity factor: low enough that every layer drops tokens
LOW = 0.5
#: name → mesh sizes of the direct loss and gradient
GRAD_LAYOUTS = {"data2-expert2": dict(data=2, expert=2),
                "expert4": dict(data=1, expert=4)}
#: name → mesh sizes of a fit
FIT_LAYOUTS = {"data2-expert2": dict(data=2, expert=2),
               "fsdp2-expert2": dict(data=1, fsdp=2, expert=2)}
SAVE_LAYOUT, SAVE_AT = "fsdp2-expert2", 2


def _stream(seed=7):
    rng = np.random.default_rng(seed)
    while True:
        yield {"tokens": rng.integers(0, 128, (8, 32)).astype(np.int32)}


def _loss_batch():
    rng = np.random.default_rng(5)
    return {"tokens": rng.integers(0, 128, (8, 32)).astype(np.int32),
            "loss_mask": (rng.random((8, 32)) < 0.8).astype(np.float32)}


def _kw(cf):
    return dict(KW, capacity_factor=cf)


# ---------------------------------------------------------------------------
# The worker: one rank of the gang (``python tests/test_torch_experts.py``)
# ---------------------------------------------------------------------------
def worker(rank: int, store: str, out: str) -> None:
    import datetime

    import torch
    import torch.distributed as tdist

    from determined_tpu_torch import core
    from determined_tpu_torch.core._distributed import DistributedContext
    from determined_tpu_torch.models import gpt
    from determined_tpu_torch.parallel import MeshConfig, make_mesh
    from determined_tpu_torch.trainer import Batch, TorchTrial, Trainer, optim
    from determined_tpu_torch.trainer import _checkpoint as ckpt_io

    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=JOIN_S))
    dctx = DistributedContext(rank=rank, size=WORLD)
    res, arrays = {}, {}
    tree = ckpt_io.nest(dict(np.load(os.path.join(out, "params.npz"))))

    class Trial(TorchTrial):
        def build_model(self, device, mesh=None):
            model = gpt.GPT(gpt.GPTConfig(dtype=torch.float32, **_kw(LOW)),
                            device=device, mesh=mesh)
            return gpt.load_jax_params(model, tree)

        def build_optimizer(self):
            return optim.chain(optim.clip_by_global_norm(CLIP),
                               optim.adamw(LR))

        def build_training_data(self):
            return _stream()

    def fit(trainer, steps, **kw):
        seen = []
        flush = trainer._flush

        def recording(pending, t_start):
            agg, reason = flush(pending, t_start)
            seen.append(agg)
            return agg, reason

        trainer._flush = recording
        try:
            trainer.fit(max_length=Batch(steps), report_period=Batch(1), **kw)
        finally:
            trainer._flush = flush
        return seen

    # -- the loss and gradient on the global batch ---------------------------
    for name, sizes in GRAD_LAYOUTS.items():
        trainer = Trainer(Trial(), core._dummy_init(distributed=dctx),
                          device="cpu",
                          mesh=make_mesh(MeshConfig(**sizes), device="cpu"))
        layout, model = trainer._layout, trainer.model
        batch = trainer._put_batch(_loss_batch())
        with trainer._gathering():
            loss, metrics = model.loss(batch)
        weight = layout.loss_weight(metrics)
        grads = layout.reduce_grads(torch.autograd.grad(
            loss * weight, trainer._params, materialize_grads=True))
        got = layout.reduce_metrics(
            {k: v.detach() for k, v in metrics.items()}, weight)
        res[name] = dict(
            loss=float(got["loss"]), accuracy=float(got["accuracy"]),
            expert_index=model._expert_index, dp_index=layout.dp_index,
            expert_dims=model.expert_dims(),
            drops={str(k): int(v[0]) for k, v in model.moe_drops.items()},
            shapes={n: list(p.shape) for n, p in model.named_parameters()})
        for n, g in zip(trainer._names, grads):
            arrays[f"{name}/{n}"] = g.numpy().copy()

    # -- Trainer.fit, and a sharded save --------------------------------------
    for name, sizes in FIT_LAYOUTS.items():
        mesh = make_mesh(MeshConfig(**sizes), device="cpu")
        storage = os.path.join(out, f"ckpt-{name}")
        trainer = Trainer(Trial(), core._dummy_init(
            distributed=dctx, checkpoint_storage=storage), device="cpu",
            mesh=mesh)
        save = name == SAVE_LAYOUT
        seen = fit(trainer, 4 if save else STEPS,
                   **(dict(checkpoint_period=Batch(SAVE_AT)) if save else {}))
        res[f"fit/{name}"] = dict(reports=seen)
        if save:
            ids = {}
            for uuid_ in os.listdir(storage):
                with open(os.path.join(storage, uuid_,
                                       "metadata.json")) as fh:
                    ids[json.load(fh)["steps_completed"]] = uuid_
            res["save"] = dict(id=ids[SAVE_AT], storage=storage,
                               coordinate=[int(x) for x in
                                           mesh.get_coordinate()])

    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    dctx.close()
    tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# The JAX references, in the test process
# ---------------------------------------------------------------------------
def _jax_loss(tree, cf):
    """The reference's loss, metrics, aux, logits and gradient on one
    device."""
    import jax
    import jax.numpy as jnp

    from determined_tpu.models import gpt as jgpt
    from determined_tpu_torch.models.base import _flatten
    from determined_tpu_torch.trainer._checkpoint import nest

    model = jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **_kw(cf)))
    batch = {k: jnp.asarray(v) for k, v in _loss_batch().items()}

    @jax.jit
    def run(params):
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: model.loss(p, batch, None), has_aux=True)(params)
        logits, aux = model._forward(params, batch["tokens"])
        return loss, metrics, aux, logits, grads

    loss, metrics, aux, logits, grads = run(
        jax.tree.map(jnp.asarray, nest(tree)))
    return ({"loss": float(loss), "accuracy": float(metrics["accuracy"]),
             "aux": float(aux)}, np.asarray(logits),
            {n: np.asarray(g) for n, g in _flatten(jax.device_get(grads))})


def _jax_fit(tree):
    import jax
    import jax.numpy as jnp
    import optax

    from determined_tpu import core as jcore
    from determined_tpu.models import gpt as jgpt
    from determined_tpu.parallel.mesh import MeshConfig, make_mesh
    from determined_tpu.trainer import Batch, JAXTrial, Trainer
    from determined_tpu_torch.trainer._checkpoint import nest

    class JTrial(JAXTrial):
        def build_model(self, mesh):
            return jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **_kw(LOW)),
                            mesh=mesh)

        def build_optimizer(self):
            return optax.chain(optax.clip_by_global_norm(CLIP),
                               optax.adamw(LR))

        def build_training_data(self):
            return _stream()

    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    ctx = jcore._context._dummy_init()
    trainer = Trainer(JTrial(), ctx, mesh=mesh, seed=0)
    params = jax.tree.map(lambda x, s: jax.device_put(jnp.asarray(x), s),
                          nest(tree), trainer._param_shardings())
    trainer._state = {"step": jnp.zeros((), jnp.int32), "params": params,
                      "opt_state": trainer._tx.init(params)}
    trainer.fit(max_length=Batch(STEPS), report_period=Batch(1))
    return [m for g, _, m in ctx.train._reported if g == "training"]


# ---------------------------------------------------------------------------
# The fixture: the gang, and the JAX references meanwhile
# ---------------------------------------------------------------------------
def _spawn(tmp):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DTPU_", "JAX_", "XLA_"))}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", TMPDIR=str(tmp))
    procs = []
    for rank in range(WORLD):
        log = open(tmp / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, str(rank), str(tmp / "store"),
             str(tmp)], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


def _kill(procs):
    for p, log in procs:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=10)
        log.close()


def _join(procs, tmp):
    deadline = time.time() + JOIN_S
    failed = None
    try:
        while time.time() < deadline:
            codes = [p.poll() for p, _ in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = bad[0]
                break
            if all(c == 0 for c in codes):
                return
            time.sleep(0.2)
    finally:
        _kill(procs)
    logs = "\n".join(
        f"--- rank {r} ---\n{(tmp / f'rank{r}.log').read_text()[-4000:]}"
        for r in range(WORLD) if failed is None or r == failed)
    raise AssertionError(
        (f"gang rank {failed} failed" if failed is not None
         else f"gang did not finish in {JOIN_S} s") + "\n" + logs)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("experts")
    tree = _numpy_tree(KW)
    np.savez(tmp / "params.npz", **tree)
    procs = _spawn(tmp)
    try:
        with ThreadPoolExecutor(3) as pool:
            losses = {cf: pool.submit(_jax_loss, tree, cf)
                      for cf in (1.25, LOW)}
            fit = pool.submit(_jax_fit, tree)
            ref = {cf: f.result() for cf, f in losses.items()}
            ref["fit"] = fit.result()
    except BaseException:
        _kill(procs)
        raise
    _join(procs, tmp)
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as fh:
            ranks.append((json.load(fh), dict(np.load(tmp / f"rank{r}.npz"))))
    return {"ranks": ranks, "ref": ref, "tmp": tmp, "tree": tree}


def _port(tree, cf, dtype="float32", dispatch="index"):
    import torch

    from determined_tpu_torch.models import gpt
    from determined_tpu_torch.trainer._checkpoint import nest

    model = gpt.GPT(gpt.GPTConfig(dtype=getattr(torch, dtype), **_kw(cf)),
                    device="cpu")
    model = gpt.load_jax_params(model, nest(tree))
    model.moe_dispatch = dispatch
    return model


def _port_loss(model):
    import torch

    batch = {k: torch.from_numpy(v) for k, v in _loss_batch().items()}
    loss, metrics = model.loss(batch)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    logits, aux = model._forward(batch["tokens"].long())
    names = [n for n, _ in model.named_parameters()]
    return loss, metrics, aux, logits, dict(zip(names, grads))


def _slice(whole, dims, name, index, n):
    dim = dims.get(name)
    if dim is None or n == 1:
        return whole
    k = whole.shape[dim] // n
    return np.take(whole, np.arange(index * k, (index + 1) * k), axis=dim)


# ---------------------------------------------------------------------------
# One device
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cf", [1.25, LOW])
def test_experts_on_one_device_match_the_reference(gang, cf):
    want, want_logits, want_grads = gang["ref"][cf]
    model = _port(gang["tree"], cf)
    loss, metrics, aux, logits, grads = _port_loss(model)
    np.testing.assert_allclose(float(loss.detach()), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(metrics["accuracy"]), want["accuracy"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), want["aux"], rtol=1e-5)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                               rtol=0, atol=1e-4)
    for name, g in want_grads.items():
        scale = float(np.abs(g).max())
        np.testing.assert_allclose(grads[name].numpy(), g, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
    dropped = [int(model.moe_drops[i][0]) for i in range(KW["n_layers"])]
    if cf == LOW:
        assert all(d > 0 for d in dropped), dropped


def test_serving_with_experts_matches_the_reference(gang):
    import jax
    import jax.numpy as jnp
    import torch

    from determined_tpu.models import gpt as jgpt
    from determined_tpu_torch.batch_inference import pack_sequences
    from determined_tpu_torch.trainer._checkpoint import nest

    jmodel = jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **_kw(LOW)))
    params = jax.tree.map(jnp.asarray, nest(gang["tree"]))
    tmodel = _port(gang["tree"], LOW)
    rng = np.random.default_rng(1)
    docs = [list(rng.integers(1, 128, size=n)) for n in (9, 14, 5, 20)]
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
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-4,
                                   rtol=0)
    # the capacity of a call is its own: 64 packed tokens at 0.5 drop some
    assert all(int(d) > 0 for d, n in tmodel.moe_drops.values())
    c = tmodel.config
    n_pages, ps, b, p = 9, 16, 3, 2
    pool = rng.normal(size=(2, c.n_layers, n_pages, ps, c.n_heads,
                            c.head_dim)).astype(np.float32)
    pt = rng.permutation(np.arange(1, n_pages))[:b * p].reshape(b, p)
    pt = pt.astype(np.int32)
    lengths = np.array([0, 20, 31], np.int32)
    active = np.array([True, False, True])
    last = np.array([5, 7, 100], np.int32)
    for kernel in ("paged", "gather"):
        j = jnp.asarray
        ref_logits, ref_k, _ = jmodel.decode_kv(
            params, j(last), j(lengths), j(active), j(pool[0]), j(pool[1]),
            j(pt), kernel=kernel, interpret=kernel == "paged")
        t = torch.from_numpy
        ck, cv = t(pool[0].copy()), t(pool[1].copy())
        logits, ck, _ = tmodel.decode_kv(t(last), t(lengths), t(active), ck,
                                         cv, t(pt), kernel=kernel)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   atol=1e-4, rtol=0, err_msg=kernel)
        np.testing.assert_allclose(ck.numpy(), np.asarray(ref_k), atol=1e-4,
                                   rtol=0, err_msg=kernel)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 2.0 ** -6)])
def test_index_dispatch_matches_the_dense_einsums(gang, dtype, tol):
    """The forward bit for bit. The gradients within rounding (`tol` of
    each leaf's largest magnitude: 1e-6 in fp32, two bf16 ulps): the
    gate's gradient is a dot product over D, which the dense form's
    einsum takes by a matmul and the index form by a reduction."""
    import torch

    runs = [_port_loss(_port(gang["tree"], LOW, dtype, dispatch))
            for dispatch in ("index", "dense")]
    (l1, m1, a1, x1, g1), (l2, m2, a2, x2, g2) = runs
    assert torch.equal(l1, l2) and torch.equal(a1, a2)
    assert torch.equal(x1, x2)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    for name in g1:
        a, b = g1[name].float().numpy(), g2[name].float().numpy()
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=tol * float(np.abs(b).max()),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# Over the expert axis
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", list(GRAD_LAYOUTS))
def test_expert_axis_matches_the_global_batch(gang, layout):
    want, _, grads = gang["ref"][LOW]
    sizes = GRAD_LAYOUTS[layout]
    ep = sizes["expert"]
    one = _port(gang["tree"], LOW)
    _port_loss(one)
    drops = {}
    for r, (res, arrays) in enumerate(gang["ranks"]):
        got = res[layout]
        assert got["expert_index"] == r % ep
        assert got["shapes"]["blocks.we_in"] == [2, 4 // ep, 64, 128]
        assert got["shapes"]["blocks.router"] == [2, 64, 4]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5,
                                   err_msg=f"{layout} rank {r}")
        np.testing.assert_allclose(got["accuracy"], want["accuracy"],
                                   rtol=1e-5)
        for name, g in grads.items():
            scale = float(np.abs(g).max())
            np.testing.assert_allclose(
                arrays[f"{layout}/{name}"],
                _slice(g, got["expert_dims"], name, got["expert_index"], ep),
                rtol=0, atol=1e-4 * scale, err_msg=f"{layout} rank {r} {name}")
        drops[got["dp_index"]] = got["drops"]
    # the ranks' rows drop what one device drops over the global batch
    for i in range(KW["n_layers"]):
        total = sum(d[str(i)] for d in drops.values())
        assert total == int(one.moe_drops[i][0]) > 0, (layout, i)


@pytest.mark.parametrize("layout", list(FIT_LAYOUTS))
def test_expert_fit_matches_the_jax_trainer(gang, layout):
    for r, (res, _) in enumerate(gang["ranks"]):
        _hold_reports(res[f"fit/{layout}"]["reports"][:STEPS],
                      gang["ref"]["fit"], f"{layout} rank {r}")


def test_an_expert_save_restores_onto_one_rank(gang):
    import torch

    from determined_tpu_torch import core
    from determined_tpu_torch.models import gpt
    from determined_tpu_torch.trainer import Batch, TorchTrial, Trainer, optim
    from determined_tpu_torch.trainer import _checkpoint as ckpt_io

    res0 = gang["ranks"][0][0]
    saved = res0["save"]
    files = sorted(os.path.basename(f) for f in glob.glob(
        os.path.join(saved["storage"], saved["id"], "*")))
    # split over expert (dimension 1) and fsdp (the embed dimension 2)
    assert [f for f in files if f.startswith("params__blocks__we_in")] == [
        "params__blocks__we_in.shard0_0_0_0.npy",
        "params__blocks__we_in.shard0_0_32_0.npy",
        "params__blocks__we_in.shard0_2_0_0.npy",
        "params__blocks__we_in.shard0_2_32_0.npy"]
    assert [f for f in files if f.startswith("params__blocks__be_in")] == [
        "params__blocks__be_in.shard0_0_0.npy",
        "params__blocks__be_in.shard0_2_0.npy"]
    tree = ckpt_io.nest(gang["tree"])

    class Trial(TorchTrial):
        def build_model(self, device, mesh=None):
            return gpt.load_jax_params(gpt.GPT(gpt.GPTConfig(
                dtype=torch.float32, **_kw(LOW)), device=device), tree)

        def build_optimizer(self):
            return optim.chain(optim.clip_by_global_norm(CLIP),
                               optim.adamw(LR))

        def build_training_data(self):
            return _stream()

    one = Trainer(Trial(), core._dummy_init(
        checkpoint_storage=saved["storage"]), device="cpu")
    seen = []
    flush = one._flush

    def recording(pending, t_start):
        agg, reason = flush(pending, t_start)
        seen.append(agg)
        return agg, reason

    one._flush = recording
    one.fit(max_length=Batch(4), report_period=Batch(1),
            latest_checkpoint=saved["id"])
    assert one.steps_completed == 4
    gang_losses = [m["loss"] for m in res0[f"fit/{SAVE_LAYOUT}"]["reports"]]
    np.testing.assert_allclose([m["loss"] for m in seen],
                               gang_losses[SAVE_AT:], rtol=1e-5)


# ---------------------------------------------------------------------------
# What is left out, by name
# ---------------------------------------------------------------------------
def _fake_mesh(**sizes):
    from determined_tpu_torch.parallel.mesh import AXIS_NAMES

    return types.SimpleNamespace(
        mesh_dim_names=AXIS_NAMES, device_type="cpu",
        shape=tuple(sizes.get(a, 1) for a in AXIS_NAMES),
        get_coordinate=lambda: (0,) * 6, get_group=lambda axis: None)


@pytest.mark.parametrize("axis", ["tensor", "context"])
def test_experts_beside_tensor_or_context_are_refused_by_name(
        axis, monkeypatch):
    """Retired refusals: an expert GPT builds beside a tensor axis (its
    experts' ``mlp`` dimension split over it) and beside a context axis
    (its experts whole). The mesh-like has no process groups: the
    expert × tensor group is not made."""
    import torch

    from determined_tpu_torch.models import gpt
    from determined_tpu_torch.parallel import experts

    monkeypatch.setattr(experts, "_group", lambda mesh, axes: None)

    model = gpt.GPT(gpt.GPTConfig(dtype=torch.float32, **KW), device="cpu",
                    mesh=_fake_mesh(expert=2, **{axis: 2}))
    f = 128 // 2 if axis == "tensor" else 128
    assert model.blocks["we_in"].shape == (2, 2, 64, f)
    assert model.blocks["be_in"].shape == (2, 2, f)
    assert model.blocks["we_out"].shape == (2, 2, f, 64)
    assert model.blocks["router"].shape == (2, 64, 4)
    assert model.tensor_dims().get("blocks.we_in") == (
        3 if axis == "tensor" else None)


@pytest.mark.parametrize("axis", ["pipeline", "tensor", "context"])
def test_an_expert_axis_beside_another_model_axis_is_refused(axis):
    """Experts under a pipeline stay refused, as the reference refuses
    them; beside a tensor or context axis they are taken."""
    from determined_tpu_torch.parallel import MeshConfig
    from determined_tpu_torch.parallel.mesh import refuse_later_axes

    refuse_later_axes(MeshConfig(data=2, fsdp=2, expert=2))
    refuse_later_axes(MeshConfig(**{axis: 2}))
    if axis != "pipeline":
        refuse_later_axes(MeshConfig(expert=2, **{axis: 2}))
        return
    with pytest.raises(NotImplementedError,
                       match=f"expert=2 and {axis}=2: experts over {axis} "
                             r"are left out \(ROADMAP queue 1, item 4\)"):
        refuse_later_axes(MeshConfig(expert=2, **{axis: 2}))


def test_the_expert_axis_must_divide_the_experts():
    import torch

    from determined_tpu_torch.models import gpt

    with pytest.raises(ValueError, match=r"n_experts=4 is not divisible by "
                                         r"the expert axis \(3\)"):
        gpt.GPT(gpt.GPTConfig(dtype=torch.float32, **KW), device="cpu",
                mesh=_fake_mesh(expert=3))


@pytest.mark.parametrize("method,n_args", [
    ("apply", 1), ("prefill_kv", 3), ("decode_kv", 6),
])
def test_serving_is_refused_on_an_expert_mesh(method, n_args):
    import torch

    from determined_tpu_torch.models import gpt

    model = gpt.GPT(gpt.GPTConfig(dtype=torch.float32, **KW), device="cpu",
                    mesh=_fake_mesh(expert=2))
    assert model.blocks["we_in"].shape == (2, 2, 64, 128)
    with pytest.raises(NotImplementedError,
                       match=f"GPT.{method} on a mesh with expert=2"):
        getattr(model, method)(*([torch.zeros(1, 4, dtype=torch.long)]
                                 * n_args))


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
