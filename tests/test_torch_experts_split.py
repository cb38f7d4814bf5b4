"""Experts over the tensor and context axes: a 4-process port gang on the
CPU (gloo) against the JAX package.

The gang is spawned once for the file by a module-scoped fixture (the
pattern of ``tests/test_torch_experts.py``, whose GPT, batches, capacity
and JAX references this file reuses); the JAX references run in the test
process meanwhile, one run each shared by every case that needs it.
Every join has a timeout. The GPT is 2 layers, d 64, 4 heads, d_ff 128,
vocab 128, S 32, 4 experts at capacity factor 0.5, fp32.

- The loss and gradient on the global batch at ``expert=2 × tensor=2``
  (the experts' ``mlp`` dimension split over tensor) and at ``expert=2 ×
  context=2`` by ring attention (contiguous), Ulysses and the zigzag
  layout: the loss and the experts' aux loss within 1e-5 relative, every
  rank's gradient (its expert and tensor slices) within 1e-4 of the
  leaf's largest magnitude, and the tokens dropped over the ranks the
  reference's count, layer by layer (the capacity's cumsum runs over the
  global [B·S] order, whatever splits the sequence). Ring and Ulysses are
  held against the one-device JAX GPT (the function does not depend on
  the mesh), zigzag against the JAX GPT on 8 virtual devices at
  ``data=4 × context=2`` with ``sequence_layout="zigzag"``, whose token
  order is the zigzag loader's permuted one.
- ``Trainer.fit`` for 3 steps at ``expert=2 × tensor=2`` and at ``fsdp=2
  × tensor=2`` (ZeRO-3 blocks of the experts' d dimension beside their
  tensor slices) against the JAX ``Trainer`` on one device (rtol 1e-5 /
  1e-4).
- A sharded save at ``expert=2 × tensor=2``: the expert and ``mlp``
  offsets in the file names; restored onto ``data=2 × expert=2`` in the
  gang and onto one rank here, both train on with the gang's losses.
"""
import glob
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_experts import (
    KW,
    LOW,
    _jax_fit,
    _jax_loss,
    _join,
    _kill,
    _kw,
    _loss_batch,
    _stream,
)
from tests.test_torch_gang import CLIP, LR, STEPS, _hold_reports, _numpy_tree

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
JOIN_S = 150
#: name → (mesh sizes, GPTConfig fields, batch) of the direct loss and
#: gradient
GRAD_LAYOUTS = {
    "expert2-tensor2": (dict(expert=2, tensor=2), {}, "tokens"),
    "expert2-context2-ring": (dict(expert=2, context=2), {}, "tokens"),
    "expert2-context2-ulysses": (dict(expert=2, context=2),
                                 dict(attn_impl="ulysses"), "tokens"),
    "expert2-context2-zigzag": (dict(expert=2, context=2),
                                dict(sequence_layout="zigzag"), "zigzag"),
}
#: name → mesh sizes of a fit
FIT_LAYOUTS = {"expert2-tensor2": dict(expert=2, tensor=2),
               "fsdp2-tensor2": dict(fsdp=2, tensor=2)}
SAVE_LAYOUT, SAVE_AT, SAVE_STEPS = "expert2-tensor2", 2, 4
#: the layout a save restores onto in the gang
RESTORE_LAYOUT = dict(data=2, expert=2)


def _zigzag_batch(lm_dataset):
    """The zigzag loader's first batch at context 2: tokens and targets
    [8, 32] in its permuted order, positions [32]."""
    return dict(next(lm_dataset(None, 8, 32, 128, seed=7, zigzag_ring=2)))


# ---------------------------------------------------------------------------
# The worker: one rank of the gang (``python tests/test_torch_experts_split.py``)
# ---------------------------------------------------------------------------
def worker(rank: int, store: str, out: str) -> None:
    import datetime

    import torch
    import torch.distributed as tdist

    from determined_tpu_torch import core
    from determined_tpu_torch.core._distributed import DistributedContext
    from determined_tpu_torch.data import lm_dataset
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
        def __init__(self, fields=None):
            super().__init__()
            self.fields = fields or {}

        def build_model(self, device, mesh=None):
            model = gpt.GPT(gpt.GPTConfig(dtype=torch.float32, **_kw(LOW),
                                          **self.fields),
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
    for name, (sizes, fields, kind) in GRAD_LAYOUTS.items():
        mesh = make_mesh(MeshConfig(**sizes), device="cpu")
        trainer = Trainer(Trial(fields), core._dummy_init(distributed=dctx),
                          device="cpu", mesh=mesh)
        layout, model = trainer._layout, trainer.model
        whole = (_zigzag_batch(lm_dataset) if kind == "zigzag"
                 else _loss_batch())
        batch = trainer._put_batch(whole)
        with trainer._gathering():
            loss, metrics = model.loss(batch)
        drops = {str(k): int(v[0]) for k, v in model.moe_drops.items()}
        weight = layout.loss_weight(metrics)
        grads = layout.reduce_grads(torch.autograd.grad(
            loss * weight, trainer._params, materialize_grads=True))
        got = layout.reduce_metrics(
            {k: v.detach() for k, v in metrics.items()}, weight)
        with torch.no_grad(), trainer._gathering():
            _, aux = model._forward(batch["tokens"].long(),
                                    batch.get("positions"))
        res[name] = dict(
            loss=float(got["loss"]), accuracy=float(got["accuracy"]),
            aux=float(aux), coordinate=[int(x) for x in
                                        mesh.get_coordinate()],
            slices={n: {a: [d, model._index(a), model._degree(a)]
                        for a, d in dims.items()}
                    for n, dims in model._slice_dims.items()},
            drops=drops,
            shapes={n: list(p.shape) for n, p in model.named_parameters()})
        for n, g in zip(trainer._names, grads):
            arrays[f"{name}/{n}"] = g.numpy().copy()

    # -- Trainer.fit, and a sharded save --------------------------------------
    for name, sizes in FIT_LAYOUTS.items():
        storage = os.path.join(out, f"ckpt-{name}")
        trainer = Trainer(Trial(), core._dummy_init(
            distributed=dctx, checkpoint_storage=storage), device="cpu",
            mesh=make_mesh(MeshConfig(**sizes), device="cpu"))
        save = name == SAVE_LAYOUT
        seen = fit(trainer, SAVE_STEPS if save else STEPS,
                   **(dict(checkpoint_period=Batch(SAVE_AT)) if save else {}))
        res[f"fit/{name}"] = dict(reports=seen)
        if save:
            ids = {}
            for uuid_ in os.listdir(storage):
                with open(os.path.join(storage, uuid_,
                                       "metadata.json")) as fh:
                    ids[json.load(fh)["steps_completed"]] = uuid_
            res["save"] = dict(id=ids[SAVE_AT], storage=storage)
            restored = Trainer(Trial(), core._dummy_init(
                distributed=dctx, checkpoint_storage=storage), device="cpu",
                mesh=make_mesh(MeshConfig(**RESTORE_LAYOUT), device="cpu"))
            res["restored"] = dict(reports=fit(
                restored, SAVE_STEPS, latest_checkpoint=ids[SAVE_AT]))

    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    dctx.close()
    tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# The JAX references, in the test process
# ---------------------------------------------------------------------------
def _counting(model, sink):
    """`model` (a reference GPT) with its ``_moe_mlp`` also counting the
    tokens its capacity drops into `sink`, by the reference's own
    arithmetic (a token is dropped when its position in its expert's
    cumsum reaches the capacity)."""
    import jax
    import jax.numpy as jnp

    real = model._moe_mlp
    c = model.config

    def counted(h, blk, manual):
        b, s, d = h.shape
        e = c.n_experts
        cap = max(1, int(c.capacity_factor * b * s / e))
        gates = jax.nn.softmax(jnp.einsum(
            "td,de->te", h.reshape(b * s, d),
            blk["router"].astype(c.dtype)).astype(jnp.float32))
        onehot = jax.nn.one_hot(jnp.argmax(gates, axis=-1), e,
                                dtype=jnp.float32)
        pos = (jnp.cumsum(onehot, axis=0) - 1.0) * onehot
        sink.append(jnp.sum(onehot * (pos >= cap)))
        return real(h, blk, manual)

    model._moe_mlp = counted
    return model


def _jax_drops(model, params, tokens, positions=None):
    """The reference's dropped tokens per layer on its forward."""
    import jax

    sink = []
    _counting(model, sink)

    @jax.jit
    def run(p):
        sink.clear()
        model._forward(p, tokens, positions)
        return list(sink)

    return [int(d) for d in run(params)]


def _jax_one_device(tree):
    """The one-device reference at the gang's capacity: loss, metrics,
    aux, gradient (``_jax_loss``) and the drops per layer."""
    import jax
    import jax.numpy as jnp

    from determined_tpu.models import gpt as jgpt
    from determined_tpu_torch.trainer._checkpoint import nest

    want, _, grads = _jax_loss(tree, LOW)
    model = jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **_kw(LOW)))
    drops = _jax_drops(model, jax.tree.map(jnp.asarray, nest(tree)),
                       jnp.asarray(_loss_batch()["tokens"]))
    return want, grads, drops


def _jax_zigzag(tree):
    """The reference at ``data=4 × context=2`` on 8 virtual devices,
    ``sequence_layout="zigzag"``, on the zigzag loader's batch: one compile
    of its loss and gradient."""
    import jax
    import jax.numpy as jnp

    from determined_tpu.data import lm_dataset
    from determined_tpu.models import gpt as jgpt
    from determined_tpu.parallel.mesh import MeshConfig, make_mesh
    from determined_tpu_torch.models.base import _flatten
    from determined_tpu_torch.trainer._checkpoint import nest

    mesh = make_mesh(MeshConfig(data=4, context=2), devices=jax.devices()[:8])
    model = jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32,
                                    sequence_layout="zigzag", **_kw(LOW)),
                     mesh=mesh)
    batch = {k: jnp.asarray(v) for k, v in _zigzag_batch(lm_dataset).items()}
    params = jax.tree.map(jnp.asarray, nest(tree))

    @jax.jit
    def run(p):
        (loss, metrics), grads = jax.value_and_grad(
            lambda q: model.loss(q, batch, None), has_aux=True)(p)
        _, aux = model._forward(p, batch["tokens"], batch["positions"])
        return loss, metrics, aux, grads

    with mesh:
        loss, metrics, aux, grads = run(params)
        drops = _jax_drops(model, params, batch["tokens"],
                           batch["positions"])
    want = {"loss": float(loss), "accuracy": float(metrics["accuracy"]),
            "aux": float(aux)}
    return want, {n: np.asarray(g) for n, g in
                  _flatten(jax.device_get(grads))}, drops


# ---------------------------------------------------------------------------
# The fixture: the gang, and the JAX references meanwhile
# ---------------------------------------------------------------------------
def _spawn(tmp):
    import subprocess

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


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("experts-split")
    tree = _numpy_tree(KW)
    np.savez(tmp / "params.npz", **tree)
    procs = _spawn(tmp)
    try:
        with ThreadPoolExecutor(3) as pool:
            one = pool.submit(_jax_one_device, tree)
            zigzag = pool.submit(_jax_zigzag, tree)
            fit = pool.submit(_jax_fit, tree)
            ref = {"one": one.result(), "zigzag": zigzag.result(),
                   "fit": fit.result()}
    except BaseException:
        _kill(procs)
        raise
    _join(procs, tmp)
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as fh:
            ranks.append((json.load(fh), dict(np.load(tmp / f"rank{r}.npz"))))
    return {"ranks": ranks, "ref": ref, "tree": tree}


def _slices(whole, dims):
    """This rank's slice of a whole gradient: {axis: [dim, index, n]}."""
    for dim, index, n in dims.values():
        k = whole.shape[dim] // n
        whole = np.take(whole, np.arange(index * k, (index + 1) * k),
                        axis=dim)
    return whole


# ---------------------------------------------------------------------------
# The loss, its gradient and the drops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", list(GRAD_LAYOUTS))
def test_experts_split_match_the_global_batch(gang, layout):
    sizes, _, kind = GRAD_LAYOUTS[layout]
    want, grads, want_drops = gang["ref"]["zigzag" if kind == "zigzag"
                                          else "one"]
    drops = {}
    for r, (res, arrays) in enumerate(gang["ranks"]):
        got = res[layout]
        what = f"{layout} rank {r}"
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5,
                                   err_msg=what)
        np.testing.assert_allclose(got["accuracy"], want["accuracy"],
                                   rtol=1e-5, err_msg=what)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5,
                                   err_msg=what)
        # the experts' slices: E/ep experts, on a tensor axis f/tp of each
        we_in = got["shapes"]["blocks.we_in"]
        assert we_in == [2, 4 // sizes["expert"], 64,
                         128 // sizes.get("tensor", 1)], (what, we_in)
        assert got["shapes"]["blocks.router"] == [2, 64, 4], what
        for name, g in grads.items():
            scale = float(np.abs(g).max())
            np.testing.assert_allclose(
                arrays[f"{layout}/{name}"],
                _slices(g, got["slices"].get(name, {})),
                rtol=0, atol=1e-4 * scale, err_msg=f"{what} {name}")
        # (data, fsdp, context) place a rank's tokens; its expert and
        # tensor coordinates share them
        _, _, _, ei, ci, ti = got["coordinate"]
        if ei == 0 and ti == 0:
            drops[ci] = got["drops"]
    assert len(drops) == sizes.get("context", 1), drops
    for i in range(KW["n_layers"]):
        total = sum(d[str(i)] for d in drops.values())
        assert total == want_drops[i] > 0, (layout, i, drops, want_drops)


def test_the_drops_are_the_reference_count_on_one_device(gang):
    """The one-device port drops the reference's count per layer (the
    count the ring and Ulysses layouts are held to)."""
    import torch

    from determined_tpu_torch.models import gpt
    from determined_tpu_torch.trainer._checkpoint import nest

    model = gpt.load_jax_params(gpt.GPT(gpt.GPTConfig(
        dtype=torch.float32, **_kw(LOW)), device="cpu"), nest(gang["tree"]))
    with torch.no_grad():
        model._forward(torch.from_numpy(_loss_batch()["tokens"]).long())
    got = [int(model.moe_drops[i][0]) for i in range(KW["n_layers"])]
    assert got == gang["ref"]["one"][2], got


# ---------------------------------------------------------------------------
# Training, and the sharded save
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", list(FIT_LAYOUTS))
def test_experts_split_fit_matches_the_jax_trainer(gang, layout):
    for r, (res, _) in enumerate(gang["ranks"]):
        _hold_reports(res[f"fit/{layout}"]["reports"][:STEPS],
                      gang["ref"]["fit"], f"{layout} rank {r}")


def test_an_expert_tensor_save_restores_onto_other_layouts(gang):
    import torch

    from determined_tpu_torch import core
    from determined_tpu_torch.models import gpt
    from determined_tpu_torch.trainer import Batch, TorchTrial, Trainer, optim
    from determined_tpu_torch.trainer import _checkpoint as ckpt_io

    res0 = gang["ranks"][0][0]
    saved = res0["save"]
    files = sorted(os.path.basename(f) for f in glob.glob(
        os.path.join(saved["storage"], saved["id"], "*")))
    # split over expert (dimension 1) and tensor (the mlp dimension)
    assert [f for f in files if f.startswith("params__blocks__we_in")] == [
        "params__blocks__we_in.shard0_0_0_0.npy",
        "params__blocks__we_in.shard0_0_0_64.npy",
        "params__blocks__we_in.shard0_2_0_0.npy",
        "params__blocks__we_in.shard0_2_0_64.npy"]
    assert [f for f in files if f.startswith("params__blocks__we_out")] == [
        "params__blocks__we_out.shard0_0_0_0.npy",
        "params__blocks__we_out.shard0_0_64_0.npy",
        "params__blocks__we_out.shard0_2_0_0.npy",
        "params__blocks__we_out.shard0_2_64_0.npy"]
    assert [f for f in files if f.startswith("params__blocks__be_in")] == [
        "params__blocks__be_in.shard0_0_0.npy",
        "params__blocks__be_in.shard0_0_64.npy",
        "params__blocks__be_in.shard0_2_0.npy",
        "params__blocks__be_in.shard0_2_64.npy"]
    assert "params__blocks__router.npy" in files
    gang_losses = [m["loss"] for m in
                   res0[f"fit/{SAVE_LAYOUT}"]["reports"]][SAVE_AT:]
    # onto data=2 × expert=2, in the gang
    for r, (res, _) in enumerate(gang["ranks"]):
        np.testing.assert_allclose(
            [m["loss"] for m in res["restored"]["reports"]], gang_losses,
            rtol=1e-5, err_msg=f"restored onto data=2 x expert=2, rank {r}")
    # onto one rank, here
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

    ctx = core._dummy_init(checkpoint_storage=saved["storage"])
    one = Trainer(Trial(), ctx, device="cpu")
    one.fit(max_length=Batch(SAVE_STEPS), report_period=Batch(1),
            latest_checkpoint=saved["id"])
    assert one.steps_completed == SAVE_STEPS
    np.testing.assert_allclose(
        [m["loss"] for g, _, m in ctx.train._reported if g == "training"],
        gang_losses, rtol=1e-5)


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
