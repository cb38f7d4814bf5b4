"""Pipeline stages: a 4-process port gang on the CPU (gloo) against the JAX
package.

One gang, spawned once for the file by a module-scoped fixture (the
pattern of ``tests/test_torch_tensor.py``, whose optimizer chain and
report tolerances this file reuses): each rank runs this file as a script
(``worker``), answers every case and writes what it saw to
``rank<r>.json`` / ``rank<r>.npz``. The reference's schedules on a toy
stage run in one more process (``jax_worker``) under ``shard_map`` on a
pipeline-only mesh of the reference's virtual CPU devices; the reference's
GPT runs unpipelined in the test process meanwhile (its own tests hold
its pipelines against the unpipelined model too). Every join has a
timeout. The GPT has 4 layers (d 64, 4 heads, d_ff 128, vocab 128, S 32),
fp32, from one numpy parameter tree.

- The schedules on a toy stage (tanh(x @ w), D 8, M 4): the port's
  ``pipeline_apply`` and ``circular_pipeline_apply`` (V 2, its own
  ``stack_circular_stages`` layout) give the reference's outputs under
  ``shard_map`` at S 2 and 4, and their gradients are the sequential
  composition's (``jax.grad``); the port's ``one_f_one_b_grads`` gives the
  reference's metric sums, stage, embedding and loss gradients (outputs
  within 1e-6, the rest within 1e-5 of the reference's largest magnitude,
  at least 1); its stash never above
  ``one_f_one_b_stash_size`` = min(M, 2S − 1) (stage 0 reaching it).
- ``stack_circular_stages`` against the reference's, and its refusal.
- The GPT on nine layouts, the reference's tolerances (``tests/test_1f1b.py``:
  loss 1e-4, accuracy 1e-5, every gradient leaf rtol 5e-3 / atol 1e-5,
  fp32) against the unpipelined JAX model on one masked batch: GPipe at
  ``data=2 × pipeline=2``, circular at ``fsdp=2 × pipeline=2``, 1F1B at
  ``data=2 × pipeline=2``, at ``pipeline=4`` and at ``pipeline=2 ×
  tensor=2`` (untied head), GPipe at ``pipeline=2 × tensor=2`` (rematted),
  and pipeline × context: 1F1B with ring attention on the Trainer's
  pre-shifted batch, GPipe with Ulysses, and 1F1B on the zigzag loader's
  batch (held against the reference on the batch put back in order).
  Then ``Trainer.fit`` for 3 steps on each: the tied layouts' losses and
  grad norms against the JAX ``Trainer`` on one device (rtol 1e-5 / 1e-4),
  the 1F1B stash per step within its bound.
- A sharded save at ``data=2 × pipeline=2`` (every stage holds every
  block, as the reference's) restored onto one rank, which trains on with
  the gang's losses.
- Every guard of the reference's pipelined paths, by its words.
"""
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
KW = dict(vocab_size=128, n_layers=4, n_heads=4, d_model=64, d_ff=128,
          seq_len=32, remat=False)
#: name → (mesh sizes, GPTConfig fields, data stream)
LAYOUTS = {
    "gpipe-d2p2": (dict(data=2, pipeline=2),
                   dict(pipeline_schedule="gpipe", num_microbatches=2),
                   "tokens"),
    "circular-f2p2": (dict(fsdp=2, pipeline=2),
                      dict(pipeline_schedule="circular", num_microbatches=2,
                           pipeline_virtual_stages=2), "tokens"),
    "1f1b-d2p2": (dict(data=2, pipeline=2),
                  dict(pipeline_schedule="1f1b", num_microbatches=4),
                  "tokens"),
    "1f1b-p4": (dict(pipeline=4),
                dict(pipeline_schedule="1f1b", num_microbatches=8),
                "tokens"),
    "1f1b-p2t2-untied": (dict(pipeline=2, tensor=2),
                         dict(pipeline_schedule="1f1b", num_microbatches=4,
                              tie_embeddings=False), "untied"),
    "gpipe-p2t2-remat": (dict(pipeline=2, tensor=2),
                         dict(pipeline_schedule="gpipe", num_microbatches=4,
                              remat=True), "tokens"),
    "1f1b-p2c2-ring": (dict(pipeline=2, context=2),
                       dict(pipeline_schedule="1f1b", num_microbatches=4),
                       "tokens"),
    "gpipe-p2c2-ulysses": (dict(pipeline=2, context=2),
                           dict(pipeline_schedule="gpipe",
                                num_microbatches=4, attn_impl="ulysses"),
                           "tokens"),
    "1f1b-p2c2-zigzag": (dict(pipeline=2, context=2),
                         dict(pipeline_schedule="1f1b", num_microbatches=4,
                              sequence_layout="zigzag"), "zigzag"),
}
#: the toy schedules: microbatches, rows, width, vocabulary, virtual stages
TOY_M, TOY_MB, TOY_D, TOY_V, TOY_VS = 4, 2, 8, 16, 2
SAVE_LAYOUT, SAVE_AT = "gpipe-d2p2", 2


def _stream(kind="tokens", lm_dataset=None):
    if kind == "zigzag":
        return lm_dataset(None, 8, 32, 128, seed=7, zigzag_ring=2)

    def tokens():
        rng = np.random.default_rng(7)
        while True:
            yield {"tokens": rng.integers(0, 128, (8, 32)).astype(np.int32)}

    return tokens()


def _loss_batch(kind="tokens", lm_dataset=None):
    """The masked batch the gradients are held on; the zigzag loader's
    first batch for the zigzag layout."""
    if kind == "zigzag":
        return dict(next(_stream(kind, lm_dataset)))
    rng = np.random.default_rng(5)
    return {"tokens": rng.integers(0, 128, (8, 32)).astype(np.int32),
            "loss_mask": (rng.random((8, 32)) < 0.8).astype(np.float32)}


def _unzig(batch):
    """A zigzag batch put back in order (its positions map inverted)."""
    batch = dict(batch)
    inv = np.argsort(batch.pop("positions"))
    return {k: v[:, inv] for k, v in batch.items()}


def _toy_inputs(s):
    """Per-stage weights [S·V, D, D], microbatches, the output cotangent,
    the 1F1B embedding table and head, tokens and mask."""
    rng = np.random.default_rng(11 + s)
    d = TOY_D
    return dict(
        w=(0.5 * rng.standard_normal((s * TOY_VS, d, d))).astype(np.float32),
        x=rng.standard_normal((TOY_M, TOY_MB, d)).astype(np.float32),
        r=rng.standard_normal((TOY_M, TOY_MB, d)).astype(np.float32),
        e=rng.standard_normal((TOY_V, d)).astype(np.float32),
        h=rng.standard_normal((d,)).astype(np.float32),
        tok=rng.integers(0, TOY_V, (TOY_M, TOY_MB, 3)).astype(np.int32),
        msk=(rng.random((TOY_M, TOY_MB, 3)) < 0.7).astype(np.float32))


def _toy_fns(xp):
    """The toy stage, embedding and loss over `xp` (jax.numpy or torch)."""

    def stage(w, x):
        return xp.tanh(x @ w[0])

    def emb(ep, tok, pos):
        return ep["e"][tok] + 0.1 * pos[:, None]

    def loss(lp, y, tok, msk):
        v = (y @ lp["h"] - 0.1 * tok) ** 2 * msk
        return v.sum(), xp.stack([v.sum(), msk.sum()])

    return stage, emb, loss


# ---------------------------------------------------------------------------
# The worker: one rank of the gang (``python tests/test_torch_pipeline.py``)
# ---------------------------------------------------------------------------
def worker(rank: int, store: str, out: str) -> None:
    import datetime

    import torch
    import torch.distributed as tdist

    from determined_tpu_torch import core
    from determined_tpu_torch.core._distributed import DistributedContext
    from determined_tpu_torch.data.tokens import lm_dataset
    from determined_tpu_torch.models import gpt
    from determined_tpu_torch.parallel import MeshConfig, make_mesh
    from determined_tpu_torch.parallel import pipeline as pp
    from determined_tpu_torch.trainer import Batch, TorchTrial, Trainer, optim
    from determined_tpu_torch.trainer import _checkpoint as ckpt_io

    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=JOIN_S))
    dctx = DistributedContext(rank=rank, size=WORLD)
    res, arrays = {}, {}

    # -- the schedules on a toy stage, at S 4 and at S 2 (× data 2) ----------
    stage, emb, loss = _toy_fns(torch)
    for s in (4, 2):
        mesh = make_mesh(MeshConfig(data=WORLD // s, pipeline=s),
                         device="cpu")
        d = int(mesh.get_coordinate()[0])
        toy = {k: torch.from_numpy(v) for k, v in _toy_inputs(s).items()}
        x = toy["x"].clone().requires_grad_()
        w = toy["w"][d:d + 1][None].clone().requires_grad_()   # [1, 1, D, D]
        y = pp.pipeline_apply(lambda p, a: stage(p[0], a), w, x, group=mesh)
        gw, gx = torch.autograd.grad((y * toy["r"]).sum(), (w, x))
        arrays[f"toy{s}/gpipe"] = y.detach().numpy()
        arrays[f"toy{s}/gpipe_dw"] = gw[0, 0].numpy()
        arrays[f"toy{s}/gpipe_dx"] = gx.numpy()
        stacked = pp.stack_circular_stages(toy["w"][:, None], s)  # [S, V, 1, D, D]
        wc = stacked[d].clone().requires_grad_()
        x = toy["x"].clone().requires_grad_()
        y = pp.circular_pipeline_apply(stage, wc, x, group=mesh)
        gw, gx = torch.autograd.grad((y * toy["r"]).sum(), (wc, x))
        arrays[f"toy{s}/circular"] = y.detach().numpy()
        arrays[f"toy{s}/circular_dw"] = gw[:, 0].numpy()
        arrays[f"toy{s}/circular_dx"] = gx.numpy()
        msums, s_g, e_g, l_g = pp.one_f_one_b_grads(
            stage, toy["w"][d:d + 1], emb, {"e": toy["e"]}, loss,
            {"h": toy["h"]}, toy["tok"], toy["msk"],
            positions=torch.arange(3.0), group=mesh)
        arrays[f"toy{s}/1f1b_msums"] = msums.numpy()
        arrays[f"toy{s}/1f1b_dw"] = s_g[0].numpy()
        arrays[f"toy{s}/1f1b_de"] = e_g["e"].numpy()
        arrays[f"toy{s}/1f1b_dh"] = l_g["h"].numpy()
        res[f"toy{s}"] = dict(stage=d, high=pp.stats["stash_high_water"])

    # -- the GPT on each layout -------------------------------------------------
    trees = {"tied": ckpt_io.nest(dict(np.load(os.path.join(out,
                                                              "tied.npz")))),
             "untied": ckpt_io.nest(dict(np.load(os.path.join(
                 out, "untied.npz"))))}

    class Trial(TorchTrial):
        def __init__(self, fields=None, kind="tokens"):
            super().__init__()
            self.fields, self.kind = fields or {}, kind

        def build_model(self, device, mesh=None):
            cfg = dict(KW, **self.fields)
            cfg["pipeline_stages"] = (
                1 if mesh is None else
                int(mesh.shape[mesh.mesh_dim_names.index("pipeline")]))
            model = gpt.GPT(gpt.GPTConfig(dtype=torch.float32, **cfg),
                            device=device, mesh=mesh)
            tree = trees["untied" if self.kind == "untied" else "tied"]
            return gpt.load_jax_params(model, tree)

        def build_optimizer(self):
            return optim.chain(optim.clip_by_global_norm(CLIP),
                               optim.adamw(LR))

        def build_training_data(self):
            return _stream("zigzag" if self.kind == "zigzag" else "tokens",
                           lm_dataset)

    def fit(trainer, steps, **kw):
        seen, highs = [], []
        flush, step = trainer._flush, trainer._train_step

        def recording(pending, t_start):
            agg, reason = flush(pending, t_start)
            seen.append(agg)
            return agg, reason

        def stepping(batch, poison=1.0):
            pp.stats["stash_high_water"] = -1
            result = step(batch, poison)
            highs.append(pp.stats["stash_high_water"])
            return result

        trainer._flush, trainer._train_step = recording, stepping
        try:
            trainer.fit(max_length=Batch(steps), report_period=Batch(1), **kw)
        finally:
            trainer._flush, trainer._train_step = flush, step
        return seen, highs

    for name, (sizes, fields, kind) in LAYOUTS.items():
        mesh = make_mesh(MeshConfig(**{"data": 1, **sizes}), device="cpu")
        trainer = Trainer(Trial(fields, kind), core._dummy_init(
            distributed=dctx), device="cpu", mesh=mesh)
        layout, model = trainer._layout, trainer.model
        batch = trainer._put_batch(_loss_batch(kind, lm_dataset))
        with trainer._gathering():
            lo, metrics = model.loss(batch)
        weight = layout.loss_weight(metrics)
        grads = torch.autograd.grad(lo * weight, trainer._params,
                                    materialize_grads=True)
        grads = layout.reduce_grads(grads)
        got = layout.reduce_metrics(
            {k: v.detach() for k, v in metrics.items()}, weight)
        res[name] = dict(
            loss=float(got["loss"]), accuracy=float(got["accuracy"]),
            stage=model._stage, tensor_index=model._tensor_index,
            tensor_dims=model.tensor_dims())
        for n, g, b in zip(trainer._names, grads, layout.blocks):
            if b.dim is not None:
                g = layout._all_gather(g, b.dim, None)
            arrays[f"{name}/{n}"] = g.numpy().copy()
        seen, highs = fit(trainer, STEPS)
        res[name].update(reports=seen, highs=highs)

    # -- a sharded save at data=2 × pipeline=2, and the gang's losses on ------
    sizes, fields, kind = LAYOUTS[SAVE_LAYOUT]
    storage = os.path.join(out, "ckpt")
    trainer = Trainer(Trial(fields, kind), core._dummy_init(
        distributed=dctx, checkpoint_storage=storage), device="cpu",
        mesh=make_mesh(MeshConfig(**sizes), device="cpu"))
    seen, _ = fit(trainer, 4, checkpoint_period=Batch(SAVE_AT))
    ids = {}
    for uuid_ in os.listdir(storage):
        with open(os.path.join(storage, uuid_, "metadata.json")) as fh:
            ids[json.load(fh)["steps_completed"]] = uuid_
    res["save"] = dict(id=ids[SAVE_AT], losses=[m["loss"] for m in seen])

    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    dctx.close()
    tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# The reference's schedules on the toy stage (``... jax <dir>``)
# ---------------------------------------------------------------------------
def jax_worker(out: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from determined_tpu.common.jaxcompat import shard_map
    from determined_tpu.parallel import pipeline as jp

    jax.config.update("jax_platforms", "cpu")
    stage, emb, loss = _toy_fns(jnp)
    arrays = {}
    for s in (4, 2):
        toy = _toy_inputs(s)
        mesh = Mesh(np.array(jax.devices()[:s]), ("pipeline",))
        x, r = jnp.asarray(toy["x"]), jnp.asarray(toy["r"])
        w = jnp.asarray(toy["w"])

        def sequential(ws, x):
            for i in range(ws.shape[0]):
                x = jnp.tanh(x @ ws[i])
            return x

        gpipe = shard_map(
            lambda w_, x_: jp.pipeline_apply(stage, w_[0], x_), mesh=mesh,
            in_specs=(P("pipeline"), P()), out_specs=P(), check_vma=False)
        arrays[f"toy{s}/gpipe"] = np.asarray(jax.jit(gpipe)(w[:s, None], x))
        dw, dx = jax.grad(lambda a, b: (sequential(a, b) * r).sum(),
                          argnums=(0, 1))(w[:s], x)
        arrays[f"toy{s}/gpipe_dw"], arrays[f"toy{s}/gpipe_dx"] = dw, dx
        circ = shard_map(
            lambda w_, x_: jp.circular_pipeline_apply(stage, w_[0], x_),
            mesh=mesh, in_specs=(P("pipeline"), P()), out_specs=P(),
            check_vma=False)
        stacked = jp.stack_circular_stages(w[:, None], s)
        arrays[f"toy{s}/stacked"] = np.asarray(stacked)
        arrays[f"toy{s}/circular"] = np.asarray(jax.jit(circ)(stacked, x))
        dw, dx = jax.grad(lambda a, b: (sequential(a, b) * r).sum(),
                          argnums=(0, 1))(w, x)
        arrays[f"toy{s}/circular_dw"], arrays[f"toy{s}/circular_dx"] = dw, dx
        ofob = shard_map(
            lambda w_, tk, mk, ep, lp: jp.one_f_one_b_grads(
                stage, w_[0], emb, ep, loss, lp, tk, mk,
                positions=jnp.arange(3.0)),
            mesh=mesh, in_specs=(P("pipeline"), P(), P(), P(), P()),
            out_specs=(P(), P("pipeline"), P(), P()), check_vma=False)
        msums, s_g, e_g, l_g = jax.jit(ofob)(
            w[:s, None], jnp.asarray(toy["tok"]), jnp.asarray(toy["msk"]),
            {"e": jnp.asarray(toy["e"])}, {"h": jnp.asarray(toy["h"])})
        arrays[f"toy{s}/1f1b_msums"] = msums
        arrays[f"toy{s}/1f1b_dw"] = s_g[:, 0]
        arrays[f"toy{s}/1f1b_de"], arrays[f"toy{s}/1f1b_dh"] = (e_g["e"],
                                                                l_g["h"])
    np.savez(os.path.join(out, "jax.npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})


# ---------------------------------------------------------------------------
# The JAX GPT references, in the test process
# ---------------------------------------------------------------------------
def _jax_grads(tree, fields, batch):
    """The unpipelined reference's loss, accuracy and gradient on one
    device."""
    import jax
    import jax.numpy as jnp

    from determined_tpu.models import gpt as jgpt
    from determined_tpu_torch.models.base import _flatten
    from determined_tpu_torch.trainer._checkpoint import nest

    model = jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **KW, **fields))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss(p, batch, None), has_aux=True))(
            jax.tree.map(jnp.asarray, nest(tree)))
    return ({"loss": float(loss), "accuracy": float(metrics["accuracy"])},
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
            return jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **KW),
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
# The fixture: the gang and the toy references, and the JAX GPT meanwhile
# ---------------------------------------------------------------------------
def _spawn(tmp):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DTPU_", "JAX_", "XLA_"))}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", TMPDIR=str(tmp))
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    argvs = [([str(rank), str(tmp / "store"), str(tmp)], env)
             for rank in range(WORLD)] + [(["jax", str(tmp)], jenv)]
    procs = []
    for i, (argv, e) in enumerate(argvs):
        log = open(tmp / f"proc{i}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, *argv], cwd=ROOT, env=e, stdout=log,
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
        f"--- process {r} ---\n{(tmp / f'proc{r}.log').read_text()[-4000:]}"
        for r in range(len(procs)) if failed is None or r == failed)
    raise AssertionError(
        (f"process {failed} failed" if failed is not None
         else f"gang did not finish in {JOIN_S} s") + "\n" + logs)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    from determined_tpu.data import lm_dataset

    tmp = tmp_path_factory.mktemp("pipeline")
    trees = {"tied": _numpy_tree(KW),
             "untied": _numpy_tree(dict(KW, tie_embeddings=False))}
    for kind, tree in trees.items():
        np.savez(tmp / f"{kind}.npz", **tree)
    procs = _spawn(tmp)
    try:
        with ThreadPoolExecutor(4) as pool:
            grads = {
                "tied": pool.submit(_jax_grads, trees["tied"], {},
                                    _loss_batch()),
                "untied": pool.submit(_jax_grads, trees["untied"],
                                      dict(tie_embeddings=False),
                                      _loss_batch()),
                "zigzag": pool.submit(_jax_grads, trees["tied"], {},
                                      _unzig(_loss_batch("zigzag",
                                                         lm_dataset))),
            }
            fit = pool.submit(_jax_fit, trees["tied"])
            ref = {k: f.result() for k, f in grads.items()}
            ref["fit"] = fit.result()
    except BaseException:
        _kill(procs)
        raise
    _join(procs, tmp)
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as fh:
            ranks.append((json.load(fh), dict(np.load(tmp / f"rank{r}.npz"))))
    return {"ranks": ranks, "ref": ref, "tmp": tmp, "trees": trees,
            "jax": dict(np.load(tmp / "jax.npz"))}


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------
def _close(got, want, what):
    """Within 1e-5 of the reference's largest magnitude (at least 1)."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                               err_msg=what)


@pytest.mark.parametrize("s", [4, 2])
@pytest.mark.parametrize("schedule", ["gpipe", "circular"])
def test_forward_schedules_match_the_reference_on_a_toy_stage(gang, s,
                                                             schedule):
    want = gang["jax"]
    for r, (res, arrays) in enumerate(gang["ranks"]):
        d = res[f"toy{s}"]["stage"]
        np.testing.assert_allclose(arrays[f"toy{s}/{schedule}"],
                                   want[f"toy{s}/{schedule}"], rtol=0,
                                   atol=1e-6, err_msg=f"rank {r}")
        dw = want[f"toy{s}/{schedule}_dw"]
        dw = dw[d::s] if schedule == "circular" else dw[d]
        _close(arrays[f"toy{s}/{schedule}_dw"], dw, f"rank {r} dw")
        dx = want[f"toy{s}/{schedule}_dx"] if d == 0 else 0.0
        _close(arrays[f"toy{s}/{schedule}_dx"],
               np.broadcast_to(dx, arrays[f"toy{s}/{schedule}_dx"].shape),
               f"rank {r} dx")


@pytest.mark.parametrize("s", [4, 2])
def test_one_f_one_b_grads_match_the_reference_on_a_toy_stage(gang, s):
    from determined_tpu_torch.parallel.pipeline import one_f_one_b_stash_size

    want = gang["jax"]
    highs = {}
    for r, (res, arrays) in enumerate(gang["ranks"]):
        d = res[f"toy{s}"]["stage"]
        for key in ("msums", "de", "dh"):
            _close(arrays[f"toy{s}/1f1b_{key}"], want[f"toy{s}/1f1b_{key}"],
                   f"rank {r} {key}")
        _close(arrays[f"toy{s}/1f1b_dw"], want[f"toy{s}/1f1b_dw"][d],
               f"rank {r} dw")
        highs[d] = res[f"toy{s}"]["high"]
    bound = one_f_one_b_stash_size(TOY_M, s)
    assert bound == min(TOY_M, 2 * s - 1)
    # stage d holds at most 2(S−1−d)+1 inputs, capped by M; stage 0 fills
    # the bound
    assert highs == {d: min(TOY_M, 2 * (s - 1 - d) + 1) for d in range(s)}
    assert highs[0] == bound


def test_stack_circular_stages_is_the_references_layout(gang):
    import torch

    from determined_tpu_torch.parallel import stack_circular_stages

    for s in (4, 2):
        w = _toy_inputs(s)["w"][:, None]
        got = stack_circular_stages({"w": torch.from_numpy(w)}, s)["w"]
        np.testing.assert_array_equal(got.numpy(), gang["jax"][f"toy{s}/stacked"])
    with pytest.raises(ValueError, match=r"global stages \(6\) must divide "
                                         r"by pipeline size \(4\)"):
        stack_circular_stages(torch.zeros(6, 2), 4)


def _slice(name, whole, index, tensor, dims):
    dim = dims.get(name)
    if dim is None or tensor == 1:
        return whole
    n = whole.shape[dim] // tensor
    return np.take(whole, np.arange(index * n, (index + 1) * n), axis=dim)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pipelined_gpt_matches_the_unpipelined_reference(gang, layout):
    sizes, fields, kind = LAYOUTS[layout]
    want, grads = gang["ref"]["zigzag" if kind == "zigzag" else
                              "untied" if kind == "untied" else "tied"]
    tensor = sizes.get("tensor", 1)
    stages = set()
    for r, (res, arrays) in enumerate(gang["ranks"]):
        got = res[layout]
        stages.add(got["stage"])
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4,
                                   err_msg=f"{layout} rank {r} loss")
        np.testing.assert_allclose(got["accuracy"], want["accuracy"],
                                   rtol=1e-5, err_msg=f"{layout} rank {r}")
        for name, g in grads.items():
            np.testing.assert_allclose(
                arrays[f"{layout}/{name}"],
                _slice(name, g, got["tensor_index"], tensor,
                       got["tensor_dims"]),
                rtol=5e-3, atol=1e-5, err_msg=f"{layout} rank {r} {name}")
    assert stages == set(range(sizes["pipeline"]))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pipelined_fit_trains_as_the_reference(gang, layout):
    from determined_tpu_torch.parallel.pipeline import one_f_one_b_stash_size

    sizes, fields, kind = LAYOUTS[layout]
    s = sizes["pipeline"]
    bound = one_f_one_b_stash_size(fields["num_microbatches"], s)
    for r, (res, _) in enumerate(gang["ranks"]):
        got = res[layout]
        reports = got["reports"]
        assert len(reports) == STEPS
        assert all(m["loss"] == reports_0["loss"] for m, reports_0 in zip(
            reports, gang["ranks"][0][0][layout]["reports"]))
        if kind == "tokens":
            _hold_reports(reports, gang["ref"]["fit"], f"{layout} rank {r}")
        else:
            assert all(np.isfinite(m["loss"]) for m in reports)
        if fields["pipeline_schedule"] == "1f1b":
            d = got["stage"]
            assert got["highs"] == [min(fields["num_microbatches"],
                                        2 * (s - 1 - d) + 1)] * STEPS
            assert max(got["highs"]) <= bound
        else:
            assert got["highs"] == [-1] * STEPS  # no 1F1B stash


def test_a_pipeline_save_restores_onto_one_rank(gang):
    import torch

    from determined_tpu_torch import core
    from determined_tpu_torch.models import gpt
    from determined_tpu_torch.trainer import Batch, TorchTrial, Trainer, optim
    from determined_tpu_torch.trainer import _checkpoint as ckpt_io

    tree = ckpt_io.nest(gang["trees"]["tied"])

    class Trial(TorchTrial):
        def build_model(self, device, mesh=None):
            return gpt.load_jax_params(gpt.GPT(gpt.GPTConfig(
                dtype=torch.float32, **KW), device=device), tree)

        def build_optimizer(self):
            return optim.chain(optim.clip_by_global_norm(CLIP),
                               optim.adamw(LR))

        def build_training_data(self):
            return _stream()

    saved = gang["ranks"][0][0]["save"]
    ctx = core._dummy_init(checkpoint_storage=str(gang["tmp"] / "ckpt"))
    one = Trainer(Trial(), ctx, device="cpu")
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
    np.testing.assert_allclose([m["loss"] for m in seen],
                               saved["losses"][SAVE_AT:], rtol=1e-5)


# ---------------------------------------------------------------------------
# The guards, each by the reference's words
# ---------------------------------------------------------------------------
def _fake_mesh(**sizes):
    from determined_tpu_torch.parallel.mesh import AXIS_NAMES

    return types.SimpleNamespace(
        mesh_dim_names=AXIS_NAMES, device_type="cpu",
        shape=tuple(sizes.get(a, 1) for a in AXIS_NAMES),
        get_coordinate=lambda: (0,) * 6, get_group=lambda axis: None)


def _piped(mesh=None, **fields):
    import torch

    from determined_tpu_torch.models import gpt

    cfg = dict(KW, pipeline_stages=2, num_microbatches=4)
    cfg.update(fields)
    if mesh is None:
        mesh = _fake_mesh(pipeline=cfg["pipeline_stages"])
    return gpt.GPT(gpt.GPTConfig(dtype=torch.float32, **cfg), device="cpu",
                   mesh=mesh)


def _batch(**extra):
    import torch

    b = {"tokens": torch.zeros(8, 32, dtype=torch.long)}
    b.update(extra)
    return b


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_segment_ids_are_refused_under_a_pipeline(schedule):
    import torch

    model = _piped(pipeline_schedule=schedule)
    with pytest.raises(ValueError, match=r"segment_ids \(packed sequences\) "
                                         "are not supported with pipeline "
                                         "parallelism yet"):
        model.loss(_batch(segment_ids=torch.ones(8, 32, dtype=torch.int32)))


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_positions_are_refused_on_a_context_unsharded_pipeline(schedule):
    import torch

    model = _piped(pipeline_schedule=schedule)
    with pytest.raises(ValueError, match="explicit positions with a "
                                         "context-unsharded pipeline would "
                                         "silently break the dense causal "
                                         "mask"):
        model.loss(_batch(positions=torch.arange(32)))


def test_zigzag_is_refused_without_a_context_axis():
    with pytest.raises(ValueError, match="sharded context axis"):
        _piped(sequence_layout="zigzag")


def test_one_f_one_b_under_context_needs_pre_shifted_batches():
    model = _piped(mesh=_fake_mesh(pipeline=2, context=2),
                   pipeline_schedule="1f1b")
    with pytest.raises(ValueError, match=r"1F1B with a sharded context axis "
                                         r"\(or zigzag layout\) needs "
                                         "pre-shifted batches"):
        model.loss(_batch())


@pytest.mark.parametrize("schedule", ["gpipe", "circular", "1f1b"])
def test_microbatches_must_divide_the_batch(schedule):
    model = _piped(pipeline_schedule=schedule, num_microbatches=3)
    with pytest.raises(ValueError, match="batch 8 not divisible by 3 "
                                         "microbatches"):
        model.loss(_batch())


def test_experts_are_refused_beside_a_pipeline():
    with pytest.raises(NotImplementedError,
                       match=r"MoE\+pipeline composition not supported yet"):
        _piped(n_experts=4)


@pytest.mark.parametrize("method,n_args", [("prefill_kv", 3),
                                           ("prefill_kv_cached", 6)])
def test_prefill_is_refused_with_pipeline_stages(method, n_args):
    import torch

    model = _piped()
    with pytest.raises(ValueError,
                       match=f"{method} does not support pipeline stages"):
        getattr(model, method)(*([torch.zeros(1, 4, dtype=torch.long)]
                                 * n_args))


@pytest.mark.parametrize("mesh,fields,match", [
    (None, {}, "pipeline parallelism needs a mesh"),
    ("p4", {}, r"mesh pipeline axis 4 != config pipeline_stages 2"),
    ("p2", {"n_layers": 3}, "n_layers 3 is not divisible by pipeline_stages 2"),
    ("p2", {"pipeline_schedule": "zigzag"}, "unknown pipeline_schedule"),
    ("p2", {"pipeline_schedule": "circular", "pipeline_virtual_stages": 4},
     r"n_layers 4 must divide stages×virtual \(2×4\)"),
])
def test_pipeline_layout_is_checked_by_the_references_words(mesh, fields,
                                                            match):
    import torch

    from determined_tpu_torch.models import gpt

    cfg = dict(KW, pipeline_stages=2, num_microbatches=4, **fields)
    mesh = {None: None, "p2": _fake_mesh(pipeline=2),
            "p4": _fake_mesh(pipeline=4)}[mesh]
    model = gpt.GPT(gpt.GPTConfig(dtype=torch.float32, **cfg), device="cpu",
                    mesh=mesh)
    with pytest.raises(ValueError, match=match):
        model.loss(_batch())


def test_circular_schedule_needs_as_many_microbatches_as_stages(
        monkeypatch):
    import torch
    import torch.distributed as dist

    from determined_tpu_torch.parallel import circular_pipeline_apply

    class TwoStages:
        """A mesh-like whose pipeline group has two ranks."""

        mesh_dim_names = ("pipeline",)

        def get_local_rank(self, axis):
            return 0

        def get_group(self, axis):
            return "pipeline-group"

    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    with pytest.raises(ValueError, match=r"circular schedule needs "
                                         r"microbatches \(1\) >= "
                                         r"pipeline stages \(2\)"):
        circular_pipeline_apply(lambda p, x: x, torch.zeros(2, 1),
                                torch.zeros(1, 3), group=TwoStages())


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        jax_worker(sys.argv[2])
    else:
        worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
