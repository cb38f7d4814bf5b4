"""Training over the context axis: a 4-process port gang on the CPU (gloo)
against the JAX ``Trainer`` on the same layout.

One gang, spawned once for the file by a module-scoped fixture (the
pattern of ``tests/test_torch_gang.py``, whose tiny GPT, optimizer chain
and tolerances this file reuses): each rank runs this file as a script
(``worker``), answers every case and writes what it saw to
``rank<r>.json`` / ``rank<r>.npz``. The JAX references run meanwhile in
four more processes (``jax_worker``, one a layout), on four of the
reference's virtual CPU devices each. Every join has a timeout.

- ``Trainer.fit`` for 3 steps on ``context=4`` (ring attention,
  contiguous), ``fsdp=2 × context=2`` (ring, zigzag: the zigzag loader's
  pre-shifted batches, ``sequence_layout="zigzag"``) and ``data=2 ×
  context=2`` (``attn_impl="ulysses"``): every loss within 1e-5 relative,
  every grad norm within 1e-4 relative, every parameter leaf but the key
  bias within 1e-4 of its own largest magnitude — bar the entries whose
  first gradient (the reference's) is within 10 ε of zero, where Adam's
  first step g / (|g| + ε) is set by rounding (under 0.5% of the
  entries, asserted).
- A packed batch on ``context=4`` whose documents start and end on the
  chunk edges (8, 16, 24), padding included: the Trainer pre-shifts it
  (``_mesh.preshift``) before the split, and the loss is the reference's
  global token mean within 1e-5 relative. ``preshift`` alone gives the
  in-model shift's loss on one device.
- A sharded checkpoint at ``fsdp=2 × context=2``: the reference's names,
  one merged manifest, replica 0 (context index 0) of each fsdp block;
  the reference's ``load_pytree`` reads every rank's blocks, and a fresh
  gang trainer resumes it bitwise with the uninterrupted run's next loss.
- The expert axis is still refused by name beside the context, tensor
  and pipeline axes.
"""
import glob
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_gang import (
    CLIP,
    KW,
    LR,
    STEPS,
    _hold_reports,
    _numpy_tree,
)

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
JOIN_S = 150
#: name → ((data, fsdp, context), GPTConfig fields, data stream)
LAYOUTS = {
    "context4": ((1, 1, 4), {}, "tokens"),
    "fsdp2-context2-zigzag": ((1, 2, 2), dict(sequence_layout="zigzag"),
                              "zigzag"),
    "data2-context2-ulysses": ((2, 1, 2), dict(attn_impl="ulysses"),
                               "tokens"),
    "packed-context4": ((1, 1, 4), {}, "packed"),
}
#: the packed batch's documents, row by row (S 32 over context 4: chunk
#: edges at 8, 16 and 24)
EDGE_DOCS = ([8, 8, 7], [5, 11, 16], [16, 16], [3, 5, 9, 7], [24],
             [8, 24], [12, 4, 8, 8], [31])


def _tokens():
    rng = np.random.default_rng(7)
    while True:
        yield {"tokens": rng.integers(0, 128, (8, 32)).astype(np.int32)}


def _edge_batch():
    seg = np.zeros((8, 32), np.int32)
    for r, lens in enumerate(EDGE_DOCS):
        bounds = np.cumsum([0] + lens)
        for i, (lo, hi) in enumerate(zip(bounds, bounds[1:]), 1):
            seg[r, lo:hi] = i
    tokens = np.random.default_rng(13).integers(1, 128, (8, 32)) * (seg != 0)
    return {"tokens": tokens.astype(np.int32), "segment_ids": seg,
            "loss_mask": (seg != 0).astype(np.float32)}


def _packed():
    batch = _edge_batch()
    while True:
        yield batch


def _stream(kind, lm_dataset=None):
    if kind == "zigzag":
        return lm_dataset(None, 8, 32, 128, seed=7, zigzag_ring=2)
    return {"tokens": _tokens, "packed": _packed}[kind]()


# ---------------------------------------------------------------------------
# The worker: one rank of the gang (``python tests/test_torch_context.py``)
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
    nested = ckpt_io.nest(dict(np.load(os.path.join(out, "params.npz"))))

    class Trial(TorchTrial):
        def __init__(self, fields, kind):
            super().__init__()
            self.fields, self.kind = fields, kind
            if kind == "packed":
                self.replicated_batch_keys = frozenset()

        def build_model(self, device, mesh=None):
            model = gpt.GPT(gpt.GPTConfig(dtype=torch.float32, **KW,
                                          **self.fields),
                            device=device, mesh=mesh)
            return gpt.load_jax_params(model, nested)

        def build_optimizer(self):
            return optim.chain(optim.clip_by_global_norm(CLIP),
                               optim.adamw(LR))

        def build_training_data(self):
            return _stream(self.kind, lm_dataset)

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

    def gathered(trainer):
        return {n: p.numpy().copy()
                for n, p in trainer.full_parameters().items()}

    for name, ((d, f, c), fields, kind) in LAYOUTS.items():
        mesh = make_mesh(MeshConfig(data=d, fsdp=f, context=c), device="cpu")
        trainer = Trainer(Trial(fields, kind), core._dummy_init(
            distributed=dctx), device="cpu", mesh=mesh)
        res[name] = fit(trainer, STEPS)
        local = trainer._put_batch(next(_stream(kind, lm_dataset)))
        res[f"{name}_local"] = {k: list(v.shape) for k, v in local.items()}
        if kind == "packed":
            res["packed_local_mask"] = local["loss_mask"].tolist()
        for n, a in gathered(trainer).items():
            arrays[f"{name}/{n}"] = a

    # -- the sharded checkpoint at fsdp=2 × context=2, and its resume ---------
    storage = os.path.join(out, "ckpt")
    mesh = make_mesh(MeshConfig(fsdp=2, context=2, data=1), device="cpu")
    trial = Trial({}, "tokens")
    ctx = core._dummy_init(distributed=dctx, checkpoint_storage=storage)
    trainer = Trainer(trial, ctx, device="cpu", mesh=mesh)
    saved = {}
    save = trainer._save_checkpoint

    def recording_save(**kw):
        if trainer._step == 2:
            view = trainer._state_view()
            saved["blocks"] = {
                ckpt_io._leaf_name(path): (leaf.local.numpy().copy(),
                                           list(leaf.starts), leaf.replica0,
                                           leaf.whole)
                for path, leaf in ckpt_io._flatten_with_path(view)
                if isinstance(leaf, ckpt_io.Shard)}
        return save(**kw)

    trainer._save_checkpoint = recording_save
    res["ckpt_run"] = fit(trainer, STEPS, checkpoint_period=Batch(2))
    ids = {}
    for uuid_ in os.listdir(storage):
        with open(os.path.join(storage, uuid_, "metadata.json")) as fh:
            ids[json.load(fh)["steps_completed"]] = uuid_
    res["ckpt_ids"] = ids
    res["block_starts"] = {}
    for leaf, (a, starts, replica0, whole) in saved["blocks"].items():
        arrays[f"block/{leaf}"] = a
        res["block_starts"][leaf] = [starts, replica0, whole]
    res["coordinate"] = [int(x) for x in mesh.get_coordinate()]
    resumed = Trainer(Trial({}, "tokens"), core._dummy_init(
        distributed=dctx, checkpoint_storage=storage), device="cpu",
        mesh=mesh)
    res["resumed"] = fit(resumed, 2, latest_checkpoint=ids[2])  # restores
    view = resumed._state_view()
    res["resume_bitwise"] = all(
        np.array_equal(leaf.local.numpy(),
                       saved["blocks"][ckpt_io._leaf_name(path)][0])
        for path, leaf in ckpt_io._flatten_with_path(view)
        if isinstance(leaf, ckpt_io.Shard))
    res["resumed"] += fit(resumed, STEPS)

    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    dctx.close()
    tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# The JAX references (``python tests/test_torch_context.py jax <dir> <names>``)
# ---------------------------------------------------------------------------
def jax_worker(out: str, names) -> None:
    import jax
    import jax.numpy as jnp
    import optax

    from determined_tpu import core as jcore
    from determined_tpu.data import lm_dataset
    from determined_tpu.models import gpt as jgpt
    from determined_tpu.parallel.mesh import MeshConfig, make_mesh
    from determined_tpu.trainer import Batch, JAXTrial, Trainer
    from determined_tpu_torch.models.base import _flatten
    from determined_tpu_torch.trainer._checkpoint import nest

    jax.config.update("jax_platforms", "cpu")
    tree = dict(np.load(os.path.join(out, "params.npz")))
    reports, arrays = {}, {}
    for name in names:
        (d, f, c), fields, kind = LAYOUTS[name]

        class JTrial(JAXTrial):
            def build_model(self, mesh):
                return jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **KW,
                                               **fields), mesh=mesh)

            def build_optimizer(self):
                return optax.chain(optax.clip_by_global_norm(CLIP),
                                   optax.adamw(LR))

            def build_training_data(self):
                return _stream(kind, lm_dataset)

        trial = JTrial()
        if kind == "packed":
            trial.replicated_batch_keys = frozenset()
        mesh = make_mesh(MeshConfig(data=d, fsdp=f, context=c),
                         devices=jax.devices()[:WORLD])
        ctx = jcore._context._dummy_init()
        trainer = Trainer(trial, ctx, mesh=mesh, seed=0)
        params = jax.tree.map(lambda x, s: jax.device_put(jnp.asarray(x), s),
                              nest(tree), trainer._param_shardings())
        trainer._state = {"step": jnp.zeros((), jnp.int32), "params": params,
                          "opt_state": trainer._tx.init(params)}
        arrays.update(_first_gradient(name, fields, tree))
        trainer.fit(max_length=Batch(STEPS), report_period=Batch(1))
        reports[name] = [{k: float(v) for k, v in m.items()}
                         for g, _, m in ctx.train._reported if g == "training"]
        for n, a in _flatten(jax.device_get(trainer.state["params"])):
            arrays[f"{name}/{n}"] = np.asarray(a)
    np.savez(os.path.join(out, f"jax-{names[0]}.npz"), **arrays)
    with open(os.path.join(out, f"jax-{names[0]}.json"), "w") as fh:
        json.dump(reports, fh)


def _first_gradient(name, fields, tree):
    """The reference's gradient of the first batch's loss at the initial
    parameters, on one device through its dense attention (a zigzag batch
    put back in order), as ``grad1/<name>/<leaf>``."""
    import jax
    import jax.numpy as jnp

    from determined_tpu.data import lm_dataset
    from determined_tpu.models import gpt as jgpt
    from determined_tpu_torch.models.base import _flatten
    from determined_tpu_torch.trainer._checkpoint import nest

    kind = LAYOUTS[name][2]
    batch = dict(next(_stream(kind, lm_dataset)))
    if kind == "zigzag":
        inv = np.argsort(batch.pop("positions"))
        batch = {k: v[:, inv] for k, v in batch.items()}
    model = jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, attn_impl="dense",
                                    **KW))
    grads = jax.jit(jax.grad(lambda p: model.loss(p, batch, None)[0]))(
        jax.tree.map(jnp.asarray, nest(tree)))
    return {f"grad1/{name}/{n}": np.asarray(g)
            for n, g in _flatten(jax.device_get(grads))}


JAX_SHARES = tuple((name,) for name in LAYOUTS)


# ---------------------------------------------------------------------------
# The fixture
# ---------------------------------------------------------------------------
def _spawn(tmp):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DTPU_", "JAX_", "XLA_"))}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", TMPDIR=str(tmp))
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    argvs = [([str(rank), str(tmp / "store"), str(tmp)], env)
             for rank in range(WORLD)]
    argvs += [(["jax", str(tmp), *names], jenv) for names in JAX_SHARES]
    procs = []
    for i, (argv, e) in enumerate(argvs):
        log = open(tmp / f"proc{i}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, *argv], cwd=ROOT, env=e, stdout=log,
            stderr=subprocess.STDOUT), log))
    return procs


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
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=10)
            log.close()
    logs = "\n".join(
        f"--- process {r} ---\n{(tmp / f'proc{r}.log').read_text()[-4000:]}"
        for r in range(len(procs)) if failed is None or r == failed)
    raise AssertionError(
        (f"process {failed} failed" if failed is not None
         else f"the processes did not finish in {JOIN_S} s") + "\n" + logs)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("context")
    tree = _numpy_tree()
    np.savez(tmp / "params.npz", **tree)
    _join(_spawn(tmp), tmp)
    ref = {}
    for names in JAX_SHARES:
        with open(tmp / f"jax-{names[0]}.json") as fh:
            reports = json.load(fh)
        arrays = np.load(tmp / f"jax-{names[0]}.npz")
        for name in names:
            ref[name] = (reports[name], {
                k.split("/", 1)[1]: a for k, a in arrays.items()
                if k.startswith(name + "/")}, {
                k.split("/", 2)[2]: a for k, a in arrays.items()
                if k.startswith(f"grad1/{name}/")})
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as fh:
            ranks.append((json.load(fh), dict(np.load(tmp / f"rank{r}.npz"))))
    return {"ranks": ranks, "ref": ref, "tmp": tmp, "tree": tree}


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_context_fit_matches_the_jax_trainer_on_its_mesh(gang, layout):
    want_reports, want_params, grad1 = gang["ref"][layout]
    (d, f, c), _, _ = LAYOUTS[layout]
    # Adam's first step is g / (|g| + ε), ε = 1e-8: an entry whose first
    # gradient is within 10 ε of zero moves by a share of the learning
    # rate that the two packages' rounding of g sets (one wo_mlp entry
    # with g = 1e-8 ended 1.3e-5 apart). Such entries are not compared,
    # as the key bias is not; they are under 0.5% of the entries.
    dead = {name: np.abs(g) < 1e-7 for name, g in grad1.items()}
    share = (sum(int(m.sum()) for m in dead.values())
             / sum(m.size for m in dead.values()))
    assert share < 0.005, share
    for r, (res, arrays) in enumerate(gang["ranks"]):
        _hold_reports(res[layout], want_reports, f"{layout} rank {r}")
        # this rank's block of the batch: rows over data × fsdp, the
        # sequence over context
        assert res[f"{layout}_local"]["tokens"] == [8 // (d * f), 32 // c]
        for name, want in want_params.items():
            got = np.where(dead[name], want, arrays[f"{layout}/{name}"])
            scale = float(np.abs(want).max())
            if name == "blocks.bqkv":  # the key bias: test_torch_gang.py
                got, want = np.delete(got, 1, axis=1), np.delete(want, 1, axis=1)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale,
                                       err_msg=f"{layout} rank {r} {name}")


def test_packed_documents_across_chunk_edges(gang):
    """The packed batch's boundaries sit on the chunk edges: each rank's
    loss mask is its slice of the pre-shifted global mask, whose last
    column and every cross-document target are masked."""
    from determined_tpu_torch.trainer._mesh import preshift

    mask = preshift(_edge_batch())["loss_mask"]
    assert mask[:, -1].sum() == 0
    assert mask[0, 7] == 0 and mask[0, 15] == 0 and mask[0, 22] == 0
    assert mask[1, 15] == 0 and mask[6, 23] == 0 and mask[0, 6] == 1
    for r, (res, _) in enumerate(gang["ranks"]):
        np.testing.assert_array_equal(res["packed_local_mask"],
                                      mask[:, 8 * r:8 * (r + 1)])


def test_preshift_gives_the_in_model_shift():
    """On one device the pre-shifted batch trains the in-model shift's
    function: the same loss, accuracy and token count."""
    import torch

    from determined_tpu_torch.models import gpt
    from determined_tpu_torch.trainer._mesh import preshift

    model = gpt.GPT(gpt.GPTConfig(dtype=torch.float32, **KW), device="cpu")
    for batch in (_edge_batch(), next(_tokens())):
        a = model.loss({k: torch.from_numpy(v) for k, v in batch.items()})[1]
        b = model.loss({k: torch.from_numpy(v)
                        for k, v in preshift(batch).items()})[1]
        for key in ("loss", "accuracy", "tokens"):
            np.testing.assert_allclose(float(b[key].detach()),
                                       float(a[key].detach()), rtol=1e-6,
                                       err_msg=key)


def test_sharded_checkpoint_at_fsdp2_context2_loads_in_the_reference(gang):
    res0 = gang["ranks"][0][0]
    path = gang["tmp"] / "ckpt" / res0["ckpt_ids"]["2"]
    files = sorted(os.path.basename(f) for f in glob.glob(str(path / "*")))
    assert files.count("manifest.json") == 1 and "tree.json" in files
    assert [f for f in files if f.startswith("params__blocks__wqkv")] == [
        "params__blocks__wqkv.shard0_0_0_0_0.npy",
        "params__blocks__wqkv.shard0_32_0_0_0.npy"]
    assert "params__blocks__bi.npy" in files and "step.npy" in files
    # a split leaf's replica 0 is context index 0 of its fsdp block; a
    # whole leaf's is the chief's copy
    for r, (res, _) in enumerate(gang["ranks"]):
        _, _, fsdp, _, ctx, _ = res["coordinate"]
        for leaf, (_, replica0, whole) in res["block_starts"].items():
            assert replica0 == (ctx == 0 and (fsdp == 0 or not whole)), (
                r, leaf)
    loaded = _load_in_reference(path, gang["tree"])
    assert int(loaded["step"]) == 2
    for r, (res, arrays) in enumerate(gang["ranks"]):
        for leaf, (starts, _, _) in res["block_starts"].items():
            block = arrays[f"block/{leaf}"]
            region = tuple(slice(s, s + n) for s, n in zip(starts,
                                                           block.shape))
            np.testing.assert_array_equal(loaded[leaf][region], block,
                                          err_msg=f"rank {r} {leaf}")


def _load_in_reference(path, tree):
    """The checkpoint through the reference's ``load_pytree``, into the
    structure of the JAX trainer's state (params and AdamW state of the
    tiny GPT under the gang's chain), flattened to leaf names."""
    import jax
    import jax.numpy as jnp
    import optax

    from determined_tpu.trainer import _checkpoint as jckpt
    from determined_tpu_torch.trainer._checkpoint import nest

    params = jax.tree.map(jnp.asarray, nest(tree))
    tx = optax.chain(optax.clip_by_global_norm(CLIP), optax.adamw(LR))
    like = jax.eval_shape(lambda p: {
        "step": jnp.zeros((), jnp.int32), "params": p,
        "opt_state": tx.init(p)}, params)
    loaded = jckpt.load_pytree(str(path), like)
    return {jckpt._leaf_name(p): np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(loaded)[0]}


def test_gang_resumes_its_context_checkpoint_bitwise(gang):
    for r, (res, _) in enumerate(gang["ranks"]):
        assert res["resume_bitwise"], r
        assert [m["loss"] for m in res["resumed"]] == [
            m["loss"] for m in res["ckpt_run"]][2:], r


@pytest.mark.parametrize("axis,beside", [
    ("expert", "tensor"), ("expert", "context"), ("expert", "pipeline"),
])
def test_other_axes_are_still_refused_by_name(axis, beside):
    """The expert axis beside a pipeline axis is left out, as the
    reference leaves it out; beside a tensor or context axis it trains
    (tests/test_torch_experts_split.py), and so do pipeline stages beside
    the context axis (tests/test_torch_pipeline.py)."""
    from determined_tpu_torch.parallel import MeshConfig
    from determined_tpu_torch.parallel.mesh import refuse_later_axes

    if beside == "pipeline":
        with pytest.raises(NotImplementedError,
                           match=f"{axis}=2 and {beside}=2.*item 4"):
            refuse_later_axes(MeshConfig(**{axis: 2, beside: 2}))
    else:
        refuse_later_axes(MeshConfig(**{axis: 2, beside: 2}))
    refuse_later_axes(MeshConfig(**{beside: 2}))
    refuse_later_axes(MeshConfig(pipeline=2, context=2))


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        jax_worker(sys.argv[2], sys.argv[3:])
    else:
        worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
