"""Training over the tensor axis: a 4-process port gang on the CPU (gloo)
against the JAX package.

One gang, spawned once for the file by a module-scoped fixture (the
pattern of ``tests/test_torch_gang.py``, whose optimizer chain, report
tolerances and key-bias exception this file reuses): each rank runs this
file as a script (``worker``), answers every case and writes what it saw
to ``rank<r>.json`` / ``rank<r>.npz``. The JAX references run in the test
process meanwhile, on four of the reference's virtual CPU devices. Every
join has a timeout. The GPT is ``gpt.tiny()``-sized (2 layers, d 64, 4
heads, d_ff 256, vocab 256, S 32) in fp32, from one numpy parameter tree.

- The vocab-parallel embedding and cross-entropy (``parallel/tensor.py``)
  at ``tensor=2`` and ``tensor=4``, every rank on the whole batch,
  against the JAX ``GPT.loss`` on one device: loss, ``z_loss`` and
  accuracy within 1e-5 relative, every rank's gradient slice within 1e-4
  of its leaf's largest magnitude. The global argmax takes ties to the
  lowest index across the ranks' slices, as ``jnp.argmax``.
- ``Trainer.fit`` for 3 steps on ``data=2 × tensor=2``, ``fsdp=2 ×
  tensor=2`` and ``context=2 × tensor=2`` (ring, contiguous) against the
  JAX ``Trainer`` on the same layout: every loss within 1e-5 relative,
  every grad norm within 1e-4 relative, every rank's slice of every leaf
  but the key bias within 1e-4 of the leaf's largest magnitude.
- Ulysses over ``context=2 × tensor=2`` (``make_ulysses_attention``, the
  heads split over tensor, then over context by the all-to-all): output
  and input gradients against the reference's on that mesh, to
  ``tests/test_torch_ring.py``'s tolerances.
- A sharded checkpoint at ``fsdp=2 × tensor=2`` with the audit every
  step: the reference's file names with the tensor offsets in the starts,
  replica 0 of each block only, one manifest; the reference's
  ``load_pytree`` reads every rank's blocks, and a fresh gang trainer
  resumes it bitwise with the uninterrupted run's next loss.
- The tensor axis's limits, refused by name: heads, d_ff or vocab not
  divisible by it, Ulysses' heads per rank not divisible by the context
  axis, the serving methods on a tensor mesh; the expert axis beside it
  still refused. The GPT-2 trial's microbatch scales by data × fsdp,
  not by tensor.
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
KW = dict(vocab_size=256, n_layers=2, n_heads=4, d_model=64, d_ff=256,
          seq_len=32, remat=False)
#: name → (data, fsdp, context, tensor)
LAYOUTS = {"data2-tensor2": (2, 1, 1, 2), "fsdp2-tensor2": (1, 2, 1, 2),
           "context2-tensor2": (1, 1, 2, 2)}
#: the Ulysses case: B, S, H, D, causal (H / (tensor · context) = 2)
ULYSSES = (2, 32, 8, 16, True)


def _stream(seed=7):
    rng = np.random.default_rng(seed)
    while True:
        yield {"tokens": rng.integers(0, 256, (8, 32)).astype(np.int32)}


def _loss_batch():
    rng = np.random.default_rng(5)
    mask = (rng.random((8, 32)) < 0.8).astype(np.float32)
    return {"tokens": rng.integers(0, 256, (8, 32)).astype(np.int32),
            "loss_mask": mask}


def _ulysses_inputs():
    b, s, h, d, _ = ULYSSES
    rng = np.random.default_rng(9)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(4)]


def _tie_logits():
    """Logits [2, 3, 256] whose global maximum sits at two indices in
    different ranks' slices at tensor=4 (64 columns each), and the index
    ``jnp.argmax`` picks: the lower."""
    logits = np.random.default_rng(4).standard_normal((2, 3, 256))
    pairs = [(10, 200), (70, 130), (5, 6), (64, 255), (191, 192), (0, 128)]
    for (i, j), (lo, hi) in zip(np.ndindex(2, 3), pairs):
        logits[i, j, lo] = logits[i, j, hi] = 9.0
    return logits.astype(np.float32), np.asarray(pairs)[:, 0].reshape(2, 3)


# ---------------------------------------------------------------------------
# The worker: one rank of the gang (``python tests/test_torch_tensor.py``)
# ---------------------------------------------------------------------------
def worker(rank: int, store: str, out: str) -> None:
    import datetime

    import torch
    import torch.distributed as tdist

    from determined_tpu_torch import core
    from determined_tpu_torch.core._distributed import DistributedContext
    from determined_tpu_torch.models import gpt
    from determined_tpu_torch.parallel import MeshConfig, make_mesh
    from determined_tpu_torch.parallel.tensor import vocab_parallel_token_sums
    from determined_tpu_torch.parallel.ulysses import make_ulysses_attention
    from determined_tpu_torch.trainer import Batch, TorchTrial, Trainer, optim
    from determined_tpu_torch.trainer import _checkpoint as ckpt_io

    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=JOIN_S))
    dctx = DistributedContext(rank=rank, size=WORLD)
    res, arrays = {}, {}
    nested = ckpt_io.nest(dict(np.load(os.path.join(out, "params.npz"))))
    config = gpt.GPTConfig(dtype=torch.float32, **KW)

    def model_on(mesh):
        return gpt.load_jax_params(gpt.GPT(config, device="cpu", mesh=mesh),
                                   nested)

    # -- the vocab-parallel loss at tensor=2 and tensor=4 ---------------------
    batch = {k: torch.from_numpy(v) for k, v in _loss_batch().items()}
    tokens, mask = batch["tokens"].long(), batch["loss_mask"]
    for t in (2, 4):
        model = model_on(make_mesh(MeshConfig(data=WORLD // t, tensor=t),
                                   device="cpu"))
        loss, metrics = model.loss(batch)
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()))
        with torch.no_grad():
            logits = model.forward(tokens).float()
            nll, z, acc, n = vocab_parallel_token_sums(
                logits[:, :-1], tokens[:, 1:], mask[:, 1:],
                model._vocab_start, KW["vocab_size"], model._tgroup)
        res[f"ce-t{t}"] = dict(
            loss=float(loss.detach()), accuracy=float(metrics["accuracy"]),
            tokens=float(metrics["tokens"]), nll=float(nll / n),
            z_loss=float(z / n), acc_direct=float(acc / n),
            tensor_index=model._tensor_index, tensor_dims=model.tensor_dims(),
            shapes={n_: list(p.shape) for n_, p in model.named_parameters()})
        for name, g in zip(names, grads):
            arrays[f"ce-t{t}/{name}"] = g.numpy().copy()
        if t == 4:
            full, lowest = _tie_logits()
            lo = model._vocab_start
            local = torch.from_numpy(full[..., lo:lo + 64])
            ones = torch.ones(2, 3)
            res["ties"] = [float(vocab_parallel_token_sums(
                local, torch.from_numpy(target), ones, lo, 256,
                model._tgroup)[2]) for target in (lowest, lowest + 1)]

    # -- Trainer.fit on three layouts ----------------------------------------
    class Trial(TorchTrial):
        def __init__(self, fields=None):
            super().__init__()
            self.fields = fields or {}

        def build_model(self, device, mesh=None):
            model = gpt.GPT(gpt.GPTConfig(dtype=torch.float32, **KW,
                                          **self.fields),
                            device=device, mesh=mesh)
            return gpt.load_jax_params(model, nested)

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

    for name, (d, f, c, t) in LAYOUTS.items():
        mesh = make_mesh(MeshConfig(data=d, fsdp=f, context=c, tensor=t),
                         device="cpu")
        trainer = Trainer(Trial(), core._dummy_init(distributed=dctx),
                          device="cpu", mesh=mesh)
        res[name] = fit(trainer, STEPS)
        res[f"{name}_tensor_index"] = trainer.model._tensor_index
        for n, p in trainer.full_parameters().items():
            arrays[f"{name}/{n}"] = p.numpy().copy()

    # -- Ulysses over context=2 × tensor=2 ------------------------------------
    mesh = make_mesh(MeshConfig(data=1, context=2, tensor=2), device="cpu")
    q, k, v, cot = (torch.from_numpy(x) for x in _ulysses_inputs())
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    o = make_ulysses_attention(mesh, causal=ULYSSES[-1])(q, k, v)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), cot)
    for key, a in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
        arrays[f"ulysses/{key}"] = a.detach().numpy().copy()

    # -- the sharded checkpoint at fsdp=2 × tensor=2, and its resume -----------
    storage = os.path.join(out, "ckpt")
    mesh = make_mesh(MeshConfig(data=1, fsdp=2, tensor=2), device="cpu")
    ctx = core._dummy_init(distributed=dctx, checkpoint_storage=storage)
    trainer = Trainer(Trial(), ctx, device="cpu", mesh=mesh,
                      health={"divergence_check_period": 1})
    saved = {}
    save = trainer._save_checkpoint

    def recording_save(**kw):
        if trainer._step == 2:
            view = trainer._state_view()
            saved["blocks"] = {
                ckpt_io._leaf_name(path): (leaf.local.numpy().copy(),
                                           list(leaf.starts), leaf.replica0)
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
    for leaf, (a, starts, replica0) in saved["blocks"].items():
        arrays[f"block/{leaf}"] = a
        res["block_starts"][leaf] = [starts, replica0]
    res["coordinate"] = [int(x) for x in mesh.get_coordinate()]
    resumed = Trainer(Trial(), core._dummy_init(
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
# The JAX references, in the test process
# ---------------------------------------------------------------------------
def _jax_loss(tree):
    """The reference's loss, z_loss, accuracy and gradient on one device."""
    import jax
    import jax.numpy as jnp

    from determined_tpu.models import gpt as jgpt
    from determined_tpu_torch.models.base import _flatten
    from determined_tpu_torch.trainer._checkpoint import nest

    model = jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **KW))
    batch = {k: jnp.asarray(v) for k, v in _loss_batch().items()}

    @jax.jit
    def run(params):
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: model.loss(p, batch, None), has_aux=True)(params)
        logits = model.apply(params, batch["tokens"]).astype(jnp.float32)
        nll, z, _, n = model._next_token_sums(logits, batch["tokens"],
                                              batch["loss_mask"])
        return loss, metrics, nll / n, z / n, grads

    loss, metrics, nll, z, grads = run(jax.tree.map(jnp.asarray, nest(tree)))
    return ({"loss": float(loss), "accuracy": float(metrics["accuracy"]),
             "tokens": float(metrics["tokens"]), "nll": float(nll),
             "z_loss": float(z)},
            {n: np.asarray(g) for n, g in _flatten(jax.device_get(grads))})


def _jax_fit(layout, tree):
    import jax
    import jax.numpy as jnp
    import optax

    from determined_tpu import core as jcore
    from determined_tpu.models import gpt as jgpt
    from determined_tpu.parallel.mesh import MeshConfig, make_mesh
    from determined_tpu.trainer import Batch, JAXTrial, Trainer
    from determined_tpu_torch.models.base import _flatten
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

    d, f, c, t = LAYOUTS[layout]
    mesh = make_mesh(MeshConfig(data=d, fsdp=f, context=c, tensor=t),
                     devices=jax.devices()[:WORLD])
    ctx = jcore._context._dummy_init()
    trainer = Trainer(JTrial(), ctx, mesh=mesh, seed=0)
    params = jax.tree.map(lambda x, s: jax.device_put(jnp.asarray(x), s),
                          nest(tree), trainer._param_shardings())
    trainer._state = {"step": jnp.zeros((), jnp.int32), "params": params,
                      "opt_state": trainer._tx.init(params)}
    trainer.fit(max_length=Batch(STEPS), report_period=Batch(1))
    reports = [m for g, _, m in ctx.train._reported if g == "training"]
    return reports, {n: np.asarray(a) for n, a in
                     _flatten(jax.device_get(trainer.state["params"]))}


def _jax_ulysses():
    import jax
    import jax.numpy as jnp

    from determined_tpu.parallel import MeshConfig, make_mesh
    from determined_tpu.parallel.ulysses import make_ulysses_attention

    mesh = make_mesh(MeshConfig(data=1, context=2, tensor=2),
                     jax.devices()[:WORLD])
    fn = make_ulysses_attention(mesh, causal=ULYSSES[-1])
    q, k, v, cot = (jnp.asarray(x) for x in _ulysses_inputs())

    @jax.jit
    def both(q, k, v, cot):
        o, vjp = jax.vjp(fn, q, k, v)
        return (o, *vjp(cot))

    return {key: np.asarray(a)
            for key, a in zip(("o", "dq", "dk", "dv"), both(q, k, v, cot))}


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
    tmp = tmp_path_factory.mktemp("tensor")
    tree = _numpy_tree(KW)
    np.savez(tmp / "params.npz", **tree)
    procs = _spawn(tmp)
    try:
        # the three JAX fits in threads: their XLA compiles overlap
        with ThreadPoolExecutor(5) as pool:
            fits = {name: pool.submit(_jax_fit, name, tree)
                    for name in LAYOUTS}
            loss = pool.submit(_jax_loss, tree)
            ulysses = pool.submit(_jax_ulysses)
            ref = {name: f.result() for name, f in fits.items()}
            ref["loss"], ref["ulysses"] = loss.result(), ulysses.result()
    except BaseException:
        _kill(procs)
        raise
    _join(procs, tmp)
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as fh:
            ranks.append((json.load(fh), dict(np.load(tmp / f"rank{r}.npz"))))
    return {"ranks": ranks, "ref": ref, "tmp": tmp, "tree": tree}


def _slice(name, whole, index, tensor):
    """Rank `index`'s slice of the whole leaf `name` on a tensor axis of
    `tensor` ranks: along the dimension that the reference's rules map to
    ``tensor``."""
    import jax.numpy as jnp

    from determined_tpu.models import gpt as jgpt
    from determined_tpu.parallel.sharding import DEFAULT_RULES

    axes = jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **KW)).logical_axes()
    for key in name.split("."):
        axes = axes[key]
    dims = [d for d, a in enumerate(axes) if DEFAULT_RULES.lookup(a) == "tensor"]
    if not dims:
        return whole
    dim, = dims
    n = whole.shape[dim] // tensor
    return np.take(whole, np.arange(index * n, (index + 1) * n), axis=dim)


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tensor", [2, 4])
def test_vocab_parallel_loss_matches_the_reference(gang, tensor):
    want, grads = gang["ref"]["loss"]
    for r, (res, arrays) in enumerate(gang["ranks"]):
        got = res[f"ce-t{tensor}"]
        assert got["tensor_index"] == r % tensor
        assert got["shapes"]["tok_embed"] == [256 // tensor, 64]
        assert got["shapes"]["blocks.wqkv"] == [2, 64, 3, 4 // tensor, 16]
        assert got["shapes"]["blocks.wo_mlp"] == [2, 256 // tensor, 64]
        assert got["shapes"]["pos_embed"] == [32, 64]
        assert got["acc_direct"] == got["accuracy"]
        for key in ("loss", "nll", "z_loss", "accuracy", "tokens"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       err_msg=f"t{tensor} rank {r} {key}")
        for name, g in grads.items():
            scale = float(np.abs(g).max())
            np.testing.assert_allclose(
                arrays[f"ce-t{tensor}/{name}"],
                _slice(name, g, got["tensor_index"], tensor), rtol=0,
                atol=1e-4 * scale, err_msg=f"t{tensor} rank {r} {name}")


def test_vocab_parallel_argmax_takes_ties_to_the_lowest_index(gang):
    """A maximum shared by two ranks' slices (and by two columns of one)
    counts as the lower index, as ``jnp.argmax``: all 6 positions right
    against the lower index, none against the higher."""
    import jax.numpy as jnp

    logits, lowest = _tie_logits()
    np.testing.assert_array_equal(np.asarray(jnp.argmax(logits, -1)), lowest)
    for res, _ in gang["ranks"]:
        assert res["ties"] == [6.0, 0.0]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tensor_fit_matches_the_jax_trainer_on_its_mesh(gang, layout):
    want_reports, want_params = gang["ref"][layout]
    t = LAYOUTS[layout][3]
    for r, (res, arrays) in enumerate(gang["ranks"]):
        _hold_reports(res[layout], want_reports, f"{layout} rank {r}")
        index = res[f"{layout}_tensor_index"]
        assert index == r % t
        for name, whole in want_params.items():
            scale = float(np.abs(whole).max())
            want = _slice(name, whole, index, t)
            got = arrays[f"{layout}/{name}"]
            if name == "blocks.bqkv":  # the key bias: test_torch_gang.py
                got, want = np.delete(got, 1, axis=1), np.delete(want, 1, axis=1)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale,
                                       err_msg=f"{layout} rank {r} {name}")


def test_ulysses_over_tensor_and_context_matches_the_reference(gang):
    want = gang["ref"]["ulysses"]
    for r, (_, arrays) in enumerate(gang["ranks"]):
        for key, tol in (("o", 1e-5), ("dq", 1e-4), ("dk", 1e-4),
                         ("dv", 1e-4)):
            scale = float(np.abs(want[key]).max())
            np.testing.assert_allclose(
                arrays[f"ulysses/{key}"], want[key], rtol=0,
                atol=tol * scale, err_msg=f"rank {r} {key}")


def test_sharded_checkpoint_at_fsdp2_tensor2_loads_in_the_reference(gang):
    from tests.test_torch_context import _load_in_reference

    res0 = gang["ranks"][0][0]
    path = gang["tmp"] / "ckpt" / res0["ckpt_ids"]["2"]
    files = sorted(os.path.basename(f) for f in glob.glob(str(path / "*")))
    assert files.count("manifest.json") == 1 and "tree.json" in files
    # split two ways: one file per (fsdp, tensor) block, tensor offsets in
    # the starts
    assert [f for f in files if f.startswith("params__blocks__wqkv")] == [
        "params__blocks__wqkv.shard0_0_0_0_0.npy",
        "params__blocks__wqkv.shard0_0_0_2_0.npy",
        "params__blocks__wqkv.shard0_32_0_0_0.npy",
        "params__blocks__wqkv.shard0_32_0_2_0.npy"]
    assert [f for f in files if f.startswith("params__tok_embed")] == [
        "params__tok_embed.shard0_0.npy", "params__tok_embed.shard0_32.npy",
        "params__tok_embed.shard128_0.npy",
        "params__tok_embed.shard128_32.npy"]
    # split over tensor alone, and whole
    assert [f for f in files if f.startswith("params__blocks__bi")] == [
        "params__blocks__bi.shard0_0.npy", "params__blocks__bi.shard0_128.npy"]
    assert "params__blocks__bo.npy" in files and "step.npy" in files
    for r, (res, _) in enumerate(gang["ranks"]):
        _, _, fsdp, _, _, tensor = res["coordinate"]
        starts = res["block_starts"]
        assert starts["params__blocks__wqkv"] == [
            [0, 32 * fsdp, 0, 2 * tensor, 0], True], r
        # replica 0 of a block the tensor axis replicates: tensor index 0
        assert starts["params__pos_embed"] == [[0, 32 * fsdp], tensor == 0]
        assert starts["params__blocks__bi"] == [[0, 128 * tensor], fsdp == 0]
    loaded = _load_in_reference(path, gang["tree"])
    assert int(loaded["step"]) == 2
    for r, (res, arrays) in enumerate(gang["ranks"]):
        for leaf, (starts, _) in res["block_starts"].items():
            block = arrays[f"block/{leaf}"]
            region = tuple(slice(s, s + n) for s, n in zip(starts,
                                                           block.shape))
            np.testing.assert_array_equal(loaded[leaf][region], block,
                                          err_msg=f"rank {r} {leaf}")


def test_gang_resumes_its_tensor_checkpoint_bitwise(gang):
    for r, (res, _) in enumerate(gang["ranks"]):
        assert res["resume_bitwise"], r
        assert len(res["ckpt_run"]) == STEPS  # the audit found nothing
        assert [m["loss"] for m in res["resumed"]] == [
            m["loss"] for m in res["ckpt_run"]][2:], r


def _fake_mesh(**sizes):
    """A mesh-like with a DeviceMesh's names, shape and accessors, for
    what is refused before any collective."""
    from determined_tpu_torch.parallel.mesh import AXIS_NAMES

    return types.SimpleNamespace(
        mesh_dim_names=AXIS_NAMES, device_type="cpu",
        shape=tuple(sizes.get(a, 1) for a in AXIS_NAMES),
        get_coordinate=lambda: (0,) * 6, get_group=lambda axis: None)


@pytest.mark.parametrize("field,value", [
    ("n_heads", 6), ("d_ff", 250), ("vocab_size", 255),
])
def test_tensor_must_divide_heads_mlp_and_vocab(field, value):
    import torch

    from determined_tpu_torch.models import gpt

    fields = dict(KW, d_model=96 if field == "n_heads" else 64)
    fields[field] = value
    with pytest.raises(ValueError, match=f"{field}={value} is not "
                                         "divisible by the tensor axis"):
        gpt.GPT(gpt.GPTConfig(dtype=torch.float32, **fields), device="cpu",
                mesh=_fake_mesh(tensor=4))


def test_ulysses_needs_the_heads_per_rank_divisible_by_context():
    import torch

    from determined_tpu_torch.models.attention import attention

    x = torch.zeros(1, 8, 1, 16)  # 2 heads over tensor 2: one per rank
    with pytest.raises(ValueError, match=(
            r"heads \(2\) divisible by tensor \(2\) and heads/tensor \(1\) "
            r"divisible by the context axis \(2\)")):
        attention(x, x, x, mesh=_fake_mesh(context=2, tensor=2),
                  impl="ulysses")


@pytest.mark.parametrize("method,n_args", [
    ("apply", 1), ("prefill_kv", 3), ("prefill_kv_cached", 6),
    ("decode_kv", 6), ("decode_kv_spec", 7),
])
def test_serving_methods_are_refused_on_a_tensor_mesh(method, n_args):
    import torch

    from determined_tpu_torch.models import gpt

    model = gpt.GPT(gpt.GPTConfig(dtype=torch.float32, **KW), device="cpu",
                    mesh=_fake_mesh(tensor=2))
    assert model.blocks["wqkv"].shape == (2, 64, 3, 2, 16)
    with pytest.raises(NotImplementedError,
                       match=f"GPT.{method} on a mesh with tensor=2"):
        getattr(model, method)(*([torch.zeros(1, 4, dtype=torch.long)]
                                 * n_args))


def test_gpt2_trial_scales_its_microbatch_by_data_and_fsdp_not_tensor():
    from determined_tpu_torch.examples.gpt2_trial import GPT2PretrainTrial

    trial = GPT2PretrainTrial({"model_config": dict(KW), "microbatch": 3})
    model = trial.build_model("cpu", _fake_mesh(data=2, fsdp=2, tensor=2))
    assert model.tensor_dims()["blocks.wi"] == 2
    assert next(trial.build_training_data())["tokens"].shape == (12, 32)


@pytest.mark.parametrize("axis", ["pipeline", "expert"])
def test_pipeline_and_expert_are_still_refused_with_tensor(axis, monkeypatch):
    """Pipeline stages beside the tensor axis train
    (tests/test_torch_pipeline.py), and so does the expert axis
    (tests/test_torch_experts_split.py); the expert axis beside pipeline
    stages is left out, as the reference leaves it out."""
    import torch

    from determined_tpu_torch.models import gpt
    from determined_tpu_torch.parallel import MeshConfig
    from determined_tpu_torch.parallel.mesh import refuse_later_axes

    refuse_later_axes(MeshConfig(tensor=2, context=2, fsdp=2))
    refuse_later_axes(MeshConfig(tensor=2, pipeline=2))
    if axis == "expert":
        from determined_tpu_torch.parallel import experts

        refuse_later_axes(MeshConfig(tensor=2, expert=2))
        # the mesh-like has no process groups to make
        monkeypatch.setattr(experts, "_group", lambda mesh, axes: None)
        model = gpt.GPT(gpt.GPTConfig(dtype=torch.float32, **KW,
                                      n_experts=4), device="cpu",
                         mesh=_fake_mesh(tensor=2, expert=2))
        assert model.tensor_dims()["blocks.we_in"] == 3
        assert model.expert_dims()["blocks.we_in"] == 1
        return
    with pytest.raises(NotImplementedError,
                       match="expert=2 and (pipeline|tensor)=2.*item 4"):
        refuse_later_axes(MeshConfig(**{"tensor": 2, "expert": 2, axis: 2}))


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
