"""A 4-process port gang on the CPU (gloo) against the JAX package.

One gang, spawned once for the whole file by a module-scoped fixture:
four CPU processes over gloo, joined through a ``FileStore`` under the
test's temporary directory, one thread each. Each rank runs this file as
a script (``worker``), answers every case below in turn and writes what
it saw to ``rank<r>.json`` / ``rank<r>.npz``; the JAX references run in
the test process meanwhile. Every join has a timeout; a failing rank
makes the fixture kill its siblings and raise that rank's traceback.

- ``DistributedContext``'s gather, broadcast, allgather and barrier, on
  both channels.
- ``Trainer.fit`` on meshes of ``data=2 × fsdp=2``, ``fsdp=4`` and
  ``data=4`` against the JAX ``Trainer`` on the same layout over four of
  the reference's virtual CPU devices: a tiny GPT (2 layers, d 64) in
  fp32 from the same numpy parameters, the same global batches, 3 steps
  under ``chain(clip_by_global_norm(0.82), adamw(1e-3))`` (the clip
  engaged on some steps, not on others): every loss within 1e-5 relative,
  every grad norm within 1e-4 relative (the existing train parity's
  tolerances), every parameter leaf of every rank's gathered copy within
  1e-4 of its own largest magnitude — but the key bias (``bqkv[:, 1]``),
  whose true gradient is identically zero (softmax ignores a shift shared
  by all keys): each package moves it by Adam steps made of its own
  rounding noise, as the one-device port does (``test_torch_trainer.py``).
  At a learning rate of 1e-2 Adam's normalized steps carry the two
  packages' fp32 rounding differences past 1e-4 of the ``wqkv`` and
  ``wo`` leaves, for the one-device port as for this gang; at 1e-3 they
  stay below it.
- A packed batch whose ranks hold unequal token counts: the loss is the
  reference's global token mean within 1e-5 relative.
- A gang trainer given no mesh trains, as the reference's does, on the
  default ``MeshConfig()`` (data over the whole gang): the ``data=4`` run
  bit for bit.
- A sharded checkpoint at ``data=2 × fsdp=2``: the reference's file names
  (``{name}.shard<starts>.npy`` for split leaves, replica 0 only, one
  merged manifest), read by the reference's ``load_pytree`` into exactly
  every rank's blocks and the gathered parameters (``Trainer.
  full_parameters``: the blocks gathered over fsdp); a fresh gang trainer
  resumes it with a bitwise-equal state and the uninterrupted run's next
  loss. The audit runs every step of that run and finds nothing.
- The ``train.divergence.rank1`` drill: ``ReplicaDivergenceError`` naming
  rank 1 alone, on every rank.
- The ``train.nonfinite`` drill past ``max_consecutive_skips``: every
  rank skips, rolls back to the same checkpoint and goes on alike.
- The same checkpoint restored by a gang on another layout (``fsdp=4``):
  every rank reads its own blocks from the files of the old layout, the
  gathered state equals the saved one bitwise, and the next loss is the
  resumed run's.
"""
import glob
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
STEPS = 3
KW = dict(vocab_size=128, n_layers=2, n_heads=4, d_model=64, d_ff=128,
          seq_len=32, remat=False)
LAYOUTS = {"data2-fsdp2": (2, 2), "fsdp4": (1, 4), "data4": (4, 1)}
JOIN_S = 150
#: the global norm is 0.798 at step 1, then 0.843 and ~0.83: clipping
#: engages on the later steps only.
CLIP = 0.82
LR = 1e-3


def _stream(seed=7):
    rng = np.random.default_rng(seed)
    while True:
        yield {"tokens": rng.integers(0, 128, (8, 32)).astype(np.int32)}


def _packed_stream():
    """Packed documents of 3-20 tokens, rows filled to different lengths
    (so the ranks' token counts differ)."""
    from determined_tpu_torch.batch_inference import pack_sequences

    rng = np.random.default_rng(11)
    docs = (rng.integers(1, 128, int(n)).tolist()
            for n in rng.integers(3, 21, size=10_000))
    for batch in pack_sequences(docs, 32, 8):
        # empty the tails of some rows: unequal counts per rank
        cut = rng.integers(4, 32, size=8)
        cut[::3] = 32
        keep = np.arange(32)[None, :] < cut[:, None]
        batch["loss_mask"] = batch["loss_mask"] * keep
        yield batch


# ---------------------------------------------------------------------------
# The worker: one rank of the gang (``python tests/test_torch_gang.py``)
# ---------------------------------------------------------------------------
def worker(rank: int, store: str, out: str) -> None:
    import datetime

    import torch
    import torch.distributed as tdist

    from determined_tpu_torch import core
    from determined_tpu_torch.common import faults
    from determined_tpu_torch.core._distributed import DistributedContext
    from determined_tpu_torch.models import gpt
    from determined_tpu_torch.parallel import MeshConfig, make_mesh
    from determined_tpu_torch.trainer import Batch, TorchTrial, Trainer, optim
    from determined_tpu_torch.trainer import _checkpoint as ckpt_io
    from determined_tpu_torch.trainer import _sentinel

    torch.set_num_threads(1)
    tdist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=JOIN_S))
    dctx = DistributedContext(rank=rank, size=WORLD)
    res, arrays = {}, {}
    tree = dict(np.load(os.path.join(out, "params.npz")))
    nested = ckpt_io.nest(tree)

    # -- the control plane ---------------------------------------------------
    res["gather"] = dctx.gather({"rank": rank})
    res["broadcast"] = dctx.broadcast(f"from {rank}")
    res["allgather"] = dctx.allgather(rank * rank, channel="checkpoint")
    dctx.barrier()
    res["barrier"] = True

    class Trial(TorchTrial):
        def __init__(self, data=_stream, replicated=None):
            super().__init__()
            self.data = data
            if replicated is not None:
                self.replicated_batch_keys = replicated

        def build_model(self, device, mesh=None):
            model = gpt.GPT(gpt.GPTConfig(dtype=torch.float32, **KW),
                            device=device, mesh=mesh)
            return gpt.load_jax_params(model, nested)

        def build_optimizer(self):
            return optim.chain(optim.clip_by_global_norm(CLIP),
                               optim.adamw(LR))

        def build_training_data(self):
            return self.data()

    def fit(trainer, steps, **kw):
        """fit → the training metrics of every report window, as this
        rank computed them (only the chief reports them)."""
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

    # -- parity on three layouts, and the packed batch -----------------------
    cases = [(name, d, f, Trial()) for name, (d, f) in LAYOUTS.items()]
    cases.append(("packed", 2, 2, Trial(_packed_stream, frozenset())))
    for name, d, f, trial in cases:
        mesh = make_mesh(MeshConfig(data=d, fsdp=f), device="cpu")
        ctx = core._dummy_init(distributed=dctx)
        trainer = Trainer(trial, ctx, device="cpu", mesh=mesh)
        res[name] = fit(trainer, STEPS)
        res[f"{name}_local_tokens"] = float(
            trainer._put_batch(next(trial.data()))
            .get("loss_mask", torch.ones(2, 32))[:, 1:].sum())
        for n, a in gathered(trainer).items():
            arrays[f"{name}/{n}"] = a

    # -- no mesh: the default, data over the whole gang ------------------------
    trainer = Trainer(Trial(), core._dummy_init(distributed=dctx),
                      device="cpu")
    res["nomesh_axes"] = dict(zip(trainer.mesh.mesh_dim_names,
                                  map(int, trainer.mesh.shape)))
    res["nomesh"] = fit(trainer, STEPS)
    for n, a in gathered(trainer).items():
        arrays[f"nomesh/{n}"] = a

    # -- the sharded checkpoint, its resume, the audit -----------------------
    storage = os.path.join(out, "ckpt")
    mesh = make_mesh(MeshConfig(data=2, fsdp=2), device="cpu")
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
                                           list(leaf.starts))
                for path, leaf in ckpt_io._flatten_with_path(view)
                if isinstance(leaf, ckpt_io.Shard)}
            saved["gathered"] = gathered(trainer)
        return save(**kw)

    trainer._save_checkpoint = recording_save
    res["ckpt_run"] = fit(trainer, STEPS, checkpoint_period=Batch(2))
    ids = {}
    for uuid_ in os.listdir(storage):
        with open(os.path.join(storage, uuid_, "metadata.json")) as fh:
            ids[json.load(fh)["steps_completed"]] = uuid_
    res["ckpt_ids"] = ids
    for leaf, (a, starts) in saved["blocks"].items():
        arrays[f"block/{leaf}"] = a
        res.setdefault("block_starts", {})[leaf] = starts
    for n, a in saved["gathered"].items():
        arrays[f"step2/{n}"] = a
    ctx_b = core._dummy_init(distributed=dctx, checkpoint_storage=storage)
    resumed = Trainer(Trial(), ctx_b, device="cpu", mesh=mesh)
    res["resumed"] = fit(resumed, 2, latest_checkpoint=ids[2])
    view = resumed._state_view()
    res["resume_bitwise"] = all(
        np.array_equal(leaf.local.numpy(),
                       saved["blocks"][ckpt_io._leaf_name(path)][0])
        for path, leaf in ckpt_io._flatten_with_path(view)
        if isinstance(leaf, ckpt_io.Shard))
    res["resume_gathered_bitwise"] = all(
        np.array_equal(a, saved["gathered"][n])
        for n, a in gathered(resumed).items())
    res["resumed"] += fit(resumed, STEPS)
    other = make_mesh(MeshConfig(data=1, fsdp=4), device="cpu")
    reshard = Trainer(Trial(), core._dummy_init(
        distributed=dctx, checkpoint_storage=storage), device="cpu",
        mesh=other)
    reshard._restore_with_fallback(ids[2])
    res["reshard_gathered_bitwise"] = all(
        np.array_equal(a, saved["gathered"][n])
        for n, a in gathered(reshard).items())
    res["reshard"] = fit(reshard, STEPS)

    # -- the divergence drill -----------------------------------------------
    os.environ["DTPU_FAULT_PLAN"] = json.dumps(
        {"train.divergence.rank1": {"failures": 1}})
    faults.clear()
    try:
        ctx = core._dummy_init(distributed=dctx)
        trainer = Trainer(Trial(), ctx, device="cpu", mesh=mesh,
                          health={"divergence_check_period": 1})
        fit(trainer, 2)
        res["drill"] = None
    except _sentinel.ReplicaDivergenceError as e:
        res["drill"] = str(e)
        res["drill_step"] = trainer.steps_completed
    finally:
        del os.environ["DTPU_FAULT_PLAN"]
        faults.clear()

    # -- rollback-and-skip, agreed by the gang ---------------------------------
    ctx = core._dummy_init(distributed=dctx, checkpoint_storage=os.path.join(
        out, "ckpt-rollback"))
    trainer = Trainer(Trial(), ctx, device="cpu", mesh=mesh,
                      health={"max_consecutive_skips": 2})
    fit(trainer, 2, checkpoint_period=Batch(2))
    os.environ["DTPU_FAULT_PLAN"] = json.dumps(
        {"train.nonfinite": {"failures": 2}})
    faults.clear()
    try:
        res["rollback_run"] = fit(trainer, 5, checkpoint_period=Batch(2))
    finally:
        del os.environ["DTPU_FAULT_PLAN"]
        faults.clear()
    res["rollback"] = [trainer.rollbacks, trainer.steps_skipped,
                       trainer._data_offset, trainer.steps_completed]

    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    dctx.close()
    tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# The fixture: the gang, and the JAX references meanwhile
# ---------------------------------------------------------------------------
def _numpy_tree(kw=KW):
    """The GPT's parameters (GPTConfig fields `kw`) from a numpy seed:
    normal(0, 0.02) weights and biases, layernorm scales 1 + normal(0,
    0.02)."""
    import torch

    from determined_tpu_torch.models import gpt

    rng = np.random.default_rng(3)
    model = gpt.GPT(gpt.GPTConfig(dtype=torch.float32, **kw), device="cpu")
    return {n: ((1.0 if "scale" in n else 0.0)
                + 0.02 * rng.standard_normal(p.shape)).astype(np.float32)
            for n, p in model.named_parameters()}


def _jax_fit(d, f, data, tree, steps=STEPS):
    import jax
    import jax.numpy as jnp
    import optax

    from determined_tpu import core as jcore
    from determined_tpu.models import gpt as jgpt
    from determined_tpu.parallel.mesh import MeshConfig, make_mesh
    from determined_tpu.trainer import Batch, JAXTrial, Trainer

    class JTrial(JAXTrial):
        def build_model(self, mesh):
            return jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **KW), mesh=mesh)

        def build_optimizer(self):
            return optax.chain(optax.clip_by_global_norm(CLIP),
                               optax.adamw(LR))

        def build_training_data(self):
            return data()

    from determined_tpu_torch.trainer._checkpoint import nest

    mesh = make_mesh(MeshConfig(data=d, fsdp=f), devices=jax.devices()[:WORLD])
    ctx = jcore._context._dummy_init()
    trainer = Trainer(JTrial(), ctx, mesh=mesh, seed=0)
    # The numpy parameters, placed by the trainer's own shardings.
    params = jax.tree.map(lambda x, s: jax.device_put(jnp.asarray(x), s),
                          nest(tree), trainer._param_shardings())
    trainer._state = {"step": jnp.zeros((), jnp.int32), "params": params,
                      "opt_state": trainer._tx.init(params)}
    trainer.fit(max_length=Batch(steps), report_period=Batch(1))
    reports = [m for g, _, m in ctx.train._reported if g == "training"]
    return reports, trainer


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
    rank = failed if failed is not None else "?"
    logs = "\n".join(
        f"--- rank {r} ---\n{(tmp / f'rank{r}.log').read_text()[-4000:]}"
        for r in range(WORLD) if failed is None or r == failed)
    raise AssertionError(
        f"gang rank {rank} failed" if failed is not None
        else f"gang did not finish in {JOIN_S} s" + "\n" + logs)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gang")
    tree = _numpy_tree()
    np.savez(tmp / "params.npz", **tree)
    procs = _spawn(tmp)
    try:
        # The four JAX fits in threads: their XLA compiles overlap.
        with ThreadPoolExecutor(4) as pool:
            futures = {name: pool.submit(_jax_fit, d, f, _stream, tree)
                       for name, (d, f) in LAYOUTS.items()}
            futures["packed"] = pool.submit(_jax_fit, 2, 2, _packed_stream,
                                            tree)
            fitted = {name: f.result() for name, f in futures.items()}
        ref = {name: (reports, jax_params(trainer))
               for name, (reports, trainer) in fitted.items()}
        like = fitted["data2-fsdp2"][1].state
    except BaseException:
        for p, log in procs:
            p.kill()
            p.wait(timeout=10)
            log.close()
        raise
    _join(procs, tmp)
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as fh:
            ranks.append((json.load(fh), dict(np.load(tmp / f"rank{r}.npz"))))
    return {"ranks": ranks, "ref": ref, "tmp": tmp, "tree": tree,
            "like": like}


def jax_params(trainer):
    import jax

    from determined_tpu_torch.models.base import _flatten

    return {n: np.asarray(a) for n, a in
            _flatten(jax.device_get(trainer.state["params"]))}


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------
def test_control_plane_collectives(gang):
    for r, (res, _) in enumerate(gang["ranks"]):
        want = [{"rank": i} for i in range(WORLD)] if r == 0 else None
        assert res["gather"] == want
        assert res["broadcast"] == "from 0"
        assert res["allgather"] == [i * i for i in range(WORLD)]
        assert res["barrier"] is True


def _hold_reports(got, want, what):
    assert len(got) == len(want) == STEPS, what
    for step, (g, w) in enumerate(zip(got, want), 1):
        np.testing.assert_allclose(g["loss"], float(w["loss"]), rtol=1e-5,
                                   err_msg=f"{what} loss @ {step}")
        np.testing.assert_allclose(g["grad_norm"], float(w["grad_norm"]),
                                   rtol=1e-4,
                                   err_msg=f"{what} grad_norm @ {step}")
        np.testing.assert_allclose(g["tokens"], float(w["tokens"]),
                                   rtol=1e-6, err_msg=f"{what} tokens")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_gang_fit_matches_the_jax_trainer_on_its_mesh(gang, layout):
    want_reports, want_params = gang["ref"][layout]
    for r, (res, arrays) in enumerate(gang["ranks"]):
        _hold_reports(res[layout], want_reports, f"{layout} rank {r}")
        for name, want in want_params.items():
            got = arrays[f"{layout}/{name}"]
            scale = float(np.abs(want).max())
            if name == "blocks.bqkv":  # the key bias: see the docstring
                got, want = np.delete(got, 1, axis=1), np.delete(want, 1, axis=1)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale,
                                       err_msg=f"{layout} rank {r} {name}")
    # clipping engaged on some steps and not on others (the global norm's
    # all-reduce decides it)
    norms = [float(m["grad_norm"]) for m in want_reports]
    assert min(norms) < CLIP < max(norms), norms


def test_packed_batch_with_unequal_tokens_is_the_global_token_mean(gang):
    want, _ = gang["ref"]["packed"]
    local = [res["packed_local_tokens"] for res, _ in gang["ranks"]]
    assert len(set(local)) > 1, local  # the ranks hold unequal counts
    for r, (res, _) in enumerate(gang["ranks"]):
        _hold_reports(res["packed"], want, f"packed rank {r}")


def test_gang_without_a_mesh_trains_on_the_default_mesh(gang):
    want_reports, _ = gang["ref"]["data4"]
    for r, (res, arrays) in enumerate(gang["ranks"]):
        assert res["nomesh_axes"] == dict(pipeline=1, data=WORLD, fsdp=1,
                                          expert=1, context=1, tensor=1), r
        _hold_reports(res["nomesh"], want_reports, f"no mesh rank {r}")
        for got, want in zip(res["nomesh"], res["data4"]):
            for key in ("loss", "grad_norm", "tokens", "sentinel_skipped"):
                assert got[key] == want[key], (r, key)
        for key, a in arrays.items():
            if key.startswith("data4/"):
                np.testing.assert_array_equal(
                    arrays["nomesh/" + key[len("data4/"):]], a,
                    err_msg=f"rank {r} {key}")


def test_sharded_checkpoint_has_the_reference_names_and_loads_there(gang):
    from determined_tpu.trainer import _checkpoint as jckpt

    res0 = gang["ranks"][0][0]
    path = gang["tmp"] / "ckpt" / res0["ckpt_ids"]["2"]
    files = sorted(os.path.basename(f) for f in glob.glob(str(path / "*")))
    assert files.count("manifest.json") == 1 and "tree.json" in files
    assert "trainer_state.json" in files and "metadata.json" in files
    # split leaves: one file per fsdp block, replica 0 (data 0) only
    assert [f for f in files if f.startswith("params__blocks__wqkv")] == [
        "params__blocks__wqkv.shard0_0_0_0_0.npy",
        "params__blocks__wqkv.shard0_32_0_0_0.npy"]
    assert [f for f in files if f.startswith("params__tok_embed")] == [
        "params__tok_embed.shard0_0.npy", "params__tok_embed.shard0_32.npy"]
    # whole leaves: one file, from the chief
    assert "params__blocks__bi.npy" in files and "step.npy" in files
    assert not any(".shard" in f for f in files
                   if f.startswith("params__blocks__bi"))
    loaded = jckpt.load_pytree(str(path), gang["like"])
    flat = {jckpt._leaf_name(p): np.asarray(a) for p, a in
            __import__("jax").tree_util.tree_flatten_with_path(loaded)[0]}
    assert int(flat["step"]) == 2
    for r, (res, arrays) in enumerate(gang["ranks"]):
        for leaf, starts in res["block_starts"].items():
            block = arrays[f"block/{leaf}"]
            region = tuple(slice(s, s + n) for s, n in zip(starts,
                                                           block.shape))
            np.testing.assert_array_equal(flat[leaf][region], block,
                                          err_msg=f"rank {r} {leaf}")
        for name, a in gang["tree"].items():
            key = "params__" + name.replace(".", "__")
            np.testing.assert_array_equal(flat[key], arrays[f"step2/{name}"])


def test_gang_resumes_its_sharded_checkpoint_bitwise(gang):
    for r, (res, _) in enumerate(gang["ranks"]):
        assert res["resume_bitwise"] and res["resume_gathered_bitwise"], r
        assert [m["loss"] for m in res["resumed"]] == [
            m["loss"] for m in res["ckpt_run"]][2:], r
        assert len(res["ckpt_run"]) == STEPS  # the audit found nothing
        # the data=2 x fsdp=2 save restored onto fsdp=4: the same state,
        # and the same next loss but for the order of the metrics' sum
        assert res["reshard_gathered_bitwise"], r
        assert len(res["reshard"]) == 1
        np.testing.assert_allclose(res["reshard"][0]["loss"],
                                   res["resumed"][0]["loss"], rtol=1e-5)


def test_rollback_and_skip_is_agreed_by_every_rank(gang):
    """Two poisoned steps after the step-2 checkpoint: every rank skips
    both, rolls back to step 2 together and trains on past the window."""
    runs = [res["rollback_run"] for res, _ in gang["ranks"]]
    for r, (res, _) in enumerate(gang["ranks"]):
        assert res["rollback"] == [1, 2, 2, 5], r
        assert [m.get("loss") for m in res["rollback_run"]] == [
            m.get("loss") for m in runs[0]], r
    assert [int(m["sentinel_skipped"]) for m in runs[0]] == [1, 1, 0, 0, 0]


def test_divergence_drill_names_rank_1_on_every_rank(gang):
    for r, (res, _) in enumerate(gang["ranks"]):
        msg = res["drill"]
        assert msg is not None and res["drill_step"] == 1, r
        assert "suspect rank 1 device cpu" in msg and "rank 0" not in msg
        assert "rank 2" not in msg and "rank 3" not in msg



if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
