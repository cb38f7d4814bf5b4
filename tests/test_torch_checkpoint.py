"""Checkpoint interchange between the port (determined_tpu_torch.trainer,
._checkpoint, .core) and the JAX package, on the CPU at fp32.

- JAX → port: the JAX ``Trainer`` saves at steps 2 and 4 of a 5-step
  run; the port's ``Trainer`` resumes from the step-2 checkpoint with
  every leaf bitwise equal to the JAX arrays, then reports the JAX run's
  losses and grad norms for steps 3–5 (the guarded NaN step at 4
  included) and ends on its parameters.
- Port → JAX: the port saves at steps 2 and 4 and at the end; JAX's
  ``load_pytree`` reads every leaf of the step-2 checkpoint bitwise, and
  the JAX ``Trainer`` resumes from it with the port's losses.
- Names: for ``chain(clip, adamw)`` at a constant rate and over a
  warmup-cosine schedule, and for ``adam``, the port writes exactly the
  JAX ``Trainer``'s ``.npy`` names, ``tree.json`` and ``metadata.json``,
  and the same ``trainer_state.json``, its goodput ``timeline`` included
  (the same fields; the seconds are each run's own).
- Manifests: each package's ``verify_checkpoint_dir`` accepts the other's
  checkpoints and refuses a truncated or bit-flipped file, which leaves
  the port's trainer untouched.
- Shards: a hand-built ``.shard<starts>`` checkpoint (a multi-host pod's
  layout) loads bitwise; incomplete, overlapping and drifted shards are
  refused.
- The fit loop: period and final saves, a preemption's synchronous save,
  the resumed data stream (``.skip()`` and discarding), a failing
  background save, and the refusals of later slices.

Tolerances are the trainer parity test's (tests/test_torch_trainer.py):
losses and grad norms 1e-5 relative, final parameters 5e-5 absolute.
Restored state is bitwise.
"""
import itertools
import json
import os
import shutil

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from determined_tpu import core as jcore
from determined_tpu.models import gpt as jgpt
from determined_tpu.storage.base import (
    CorruptCheckpointError as JCorrupt,
    verify_checkpoint_dir as jverify,
)
from determined_tpu.trainer import Batch as JBatch
from determined_tpu.trainer import JAXTrial, Trainer as JTrainer
from determined_tpu.trainer import _checkpoint as jckpt
from determined_tpu_torch import core as tcore
from determined_tpu_torch.models import gpt as tgpt
from determined_tpu_torch.storage import CorruptCheckpointError
from determined_tpu_torch.storage.base import verify_checkpoint_dir
from determined_tpu_torch.trainer import Batch, TorchTrial, Trainer, optim
from determined_tpu_torch.trainer import _checkpoint as ckpt_io

KW = dict(vocab_size=128, n_layers=2, n_heads=2, d_model=32, d_ff=64,
          seq_len=32, remat=False)
N_STEPS, NAN_STEP, PERIOD = 5, 3, 2


def _stream():
    rng = np.random.default_rng(7)
    for i in itertools.count():
        tokens = rng.integers(0, 128, (8, 32)).astype(np.int32)
        mask = np.ones((8, 32), np.float32)
        if i == NAN_STEP:
            mask[0, 5] = np.nan  # the step after the resume is guarded
        yield {"tokens": tokens, "loss_mask": mask}


RECIPES = {
    "clip-adamw": lambda lib: lib.chain(lib.clip_by_global_norm(1.0),
                                        lib.adamw(1e-2)),
    "clip-adamw-warmup-cosine": lambda lib: lib.chain(
        lib.clip_by_global_norm(1.0),
        lib.adamw(lib.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 10))),
    "adam": lambda lib: lib.adam(3e-3),
}


class _JTrial(JAXTrial):
    def __init__(self, recipe="clip-adamw"):
        super().__init__()
        self.recipe = recipe

    def build_model(self, mesh):
        return jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **KW), mesh=mesh)

    def build_optimizer(self):
        return RECIPES[self.recipe](optax)

    def build_training_data(self):
        return _stream()


class _TTrial(TorchTrial):
    def __init__(self, tree=None, recipe="clip-adamw"):
        super().__init__()
        self.tree, self.recipe = tree, recipe

    def build_model(self, device):
        model = tgpt.GPT(tgpt.GPTConfig(dtype=torch.float32, **KW),
                         device=device)
        if self.tree is not None:
            tgpt.load_jax_params(model, self.tree)
        return model

    def build_optimizer(self):
        return RECIPES[self.recipe](optim)

    def build_training_data(self):
        return _stream()


@pytest.fixture(scope="module")
def tree():
    return jax.device_get(jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **KW))
                          .init(jax.random.PRNGKey(0)))


def _by_step(root):
    """{steps_completed: storage_id} of every checkpoint under `root`."""
    out = {}
    for sid in os.listdir(root):
        with open(os.path.join(root, sid, "metadata.json")) as f:
            out[json.load(f)["steps_completed"]] = sid
    return out


def _training(ctx):
    return {s: m for g, s, m in ctx.train._reported if g == "training"}


def _assert_reports_match(got, want, steps):
    for step in steps:
        for key in ("loss", "grad_norm"):
            assert (key in got[step]) == (key in want[step]), (key, step)
            if key in want[step]:
                np.testing.assert_allclose(got[step][key], want[step][key],
                                           rtol=1e-5, err_msg=f"{key}@{step}")
        assert got[step]["sentinel_skipped"] == want[step]["sentinel_skipped"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, tree):
    """Uninterrupted 5-step runs of both Trainers, saving every 2 steps,
    each into its own storage directory."""
    jroot = str(tmp_path_factory.mktemp("jax-ckpts"))
    jctx = jcore._context._dummy_init(checkpoint_storage=jroot)
    jt = JTrainer(_JTrial(), jctx, seed=0)
    jt.fit(max_length=JBatch(N_STEPS), checkpoint_period=JBatch(PERIOD),
           report_period=JBatch(1))
    troot = str(tmp_path_factory.mktemp("port-ckpts"))
    tctx = tcore._dummy_init(checkpoint_storage=troot)
    tt = Trainer(_TTrial(tree), tctx, device="cpu", seed=0)
    tt.fit(max_length=Batch(N_STEPS), checkpoint_period=Batch(PERIOD),
           report_period=Batch(1))
    return dict(
        jroot=jroot, jreports=_training(jctx),
        jparams=jax.device_get(jt.state["params"]), jstate=jt.state,
        troot=troot, treports=_training(tctx), tt=tt,
    )


def _leaves(directory):
    return {f[:-4]: np.load(os.path.join(directory, f))
            for f in os.listdir(directory) if f.endswith(".npy")}


# ---------------------------------------------------------------------------
# JAX → port and port → JAX
# ---------------------------------------------------------------------------
def test_period_and_final_saves(runs):
    for root in (runs["jroot"], runs["troot"]):
        assert sorted(_by_step(root)) == [2, 4, 5]


def test_port_resumes_a_jax_checkpoint_bitwise(runs):
    ctx = tcore._dummy_init(checkpoint_storage=runs["jroot"])
    tt = Trainer(_TTrial(), ctx, device="cpu", seed=0)  # its own random init
    sid = _by_step(runs["jroot"])[2]
    tt.fit(max_length=Batch(2), latest_checkpoint=sid)
    assert tt.steps_completed == 2
    want = _leaves(os.path.join(runs["jroot"], sid))
    got = ckpt_io.snapshot_pytree(tt._state_view())
    assert set(got) == set(want)
    for name, arr in want.items():
        assert got[name].dtype == arr.dtype and got[name].shape == arr.shape
        np.testing.assert_array_equal(got[name], arr, err_msg=name)
    assert tt._opt_state[1][0].count.dtype == torch.int32

    tt.fit(max_length=Batch(N_STEPS), report_period=Batch(1))
    got = _training(ctx)
    assert sorted(got) == [3, 4, 5]
    assert "loss" not in got[NAN_STEP + 1]  # the guarded step, resumed too
    _assert_reports_match(got, runs["jreports"], [3, 4, 5])
    want = dict(tgpt._flatten(runs["jparams"]))
    for name, p in tt.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=5e-5,
                                   rtol=0, err_msg=name)


def test_jax_reads_and_resumes_a_port_checkpoint(runs):
    sid = _by_step(runs["troot"])[2]
    path = os.path.join(runs["troot"], sid)
    assert jverify(path)
    loaded = jax.device_get(jckpt.load_pytree(path, runs["jstate"]))
    files = _leaves(path)
    flat = jax.tree_util.tree_flatten_with_path(loaded)[0]
    assert len(flat) == len(files)
    for kp, leaf in flat:
        name = jckpt._leaf_name(kp)
        assert leaf.dtype == files[name].dtype, name
        np.testing.assert_array_equal(leaf, files[name], err_msg=name)
    assert int(loaded["step"]) == 2

    jctx = jcore._context._dummy_init(checkpoint_storage=runs["troot"])
    JTrainer(_JTrial(), jctx, seed=0).fit(
        max_length=JBatch(N_STEPS), report_period=JBatch(1),
        latest_checkpoint=sid)
    got = _training(jctx)
    assert sorted(got) == [3, 4, 5]
    _assert_reports_match(got, runs["treports"], [3, 4, 5])


# ---------------------------------------------------------------------------
# The names
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_port_writes_the_jax_names(recipe, tree, tmp_path):
    roots = {}
    for pkg in ("jax", "port"):
        root = str(tmp_path / pkg)
        if pkg == "jax":
            ctx = jcore._context._dummy_init(checkpoint_storage=root)
            JTrainer(_JTrial(recipe), ctx, seed=0).fit(
                max_length=JBatch(1), checkpoint_period=JBatch(1))
        else:
            ctx = tcore._dummy_init(checkpoint_storage=root)
            Trainer(_TTrial(tree, recipe), ctx, device="cpu", seed=0).fit(
                max_length=Batch(1), checkpoint_period=Batch(1))
        (sid,) = os.listdir(root)
        roots[pkg] = os.path.join(root, sid)
    j, t = roots["jax"], roots["port"]
    assert sorted(os.listdir(t)) == sorted(os.listdir(j))
    if recipe == "clip-adamw-warmup-cosine":
        assert os.path.exists(os.path.join(t, "opt_state__1__2__count.npy"))
    for name in ("tree.json", "metadata.json"):
        with open(os.path.join(j, name)) as fj, open(os.path.join(t, name)) as ft:
            assert json.load(ft) == json.load(fj), name
    with open(os.path.join(j, "trainer_state.json")) as fj, \
            open(os.path.join(t, "trainer_state.json")) as ft:
        jmd, tmd = json.load(fj), json.load(ft)
    assert set(tmd) == set(jmd)
    jtl, ttl = jmd.pop("timeline"), tmd.pop("timeline")
    assert tmd == jmd
    # the goodput ledger: the same fields; its seconds are each run's own
    assert set(ttl) == set(jtl)
    for key in ("trial_id", "rollbacks", "restarts", "resizes"):
        assert ttl[key] == jtl[key], key
    for name, arr in _leaves(j).items():
        tarr = np.load(os.path.join(t, name + ".npy"))
        assert (tarr.dtype, tarr.shape) == (arr.dtype, arr.shape), name


# ---------------------------------------------------------------------------
# Manifests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_verifies_the_others_manifest(runs, writer):
    root = runs["jroot" if writer == "jax" else "troot"]
    for sid in os.listdir(root):
        assert verify_checkpoint_dir(os.path.join(root, sid))
        assert jverify(os.path.join(root, sid))


@pytest.mark.parametrize("damage", ["truncate", "flip"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_damaged_checkpoint_is_refused_by_both(runs, writer, damage,
                                               tmp_path):
    root = runs["jroot" if writer == "jax" else "troot"]
    sid = _by_step(root)[2]
    shutil.copytree(os.path.join(root, sid), tmp_path / sid)
    victim = tmp_path / sid / "params__blocks__wqkv.npy"
    data = bytearray(victim.read_bytes())
    if damage == "truncate":
        del data[len(data) // 2:]
    else:
        data[-3] ^= 0x01
    victim.write_bytes(bytes(data))
    with pytest.raises(CorruptCheckpointError):
        verify_checkpoint_dir(str(tmp_path / sid))
    with pytest.raises(JCorrupt):
        jverify(str(tmp_path / sid))
    tt = Trainer(_TTrial(), tcore._dummy_init(checkpoint_storage=str(tmp_path)),
                 device="cpu")
    before = ckpt_io.snapshot_pytree(tt._state_view())
    with pytest.raises(CorruptCheckpointError):
        tt.fit(max_length=Batch(3), latest_checkpoint=sid)
    after = ckpt_io.snapshot_pytree(tt._state_view())
    assert tt.steps_completed == 0
    for name, arr in before.items():
        np.testing.assert_array_equal(after[name], arr, err_msg=name)


def test_drifted_leaf_leaves_the_trainer_untouched(runs, tmp_path):
    """A leaf of the wrong shape is found before anything is written."""
    sid = _by_step(runs["troot"])[2]
    shutil.copytree(os.path.join(runs["troot"], sid), tmp_path / sid)
    os.remove(tmp_path / sid / "manifest.json")  # unverified: reaches load
    np.save(tmp_path / sid / "params__tok_embed.npy",
            np.zeros((64, 32), np.float32))
    tt = Trainer(_TTrial(), tcore._dummy_init(checkpoint_storage=str(tmp_path)),
                 device="cpu")
    before = [p.detach().clone() for p in tt.model.parameters()]
    with pytest.raises(CorruptCheckpointError, match="tok_embed"):
        tt.fit(max_length=Batch(3), latest_checkpoint=sid)
    assert tt.steps_completed == 0
    assert all(torch.equal(a, b.detach())
               for a, b in zip(before, tt.model.parameters()))


def test_checkpoint_without_manifest_loads_with_the_warning(runs, tmp_path,
                                                            caplog):
    sid = _by_step(runs["jroot"])[2]
    shutil.copytree(os.path.join(runs["jroot"], sid), tmp_path / sid)
    os.remove(tmp_path / sid / "manifest.json")
    tt = Trainer(_TTrial(), tcore._dummy_init(checkpoint_storage=str(tmp_path)),
                 device="cpu")
    tt.fit(max_length=Batch(2), latest_checkpoint=sid)
    assert tt.steps_completed == 2
    assert "UNVERIFIED" in caplog.text


# ---------------------------------------------------------------------------
# Shards (a multi-host pod's layout)
# ---------------------------------------------------------------------------
FULL = np.arange(48, dtype=np.float32).reshape(8, 6)


@pytest.mark.parametrize("layout", ["rows", "grid"])
def test_hand_built_shards_load_bitwise(tmp_path, layout):
    if layout == "rows":
        shards = {(0, 0): FULL[:3], (3, 0): FULL[3:]}
    else:
        shards = {(r, c): FULL[r:r + 4, c:c + 3]
                  for r in (0, 4) for c in (0, 3)}
    for (r, c), part in shards.items():
        np.save(tmp_path / f"params__w.shard{r}_{c}.npy", part)
    np.save(tmp_path / "step.npy", np.int32(3))
    like = {"step": torch.zeros((), dtype=torch.int32),
            "params": {"w": torch.zeros(8, 6)}}
    ckpt_io.reset_load_stats()
    out = ckpt_io.load_pytree(str(tmp_path), like)
    assert out["params"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(out["params"]["w"].numpy(), FULL)
    assert out["step"].dtype == torch.int32 and int(out["step"]) == 3
    assert ckpt_io.load_stats()["bytes_materialized"] == FULL.nbytes + 4
    jout = jckpt.load_pytree(str(tmp_path), {"params": {"w": jnp.zeros((8, 6))}})
    np.testing.assert_array_equal(np.asarray(jout["params"]["w"]), FULL)


@pytest.mark.parametrize("case,files,match", [
    ("incomplete", {"a.shard0": np.zeros(4, np.float32)}, "incomplete"),
    ("overlap-with-hole", {"a.shard0": np.zeros(4, np.float32),
                           "a.shard2": np.zeros(2, np.float32)}, "incomplete"),
    ("past-the-extent", {"a.shard0": np.zeros(4, np.float32),
                         "a.shard4": np.zeros(6, np.float32)}, "drift"),
    ("single-file-drift", {"a": np.zeros(7, np.float32)}, "shape"),
    ("rank-mismatch", {"a.shard0_0": np.zeros((8, 1), np.float32)},
     "malformed"),
])
def test_bad_shards_are_refused(tmp_path, case, files, match):
    for name, arr in files.items():
        np.save(tmp_path / f"{name}.npy", arr)
    with pytest.raises(CorruptCheckpointError, match=match):
        ckpt_io.load_pytree(str(tmp_path), {"a": torch.zeros(8)})


def test_missing_leaf_is_refused_and_shardings_read_a_region(tmp_path):
    a = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    ckpt_io.save_pytree({"a": a, "s": torch.tensor(2.5)}, str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ckpt_io.load_pytree(str(tmp_path), {"a": torch.ones(8, 3),
                                            "b": torch.ones(2)})
    # the reference's signature: a placement per leaf, None for a whole one
    got = ckpt_io.load_pytree(
        str(tmp_path), {"a": torch.ones(8, 3), "s": torch.ones(())},
        shardings={"a": ckpt_io.Placement((8, 3), ((2, 6), (0, 3))),
                   "s": None})
    assert torch.equal(got["a"], a[2:6]) and float(got["s"]) == 2.5


def test_leaf_names_follow_jax_keypaths():
    state = (optim.EmptyState(),
             optim.ScaleByAdamState(torch.zeros((), dtype=torch.int32),
                                    [torch.ones(1), torch.ones(2)],
                                    (torch.ones(1), torch.ones(2))))
    view = ckpt_io.state_view(7, ["blocks.w", "tok"], [torch.ones(1),
                                                      torch.ones(2)], state)
    names = sorted(ckpt_io.snapshot_pytree(view))
    jview = {"step": jnp.int32(7),
             "params": {"blocks": {"w": jnp.ones(1)}, "tok": jnp.ones(2)},
             "opt_state": (optax.EmptyState(), optax.ScaleByAdamState(
                 jnp.zeros((), jnp.int32),
                 {"blocks": {"w": jnp.ones(1)}, "tok": jnp.ones(2)},
                 {"blocks": {"w": jnp.ones(1)}, "tok": jnp.ones(2)}))}
    jnames = sorted(jckpt.snapshot_pytree(jview))
    assert names == jnames
    back = ckpt_io.opt_state_from_view(state, view["opt_state"],
                                       ["blocks.w", "tok"])
    assert [t.shape for t in back[1].nu] == [(1,), (2,)]


# ---------------------------------------------------------------------------
# The fit loop
# ---------------------------------------------------------------------------
class _Counting:
    """A stream of batch indices; with_skip adds the in-place .skip()."""

    def __init__(self, seen, with_skip):
        self.seen, self.start = seen, 0
        if with_skip:
            self.skip = self._skip

    def _skip(self, n):
        self.start += n

    def __iter__(self):
        for i in itertools.count(self.start):
            self.seen.append(i)
            yield {"tokens": np.full((2, 32), i % 128, np.int32)}


@pytest.mark.parametrize("with_skip", [True, False],
                         ids=["skip", "discard"])
def test_resumed_stream_sees_the_uninterrupted_batches(tmp_path, with_skip):
    seen = []

    class Trial(_TTrial):
        def build_training_data(self):
            return _Counting(seen, with_skip)

    ctx = tcore._dummy_init(checkpoint_storage=str(tmp_path))
    Trainer(Trial(), ctx, device="cpu").fit(max_length=Batch(3),
                                            checkpoint_period=Batch(2))
    assert seen[:3] == [0, 1, 2]
    sid = _by_step(str(tmp_path))[2]
    seen.clear()
    Trainer(Trial(), ctx, device="cpu").fit(max_length=Batch(4),
                                            latest_checkpoint=sid)
    consumed = seen[2:] if not with_skip else seen
    assert consumed[:2] == [2, 3]


def test_preemption_saves_synchronously_and_exits(tmp_path):
    ctx = tcore._dummy_init(checkpoint_storage=str(tmp_path))
    tt = Trainer(_TTrial(), ctx, device="cpu")
    ctx.preempt.should_preempt = lambda **kw: tt.steps_completed >= 3
    tt.fit(max_length=Batch(6), report_period=Batch(1))
    assert tt.steps_completed == 3
    assert sorted(_by_step(str(tmp_path))) == [3]
    assert not tt._ckpt_writer.in_flight
    searcher_done = [g for g, _, _ in ctx.train._reported if g == "validation"]
    assert searcher_done == []  # preempted: the op does not complete


def test_failing_background_save_fails_fit(tmp_path):
    ctx = tcore._dummy_init(checkpoint_storage=str(tmp_path))

    def broken_upload(*args, **kwargs):
        raise OSError("disk full")

    ctx.checkpoint.upload = broken_upload
    tt = Trainer(_TTrial(), ctx, device="cpu")
    with pytest.raises(OSError, match="disk full"):
        tt.fit(max_length=Batch(3), checkpoint_period=Batch(2))
    assert not tt._ckpt_writer.in_flight


def test_checkpoint_format_must_be_known():
    with pytest.raises(ValueError, match="npy"):
        Trainer(_TTrial(), tcore._dummy_init(), device="cpu",
                checkpoint_format="pickle")


def test_snapshot_is_a_copy_the_next_step_cannot_change():
    """The trainer writes its parameters in place on the next step
    (_sentinel.guarded_update) while the writer thread serializes."""
    p = torch.ones(3)
    snap = ckpt_io.snapshot_pytree({"params": {"w": p}})
    p.add_(1.0)
    np.testing.assert_array_equal(snap["params__w"], np.ones(3, np.float32))


def test_async_writer_surfaces_errors_once():
    w = ckpt_io.AsyncCheckpointWriter()
    w.submit(lambda: 1)
    assert w.wait() == 1
    w.submit(lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        w.wait()
    assert w.wait() is None
