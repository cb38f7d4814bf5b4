"""The port's exec layer off the cluster (``determined_tpu_torch.exec``,
``models.get_model``, ``_info.TrialInfo``, the GPT-2 pretrain trial)
against the JAX package's, on the CPU.

- ``parse_unit`` gives the reference's units on ints, batches, epochs and
  refuses bad specs alike.
- ``get_model`` knows the reference's seven names and builds all seven
  (the GPT configs are the reference's field for field; ``ddpm`` and
  ``dcgan`` as ``tests/test_torch_generative.py`` holds them), an unknown
  name raises the reference's ``KeyError``.
- Each built-in trial's training and validation batches, and the GPT-2
  pretrain trial's over shards and synthetic, equal the reference's bit
  for bit.
- ``harness.run`` in process with the trial variables set as the agent
  sets them (``DTPU_JAX_PLATFORM=cpu``): mnist-mlp trains 4 batches,
  exits 0, checkpoints at 2 and 4 and writes tfevents; gpt-tiny and the
  GPT-2 pretrain trial run; ``CrashingTrial`` exits 1 with "trial
  failed"; a bad platform and a missing trial are refused; a mesh, cloud
  storage and no card (unset platform) exit 1 by name. (The harness on a
  cluster: ``tests/test_torch_cluster.py``.)
- Cross-package resume: the JAX ``Trainer`` trains the reference's
  ``SyntheticTrial`` (mnist-mlp) and checkpoints at steps 2 and 4; the
  port's harness resumes the step-2 checkpoint through
  ``DTPU_LATEST_CHECKPOINT`` to step 4, and its step-4 parameters and
  Adam moments match the reference's within 1e-5 absolute (fp32; the
  same two Adam steps from bitwise-equal state, gradients summed in
  other orders).
- ``LearnableTrial``: from carried weights, the port's and the
  reference's losses agree for 3 steps within 1e-5 relative.
- ``python -m determined_tpu_torch.exec.harness`` in a subprocess exits
  0.
"""
import glob
import json
import logging
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from determined_tpu import _info as jinfo
from determined_tpu import core as jcore
from determined_tpu import models as jmodels
from determined_tpu.exec import builtin_trials as jbuiltin
from determined_tpu.exec import harness as jharness
from determined_tpu.models import gpt as jgpt
from determined_tpu.trainer import Batch as JBatch
from determined_tpu.trainer import Trainer as JTrainer
from determined_tpu_torch import _info as tinfo
from determined_tpu_torch import core as tcore
from determined_tpu_torch import models as tmodels
from determined_tpu_torch.data import write_token_shard
from determined_tpu_torch.examples import gpt2_trial as tgpt2
from determined_tpu_torch.exec import builtin_trials as tbuiltin
from determined_tpu_torch.exec import harness as tharness
from determined_tpu_torch.models import vision as tvision
from determined_tpu_torch.tensorboard import read_scalars
from determined_tpu_torch.trainer import Batch, Trainer

ROOT = Path(__file__).resolve().parent.parent
BUILTIN = "determined_tpu_torch.exec.builtin_trials"
GPT2 = "determined_tpu_torch.examples.gpt2_trial:GPT2PretrainTrial"
TINY_GPT = {"vocab_size": 256, "n_layers": 2, "n_heads": 4, "d_model": 64,
            "d_ff": 256, "seq_len": 32}


def _units(u):
    return None if u is None else (type(u).__name__, u.value)


@pytest.mark.parametrize("spec", [
    None, 5, {"batches": 3}, {"epochs": 2}, {"batches": "7"},
])
def test_parse_unit_is_the_references(spec):
    assert _units(tharness.parse_unit(spec)) == _units(jharness.parse_unit(spec))


@pytest.mark.parametrize("spec", [{"records": 4}, {}])
def test_parse_unit_refuses_bad_specs(spec):
    for harness in (tharness, jharness):
        with pytest.raises(ValueError, match="bad train-unit spec"):
            harness.parse_unit(spec)


def test_registry_knows_the_references_names(monkeypatch):
    assert sorted(tmodels._REGISTRY) == sorted(jmodels._REGISTRY)
    for name, cls in (("ddpm", tmodels.DDPM), ("dcgan", tmodels.DCGAN)):
        assert isinstance(tmodels.get_model(name, "cpu"), cls)
    with pytest.raises(KeyError) as tk:
        tmodels.get_model("resnet", "cpu")
    with pytest.raises(KeyError) as jk:
        jmodels.get_model("resnet")
    assert str(tk.value) == str(jk.value)
    # the GPT configs are the reference's, field for field
    built = {}
    monkeypatch.setattr(tmodels, "GPT", lambda cfg, device, seed: cfg)
    for name in ("gpt2-small", "gpt2-medium", "gpt-tiny"):
        built[name] = tmodels.get_model(name, "cpu")
    assert tmodels.get_model("gpt2-small", "cpu", n_layers=3).n_layers == 3
    assert tmodels.get_model("gpt-tiny", "cpu", seq_len=64).seq_len == 64
    for name, want in (("gpt2-small", jgpt.small()),
                       ("gpt2-medium", jgpt.medium()), ("gpt-tiny", jgpt.tiny())):
        for field in ("vocab_size", "n_layers", "n_heads", "d_model", "d_ff",
                      "seq_len", "remat", "tie_embeddings"):
            assert getattr(built[name], field) == getattr(want, field), (name, field)


@pytest.mark.parametrize("name,cls,kw", [
    ("mnist-mlp", tvision.MnistMLP, {}),
    ("cifar-cnn", tvision.CifarCNN, {"channels": [4, 8], "hidden": 16}),
    ("gpt-tiny", tmodels.GPT, {}),
])
def test_registry_builds_on_the_given_device_from_the_torch_seed(name, cls, kw):
    torch.manual_seed(3)
    a = tmodels.get_model(name, "cpu", **kw)
    torch.manual_seed(3)
    b = tmodels.get_model(name, "cpu", **kw)
    assert isinstance(a, cls)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert p.device.type == "cpu" and torch.equal(p, q), n


@pytest.mark.parametrize("trial,hparams", [
    ("SyntheticTrial", {"model": "mnist-mlp", "batch_size": 4}),
    ("SyntheticTrial", {"model": "cifar-cnn", "batch_size": 3}),
    ("SyntheticTrial", {"model": "gpt-tiny", "batch_size": 2, "seq_len": 16,
                        "vocab_size": 100}),
    ("SyntheticTrial", {}),
    ("LearnableTrial", {"batch_size": 5}),
    ("CrashingTrial", {"model": "cifar-cnn"}),
])
def test_builtin_trial_batches_are_the_references(trial, hparams):
    port = getattr(tbuiltin, trial)(hparams)
    ref = getattr(jbuiltin, trial)(hparams)
    for got_it, want_it in ((port.build_training_data(),
                             ref.build_training_data()),
                            (iter(port.build_validation_data()),
                             iter(ref.build_validation_data()))):
        for _ in range(2):
            got, want = next(got_it), next(want_it)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_gpt2_trial_batches_are_the_references(tmp_path):
    from examples import gpt2_trial as jgpt2

    rng = np.random.default_rng(0)
    for i in range(2):
        write_token_shard(str(tmp_path / f"s{i}.bin"),
                          rng.integers(0, 256, 5000))
    for shards in ([str(tmp_path / "s*.bin")], []):
        hp = {"model_config": TINY_GPT, "batch_size": 3,
              "token_shards": shards}
        port, ref = tgpt2.GPT2PretrainTrial(hp), jgpt2.GPT2PretrainTrial(hp)
        for got, want in zip(port.build_validation_data(),
                             ref.build_validation_data()):
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
        it, jt = port.build_training_data(), ref.build_training_data()
        for _ in range(3):
            np.testing.assert_array_equal(next(it)["tokens"],
                                          next(jt)["tokens"])
    zig = tgpt2.GPT2PretrainTrial(
        {"model_config": dict(TINY_GPT, sequence_layout="zigzag")})
    with pytest.raises(ValueError, match="zigzag.*sharded context axis"):
        zig.build_training_data()


def test_trial_info_reads_what_cluster_info_writes(monkeypatch):
    trial = jinfo.TrialInfo(
        trial_id=12, experiment_id=3, trial_seed=99,
        hparams={"model": "gpt-tiny"}, config={"searcher": {"name": "single"}},
        latest_checkpoint="abc", trial_run_id=2)
    env = jinfo.ClusterInfo(
        master_url="http://m", cluster_id="", agent_id="", session_token="",
        task_id="t", allocation_id="a", task_type="TRIAL",
        trial=trial).to_env()
    for k in [k for k in os.environ if k.startswith("DTPU_")]:
        monkeypatch.delenv(k)
    assert tinfo.TrialInfo.from_env() is None
    for k, v in env.items():
        if k != "DTPU_MASTER":
            monkeypatch.setenv(k, v)
    got = tinfo.TrialInfo.from_env()
    assert got is not None and vars(got) == vars(trial)
    assert tinfo.ClusterInfo.from_env() is None  # no master
    monkeypatch.setenv("DTPU_MASTER", "http://m")
    cluster = tinfo.ClusterInfo.from_env()
    assert cluster is not None and vars(cluster.trial) == vars(trial)
    assert cluster.to_env() == env


@pytest.fixture
def trial_env(monkeypatch, tmp_path):
    """Set the trial variables the agent sets (→ the checkpoint root)."""
    for k in [k for k in os.environ if k.startswith("DTPU_")]:
        monkeypatch.delenv(k)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    root = tmp_path / "ckpt"

    def set_env(hparams, config=None, *, trial_id=1, platform="cpu", **extra):
        env = {
            "DTPU_TRIAL_ID": str(trial_id),
            "DTPU_HPARAMS": json.dumps(hparams),
            "DTPU_EXPERIMENT_CONFIG": json.dumps(config or {}),
            "DTPU_CHECKPOINT_STORAGE": json.dumps(
                {"type": "shared_fs", "host_path": str(root)}),
            **({"DTPU_JAX_PLATFORM": platform} if platform else {}),
            **extra,
        }
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        return root

    return set_env


def _config(batches, ckpt=None, tensorboard=False, **more):
    cfg = {"searcher": {"name": "single", "metric": "loss",
                        "max_length": {"batches": batches}},
           "scheduling_unit": 1, "tensorboard": tensorboard, **more}
    if ckpt:
        cfg["min_checkpoint_period"] = {"batches": ckpt}
    return cfg


def _checkpoints(root):
    """{storage id: steps_completed} of the checkpoints under `root`."""
    out = {}
    for md in glob.glob(os.path.join(root, "*", "metadata.json")):
        with open(md) as f:
            out[os.path.basename(os.path.dirname(md))] = \
                json.load(f)["steps_completed"]
    return out


def test_harness_trains_checkpoints_and_writes_tfevents(trial_env, tmp_path):
    root = trial_env({"model": "mnist-mlp", "batch_size": 8},
                     _config(4, ckpt=2, tensorboard=True), trial_id=5)
    assert tharness.run(f"{BUILTIN}:SyntheticTrial") == 0
    assert sorted(_checkpoints(root).values()) == [2, 4]
    for ckpt in _checkpoints(root):
        assert os.path.exists(os.path.join(root, ckpt, "params__w1.npy"))
    events = glob.glob(str(tmp_path / "dtpu-tb-trial-5" / "events.out.tfevents.*"))
    assert len(events) == 1
    losses = [e["scalars"]["loss"] for e in read_scalars(events[0])
              if "loss" in e["scalars"]]
    assert len(losses) == 4 and all(np.isfinite(losses))


@pytest.mark.parametrize("entrypoint,hparams", [
    (f"{BUILTIN}:SyntheticTrial", {"model": "gpt-tiny", "batch_size": 2,
                                   "seq_len": 32}),
    (GPT2, {"model_config": TINY_GPT, "batch_size": 2, "warmup_steps": 2,
            "decay_steps": 10}),
])
def test_harness_runs_the_lm_trials(trial_env, entrypoint, hparams):
    trial_env(hparams, _config(3, smaller_is_better=False,
                               profiling={"enabled": True}))
    assert tharness.run(entrypoint) == 0


def test_harness_trains_one_batch_without_a_length(trial_env, monkeypatch):
    trial_env({"model": "mnist-mlp", "batch_size": 4}, {"tensorboard": False})
    steps = []
    fit = Trainer.fit

    def recorded(self, **kw):
        out = fit(self, **kw)
        steps.append(self.steps_completed)
        return out

    monkeypatch.setattr(Trainer, "fit", recorded)
    assert tharness.run(f"{BUILTIN}:SyntheticTrial") == 0
    assert steps == [1]


def test_crashing_trial_exits_1(trial_env, caplog):
    trial_env({"crash_message": "boom from the test"}, _config(2))
    with caplog.at_level(logging.ERROR, logger="determined_tpu_torch.exec"):
        assert tharness.run(f"{BUILTIN}:CrashingTrial") == 1
    assert "trial failed" in caplog.text
    assert "boom from the test" in caplog.text


@pytest.mark.parametrize("case,match", [
    ("mesh", "mesh.*item 4"),
    ("storage", "'gcs' is not ported"),
    ("no-card", "CudaUnavailableError"),
])
def test_harness_exits_1_by_name(trial_env, monkeypatch, caplog, case, match):
    hparams = {"model": "mnist-mlp", "batch_size": 4}
    extra = {}
    if case == "mesh":
        hparams["mesh"] = {"data": 2, "pipeline": 2, "expert": 2}
    if case == "storage":
        extra["DTPU_CHECKPOINT_STORAGE"] = json.dumps(
            {"type": "gcs", "bucket": "b"})
    if case == "no-card":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trial_env(hparams, _config(1), platform=None if case == "no-card" else "cpu",
              **extra)
    with caplog.at_level(logging.ERROR, logger="determined_tpu_torch.exec"):
        assert tharness.run(f"{BUILTIN}:SyntheticTrial") == 1
    assert "trial failed" in caplog.text
    assert len(caplog.records) == 1
    assert re.search(match, caplog.text), caplog.text


def test_resolve_mesh_refuses_a_mesh_by_name():
    """A mesh that the port leaves out (the expert axis beside a pipeline
    axis) is refused by name; the expert axis beside a tensor axis is
    taken, and then needs a gang that spans it (a data × fsdp mesh over a
    gang: tests/test_torch_rendezvous.py)."""
    import torch.distributed as dist

    assert tharness.resolve_mesh({}, {}) is None
    joined = dist.is_initialized()
    try:
        with pytest.raises(ValueError, match="1 devices not divisible by 4"):
            tharness.resolve_mesh({}, {"mesh": {"tensor": 2, "expert": 2}},
                                  device="cpu")
    finally:
        if not joined and dist.is_initialized():
            dist.destroy_process_group()
            tharness._joined_alone = False
    with pytest.raises(NotImplementedError, match="item 4"):
        tharness.resolve_mesh({"mesh": {"data": 8, "pipeline": 2,
                                        "expert": 2}},
                              {"mesh": {"fsdp": 2}})


@pytest.mark.parametrize("var,value,exc,match", [
    ("DTPU_JAX_PLATFORM", "tpu", ValueError, "DTPU_JAX_PLATFORM='tpu'"),
    ("DTPU_TRIAL_ID", None, RuntimeError, "needs a trial env"),
])
def test_harness_refuses_by_name(trial_env, monkeypatch, var, value, exc,
                                 match):
    trial_env({"model": "mnist-mlp"}, _config(1))
    if value is None:
        monkeypatch.delenv(var)
    else:
        monkeypatch.setenv(var, value)
    with pytest.raises(exc, match=match):
        tharness.run(f"{BUILTIN}:SyntheticTrial")


def _params_and_moments(directory):
    return {os.path.basename(p)[:-4]: np.load(p)
            for p in glob.glob(os.path.join(directory, "*.npy"))
            if os.path.basename(p).startswith(("params__", "opt_state__"))}


def test_harness_resumes_a_reference_checkpoint(trial_env, monkeypatch):
    """The JAX Trainer checkpoints the reference's SyntheticTrial at 2 and
    4; the port's harness resumes its step-2 checkpoint to step 4."""
    hparams = {"model": "mnist-mlp", "batch_size": 16, "lr": 1e-2}
    root = trial_env(hparams, _config(4, ckpt=2))
    jctx = jcore._context._dummy_init(checkpoint_storage=str(root))
    JTrainer(jbuiltin.SyntheticTrial(hparams), jctx, seed=0).fit(
        max_length=JBatch(4), checkpoint_period=JBatch(2),
        report_period=JBatch(1))
    ref = {steps: ckpt for ckpt, steps in _checkpoints(root).items()}
    assert sorted(ref) == [2, 4]
    monkeypatch.setenv("DTPU_LATEST_CHECKPOINT", ref[2])
    assert tharness.run(f"{BUILTIN}:SyntheticTrial") == 0
    ours = [c for c, steps in _checkpoints(root).items()
            if c not in ref.values()]
    assert len(ours) == 1 and _checkpoints(root)[ours[0]] == 4
    want = _params_and_moments(os.path.join(root, ref[4]))
    got = _params_and_moments(os.path.join(root, ours[0]))
    assert sorted(got) == sorted(want) and any(k.startswith("params__w1")
                                               for k in got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    # moved off the step-2 state, so the comparison is not vacuous
    start = _params_and_moments(os.path.join(root, ref[2]))
    assert np.abs(got["params__w1"] - start["params__w1"]).max() > 1e-4


def test_learnable_trial_losses_match_the_reference():
    hparams = {"batch_size": 16, "lr": 1e-2}
    jctx = jcore._context._dummy_init()
    jt = JTrainer(jbuiltin.LearnableTrial(hparams), jctx, seed=0)
    params = jax.tree_util.tree_map(np.asarray,
                                    jax.device_get(jt.state["params"]))
    jt.fit(max_length=JBatch(3), report_period=JBatch(1))
    want = [m["loss"] for g, _, m in jctx.train._reported if g == "training"]

    ctx = tcore._dummy_init()
    tt = Trainer(tbuiltin.LearnableTrial(hparams), ctx, device="cpu", seed=0)
    tvision.load_jax_params(tt.model, params)
    tt.fit(max_length=Batch(3), report_period=Batch(1))
    got = [m["loss"] for g, _, m in ctx.train._reported if g == "training"]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_harness_module_launch_exits_0(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("DTPU_")}
    env.update(
        DTPU_JAX_PLATFORM="cpu",
        DTPU_ENTRYPOINT=f"{BUILTIN}:SyntheticTrial",
        DTPU_TRIAL_ID="3",
        DTPU_HPARAMS=json.dumps({"model": "mnist-mlp", "batch_size": 4}),
        DTPU_EXPERIMENT_CONFIG=json.dumps(_config(2, ckpt=2)),
        DTPU_CHECKPOINT_STORAGE=json.dumps(
            {"type": "shared_fs", "host_path": str(tmp_path)}),
        TMPDIR=str(tmp_path),
    )
    out = subprocess.run(
        [sys.executable, "-m", "determined_tpu_torch.exec.harness"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "entering fit" in out.stderr
    assert sorted(_checkpoints(tmp_path).values()) == [2]
