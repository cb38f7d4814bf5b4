"""The port's health sentinel (determined_tpu_torch.trainer._sentinel and
the Trainer's rollback-and-skip) against the JAX package's, on the CPU
at fp32.

- ``SentinelConfig.from_config`` parses every ``health`` knob as the
  reference does, ``SpikeDetector`` gives the reference's verdict on
  every loss of seeded streams with planted spikes, and
  ``poison_factor`` follows the same fault plans, one read from
  ``DTPU_FAULT_PLAN`` too.
- One ``Trainer`` of each package on the tiny GPT of
  ``test_torch_trainer.py`` (its ``KW``; the port's parameters carried
  over by ``load_jax_params``) over an indexed stream whose batch i is
  made from seed 1000 + (i mod 4) and which records every index it hands
  out. Stage by stage, under ``health = HEALTH``:
  1. guard only: 6 steps with the first 3 poisoned and no checkpoint —
     the consecutive-skip cap trips with nothing to roll back to, so
     the guard alone keeps the parameters clean (no rollback);
  2. the non-finite drill: on to step 8 with ``checkpoint_period=4``,
     then to 16 under ``train.nonfinite`` ``failures=2``: steps 9-10 are
     skipped, the cap trips and the trainer rolls back to the step-8
     checkpoint, leaving the stream 2 batches ahead;
  3. the spike drill: to 24 under ``train.spike`` ``failures=1``: the
     ×1e6 loss of step 17 is finite (applied, not skipped), the z-score
     trips and the trainer rolls back to the step-16 checkpoint;
  4. each package resumes the other's step-24 checkpoint (written after
     both rollbacks) in a fresh fit to step 26.
  Both packages must give the same recorder list, ``_data_offset``,
  ``rollbacks`` and ``steps_skipped`` at every stage, the same reported
  losses (1e-5 relative) and the same final parameters (5e-5 absolute:
  the tolerances ``test_torch_trainer.py`` states and explains; see
  ``ADAM_EPS``).
"""
import dataclasses
import math

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from determined_tpu import core as jcore
from determined_tpu.common import faults as jfaults
from determined_tpu.models import gpt as jgpt
from determined_tpu.trainer import Batch as JBatch
from determined_tpu.trainer import JAXTrial, Trainer as JTrainer
from determined_tpu.trainer import _sentinel as jsentinel
from determined_tpu_torch import core as tcore
from determined_tpu_torch.common import faults as tfaults
from determined_tpu_torch.models import gpt as tgpt
from determined_tpu_torch.trainer import Batch, TorchTrial, Trainer, optim
from determined_tpu_torch.trainer import _sentinel as tsentinel

KW = dict(vocab_size=128, n_layers=2, n_heads=2, d_model=32, d_ff=64,
          seq_len=32, remat=False)
HEALTH = {"max_consecutive_skips": 2, "spike_zscore": 6.0,
          "spike_min_history": 4}
#: Adam's eps for the drills. At optax's 1e-8, the key bias — whose true
#: gradient is identically zero (softmax ignores a shift shared by all
#: keys of a row) — moves by each package's own rounding noise (~1e-10)
#: over eps; over the drills' 27 steps at lr 1e-2 the packages drifted
#: apart there by 4.8e-4. At 1e-6 that term is 100× smaller, while every
#: leaf with a real gradient (≫ eps) trains as before.
ADAM_EPS = 1e-6
PACKAGES = {"jax": (jfaults, jsentinel), "torch": (tfaults, tsentinel)}


# ---------------------------------------------------------------------------
# SentinelConfig, SpikeDetector, poison_factor
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("health", [
    None,
    {},
    {"stall_timeout_s": 120, "spike_zscore": 6, "max_consecutive_skips": 5},
    {"spike_zscore": None, "spike_window": "8", "spike_min_history": 3,
     "divergence_check_period": 4, "stall_timeout_s": None,
     "max_consecutive_skips": 0},
])
def test_config_parses_as_the_reference(health):
    port = tsentinel.SentinelConfig.from_config(health)
    ref = jsentinel.SentinelConfig.from_config(health)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def _loss_stream(seed, n=300):
    """A falling noisy loss with planted spikes (×2 to ×1e6), NaNs and
    flat stretches."""
    rng = np.random.default_rng(seed)
    losses = 5.0 * np.exp(-np.arange(n) / 120.0) + rng.normal(0, 0.05, n)
    losses[rng.integers(20, n, 12)] *= rng.choice([2.0, 10.0, 1e6], 12)
    losses[rng.integers(0, n, 4)] = np.nan
    start = int(rng.integers(0, n - 20))
    losses[start:start + 12] = losses[start]  # MAD 0: the scale's floor
    return losses


@pytest.mark.parametrize("seed,zscore,window,min_history", [
    (0, 6.0, 64, 16), (1, 4.0, 8, 4), (2, 3.0, 16, 2), (3, 6.0, 4, 4),
])
def test_spike_detector_gives_the_reference_verdicts(seed, zscore, window,
                                                     min_history):
    health = {"spike_zscore": zscore, "spike_window": window,
              "spike_min_history": min_history}
    port = tsentinel.SpikeDetector(tsentinel.SentinelConfig.from_config(health))
    ref = jsentinel.SpikeDetector(jsentinel.SentinelConfig.from_config(health))
    got, want = [], []
    for i, loss in enumerate(_loss_stream(seed)):
        if i % 97 == 96:  # a rollback drops the baseline
            port.reset()
            ref.reset()
        got.append(port.observe(float(loss)))
        want.append(ref.observe(float(loss)))
    assert got == want
    assert 3 <= sum(got) < 40  # the planted spikes fire, the baseline not


def _poison_sequence(pkg, plan_doc, n=12):
    faults, sentinel = PACKAGES[pkg]
    with faults.plan_active(faults.FaultPlan.from_json(plan_doc)):
        seq = [sentinel.poison_factor() for _ in range(n)]
    return ["nan" if math.isnan(x) else x for x in seq]


@pytest.mark.parametrize("plan_doc", [
    "{}",
    '{"train.nonfinite": {"failures": 2}}',
    '{"train.spike": {"failures": 1}}',
    '{"train.nonfinite": {"failures": 1}, "train.spike": {"failures": 2}}',
    '{"seed": 5, "train.nonfinite": {"error_rate": 0.3}, '
    '"train.spike": {"error_rate": 0.3, "max_failures": 2}}',
    '{"train.*": {"failures": 3}}',
])
def test_poison_factor_follows_the_reference_plan(plan_doc):
    got = _poison_sequence("torch", plan_doc)
    assert got == _poison_sequence("jax", plan_doc)
    assert got.count("nan") + got.count(tsentinel.SPIKE_FACTOR) == sum(
        x != 1.0 for x in got)


@pytest.fixture
def env_plan(monkeypatch):
    """set_plan(text): DTPU_FAULT_PLAN = text, and both packages forget
    any plan read before; both forget this one after the test."""
    def set_plan(text):
        monkeypatch.setenv("DTPU_FAULT_PLAN", text)
        tfaults.clear()
        jfaults.clear()
    yield set_plan
    monkeypatch.delenv("DTPU_FAULT_PLAN", raising=False)
    tfaults.clear()
    jfaults.clear()


def test_poison_factor_reads_the_env_plan_once(env_plan, monkeypatch):
    env_plan('{"train.nonfinite": {"failures": 1}, '
             '"train.spike": {"failures": 1}}')
    got = [tsentinel.poison_factor() for _ in range(3)]
    want = [jsentinel.poison_factor() for _ in range(3)]
    assert math.isnan(got[0]) and math.isnan(want[0])
    assert got[1:] == want[1:] == [tsentinel.SPIKE_FACTOR, 1.0]
    # read once: a new value is seen only after clear()
    monkeypatch.setenv("DTPU_FAULT_PLAN",
                       '{"train.nonfinite": {"failures": 5}}')
    assert tsentinel.poison_factor() == 1.0
    tfaults.clear()
    assert math.isnan(tsentinel.poison_factor())


@pytest.mark.parametrize("text", ['{"train.nonfinite": {"fails": 1}}',
                                  "not json"])
def test_a_malformed_env_plan_is_refused(env_plan, text):
    env_plan(text)
    with pytest.raises(ValueError, match="DTPU_FAULT_PLAN"):
        tsentinel.poison_factor()
    with pytest.raises(ValueError, match="DTPU_FAULT_PLAN"):
        jsentinel.poison_factor()


# ---------------------------------------------------------------------------
# Trainer drills in both packages
# ---------------------------------------------------------------------------
class _IndexedStream:
    """Batch i depends only on i (seed 1000 + i mod 4); O(1) skip(n);
    records every index handed out."""

    def __init__(self, record):
        self.i = 0
        self.record = record

    def skip(self, n):
        self.i += n

    def __iter__(self):
        return self

    def __next__(self):
        i = self.i
        self.i += 1
        self.record.append(i)
        rng = np.random.default_rng(1000 + i % 4)
        return {"tokens": rng.integers(0, 128, (8, 32)).astype(np.int32)}


class _JTrial(JAXTrial):
    def __init__(self, record):
        super().__init__()
        self.record = record

    def build_model(self, mesh):
        return jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **KW), mesh=mesh)

    def build_optimizer(self):
        return optax.chain(optax.clip_by_global_norm(1.0),
                           optax.adamw(1e-2, eps=ADAM_EPS))

    def build_training_data(self):
        return _IndexedStream(self.record)

    def build_validation_data(self):
        return []


class _TTrial(TorchTrial):
    def __init__(self, record, tree):
        super().__init__()
        self.record = record
        self.tree = tree

    def build_model(self, device):
        model = tgpt.GPT(tgpt.GPTConfig(dtype=torch.float32, **KW),
                         device=device)
        return tgpt.load_jax_params(model, self.tree)

    def build_optimizer(self):
        return optim.chain(optim.clip_by_global_norm(1.0),
                           optim.adamw(1e-2, eps=ADAM_EPS))

    def build_training_data(self):
        return _IndexedStream(self.record)

    def build_validation_data(self):
        return []


def _training(trainer):
    return [(s, m) for g, s, m in trainer.core.train._reported
            if g == "training"]


def _run_stages(pkg, trainer, record):
    """Stages 1-3 of the module docstring → {stage: observed state}."""
    faults = PACKAGES[pkg][0]
    unit = JBatch if pkg == "jax" else Batch
    plan = faults.FaultPlan
    spec = faults.FaultSpec

    def fit(n, **kw):
        trainer.fit(max_length=unit(n), report_period=unit(1), **kw)

    def observe():
        return dict(record=list(record), data_offset=trainer._data_offset,
                    rollbacks=trainer.rollbacks,
                    steps_skipped=trainer.steps_skipped,
                    steps=trainer.steps_completed)

    out = {}
    with faults.plan_active(plan({"train.nonfinite": spec(failures=3)})):
        fit(6)
    out["guard"] = observe()
    fit(8, checkpoint_period=unit(4))
    out["at8"] = observe()
    with faults.plan_active(plan({"train.nonfinite": spec(failures=2)})):
        fit(16, checkpoint_period=unit(4))
    out["nonfinite"] = observe()
    with faults.plan_active(plan({"train.spike": spec(failures=1)})):
        fit(24, checkpoint_period=unit(4))
    out["spike"] = observe()
    out["reports"] = _training(trainer)
    out["last_ckpt"] = trainer._last_ckpt_id
    return out


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    """Stages 1-4 in both packages, over one checkpoint directory."""
    store = str(tmp_path_factory.mktemp("ckpt"))
    tree = jax.device_get(
        jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **KW)).init(
            jax.random.PRNGKey(0)))
    jrec, trec = [], []
    jt = JTrainer(_JTrial(jrec), jcore._context._dummy_init(
        checkpoint_storage=store), seed=0, health=HEALTH)
    tt = Trainer(_TTrial(trec, tree), tcore._dummy_init(
        checkpoint_storage=store), device="cpu", seed=0, health=HEALTH)
    out = {"jax": _run_stages("jax", jt, jrec),
           "torch": _run_stages("torch", tt, trec)}
    out["jax"]["params"] = dict(tgpt._flatten(
        jax.device_get(jt.state["params"])))
    out["torch"]["params"] = {n: p.detach().numpy().copy()
                              for n, p in tt.model.named_parameters()}

    # Stage 4: each package resumes the other's step-24 checkpoint. The
    # JAX trainer (its step already compiled) restores in place; the
    # port's is fresh.
    del jrec[:]
    jt.fit(max_length=JBatch(26), report_period=JBatch(1),
           latest_checkpoint=out["torch"]["last_ckpt"])
    trec2 = []
    resumed_t = Trainer(_TTrial(trec2, tree), tcore._dummy_init(
        checkpoint_storage=store), device="cpu", seed=0, health=HEALTH)
    resumed_t.fit(max_length=Batch(26), report_period=Batch(1),
                  latest_checkpoint=out["jax"]["last_ckpt"])
    out["resume"] = {
        "jax": dict(record=list(jrec), data_offset=jt._data_offset,
                    loss=[m["loss"] for _, m in _training(jt)[-2:]]),
        "torch": dict(record=trec2, data_offset=resumed_t._data_offset,
                      loss=[m["loss"] for _, m in _training(resumed_t)]),
    }
    return out


def test_guard_only_without_a_checkpoint(drills):
    """The cap trips at step 2 with no checkpoint: the guard kept the
    parameters clean, the counters reset, training goes on in place."""
    for pkg in ("jax", "torch"):
        assert drills[pkg]["guard"] == dict(
            record=list(range(6)), data_offset=0, rollbacks=0,
            steps_skipped=3, steps=6), pkg


@pytest.mark.parametrize("stage,want", [
    ("at8", dict(record=list(range(8)), data_offset=0, rollbacks=0,
                 steps_skipped=3, steps=8)),
    # steps 9-10 took indices 8-9 (poisoned); the rollback restored step
    # 8 and did not rewind the stream: steps 9-16 train on 10-17.
    ("nonfinite", dict(record=list(range(18)), data_offset=2, rollbacks=1,
                       steps_skipped=5, steps=16)),
    # step 17 took index 18 (×1e6, applied); back to step 16, and steps
    # 17-24 train on 19-26.
    ("spike", dict(record=list(range(27)), data_offset=3, rollbacks=2,
                   steps_skipped=5, steps=24)),
])
def test_drill_matches_the_reference(drills, stage, want):
    assert drills["torch"][stage] == drills["jax"][stage] == want


def test_drill_reports_match_the_reference(drills):
    jrep, trep = drills["jax"]["reports"], drills["torch"]["reports"]
    assert [s for s, _ in trep] == [s for s, _ in jrep]
    assert len(trep) == 6 + 2 + 10 + 9  # a rolled-back step reports too
    for (step, jm), (_, tm) in zip(jrep, trep):
        assert set(tm) == set(jm), step
        for key in ("sentinel_skipped", "sentinel_skips", "steps_skipped",
                    "rollbacks"):
            assert tm[key] == jm[key], (key, step)
        for key in ("loss", "grad_norm", "accuracy"):
            if key in jm:
                np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5,
                                           err_msg=f"{key} @ {step}")
    spiked = [m["loss"] for s, m in trep if m.get("loss", 0) > 1e5]
    assert len(spiked) == 1  # the ×1e6 step was finite: reported


def test_drill_ends_on_the_reference_parameters(drills):
    want = drills["jax"]["params"]
    for name, got in drills["torch"]["params"].items():
        np.testing.assert_allclose(got, want[name], atol=5e-5, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("reader", ["jax", "torch"])
def test_checkpoint_after_rollbacks_resumes_in_the_other_package(drills,
                                                                 reader):
    """The step-24 checkpoint carries data_offset 3: the other package
    fast-forwards 24 + 3 batches and trains steps 25-26 on 27-28."""
    got = drills["resume"][reader]
    assert got["record"] == [27, 28]
    assert got["data_offset"] == 3
    other = drills["resume"]["torch" if reader == "jax" else "jax"]
    np.testing.assert_allclose(got["loss"], other["loss"], rtol=1e-5)
