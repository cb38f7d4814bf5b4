"""The port's step timeline and goodput ledger
(determined_tpu_torch.trainer._timeline) against the JAX package's, on
the CPU.

- The reference's ledger cases (``tests/test_timeline.py``) run through
  both ``Timeline`` classes on one injected clock: every number equal.
- ``to_metadata`` of one package loads into the other, both ways: the
  ledger and the restart gap carry over, a foreign trial id keeps the
  fresh ledger, corrupt metadata never raises.
- ``Trainer.fit`` (the tiny GPT of ``test_torch_trainer.py``) in both
  packages reports the same ``profiling`` keys at the same steps, and
  each package's ``trainer_state.json`` carries a ledger that the other
  resumes as one restart.
- ``DTPU_TIMELINE=0`` turns the timeline and its reports off.
"""
import itertools
import json
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from determined_tpu import core as jcore
from determined_tpu.models import gpt as jgpt
from determined_tpu.trainer import Batch as JBatch
from determined_tpu.trainer import JAXTrial, Trainer as JTrainer
from determined_tpu.trainer import _timeline as jtimeline
from determined_tpu_torch import core as tcore
from determined_tpu_torch.models import gpt as tgpt
from determined_tpu_torch.trainer import Batch, TorchTrial, Trainer, optim
from determined_tpu_torch.trainer import _timeline as ttimeline

KW = dict(vocab_size=128, n_layers=2, n_heads=2, d_model=32, d_ff=64,
          seq_len=32, remat=False)
MODULES = {"jax": jtimeline, "torch": ttimeline}


def _timeline(pkg):
    """A Timeline whose perf_counter is a fixed 0.125 s tick."""
    tl = MODULES[pkg].Timeline(enabled=True)
    ticks = itertools.count(0.0, 0.125)
    tl.pc = lambda: next(ticks)
    tl.reset_window()
    return tl


def _state(tl):
    """Every number of the ledger (the wall-clock stamp aside)."""
    md = tl.to_metadata(trial_id=3)
    md.pop("saved_at")
    return dict(md, snapshot=tl.snapshot(), uncommitted_s=tl.uncommitted_s,
                window=dict(tl.window), goodput=tl.goodput_pct)


def _case_window(pkg):
    tl = _timeline(pkg)
    tl.window["data_wait"] += 0.5
    tl.window["h2d_put"] += 0.25
    tl.step_done()
    tl.step_done()
    out = tl.close_window()
    total = sum(out[f"{p}_frac"] for p in MODULES[pkg].ALL_PHASES)
    assert abs(total - 1.0) < 1e-6
    return dict(out, **_state(tl))


def _case_commit_vs_rollback(pkg):
    tl = _timeline(pkg)
    tl.uncommitted_s = 10.0
    tl.commit()
    tl.uncommitted_s = 5.0
    tl.on_rollback(restore_s=1.0)
    assert abs(tl.goodput_pct - 100.0 * 10.0 / 16.0) < 1e-9
    return _state(tl)


def _case_restart_gap(pkg):
    tl = _timeline(pkg)
    tl.productive_s = 30.0
    md = tl.to_metadata()
    tl2 = _timeline(pkg)
    tl2.load(md, now=md["saved_at"] + 12.0)
    assert tl2.restarts == 1 and tl2.goodput_pct < 100.0
    return _state(tl2)


def _case_metadata_roundtrip(pkg):
    tl = _timeline(pkg)
    tl.productive_s, tl.lost_s, tl.rollbacks = 7.0, 3.0, 2
    tl.phase_totals["data_wait"] = 1.5
    md = tl.to_metadata()
    tl2 = _timeline(pkg)
    tl2.load(md, now=md["saved_at"])  # zero gap
    assert tl2.lost_s == 3.0
    return _state(tl2)


def _case_foreign_ledger(pkg):
    tl = _timeline(pkg)
    tl.productive_s, tl.lost_s, tl.rollbacks = 50.0, 20.0, 3
    md = tl.to_metadata(trial_id=7)
    fork, resume = _timeline(pkg), _timeline(pkg)
    fork.load(md, now=md["saved_at"] + 3600.0, trial_id=8)
    resume.load(md, now=md["saved_at"] + 1.0, trial_id=7)
    assert fork.goodput_pct == 100.0 and resume.restarts == 1
    return dict(fork=_state(fork), resume=_state(resume))


def _case_corrupt_metadata(pkg):
    tl = _timeline(pkg)
    tl.load({"productive_s": "garbage"})
    tl.load({})
    return _state(tl)


def _case_windows_commits_rollbacks(pkg):
    """Several windows with every phase, commits, a rollback, a restart
    and a resize: the whole state after each."""
    tl = _timeline(pkg)
    states = []
    for i in range(6):
        for p, dt in zip(MODULES[pkg].PHASES, (0.01, 0.02, 0.03, 0.04)):
            tl.window[p] += dt * (i + 1)
        tl.step_done()
        states.append(tl.close_window())
        if i % 2:
            tl.commit()
        if i == 3:
            tl.on_rollback(0.375)
        states.append(_state(tl))
    tl.on_restart(2.5)
    tl.on_resize(1.25)
    states.append(_state(tl))
    return states


@pytest.mark.parametrize("case", [
    _case_window, _case_commit_vs_rollback, _case_restart_gap,
    _case_metadata_roundtrip, _case_foreign_ledger, _case_corrupt_metadata,
    _case_windows_commits_rollbacks,
], ids=lambda f: f.__name__[len("_case_"):])
def test_ledger_cases_match_the_reference(case):
    assert case("torch") == case("jax")


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_metadata_loads_in_the_other_package(writer, reader):
    src = _timeline(writer)
    src.productive_s, src.lost_s, src.rollback_lost_s = 40.0, 4.0, 3.0
    src.rollbacks, src.restarts = 2, 1
    src.phase_totals.update(step=30.0, data_wait=2.0, checkpoint=8.0)
    md = json.loads(json.dumps(src.to_metadata(trial_id=5)))  # on disk
    dst = _timeline(reader)
    dst.load(md, now=md["saved_at"] + 6.0, trial_id=5)
    assert (dst.productive_s, dst.rollbacks, dst.restarts) == (40.0, 2, 2)
    assert dst.restart_lost_s == pytest.approx(6.0)
    assert dst.lost_s == pytest.approx(10.0)
    assert dst.phase_totals == {**{p: 0.0 for p in MODULES[reader].ALL_PHASES},
                                "step": 30.0, "data_wait": 2.0,
                                "checkpoint": 8.0}
    foreign = _timeline(reader)
    foreign.load(md, now=md["saved_at"] + 6.0, trial_id=6)
    assert foreign.goodput_pct == 100.0 and foreign.restarts == 0
    for corrupt in ({"productive_s": "garbage", "trial_id": 5},
                    {"trial_id": "x"}, {}, dict(md, rollbacks=[1])):
        _timeline(reader).load(corrupt, trial_id=5)  # never raises


def test_kill_switch(monkeypatch):
    monkeypatch.setenv("DTPU_TIMELINE", "0")
    assert ttimeline.Timeline().enabled is jtimeline.Timeline().enabled \
        is False
    monkeypatch.delenv("DTPU_TIMELINE")
    assert ttimeline.Timeline().enabled is True


def test_kill_switch_drops_the_profiling_reports(monkeypatch):
    monkeypatch.setenv("DTPU_TIMELINE", "0")
    ctx = tcore._dummy_init()
    trainer = Trainer(_TTrial(), ctx, device="cpu")
    assert trainer.timeline.enabled is False
    trainer.fit(max_length=Batch(2), report_period=Batch(1))
    groups = [g for g, _, _ in ctx.train._reported]
    assert "profiling" not in groups and groups.count("training") == 2


# ---------------------------------------------------------------------------
# Trainer.fit in both packages
# ---------------------------------------------------------------------------
def _stream():
    rng = np.random.default_rng(7)
    while True:
        yield {"tokens": rng.integers(0, 128, (8, 32)).astype(np.int32)}


class _JTrial(JAXTrial):
    def build_model(self, mesh):
        return jgpt.GPT(jgpt.GPTConfig(dtype=jnp.float32, **KW), mesh=mesh)

    def build_optimizer(self):
        return optax.adamw(1e-2)

    def build_training_data(self):
        return _stream()

    def build_validation_data(self):
        return []


class _TTrial(TorchTrial):
    def build_model(self, device):
        return tgpt.GPT(tgpt.GPTConfig(dtype=torch.float32, **KW),
                        device=device)

    def build_optimizer(self):
        return optim.adamw(1e-2)

    def build_training_data(self):
        return _stream()

    def build_validation_data(self):
        return []


def _profiling(trainer):
    return [(s, m) for g, s, m in trainer.core.train._reported
            if g == "profiling"]


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """Each package: fit to 4 (reports every 2, a checkpoint at 4); then
    each resumes the other's checkpoint and fits to 6."""
    store = str(tmp_path_factory.mktemp("ckpt"))
    jt = JTrainer(_JTrial(), jcore._context._dummy_init(
        checkpoint_storage=store), seed=0)
    tt = Trainer(_TTrial(), tcore._dummy_init(checkpoint_storage=store),
                 device="cpu")
    out = {}
    for pkg, trainer, unit in (("jax", jt, JBatch), ("torch", tt, Batch)):
        trainer.fit(max_length=unit(4), report_period=unit(2),
                    checkpoint_period=unit(4))
        with open(os.path.join(store, trainer._last_ckpt_id,
                               "trainer_state.json")) as f:
            md = json.load(f)
        out[pkg] = dict(profiling=_profiling(trainer), metadata=md,
                        ckpt=trainer._last_ckpt_id,
                        ledger=trainer.timeline.snapshot())
    # The JAX trainer (its step already compiled) resumes in place; the
    # port's is fresh.
    jt.fit(max_length=JBatch(6), report_period=JBatch(2),
           latest_checkpoint=out["torch"]["ckpt"])
    resumed = Trainer(_TTrial(), tcore._dummy_init(checkpoint_storage=store),
                      device="cpu")
    resumed.fit(max_length=Batch(6), report_period=Batch(2),
                latest_checkpoint=out["jax"]["ckpt"])
    out["resumed"] = {"jax": jt.timeline, "torch": resumed.timeline}
    return out


def test_fit_reports_the_reference_profiling_keys(fits):
    jrep, trep = fits["jax"]["profiling"], fits["torch"]["profiling"]
    assert [s for s, _ in trep] == [s for s, _ in jrep] == [2, 4]
    for (step, jm), (_, tm) in zip(jrep, trep):
        assert set(tm) == set(jm), step
        fracs = [tm[f"{p}_frac"] for p in ttimeline.ALL_PHASES]
        assert sum(fracs) == pytest.approx(1.0, abs=1e-6)
        assert 0.0 < tm["goodput_pct"] <= 100.0
    # step_flops from the second report on, as the reference's
    assert "step_flops" not in trep[0][1] and trep[1][1]["step_flops"] > 0


def test_trainer_state_carries_the_ledger(fits):
    jmd, tmd = fits["jax"]["metadata"], fits["torch"]["metadata"]
    assert set(tmd) == set(jmd) >= {"steps_completed", "data_offset",
                                    "timeline"}
    assert set(tmd["timeline"]) == set(jmd["timeline"])
    assert tmd["timeline"]["trial_id"] == jmd["timeline"]["trial_id"] == 0


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_fit_resumes_the_other_packages_ledger(fits, writer, reader):
    """The resumed ledger is the writer's at its save plus one restart
    (the save→resume gap charged as restart loss)."""
    saved = fits[writer]["metadata"]["timeline"]
    tl = fits["resumed"][reader]
    assert tl.restarts == saved["restarts"] + 1 == 1
    assert tl.restart_lost_s > 0
    assert tl.productive_s >= saved["productive_s"] > 0
    assert 0.0 < tl.goodput_pct < 100.0
