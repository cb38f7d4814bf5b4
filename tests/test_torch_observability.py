"""The port's TensorBoard writer and profiler agent
(determined_tpu_torch.tensorboard, .profiler) against the JAX package's,
on the CPU.

- ``_crc32c`` and ``_frame`` give the reference's bytes on seeded
  payloads, an event encoded at a fixed ``wall_time`` is byte-equal to
  the reference's, and each package's ``read_scalars`` reads the other's
  file.
- ``TensorboardManager`` syncs a log directory incrementally through the
  port's storage; ``ProfilerAgent`` samples, stops at its report cap and
  survives flushes racing its sampler (``tests/test_observability.py``'s
  cases); the card-memory metrics come from the CUDA caching allocator's
  counters and are absent on the CPU; ``torch_profiler_trace`` writes a
  Chrome trace.
- ``Trainer(profiling=True, tensorboard_dir=...)`` on the CPU writes the
  training and validation scalars and syncs them to checkpoint storage.
"""
import json
import os
import struct
import time
import types

import numpy as np
import pytest
import torch

from determined_tpu import tensorboard as jtb
from determined_tpu_torch import core as tcore
from determined_tpu_torch import profiler as tprof
from determined_tpu_torch import tensorboard as ttb
from determined_tpu_torch.core import DummyTrainContext
from determined_tpu_torch.models import gpt as tgpt
from determined_tpu_torch.storage.shared import SharedFSStorageManager
from determined_tpu_torch.trainer import Batch, TorchTrial, Trainer, optim


# ---------------------------------------------------------------------------
# tfevents bytes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_crc_and_framing_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 7, 255, int(rng.integers(256, 4096))):
        payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert ttb._crc32c(payload) == jtb._crc32c(payload)
        assert ttb._masked_crc(payload) == jtb._masked_crc(payload)
        assert ttb._frame(payload) == jtb._frame(payload)
    framed = ttb._frame(b"hello-tfevents")
    (length,) = struct.unpack_from("<Q", framed, 0)
    (crc,) = struct.unpack_from("<I", framed, 12 + length)
    assert crc == ttb._masked_crc(b"hello-tfevents")


@pytest.mark.parametrize("step,scalars,version", [
    (0, None, "brain.Event:2"),
    (1, {"loss": 2.5, "accuracy": 0.5}, None),
    (300, {"val_loss": -1e-7, "grad_norm": 3.4e38, "x" * 200: 1.0}, None),
    (2 ** 40, {"rollbacks": 2.0}, None),
])
def test_event_bytes_match_the_reference(step, scalars, version):
    kw = dict(scalars=scalars, file_version=version)
    assert (ttb._encode_event(1792000000.25, step, **kw)
            == jtb._encode_event(1792000000.25, step, **kw))


def _write(module, logdir, steps):
    writer = module.EventFileWriter(str(logdir))
    for step in range(1, steps + 1):
        writer.add_scalars(step, {"loss": 1.0 / step, "rollbacks": 0,
                                  "skip": "not a number"})
    writer.close()
    return writer.path


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_each_package_reads_the_others_file(tmp_path, writer, reader):
    mods = {"jax": jtb, "torch": ttb}
    events = mods[reader].read_scalars(_write(mods[writer], tmp_path, 5))
    assert events[0]["scalars"] == {} and "step" not in events[0]
    assert [e["step"] for e in events[1:]] == [1, 2, 3, 4, 5]
    for step, ev in enumerate(events[1:], 1):
        assert ev["scalars"]["loss"] == pytest.approx(1.0 / step, rel=1e-7)
        assert ev["scalars"]["rollbacks"] == 0.0
        assert "skip" not in ev["scalars"]


def test_manager_syncs_incrementally(tmp_path):
    logdir = tmp_path / "logs"
    storage = SharedFSStorageManager(str(tmp_path / "store"))
    writer = ttb.EventFileWriter(str(logdir))
    writer.add_scalars(1, {"loss": 1.0})
    writer.flush()
    manager = ttb.TensorboardManager(storage, "trial-9", str(logdir))
    assert len(manager.sync()) == 1
    assert manager.sync() == []  # unchanged: nothing re-uploaded
    writer.add_scalars(2, {"loss": 0.5})
    writer.flush()
    assert len(manager.sync()) == 1  # grew: re-synced
    writer.close()
    copy = tmp_path / "store" / "tensorboard" / "trial-9" / \
        os.path.basename(writer.path)
    assert [e.get("step") for e in ttb.read_scalars(str(copy))] == [None, 1, 2]


# ---------------------------------------------------------------------------
# ProfilerAgent
# ---------------------------------------------------------------------------
def test_profiler_samples_and_reports():
    train = DummyTrainContext()
    agent = tprof.ProfilerAgent(train, sample_interval_s=0.02,
                                report_every=3, max_reports=5)
    agent.set_steps_completed(7)
    agent.start()
    deadline = time.time() + 10
    while time.time() < deadline and not train._reported:
        time.sleep(0.05)
    agent.stop()
    assert not agent._thread.is_alive()
    group, steps, metrics = train._reported[0]
    assert group == "profiling" and steps == 7
    assert "cpu_util" in metrics or "memory_used_bytes" in metrics
    assert not any(k.startswith("device") for k in metrics)  # no card here


def test_profiler_stops_at_its_report_cap():
    train = DummyTrainContext()
    agent = tprof.ProfilerAgent(train, sample_interval_s=0.005,
                                report_every=1, max_reports=2)
    agent.start()
    time.sleep(0.3)
    agent.stop()
    assert len(train._reported) <= 3  # the cap + the final flush


def test_profiler_flushes_race_the_sampler():
    """Trainer-thread flushes hammer a fast sampler: every report
    averages at least one sample and nothing is lost mid-append."""
    train = DummyTrainContext()
    agent = tprof.ProfilerAgent(train, sample_interval_s=0.001,
                                report_every=3, max_reports=10_000)
    agent.start()
    stop = time.time() + 0.5
    while time.time() < stop:
        agent._flush()
    agent.stop()
    assert train._reported and all(m for _, _, m in train._reported)


def test_device_memory_comes_from_the_caching_allocator(monkeypatch):
    """The metric names and arithmetic, on a stand-in for one card's
    allocator counters (this box has no card)."""
    assert tprof._device_memory_metrics() == {}  # absent on the CPU
    cuda = torch.cuda
    monkeypatch.setattr(cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(cuda, "device_count", lambda: 2)
    monkeypatch.setattr(cuda, "memory_stats", lambda d: {
        "allocated_bytes.all.current": (d + 1) * 2 ** 30})
    monkeypatch.setattr(cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(total_memory=2 ** 36))
    assert tprof._device_memory_metrics() == {
        "device0_bytes_in_use": 2.0 ** 30, "device0_hbm_util": 2.0 ** -6,
        "device1_bytes_in_use": 2.0 ** 31, "device1_hbm_util": 2.0 ** -5,
    }


def test_torch_profiler_trace_writes_a_chrome_trace(tmp_path):
    with tprof.torch_profiler_trace(str(tmp_path / "trace")) as logdir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    (name,) = os.listdir(logdir)
    assert name.endswith(".pt.trace.json")
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


# ---------------------------------------------------------------------------
# Trainer(profiling=True, tensorboard_dir=...)
# ---------------------------------------------------------------------------
KW = dict(vocab_size=128, n_layers=2, n_heads=2, d_model=32, d_ff=64,
          seq_len=32, remat=False)


class _TTrial(TorchTrial):
    def build_model(self, device):
        return tgpt.GPT(tgpt.GPTConfig(dtype=torch.float32, **KW),
                        device=device)

    def build_optimizer(self):
        return optim.adamw(1e-2)

    def build_training_data(self):
        rng = np.random.default_rng(0)
        while True:
            yield {"tokens": rng.integers(0, 128, (4, 32)).astype(np.int32)}

    def build_validation_data(self):
        return [next(self.build_training_data())]


def test_trainer_writes_tensorboard_and_runs_the_profiler(tmp_path):
    ctx = tcore._dummy_init(checkpoint_storage=str(tmp_path / "store"))
    trainer = Trainer(_TTrial(), ctx, device="cpu", profiling=True,
                      tensorboard_dir=str(tmp_path / "tb"))
    trainer._profiler._interval = 0.01  # sample within the short fit
    trainer.fit(max_length=Batch(4), report_period=Batch(1),
                validation_period=Batch(2), checkpoint_period=Batch(2))
    assert not trainer._profiler._thread.is_alive()
    (name,) = os.listdir(tmp_path / "tb")
    events = ttb.read_scalars(str(tmp_path / "tb" / name))[1:]
    train = [(e["step"], e["scalars"]) for e in events if "loss" in e["scalars"]]
    assert [s for s, _ in train] == [1, 2, 3, 4]
    reported = {s: m for g, s, m in ctx.train._reported if g == "training"}
    for step, scalars in train:
        assert scalars["loss"] == pytest.approx(reported[step]["loss"],
                                                rel=1e-6)
        assert scalars["rollbacks"] == 0.0
    assert [e["step"] for e in events if "val_loss" in e["scalars"]] == [2, 4]
    # synced to checkpoint storage at the checkpoints and at the end
    copy = tmp_path / "store" / "tensorboard" / "local" / name
    assert copy.read_bytes() == (tmp_path / "tb" / name).read_bytes()
    samples = [m for g, _, m in ctx.train._reported
               if g == "profiling" and "memory_used_bytes" in m]
    assert samples and not any("device0_bytes_in_use" in m for m in samples)
