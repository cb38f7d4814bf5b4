"""Built-in trials: registry models + synthetic data (port of
``determined_tpu/exec/builtin_trials.py``).

An experiment config can point its entrypoint here
(``determined_tpu_torch.exec.builtin_trials:SyntheticTrial``) and select
any model of ``determined_tpu_torch.models`` via hyperparameters, with
synthetic data — so smoke runs work without shipping user code. The
batches are the reference's numpy streams bit for bit.

hparams:
  model:      registry name (default "mnist-mlp")
  model_kw:   dict passed to the registry constructor
  lr:         adam learning rate (default 1e-3)
  batch_size: global batch (default 16)
  seq_len:    for LM models (default 128)
  vocab_size: token range of the LM batches (default 256)
  sleep_s:    per-batch sleep — the "no-op trial" knob for scheduler tests
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterator

import numpy as np

from determined_tpu_torch.models import get_model
from determined_tpu_torch.trainer import TorchTrial, optim


class SyntheticTrial(TorchTrial):
    """Any registry model on synthetic data shaped to its input contract."""

    def build_model(self, device):
        name = self.hparams.get("model", "mnist-mlp")
        return get_model(name, device, **self.hparams.get("model_kw", {}))

    def build_optimizer(self):
        return optim.chain(
            optim.clip_by_global_norm(1.0),
            optim.adamw(float(self.hparams.get("lr", 1e-3))),
        )

    def _batches(self, seed: int) -> Iterator[Dict[str, Any]]:
        rng = np.random.default_rng(seed)
        b = int(self.hparams.get("batch_size", 16))
        sleep_s = float(self.hparams.get("sleep_s", 0.0))
        name = self.hparams.get("model", "mnist-mlp")
        while True:
            if sleep_s:
                time.sleep(sleep_s)
            if name.startswith("gpt"):
                s = int(self.hparams.get("seq_len", 128))
                vocab = int(self.hparams.get("vocab_size", 256))
                yield {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32)}
            elif name == "cifar-cnn":
                yield {
                    "image": rng.normal(size=(b, 32, 32, 3)).astype(np.float32),
                    "label": rng.integers(0, 10, (b,)).astype(np.int32),
                }
            else:
                yield {
                    "image": rng.normal(size=(b, 28, 28, 1)).astype(np.float32),
                    "label": rng.integers(0, 10, (b,)).astype(np.int32),
                }

    def build_training_data(self):
        return self._batches(0)

    def build_validation_data(self):
        it = self._batches(1)
        return [next(it) for _ in range(2)]


class CrashingTrial(SyntheticTrial):
    """Fails deterministically at model build — the fixture for error-path
    drills. `crash_message` hparam names the raise."""

    def build_model(self, device):
        raise RuntimeError(
            str(self.hparams.get("crash_message", "CrashingTrial: boom"))
        )


class LearnableTrial(SyntheticTrial):
    """Deterministic learnable task (linear labels): loss actually falls,
    so HP-search tests can distinguish good lrs from bad ones."""

    def _batches(self, seed: int) -> Iterator[Dict[str, Any]]:
        w = np.random.default_rng(1234).normal(size=(784, 10)).astype(np.float32)
        rng = np.random.default_rng(seed)
        b = int(self.hparams.get("batch_size", 16))
        while True:
            x = rng.normal(size=(b, 28, 28, 1)).astype(np.float32)
            y = np.argmax(x.reshape(b, -1) @ w, axis=-1).astype(np.int32)
            yield {"image": x, "label": y}
