"""Generative example trials: DDPM diffusion and DCGAN on synthetic
images (port of ``examples/generative_trials.py``).

The reference's recipe: hyperparameters from the experiment config
(``model_config``: ``DDPMConfig`` / ``GANConfig`` fields; ``batch_size``,
default 16; ``lr``, default 2e-4; ``data_seed``, default 0) and synthetic
Gaussian blobs, so the recipe runs anywhere. Adam as ``optax.adam``
(``trainer.optim.adam``), b1 0.5 for the GAN, one optimizer over both of
its nets (the combined loss already gives each net its own gradient).
Entrypoints: ``determined_tpu_torch.examples.generative_trials:
DiffusionTrial`` and ``...:DCGANTrial``; the configs are the reference's
``examples/diffusion.json`` and ``examples/dcgan.json`` with the entrypoint
swapped.
"""
from __future__ import annotations

import numpy as np
import torch

from determined_tpu_torch.models.generative import (
    DCGAN,
    DDPM,
    DDPMConfig,
    GANConfig,
)
from determined_tpu_torch.trainer import TorchTrial, optim


def _synthetic_images(seed: int, batch: int, size: int, channels: int):
    """Gaussian blobs at random positions, in [−1, 1]: structure a tiny
    model can learn (the reference's stream, bit for bit)."""
    rng = np.random.default_rng(seed)
    while True:
        cx = rng.uniform(0.25, 0.75, (batch, 1, 1, 1))
        cy = rng.uniform(0.25, 0.75, (batch, 1, 1, 1))
        xs = np.linspace(0, 1, size).reshape(1, size, 1, 1)
        ys = np.linspace(0, 1, size).reshape(1, 1, size, 1)
        img = np.exp(-(((xs - cx) ** 2 + (ys - cy) ** 2) / 0.02))
        img = np.repeat(img, channels, axis=-1) * 2.0 - 1.0
        yield {"image": img.astype(np.float32)}


class _ImageTrial(TorchTrial):
    def _config(self):
        raise NotImplementedError

    def build_training_data(self):
        c = self._config()
        return _synthetic_images(
            int(self.hparams.get("data_seed", 0)),
            int(self.hparams.get("batch_size", 16)),
            c.image_size, c.channels,
        )

    def build_validation_data(self):
        c = self._config()
        it = _synthetic_images(1, int(self.hparams.get("batch_size", 16)),
                               c.image_size, c.channels)
        return [next(it) for _ in range(2)]


class DiffusionTrial(_ImageTrial):
    def _config(self) -> DDPMConfig:
        return DDPMConfig(**self.hparams.get("model_config", {}))

    def build_model(self, device):
        # the trial seed: Trainer seeds torch just before build_model
        return DDPM(self._config(), device, seed=torch.initial_seed())

    def build_optimizer(self):
        return optim.adam(float(self.hparams.get("lr", 2e-4)))


class DCGANTrial(_ImageTrial):
    def _config(self) -> GANConfig:
        return GANConfig(**self.hparams.get("model_config", {}))

    def build_model(self, device):
        return DCGAN(self._config(), device, seed=torch.initial_seed())

    def build_optimizer(self):
        return optim.adam(float(self.hparams.get("lr", 2e-4)), b1=0.5)
