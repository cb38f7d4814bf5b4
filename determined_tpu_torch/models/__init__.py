"""Model zoo of the port: GPT, the example-ladder vision models and the
generative pair (DDPM, DCGAN), and the registry (``get_model``) that
configs and the built-in trials name models by (port of
``determined_tpu/models/__init__.py``).

The registry knows the reference's seven names. Each model draws its
initial parameters from a generator seeded with ``torch.initial_seed()``:
inside ``Trainer`` that is the trial seed (``torch.manual_seed(seed)``
runs just before ``build_model``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import torch

from determined_tpu_torch.models import gpt as gpt_mod
from determined_tpu_torch.models.base import Model
from determined_tpu_torch.models.generative import (
    DCGAN,
    DDPM,
    DDPMConfig,
    GANConfig,
)
from determined_tpu_torch.models.gpt import (  # noqa: F401
    GPT,
    GPTConfig,
    load_jax_params,
)
from determined_tpu_torch.models.vision import (
    CifarCNN,
    CNNConfig,
    MLPConfig,
    MnistMLP,
)

Device = Optional[Union[str, torch.device]]


_REGISTRY: Dict[str, Callable[..., Model]] = {
    "ddpm": lambda device, seed, **kw: DDPM(
        DDPMConfig(**kw) if kw else DDPMConfig(), device, seed=seed
    ),
    "dcgan": lambda device, seed, **kw: DCGAN(
        GANConfig(**kw) if kw else GANConfig(), device, seed=seed
    ),
    "gpt2-small": lambda device, seed, **kw: GPT(
        gpt_mod.small() if not kw else GPTConfig(**kw), device, seed=seed
    ),
    "gpt2-medium": lambda device, seed, **kw: GPT(
        gpt_mod.medium() if not kw else GPTConfig(**kw), device, seed=seed
    ),
    "gpt-tiny": lambda device, seed, **kw: GPT(
        gpt_mod.tiny(**kw), device, seed=seed
    ),
    "mnist-mlp": lambda device, seed, **kw: MnistMLP(
        MLPConfig(**kw) if kw else MLPConfig(), device, seed=seed
    ),
    "cifar-cnn": lambda device, seed, **kw: CifarCNN(
        CNNConfig(**kw) if kw else CNNConfig(), device, seed=seed
    ),
}


def get_model(name: str, device: Device = None, **hparams: Any) -> Model:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](device, torch.initial_seed(), **hparams)


__all__ = [
    "Model",
    "GPT",
    "GPTConfig",
    "MnistMLP",
    "CifarCNN",
    "DDPM",
    "DCGAN",
    "get_model",
]
