"""Vision models: MNIST MLP and CIFAR CNN (port of
``determined_tpu/models/vision.py``).

Small models used by tutorials, e2e tests and the HP-search workloads.
batch = {"image": f32 [B, H, W, C] (NHWC, as in the reference), "label":
int [B]}.

Parameters keep the reference's names and layouts, so the trainer's named
checkpoint view writes them under the reference's names and shapes and
either package resumes the other's checkpoints: ``w1`` [in, hidden] (in ×
out), ``b1``, ``w2``, ``b2``; ``conv{i}.w`` HWIO, ``conv{i}.b``;
``dense.w`` [flat, hidden], ``dense.b``; ``out.w``, ``out.b``.

Init is ``glorot_normal`` as JAX's ``variance_scaling(1, "fan_avg",
"truncated_normal")``, drawn from a ``torch.Generator`` seeded with
`seed`: the same distribution as the reference, not the same values
(``load_jax_params`` carries the values across). The convolutions and
matmuls are library calls, as in the reference (``lax.conv_general_dilated``
and ``@``, outside any Pallas kernel): ``F.conv2d`` on NCHW/OIHW views
with padding 1 (SAME for 3×3 at stride 1) and ``F.max_pool2d(2, 2)``
(``lax.reduce_window`` max over 2×2, VALID).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from determined_tpu_torch._device import resolve_device
from determined_tpu_torch.models.base import Metrics, Model, load_params


def _xent_metrics(logits: torch.Tensor,
                  labels: torch.Tensor) -> Tuple[torch.Tensor, Metrics]:
    """Mean cross-entropy and accuracy, in fp32."""
    logits = logits.float()
    labels = labels.long()
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - logits.gather(-1, labels[:, None]).squeeze(-1)
    loss = nll.mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": acc}


def glorot_normal(shape: Sequence[int], dtype: torch.dtype,
                  device: torch.device,
                  generator: torch.Generator) -> nn.Parameter:
    """JAX's ``glorot_normal``: a normal truncated at ±2σ, σ scaled so the
    truncated draw has variance 1/fan_avg (fans over the receptive field
    ``shape[:-2]``, ``shape[-2]`` in, ``shape[-1]`` out)."""
    receptive = math.prod(shape[:-2])
    fan_avg = (shape[-2] + shape[-1]) * receptive / 2
    # 0.8796...: the stddev of a unit normal truncated to [-2, 2].
    std = math.sqrt(1.0 / fan_avg) / 0.87962566103423978
    t = torch.empty(tuple(shape), dtype=dtype, device=device)
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
    return nn.Parameter(t)


def _zeros(n: int, dtype: torch.dtype, device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(n, dtype=dtype, device=device))


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: int = 256
    n_classes: int = 10
    dtype: Any = torch.float32


class MnistMLP(Model):
    def __init__(self, config: MLPConfig = MLPConfig(),
                 device: Optional[Union[str, torch.device]] = None,
                 *, seed: int = 0) -> None:
        super().__init__()
        c = self.config = config
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.w1 = glorot_normal((c.in_dim, c.hidden), c.dtype, dev, gen)
        self.b1 = _zeros(c.hidden, c.dtype, dev)
        self.w2 = glorot_normal((c.hidden, c.n_classes), c.dtype, dev, gen)
        self.b2 = _zeros(c.n_classes, c.dtype, dev)

    def apply(self, images: torch.Tensor) -> torch.Tensor:
        x = images.reshape(images.shape[0], -1)
        h = torch.relu(x @ self.w1 + self.b1)
        return h @ self.w2 + self.b2

    def loss(self, batch, generator=None) -> Tuple[torch.Tensor, Metrics]:
        del generator
        return _xent_metrics(self.apply(batch["image"]), batch["label"])


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    in_channels: int = 3
    channels: Tuple[int, ...] = (32, 64)
    hidden: int = 128
    n_classes: int = 10
    dtype: Any = torch.float32


class CifarCNN(Model):
    """Conv stack over NHWC batches; the dense layer is sized for the
    canonical 32×32 CIFAR input (one 2×2 pool per conv)."""

    def __init__(self, config: CNNConfig = CNNConfig(),
                 device: Optional[Union[str, torch.device]] = None,
                 *, seed: int = 0) -> None:
        super().__init__()
        c = self.config = config
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        cin = c.in_channels
        for i, cout in enumerate(c.channels):
            self.add_module(f"conv{i}", nn.ParameterDict({
                "w": glorot_normal((3, 3, cin, cout), c.dtype, dev, gen),
                "b": _zeros(cout, c.dtype, dev),
            }))
            cin = cout
        hw = 32 // (2 ** len(c.channels))
        flat = hw * hw * c.channels[-1]
        self.dense = nn.ParameterDict({
            "w": glorot_normal((flat, c.hidden), c.dtype, dev, gen),
            "b": _zeros(c.hidden, c.dtype, dev),
        })
        self.out = nn.ParameterDict({
            "w": glorot_normal((c.hidden, c.n_classes), c.dtype, dev, gen),
            "b": _zeros(c.n_classes, c.dtype, dev),
        })

    def apply(self, images: torch.Tensor) -> torch.Tensor:
        c = self.config
        x = images.to(c.dtype).permute(0, 3, 1, 2)  # NHWC → NCHW view
        for i in range(len(c.channels)):
            p = getattr(self, f"conv{i}")
            x = F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], padding=1)
            x = F.max_pool2d(torch.relu(x), 2, 2)
        # flatten in NHWC order, as the reference's dense.w expects
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = torch.relu(x @ self.dense["w"] + self.dense["b"])
        return x @ self.out["w"] + self.out["b"]

    def loss(self, batch, generator=None) -> Tuple[torch.Tensor, Metrics]:
        del generator
        return _xent_metrics(self.apply(batch["image"]), batch["label"])


def load_jax_params(model: Union[MnistMLP, CifarCNN],
                    tree: Dict[str, Any]) -> Union[MnistMLP, CifarCNN]:
    """Fill a vision model from the reference's parameter pytree (nested
    dicts of numpy arrays or tensors; keys and shapes checked first)."""
    load_params(model, tree)
    return model
