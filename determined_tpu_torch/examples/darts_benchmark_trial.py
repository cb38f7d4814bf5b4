"""DARTS-style HP-search benchmark: a NAS cell space driven by the
searcher (port of ``examples/darts_benchmark_trial.py``).

Each trial is one genotype (a categorical op choice per cell edge,
sampled by the searcher), trained on the CIFAR-shaped stream of
``HaikuVisionTrial`` through the haiku slot. The cell's parameters keep
haiku's names (``conv2_d``, ``conv2_d_1``, ... in creation order: the
stem, then the convolutions of op_0, op_1 and op_2; ``linear``), so
``integrations.haiku.load_jax_params`` takes the reference's tree.

haiku's ``SAME`` pools over the 3×3 window: ``hk.MaxPool`` pads with −∞
(``F.max_pool2d``'s padding), ``hk.AvgPool`` divides by the count of
unpadded entries (``count_include_pad=False``); ``conv5`` pads 2 a side.

Entrypoint: ``determined_tpu_torch.examples.darts_benchmark_trial:
DartsBenchmarkTrial``; the config is the reference's
``examples/darts_benchmark.json`` with the entrypoint swapped.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from determined_tpu_torch.integrations.haiku import (
    Conv2D,
    HaikuModel,
    HaikuVisionTrial,
    Linear,
    Names,
)

#: The op menu, all shape-preserving [B, C, H, W].
OPS = ("conv3", "conv5", "maxpool", "avgpool", "skip")


class _ConvOp(nn.Module):
    def __init__(self, conv: Conv2D) -> None:
        super().__init__()
        self.conv = conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.conv(x))


def _op(kind: str, channels: int, name: Names, cell: nn.Module):
    """The callable of one op; a convolution is registered on `cell`
    under its haiku name."""
    if kind in ("conv3", "conv5"):
        conv = Conv2D(channels, kernel_shape=3 if kind == "conv3" else 5)
        cell.add_module(name("conv2_d"), conv)
        return _ConvOp(conv)
    if kind == "maxpool":
        return lambda x: F.max_pool2d(x, 3, 1, 1)
    if kind == "avgpool":
        return lambda x: F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)
    if kind == "skip":
        return lambda x: x
    raise ValueError(f"unknown op {kind!r} (one of {OPS})")


class _Cell(nn.Module):
    """A 2-node DARTS-ish cell: node1 = op0(stem); node2 = op1(stem) +
    op2(node1); the head over the spatial mean of both nodes."""

    def __init__(self, genotype: Dict[str, str], channels: int,
                 num_classes: int) -> None:
        super().__init__()
        name = Names()
        self.stem = name("conv2_d")
        self.add_module(self.stem, Conv2D(channels, kernel_shape=3))
        # plain attributes: the convolutions are registered by name
        self.__dict__["ops"] = [
            _op(genotype[f"op_{i}"], channels, name, self) for i in range(3)]
        self.head = name("linear")
        self.add_module(self.head, Linear(num_classes))

    def forward(self, x: torch.Tensor, is_training: bool) -> torch.Tensor:
        del is_training
        op0, op1, op2 = self.ops
        stem = torch.relu(getattr(self, self.stem)(x.permute(0, 3, 1, 2)))
        n1 = op0(stem)
        n2 = op1(stem) + op2(n1)
        h = ((n1 + n2) / 2.0).mean(dim=(2, 3))
        return getattr(self, self.head)(h)


def cell_forward(genotype: Dict[str, str], channels: int,
                 num_classes: int) -> nn.Module:
    """The cell of one genotype, as a module ``forward(x, is_training)``
    over NHWC batches."""
    return _Cell(genotype, channels, num_classes)


class DartsBenchmarkTrial(HaikuVisionTrial):
    """HaikuVisionTrial with the architecture chosen by the searcher: the
    data stream, optimizer and validation slice are inherited, so the
    benchmark and the vision trial cannot drift apart."""

    def build_model(self, device, mesh=None) -> HaikuModel:
        _, _, classes = self._shapes()
        genotype = {k: self.hparams[k] for k in ("op_0", "op_1", "op_2")}
        return HaikuModel(
            cell_forward(genotype, int(self.hparams.get("channels", 16)),
                         classes),
            self._example(), mesh=mesh, device=device,
            seed=torch.initial_seed(),
        )
