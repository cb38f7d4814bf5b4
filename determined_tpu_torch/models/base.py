"""Model interface, without JAX.

The reference (``determined_tpu/models/base.py``) bundles a pure-functional
model as ``init(rng) -> params``, ``logical_axes()``, ``loss(params, batch,
rng)`` and ``eval_metrics(params, batch)``. In PyTorch the module owns its
parameters, so the contract shrinks to the two batch-level methods: a
model that trains overrides ``loss``; ``eval_metrics`` reuses it by
default. Parameter construction is the module's ``__init__``; the
logical-axis sharding table arrives with the multi-device slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

Batch = Any
Metrics = Dict[str, torch.Tensor]


class Model(nn.Module):
    """Base class of the port's models."""

    def loss(
        self, batch: Batch, generator: Optional[torch.Generator] = None
    ) -> Tuple[torch.Tensor, Metrics]:
        """Scalar training loss + auxiliary metrics for one batch."""
        raise NotImplementedError(
            f"{type(self).__name__} defines no training loss"
        )

    def eval_metrics(self, batch: Batch) -> Metrics:
        """Validation metrics for one batch; default reuses loss()."""
        loss, metrics = self.loss(batch)
        return dict(metrics, loss=loss)
