"""Model interface, without JAX.

The reference (``determined_tpu/models/base.py``) bundles a pure-functional
model as ``init(rng) -> params``, ``logical_axes()``, ``loss(params, batch,
rng)`` and ``eval_metrics(params, batch)``. In PyTorch the module owns its
parameters, so the contract shrinks to the two batch-level methods: a
model that trains overrides ``loss``; ``eval_metrics`` reuses it by
default. Parameter construction is the module's ``__init__``;
``logical_axes()`` names each parameter's dimensions for the sharding
rules (``parallel/sharding.py``), keyed as ``named_parameters`` names the
leaves.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
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

    def logical_axes(self) -> Dict[str, Any]:
        """Logical axis names per parameter dimension (nested dicts of
        tuples, as the reference's ``logical_axes()``). Default: every
        dimension unnamed, so the rules replicate every parameter."""
        out: Dict[str, Any] = {}
        for name, p in self.named_parameters():
            *parents, leaf = name.split(".")
            node = out
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = (None,) * p.dim()
        return out

    def gather_at_use(self, layout: Any) -> bool:
        """Offered by the Trainer on an fsdp axis above 1 (``layout``: its
        ``trainer._mesh.MeshLayout``, whose ``split_dims`` name the
        parameters held as this rank's blocks): a model that gathers each
        split parameter where it uses it, through ``layout.gather``,
        takes it and returns True. Default False: the Trainer gathers
        every split parameter at the step's start."""
        del layout
        return False

    def eval_metrics(self, batch: Batch) -> Metrics:
        """Validation metrics for one batch; default reuses loss()."""
        loss, metrics = self.loss(batch)
        return dict(metrics, loss=loss)


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """Nested dicts → (dotted name, leaf) pairs: the reference's keypaths
    as ``named_parameters`` names them."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def load_params(model: nn.Module, tree: Dict[str, Any]) -> None:
    """Fill `model`'s parameters from the reference's parameter pytree,
    given as nested dicts of numpy arrays (``jax.device_get(params)``) or
    of tensors (``trainer._checkpoint.load_pytree``).

    Every key and every shape is checked before anything is written:
    a key missing on either side raises ``KeyError``, a shape mismatch
    ``ValueError``."""
    flat = dict(_flatten(tree))
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(flat))
    unexpected = sorted(set(flat) - set(params))
    if missing or unexpected:
        raise KeyError(
            f"parameter tree does not match {type(model).__name__}: "
            f"missing {missing}, unexpected {unexpected}"
        )
    arrays = {}
    for name, p in params.items():
        arr = flat[name]
        if not isinstance(arr, torch.Tensor):
            arr = torch.tensor(np.asarray(arr, dtype=np.float32))
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(
                f"parameter {name}: shape {tuple(arr.shape)} != "
                f"{tuple(p.shape)}"
            )
        arrays[name] = arr
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(arrays[name])
