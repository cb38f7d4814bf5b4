"""TorchTrial: the user-facing trial definition of the port.

The counterpart of ``determined_tpu/trainer/_trial.py``'s ``JAXTrial``:
users subclass it and the ``Trainer`` drives it. The trial builds the
model ON the device it is given (the module owns its parameters), the
optimizer (``trainer.optim``, optax's API shape) and the data: global
numpy batches (dicts of arrays with a leading batch axis) that the
Trainer moves onto the device — on a device mesh, each rank its rows of
them (every rank's trial yields the same global batches).

Under a mesh, a trial whose ``build_model`` takes a ``mesh`` argument
gets the Trainer's ``DeviceMesh`` (as the reference's ``build_model(mesh)``);
one that does not is built as on one device.
"""
from __future__ import annotations

import abc
import inspect
from typing import Any, Dict, Iterable, Iterator, Optional

import torch

from determined_tpu_torch.models.base import Model
from determined_tpu_torch.trainer.optim import GradientTransformation


class TorchTrial(abc.ABC):
    #: hyperparameters (an experiment config's ``hyperparameters``).
    hparams: Dict[str, Any]

    #: needed only when lengths/periods use Epoch units.
    batches_per_epoch: int = 0

    def __init__(self, hparams: Optional[Dict[str, Any]] = None) -> None:
        self.hparams = hparams or {}

    @abc.abstractmethod
    def build_model(self, device: torch.device) -> Model:
        """Construct the Model with its parameters on `device`."""

    @abc.abstractmethod
    def build_optimizer(self) -> GradientTransformation:
        """Construct the optimizer (``trainer.optim``)."""

    @abc.abstractmethod
    def build_training_data(self) -> Iterator[Dict[str, Any]]:
        """Yield global training batches (numpy dicts, leading batch
        axis). Must be an infinite (or long enough) stream; the searcher
        decides how far to train."""

    def build_validation_data(self) -> Iterable[Dict[str, Any]]:
        """Finite iterable of validation batches."""
        return []


def build_model(trial: TorchTrial, device: torch.device,
                mesh: Any = None) -> Model:
    """``trial.build_model(device)``, with ``mesh=`` when there is a mesh
    and the trial's ``build_model`` asks for one."""
    if mesh is not None and "mesh" in inspect.signature(
            trial.build_model).parameters:
        return trial.build_model(device, mesh=mesh)
    return trial.build_model(device)
