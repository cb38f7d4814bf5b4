"""Trainer layer of the port: TorchTrial + the Trainer fit loop, the
optimizer chain (``optim``), the health sentinel (``_sentinel``: the
non-finite guard, the loss-spike detector; rollback-and-skip in the
loop) and the step timeline with its goodput ledger (``_timeline``).

Port of ``determined_tpu/trainer`` for one device, off-cluster (see
``_trainer.py``).
"""
from determined_tpu_torch.trainer import optim
from determined_tpu_torch.trainer._trainer import Trainer
from determined_tpu_torch.trainer._trial import TorchTrial
from determined_tpu_torch.trainer._units import Batch, Epoch, TrainUnit, to_batches

__all__ = [
    "Trainer", "TorchTrial", "Batch", "Epoch", "TrainUnit", "to_batches",
    "optim",
]
