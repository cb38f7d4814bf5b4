"""Train units: lengths expressed in Batches or Epochs.

Copy of ``determined_tpu/trainer/_units.py``: searcher op lengths and
periodic actions (validation/report periods) are denominated in these;
everything normalizes to batches, and Epoch needs the trial's
batches-per-epoch.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TrainUnit:
    value: int

    def batches(self, batches_per_epoch: int = 0) -> int:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Batch(TrainUnit):
    def batches(self, batches_per_epoch: int = 0) -> int:
        return self.value


@dataclasses.dataclass(frozen=True)
class Epoch(TrainUnit):
    def batches(self, batches_per_epoch: int = 0) -> int:
        if batches_per_epoch <= 0:
            raise ValueError(
                "Epoch units need batches_per_epoch (set "
                "TorchTrial.batches_per_epoch)"
            )
        return self.value * batches_per_epoch


def to_batches(unit, batches_per_epoch: int = 0) -> int:
    if isinstance(unit, TrainUnit):
        return unit.batches(batches_per_epoch)
    return int(unit)  # bare ints mean batches
