"""Training health sentinel: the step-level defenses of the trainer.

Port of ``determined_tpu/trainer/_sentinel.py``:

- **Non-finite guard** (``guarded_update``): a NaN/inf loss or gradient
  norm skips the optimizer update — the parameters and the WHOLE
  optimizer state (moments and step counts) keep their old values, only
  the trainer's step advances — and bumps a consecutive-skip counter.
  The choice is a select on the device (``torch.where`` with a device
  bool), so the step needs no host sync; the host reads the counters at
  report boundaries, where it already materializes metrics.
- **Loss-spike detector** (``SpikeDetector``): a robust z-score (median /
  MAD) over a rolling window of recent losses; a spike past
  ``spike_zscore`` triggers the same rollback-and-skip path as a run of
  non-finite steps (``Trainer._sentinel_rollback``). In a gang every
  rank sees the same global loss, so every rank reaches the same
  verdict with no collective of its own.
- **Replica-divergence audit** (``local_shard_checksums`` /
  ``compare_checksums``): every ``divergence_check_period`` batches,
  (Σx, Σx²) in fp32 of each parameter block a rank holds, keyed by the
  block's logical region, gathered by the chief and compared across
  every holder of the same region (the data-parallel replicas, and the
  ranks an fsdp or tensor axis replicates a parameter over; the tensor
  slices of one parameter are different regions, never compared).
  Replicas hold the same
  bytes and run the same reduction, so equality is exact; a mismatch is
  silent data corruption, and the trial errors with the minority
  holder's rank and device named (``ReplicaDivergenceError``). One
  device holds one copy of each region, so there is nothing to compare.

All are drivable through the fault plan (``common/faults.py``,
``DTPU_FAULT_PLAN``) at the ``train.*`` sites below.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import torch

from determined_tpu_torch.common import faults

#: Fault sites. `train.nonfinite` poisons the step's loss with NaN (the
#: guard must skip it); `train.spike` scales it by SPIKE_FACTOR (finite —
#: the guard must NOT trip; the z-score must).
NONFINITE_SITE = "train.nonfinite"
SPIKE_SITE = "train.spike"

DIVERGENCE_SITE_PREFIX = "train.divergence.rank"

SPIKE_FACTOR = 1e6


class ReplicaDivergenceError(RuntimeError):
    """Replicated parameters diverged across their holders: silent data
    corruption (a flipped bit, bad memory). The message names the
    offending rank and device; the trial errors rather than train on, or
    checkpoint, corrupt state."""


@dataclasses.dataclass(frozen=True)
class SentinelConfig:
    """Per-trial health knobs (the ``health:`` section)."""

    #: consecutive in-graph skips before rollback-and-skip; 0 = guard
    #: only (never roll back).
    max_consecutive_skips: int = 3
    #: robust z-score above which a finite loss counts as a spike and
    #: triggers rollback; 0 disables the detector.
    spike_zscore: float = 0.0
    #: losses kept in the spike baseline window.
    spike_window: int = 64
    #: observations required before the detector may fire.
    spike_min_history: int = 16
    #: batches between replica-divergence audits; 0 disables.
    divergence_check_period: int = 0
    #: master-side stall watchdog knob; carried here so one object
    #: describes the trial's whole health contract.
    stall_timeout_s: float = 0.0

    @classmethod
    def from_config(cls, health: Optional[Dict[str, Any]]) -> "SentinelConfig":
        health = health or {}
        return cls(
            max_consecutive_skips=int(health.get("max_consecutive_skips", 3)),
            spike_zscore=float(health.get("spike_zscore", 0.0) or 0.0),
            spike_window=int(health.get("spike_window", 64)),
            spike_min_history=int(health.get("spike_min_history", 16)),
            divergence_check_period=int(
                health.get("divergence_check_period", 0)
            ),
            stall_timeout_s=float(health.get("stall_timeout_s", 0.0) or 0.0),
        )


# -- the non-finite guard, on the device --------------------------------------
def _select(ok: torch.Tensor, new: Any, old: Any) -> Any:
    """`new` where ok else `old`, leaf by leaf over tuples/lists of
    tensors (NamedTuple optimizer states included)."""
    if isinstance(new, torch.Tensor):
        return torch.where(ok, new, old)
    if isinstance(new, tuple) and hasattr(new, "_fields"):
        return type(new)(*(_select(ok, n, o) for n, o in zip(new, old)))
    if isinstance(new, (tuple, list)):
        return type(new)(_select(ok, n, o) for n, o in zip(new, old))
    return new


@torch.no_grad()
def guarded_update(
    params: Sequence[torch.Tensor],
    new_params: Sequence[torch.Tensor],
    opt_state: Any,
    new_opt_state: Any,
    loss: torch.Tensor,
    grad_norm: torch.Tensor,
    skips_in: torch.Tensor,
) -> Tuple[Any, torch.Tensor, torch.Tensor]:
    """Apply the step when loss AND grad norm are finite, else keep the
    old values. `params` are written in place (``p ← where(ok, new, p)``);
    the optimizer state is returned.

    Returns (opt_state, ok, skips_out): `ok` is a device bool (True =
    applied), `skips_out` the device int32 consecutive-skip counter
    (reset by a healthy step). Callers must not materialize them per
    step."""
    ok = torch.isfinite(loss) & torch.isfinite(grad_norm)
    for p, n in zip(params, new_params):
        p.copy_(torch.where(ok, n, p))
    state = _select(ok, new_opt_state, opt_state)
    skips_out = torch.where(ok, torch.zeros_like(skips_in), skips_in + 1)
    return state, ok, skips_out


# -- fault-drill hook ---------------------------------------------------------
def poison_factor() -> float:
    """Host-side fault hook consulted once per step: 1.0 normally; NaN
    when the plan schedules a `train.nonfinite` injection for this call
    (the wire shape of a poisoned batch — the loss and every grad go
    non-finite); SPIKE_FACTOR for `train.spike` (finite but wild — only
    the z-score detector can catch it). One `None` check when no plan is
    active."""
    plan = faults.active()
    if plan is None:
        return 1.0
    try:
        plan.decide(NONFINITE_SITE)
    except faults.InjectedFault:
        return float("nan")
    try:
        plan.decide(SPIKE_SITE)
    except faults.InjectedFault:
        return SPIKE_FACTOR
    return 1.0


# -- loss-spike detection -----------------------------------------------------
class SpikeDetector:
    """Robust z-score loss-spike detector (median/MAD over a rolling
    window). Median and MAD instead of mean/std so the baseline is not
    dragged by the very spikes it must flag; confirmed spikes are NOT
    added to the history for the same reason."""

    def __init__(self, config: SentinelConfig) -> None:
        self.z = float(config.spike_zscore)
        self.min_history = max(2, int(config.spike_min_history))
        self._hist: Deque[float] = deque(maxlen=max(4, config.spike_window))

    @property
    def enabled(self) -> bool:
        return self.z > 0

    def observe(self, loss: float) -> bool:
        """Feed one step loss; returns True when it is a spike.
        Non-finite losses are the guard's jurisdiction — ignored here."""
        if not self.enabled or not math.isfinite(loss):
            return False
        spike = False
        if len(self._hist) >= self.min_history:
            med = statistics.median(self._hist)
            mad = statistics.median(abs(x - med) for x in self._hist)
            # 1.4826 * MAD ≈ σ for a normal baseline; the floor keeps a
            # perfectly flat loss window (MAD 0) from flagging normal
            # float jitter as infinite-z spikes.
            scale = max(1.4826 * mad, 1e-3 * max(abs(med), 1e-8))
            spike = (loss - med) / scale > self.z
        if not spike:
            self._hist.append(loss)
        return spike

    def reset(self) -> None:
        """Drop the baseline (after a rollback: the poisoned window's
        losses must not seed the fresh run's statistics)."""
        self._hist.clear()


def divergence_fault(rank: int) -> bool:
    """True when the plan schedules a replica bit-flip drill for `rank`
    (site ``train.divergence.rank<r>``: per-rank names, because every
    process inherits the same plan and a perturbation on ALL ranks would
    cancel out of the comparison)."""
    plan = faults.active()
    if plan is None:
        return False
    try:
        plan.decide(f"{DIVERGENCE_SITE_PREFIX}{rank}")
    except faults.InjectedFault:
        return True
    return False


# -- replica-divergence audit -------------------------------------------------
Checksums = Dict[str, List[Tuple[str, Tuple[float, float]]]]


def _index_key(region: Sequence[Tuple[int, int]],
               shape: Sequence[int]) -> str:
    """The reference's key of a shard's index: ``start:stop`` per
    dimension, ``0:None`` for a whole one, ``scalar`` for 0-d."""
    parts = [f"{lo}:{'None' if (lo, hi) == (0, n) else hi}"
             for (lo, hi), n in zip(region, shape)]
    return ",".join(parts) or "scalar"


def _keystr(name: str) -> str:
    """``jax.tree_util.keystr`` of a dotted parameter name."""
    return "".join(f"[{part!r}]" for part in name.split("."))


def local_shard_checksums(params: Dict[str, Any]) -> Checksums:
    """Checksums of every parameter block this rank holds, keyed by the
    block's logical region ("<leaf path>|<index>"); two holders of one key
    are replicas of the same bytes and must checksum identically. Values
    are (device label, (Σx, Σx²)) pairs, fp32 sums. `params`: {dotted
    name: tensor (a whole parameter) or ``_checkpoint.Shard`` (a block)},
    taken in sorted name order (the reference's tree order)."""
    out: Checksums = {}
    for name in sorted(params):
        leaf = params[name]
        local = getattr(leaf, "local", leaf)
        region = getattr(leaf, "region", None) or [(0, n) for n in local.shape]
        shape = tuple(getattr(leaf, "shape", local.shape))
        x32 = local.detach().float()
        sums = (float(x32.sum()), float((x32 * x32).sum()))
        key = f"{_keystr(name)}|{_index_key(region, shape)}"
        out.setdefault(key, []).append((str(local.device), sums))
    return out


def compare_checksums(
    gathered: List[Tuple[int, Checksums]],
    addrs: Optional[Dict[int, str]] = None,
) -> Optional[str]:
    """The chief's comparison of the ranks' checksums: None when every
    replica group agrees, else a diagnostic naming the minority
    holder(s) — every holder when no value has a majority."""
    groups: Dict[str, List[Tuple[int, str, Tuple[float, float]]]] = {}
    for rank, sums in gathered:
        for key, entries in sums.items():
            for device, val in entries:
                groups.setdefault(key, []).append((rank, device, val))
    for key, entries in sorted(groups.items()):
        values = {val for _, _, val in entries}
        if len(values) <= 1:
            continue
        counts: Dict[Tuple[float, float], int] = {}
        for _, _, val in entries:
            counts[val] = counts.get(val, 0) + 1
        majority = max(counts.values())
        suspects = [
            (rank, device) for rank, device, val in entries
            if counts[val] < majority
        ] or [(rank, device) for rank, device, _ in entries]
        named = ", ".join(
            f"rank {rank}"
            + (f" ({addrs[rank]})" if addrs and rank in addrs else "")
            + f" device {device}"
            for rank, device in suspects
        )
        return (
            f"replica divergence on {key}: {len(values)} distinct "
            f"checksums across {len(entries)} replicas; suspect {named} "
            "(silent data corruption — flipped bit or bad memory)"
        )
    return None
