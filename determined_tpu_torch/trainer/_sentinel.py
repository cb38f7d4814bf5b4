"""The trainer's non-finite guard.

Port of ``determined_tpu/trainer/_sentinel.py``'s ``guarded_update`` and
``SentinelConfig``: a NaN/inf loss or gradient norm skips the optimizer
update — the parameters and the WHOLE optimizer state (moments and step
counts) keep their old values, only the trainer's step advances — and
bumps a consecutive-skip counter. The choice is a select on the device
(``torch.where`` with a device bool), so the step needs no host sync; the
host reads the counters at report boundaries, where it already
materializes metrics.

The loss-spike detector, rollback-and-skip to a checkpoint and the
replica-divergence audit come with later slices; a ``health`` config that
turns them on is refused by name.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SentinelConfig:
    """Per-trial health knobs (the ``health:`` section)."""

    #: consecutive skips after which the trainer logs the run of bad
    #: steps and resets the counter (the reference's rollback branch when
    #: no checkpoint exists yet); 0 = never.
    max_consecutive_skips: int = 3

    @classmethod
    def from_config(cls, health: Optional[Dict[str, Any]]) -> "SentinelConfig":
        health = health or {}
        for key in ("spike_zscore", "divergence_check_period"):
            if health.get(key):
                raise NotImplementedError(
                    f"health.{key} (the loss-spike detector / replica-"
                    "divergence audit, with rollback to a checkpoint) is "
                    "not ported yet (later slice)"
                )
        return cls(max_consecutive_skips=int(
            health.get("max_consecutive_skips", 3)))


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
