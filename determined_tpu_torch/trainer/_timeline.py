"""Step-phase timer + goodput ledger for the trainer.

A copy of ``determined_tpu/trainer/_timeline.py`` (pure Python; the same
names, metric keys and metadata format, so either package resumes the
other's ledger). It answers *where does a step's wall-clock go*
(data-wait vs host→device put vs the step vs reporting vs checkpointing)
and *how much of the trial's lifetime was productive* (vs lost to
rollbacks and restarts — goodput %).

Discipline — no per-step host sync:

- per step the host records only `perf_counter` deltas around work the
  host ALREADY does synchronously (pulling the next batch, the batch's
  host→device copy);
- the step time is the window RESIDUAL, settled at report boundaries
  where the metrics flush already waits for the device (the window's
  one device→host transfer): residual = window wall − data-wait − put −
  report − checkpoint. The step's kernels run asynchronously, so
  per-step host timers cannot see device time; the boundary sync sees
  all of it.

Ledger semantics:

- window time accrues as *uncommitted* until a checkpoint lands
  (`commit()` → productive): work that a later rollback discards was
  never goodput;
- `on_rollback(restore_s)` moves the uncommitted time plus the restore
  itself to the lost side;
- the ledger rides the trainer metadata (`to_metadata`/`load`), so a
  process restart resumes the SAME ledger and the save→restore gap is
  charged as restart loss.

Kill switch: ``DTPU_TIMELINE=0``.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

#: Window phases the host measures directly; "step" is the residual.
PHASES = ("data_wait", "h2d_put", "report", "checkpoint")
ALL_PHASES = PHASES + ("step",)


class Timeline:
    def __init__(self, enabled: Optional[bool] = None) -> None:
        if enabled is None:
            enabled = os.environ.get("DTPU_TIMELINE", "1") != "0"
        self.enabled = enabled
        self.pc = time.perf_counter
        # -- window accumulators (reset every report boundary) --------------
        self.window: Dict[str, float] = {p: 0.0 for p in PHASES}
        self._window_start = self.pc()
        self._window_steps = 0
        # -- cumulative phase totals (lifetime, this process + restores) ----
        self.phase_totals: Dict[str, float] = {p: 0.0 for p in ALL_PHASES}
        # -- goodput ledger --------------------------------------------------
        self.productive_s = 0.0       # window time behind a checkpoint
        self.lost_s = 0.0             # rollback + restart + resize time
        self.rollback_lost_s = 0.0
        self.restart_lost_s = 0.0
        #: elastic resize event class: drain→resume wall time of in-place
        #: gang resizes (spot reclaim survived WITHOUT a restart). Charged
        #: as lost time like a restart, but in its own bucket so bench can
        #: publish resize_cost_s against the measured full-restart cost.
        self.resize_lost_s = 0.0
        self.rollbacks = 0
        self.restarts = 0
        self.resizes = 0
        #: window time since the last commit point — tentatively
        #: productive; a rollback reclassifies it as lost wholesale.
        self.uncommitted_s = 0.0

    # -- window -------------------------------------------------------------
    def reset_window(self) -> None:
        for p in PHASES:
            self.window[p] = 0.0
        self._window_steps = 0
        self._window_start = self.pc()

    def step_done(self) -> None:
        self._window_steps += 1

    def close_window(self) -> Dict[str, float]:
        """Settle the window at a report boundary (the caller has already
        blocked on the device, so the residual includes the jitted steps).
        Returns the window's phase fractions for the profiling report."""
        wall = max(self.pc() - self._window_start, 0.0)
        measured = sum(self.window.values())
        step_s = max(wall - measured, 0.0)
        # Denominator guards the clamp: measured sub-intervals can exceed
        # the wall reading by clock jitter; fractions must still sum to 1.
        denom = max(wall, measured)
        out: Dict[str, float] = {"window_s": wall}
        if denom > 0:
            for p in PHASES:
                self.phase_totals[p] += self.window[p]
                out[f"{p}_frac"] = self.window[p] / denom
            self.phase_totals["step"] += step_s
            out["step_frac"] = step_s / denom
            if self._window_steps:
                out["step_time_s"] = wall / self._window_steps
        self.uncommitted_s += wall
        self.reset_window()
        return out

    # -- ledger -------------------------------------------------------------
    def commit(self) -> None:
        """A checkpoint landed: everything since the previous commit is now
        durable — real goodput."""
        self.productive_s += self.uncommitted_s
        self.uncommitted_s = 0.0

    def on_rollback(self, restore_s: float) -> None:
        """Sentinel rollback: the uncommitted window time trained state the
        restore just discarded, and the restore itself is overhead."""
        lost = self.uncommitted_s + max(restore_s, 0.0)
        self.lost_s += lost
        self.rollback_lost_s += lost
        self.rollbacks += 1
        self.uncommitted_s = 0.0
        self.reset_window()

    def on_restart(self, gap_s: float) -> None:
        """Process restart resumed this ledger: the save→restore wall gap
        (crash, reschedule, stall-kill requeue) was not training."""
        gap = max(gap_s, 0.0)
        self.lost_s += gap
        self.restart_lost_s += gap
        self.restarts += 1

    def on_resize(self, gap_s: float) -> None:
        """Elastic resize resumed this ledger IN PLACE (same allocation,
        same process): the save→resume gap covers the drained window, the
        re-rendezvous and the reshard-restore — the whole drain→resume
        cost of surviving a reclaim, with the restart budget charged 0."""
        gap = max(gap_s, 0.0)
        self.lost_s += gap
        self.resize_lost_s += gap
        self.resizes += 1

    @property
    def goodput_pct(self) -> float:
        good = self.productive_s + self.uncommitted_s
        total = good + self.lost_s
        return 100.0 * good / total if total > 0 else 100.0

    # -- reporting / persistence ---------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        """Cumulative ledger view for the `profiling` metric group."""
        out: Dict[str, float] = {
            "goodput_pct": self.goodput_pct,
            "productive_s": self.productive_s + self.uncommitted_s,
            "lost_s": self.lost_s,
            "rollback_lost_s": self.rollback_lost_s,
            "restart_lost_s": self.restart_lost_s,
            "resize_lost_s": self.resize_lost_s,
            "ledger_rollbacks": float(self.rollbacks),
            "ledger_restarts": float(self.restarts),
            "ledger_resizes": float(self.resizes),
        }
        lifetime = sum(self.phase_totals.values())
        if lifetime > 0:
            for p in ALL_PHASES:
                out[f"total_{p}_frac"] = self.phase_totals[p] / lifetime
        return out

    def to_metadata(self, trial_id: int = 0) -> Dict[str, Any]:
        return {
            # Ledger owner: a warm-started FORK restores this checkpoint
            # under a different trial id and must start a fresh ledger —
            # inheriting the source's losses (and the save→fork wall gap)
            # would report garbage goodput for work it never did.
            "trial_id": int(trial_id),
            "productive_s": self.productive_s + self.uncommitted_s,
            "lost_s": self.lost_s,
            "rollback_lost_s": self.rollback_lost_s,
            "restart_lost_s": self.restart_lost_s,
            "resize_lost_s": self.resize_lost_s,
            "rollbacks": self.rollbacks,
            "restarts": self.restarts,
            "resizes": self.resizes,
            "phase_totals": dict(self.phase_totals),
            # wall-clock stamp: the resume charges save→restore as loss
            "saved_at": time.time(),
        }

    def load(
        self,
        md: Dict[str, Any],
        *,
        now: Optional[float] = None,
        trial_id: int = 0,
        event: str = "restart",
    ) -> None:
        """Resume the ledger from checkpoint metadata — SAME-TRIAL process
        restarts only. A trial-id mismatch (warm-started fork, continue
        into a new trial) keeps the fresh ledger: the new trial owes
        nothing to the source's history.

        `event` classifies the save→resume gap: "restart" (a new process
        resumed the trial) or "resize" (an elastic in-place resize —
        drain, re-rendezvous, reshard-restore — resumed it; its gap is
        the `resize_cost_s` bench publishes)."""
        try:
            if int(md.get("trial_id", 0)) != int(trial_id):
                return
            self.productive_s = float(md.get("productive_s", 0.0))
            self.lost_s = float(md.get("lost_s", 0.0))
            self.rollback_lost_s = float(md.get("rollback_lost_s", 0.0))
            self.restart_lost_s = float(md.get("restart_lost_s", 0.0))
            self.resize_lost_s = float(md.get("resize_lost_s", 0.0))
            self.rollbacks = int(md.get("rollbacks", 0))
            self.restarts = int(md.get("restarts", 0))
            self.resizes = int(md.get("resizes", 0))
            totals = md.get("phase_totals") or {}
            for p in ALL_PHASES:
                self.phase_totals[p] = float(totals.get(p, 0.0))
            self.uncommitted_s = 0.0
            saved_at = float(md.get("saved_at", 0.0))
            if saved_at:
                gap = (now if now is not None else time.time()) - saved_at
                if event == "resize":
                    self.on_resize(gap)
                else:
                    self.on_restart(gap)
            self.reset_window()
        except (TypeError, ValueError):
            pass  # corrupt ledger metadata must never block a restore
