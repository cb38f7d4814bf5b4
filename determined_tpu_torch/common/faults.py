"""Deterministic fault injection at named sites.

A copy of ``determined_tpu/common/faults.py``, trimmed to what the port's
storage layer and serving engine use. A ``FaultPlan`` maps **site names**
(``storage.upload``, ``serving.decode``, ...) to a ``FaultSpec`` that
says what goes wrong there:

- ``failures``: the first N calls at the site raise ``InjectedFault``;
- ``error_rate``: each call fails with this probability, drawn from a
  per-site ``random.Random`` seeded by ``(plan.seed, site)``, so the same
  plan fails the same calls in the same order;
- ``latency_s``: added delay per call;
- ``torn_writes``: the next N file uploads at the site write TRUNCATED
  bytes and then raise, the shape of a connection dying mid-upload. The
  retry layer overwrites with the full file; a process that dies instead
  leaves a torn object that the checkpoint manifest refuses to restore.

Plans install programmatically (``install`` / ``plan_active``). The
reference also reads a plan from the ``DTPU_FAULT_PLAN`` environment
variable for spawned task processes; the port has no task launcher yet
(the exec slice), so it does not. Instrumented sites are cheap when no
plan is active: one ``_plan is None`` check.
"""
from __future__ import annotations

import contextlib
import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

logger = logging.getLogger("determined_tpu_torch.faults")


class InjectedFault(OSError):
    """Raised by an instrumented site under an active FaultPlan.

    Subclasses OSError so the storage retry predicate treats it as the
    transient infrastructure failure it simulates.
    """

    def __init__(self, site: str, kind: str = "error") -> None:
        super().__init__(f"injected {kind} at {site}")
        self.site = site
        self.kind = kind


@dataclass
class FaultSpec:
    """What goes wrong at one site. All knobs compose."""

    failures: int = 0          # first N calls raise (deterministic)
    error_rate: float = 0.0    # per-call failure probability (seeded RNG)
    latency_s: float = 0.0     # added delay per call
    torn_writes: int = 0       # next N uploads write truncated bytes, then raise
    torn_fraction: float = 0.5  # fraction of bytes kept by a torn write
    max_failures: Optional[int] = None  # cap on error_rate failures (None = unlimited)


@dataclass
class _SiteState:
    calls: int = 0
    injected: int = 0
    torn: int = 0
    rng: random.Random = field(default_factory=random.Random)


class FaultPlan:
    """A reproducible failure matrix: {site: FaultSpec} + a seed.

    Site lookup is exact, with a ``"prefix.*"`` glob fallback (so
    ``"storage.*"`` covers upload/download/delete at once).
    """

    def __init__(self, sites: Dict[str, FaultSpec], seed: int = 0) -> None:
        self.sites = dict(sites)
        self.seed = seed
        self._state: Dict[str, _SiteState] = {}
        self._lock = threading.Lock()

    def _spec(self, site: str) -> Optional[FaultSpec]:
        spec = self.sites.get(site)
        if spec is not None:
            return spec
        for pattern, s in self.sites.items():
            if pattern.endswith(".*") and site.startswith(pattern[:-1]):
                return s
            if pattern == "*":
                return s
        return None

    def _site_state(self, site: str) -> _SiteState:
        st = self._state.get(site)
        if st is None:
            st = _SiteState(rng=random.Random(f"{self.seed}:{site}"))
            self._state[site] = st
        return st

    def decide(self, site: str) -> Optional[FaultSpec]:
        """Latency + failure decision for one call at `site`: applies the
        spec's latency, raises InjectedFault when this call is chosen to
        fail, and returns the matched spec (None when the plan does not
        instrument the site)."""
        spec = self._spec(site)
        if spec is None:
            return None
        with self._lock:
            st = self._site_state(site)
            st.calls += 1
            fail = False
            if st.injected < spec.failures:
                fail = True
            elif spec.error_rate > 0:
                # Always draw: the RNG sequence stays aligned with the call
                # sequence whatever the budget.
                draw = st.rng.random() < spec.error_rate
                budget_ok = spec.max_failures is None or st.injected < (
                    spec.failures + spec.max_failures
                )
                fail = draw and budget_ok
            if fail:
                st.injected += 1
        if spec.latency_s > 0:
            time.sleep(spec.latency_s)
        if fail:
            logger.debug("fault: injected error at %s", site)
            raise InjectedFault(site)
        return spec

    def take_torn_write(self, site: str) -> Optional[float]:
        """Consume one torn-write budget unit at `site`: the fraction of
        bytes to keep, or None when no torn write is scheduled."""
        spec = self._spec(site)
        if spec is None or spec.torn_writes <= 0:
            return None
        with self._lock:
            st = self._site_state(site)
            if st.torn >= spec.torn_writes:
                return None
            st.torn += 1
        logger.debug("fault: torn write at %s", site)
        return spec.torn_fraction

    def stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {
                site: {"calls": st.calls, "injected": st.injected, "torn": st.torn}
                for site, st in self._state.items()
            }


# -- module-level active plan -------------------------------------------------
_plan: Optional[FaultPlan] = None
_install_lock = threading.Lock()


def install(plan: Optional[FaultPlan]) -> None:
    """Activate `plan` (None deactivates)."""
    global _plan
    with _install_lock:
        _plan = plan


def clear() -> None:
    """Deactivate any plan."""
    install(None)


@contextlib.contextmanager
def plan_active(plan: FaultPlan) -> Iterator[FaultPlan]:
    """Install `plan` for the duration of a block."""
    install(plan)
    try:
        yield plan
    finally:
        clear()


def inject(site: str) -> None:
    """Instrumented-site hook: apply latency and possibly raise
    InjectedFault. No-op when no plan is active."""
    plan = _plan
    if plan is not None:
        plan.decide(site)


def torn_write(site: str) -> Optional[float]:
    """Instrumented-upload hook: the fraction of bytes to keep for a
    scheduled torn write at `site`, or None. The caller writes the
    truncated bytes and then raises InjectedFault(site, "torn write")."""
    plan = _plan
    if plan is None:
        return None
    return plan.take_torn_write(site)
