"""Metrics registry: Counter/Gauge/Histogram with Prometheus exposition.

A copy of ``determined_tpu/common/metrics.py``, trimmed to what the
serving engine, the page pool and the ``/metrics`` route use:

- ``Counter`` (monotone, ``inc``), ``Gauge`` (``set``/``inc``/``dec``),
  ``Histogram`` (cumulative ``le`` buckets + ``_sum``/``_count``, with the
  last exemplar per bucket), all with label support;
- a process-global ``REGISTRY`` with get-or-create semantics (import
  order does not matter) and a hard error on a name re-registered as a
  different type, label set or bucket layout;
- text exposition in the Prometheus 0.0.4 format: ``# HELP``/``# TYPE``
  lines, label escaping, no ``{}`` on label-less samples, and exemplars as
  ``# EXEMPLAR`` comment lines that a strict parser skips.

The reference's strict exposition parser and the query helpers stay
there; the port's tests parse this module's output with it.
"""
from __future__ import annotations

import math
import re
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Default latency buckets (seconds); the +Inf bucket is implicit.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_text(pairs: Sequence[Tuple[str, str]]) -> str:
    """`{a="x",b="y"}`, or the empty string for no labels (a bare `{}`
    is invalid under a strict parser)."""
    if not pairs:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(str(v))}"' for k, v in pairs
    )
    return "{" + inner + "}"


def _exemplar_line(series: str, ex: Tuple[str, float, float]) -> str:
    """One exemplar as a comment line the 0.0.4 text format tolerates:
    `# EXEMPLAR <series> <trace_id> <value> <ts>`."""
    trace_id, value, ts = ex
    return (
        f"# EXEMPLAR {series} {trace_id} {_fmt_value(value)} "
        f"{repr(float(ts))}"
    )


class _Child:
    """One labeled series of a family (or the single series of a
    label-less family)."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _CounterChild(_Child):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount


class _GaugeChild(_Child):
    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount


class _HistogramChild:
    __slots__ = ("_lock", "_buckets", "_counts", "_sum", "_count",
                 "_exemplars")

    def __init__(self, buckets: Tuple[float, ...]) -> None:
        self._lock = threading.Lock()
        self._buckets = buckets
        self._counts = [0] * len(buckets)
        self._sum = 0.0
        self._count = 0
        # Last exemplar per bucket (index len(buckets) = +Inf):
        # (trace_id, observed value, unix ts).
        self._exemplars: List[Optional[Tuple[str, float, float]]] = (
            [None] * (len(buckets) + 1)
        )

    def observe(self, value: float, trace_id: Optional[str] = None) -> None:
        with self._lock:
            self._sum += value
            self._count += 1
            # Per-bucket tally; render() emits the cumulative `le` series.
            idx = len(self._buckets)
            for i, b in enumerate(self._buckets):
                if value <= b:
                    self._counts[i] += 1
                    idx = i
                    break
            if trace_id:
                self._exemplars[idx] = (
                    str(trace_id), float(value), time.time()
                )

    def snapshot(self) -> Tuple[List[int], float, int]:
        with self._lock:
            return list(self._counts), self._sum, self._count

    def exemplars_snapshot(self) -> List[Optional[Tuple[str, float, float]]]:
        with self._lock:
            return list(self._exemplars)


class _Family:
    """A named metric family: help text, type, label names, children."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...]):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._children: Dict[Tuple[str, ...], Any] = {}
        self._lock = threading.Lock()
        if not labelnames:
            # A label-less family scrapes as 0 before it first fires, not
            # as absent (absence would read as "not instrumented").
            self._children[()] = self._new_child()

    def _new_child(self) -> Any:
        raise NotImplementedError

    def labels(self, *values: Any) -> Any:
        vals = tuple(str(v) for v in values)
        if len(vals) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got {vals}"
            )
        with self._lock:
            child = self._children.get(vals)
            if child is None:
                child = self._new_child()
                self._children[vals] = child
            return child

    def _default_child(self) -> Any:
        return self.labels()

    def _iter_children(self) -> List[Tuple[Tuple[str, ...], Any]]:
        with self._lock:
            return list(self._children.items())

    def render(self, exemplars: bool = False) -> List[str]:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} {self.kind}",
        ]
        for vals, child in sorted(self._iter_children()):
            pairs = list(zip(self.labelnames, vals))
            lines.append(
                f"{self.name}{_labels_text(pairs)} {_fmt_value(child.value)}"
            )
        return lines


class Counter(_Family):
    kind = "counter"

    def _new_child(self) -> _CounterChild:
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class Gauge(_Family):
    kind = "gauge"

    def _new_child(self) -> _GaugeChild:
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default_child().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default_child().dec(amount)

    @property
    def value(self) -> float:
        return self._default_child().value


class Histogram(_Family):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        labelnames: Tuple[str, ...],
        buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
    ) -> None:
        b = tuple(sorted(float(x) for x in buckets))
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"buckets must be strictly increasing on {name}")
        self.buckets = b
        super().__init__(name, help, labelnames)

    def _new_child(self) -> _HistogramChild:
        return _HistogramChild(self.buckets)

    def observe(self, value: float, trace_id: Optional[str] = None) -> None:
        self._default_child().observe(value, trace_id=trace_id)

    def render(self, exemplars: bool = False) -> List[str]:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} {self.kind}",
        ]
        for vals, child in sorted(self._iter_children()):
            pairs = list(zip(self.labelnames, vals))
            counts, total, count = child.snapshot()
            exs = child.exemplars_snapshot() if exemplars else None
            bounds = [_fmt_value(b) for b in self.buckets] + ["+Inf"]
            cums = [sum(counts[:i + 1]) for i in range(len(counts))] + [count]
            for i, (le, cum) in enumerate(zip(bounds, cums)):
                series = (
                    f"{self.name}_bucket{_labels_text(pairs + [('le', le)])}"
                )
                lines.append(f"{series} {cum}")
                if exs is not None and exs[i] is not None:
                    lines.append(_exemplar_line(series, exs[i]))
            lines.append(
                f"{self.name}_sum{_labels_text(pairs)} {_fmt_value(total)}"
            )
            lines.append(f"{self.name}_count{_labels_text(pairs)} {count}")
        return lines


class MetricsRegistry:
    """Name → family map with get-or-create registration: the same
    name with the same kind, labels and buckets returns the existing
    family; a mismatch raises (each name is defined exactly once)."""

    def __init__(self) -> None:
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls: type, name: str, help: str,
                       labels: Sequence[str], **kw: Any) -> Any:
        labelnames = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if (
                    type(fam) is not cls
                    or fam.labelnames != labelnames
                    or (
                        "buckets" in kw
                        and tuple(sorted(float(b) for b in kw["buckets"]))
                        != getattr(fam, "buckets", None)
                    )
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(fam).__name__}{fam.labelnames} — each name "
                        "is defined exactly once (same kind, labels, and "
                        "buckets)"
                    )
                return fam
            fam = cls(name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str,
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str,
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str, labels: Sequence[str] = (),
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._families)

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def render(self, exemplars: bool = False) -> str:
        with self._lock:
            fams = [self._families[n] for n in sorted(self._families)]
        out: List[str] = []
        for fam in fams:
            out.extend(fam.render(exemplars=exemplars))
        return "\n".join(out) + "\n"


#: The process-global registry; the serving process serves it from its
#: /metrics route.
REGISTRY = MetricsRegistry()
