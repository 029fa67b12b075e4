"""Dependency-free Prometheus-style metrics: Counter / Gauge / Histogram.

The port's copy of ``tpustack/obs/metrics.py``: the same classes, the same
``Registry`` and the same Prometheus text exposition (format 0.0.4), so a
scrape of a port server reads byte for byte as a scrape of the JAX one for
the same sequence of metric operations.  Engine and handler threads mutate
the same families, hence the per-family lock.

Conventions (those of the JAX catalog): every name is ``tpustack_*``
snake_case with a unit suffix; counters end in ``_total``; label values
are free-form but label NAMES are fixed per family at registration.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: default latency buckets (seconds): sub-ms HTTP plumbing up to the
#: multi-minute cold-compile tail a TPU serving pod can legitimately hit
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _fmt(v: float) -> str:
    """Prometheus sample-value formatting: integers without the trailing
    .0, +Inf spelled the Prometheus way, floats via repr (full precision)."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if isinstance(v, float) and v.is_integer() and abs(v) < 2**53:
        return str(int(v))
    return repr(float(v)) if isinstance(v, float) else str(v)


def _escape(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _render_labels(names: Sequence[str], values: Sequence[str],
                   extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


class _Family:
    """One metric family: fixed name/help/label-names, N labelled children.

    ``labels(**kw)`` (or positionally ``labels(*values)``) returns the child
    for that label combination, creating it on first use.  A label-less
    family is its own single child.  All mutation goes through ``self._lock``
    — engine and handler threads share these objects.
    """

    type: str = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            self._children[()] = self._make_child()

    def _make_child(self):
        raise NotImplementedError

    def _label_values(self, values, kw) -> Tuple[str, ...]:
        if kw:
            if values:
                raise ValueError("pass label values positionally OR by name")
            try:
                values = tuple(str(kw.pop(n)) for n in self.labelnames)
            except KeyError as e:
                raise ValueError(f"{self.name}: missing label {e}") from None
            if kw:
                raise ValueError(f"{self.name}: unknown labels {sorted(kw)}")
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, got {values}")
        return values

    def labels(self, *values, **kw):
        values = self._label_values(values, kw)
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._make_child()
            return child

    def _iter_children(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())

    # -- rendering
    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {_escape(self.help)}",
                 f"# TYPE {self.name} {self.type}"]
        for values, child in self._iter_children():
            lines.extend(child.render_samples(self, values))
        return lines


class _CounterValue:
    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._v += amount

    @property
    def value(self) -> float:
        return self._v

    def render_samples(self, fam: _Family, values) -> List[str]:
        return [f"{fam.name}{_render_labels(fam.labelnames, values)} "
                f"{_fmt(self._v)}"]


class Counter(_Family):
    type = "counter"

    def _make_child(self):
        return _CounterValue()

    # label-less convenience
    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    @property
    def value(self) -> float:
        return self.labels().value


class _GaugeValue:
    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._v = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._v += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._v

    def render_samples(self, fam: _Family, values) -> List[str]:
        return [f"{fam.name}{_render_labels(fam.labelnames, values)} "
                f"{_fmt(self._v)}"]


class Gauge(_Family):
    type = "gauge"

    def _make_child(self):
        return _GaugeValue()

    def set(self, value: float) -> None:
        self.labels().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self.labels().dec(amount)

    @property
    def value(self) -> float:
        return self.labels().value


class _HistogramValue:
    __slots__ = ("_bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(self, bounds: Sequence[float]):
        self._bounds = tuple(bounds)
        self._counts = [0] * (len(bounds) + 1)  # last = +Inf overflow
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        idx = bisect.bisect_left(self._bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def render_samples(self, fam: _Family, values) -> List[str]:
        with self._lock:
            counts, total, s = list(self._counts), self._count, self._sum
        lines, cum = [], 0
        for bound, c in zip(fam.buckets + (math.inf,), counts):
            cum += c
            lbl = _render_labels(fam.labelnames, values,
                                 extra=(("le", _fmt(bound)),))
            lines.append(f"{fam.name}_bucket{lbl} {cum}")
        lbl = _render_labels(fam.labelnames, values)
        lines.append(f"{fam.name}_sum{lbl} {_fmt(s)}")
        lines.append(f"{fam.name}_count{lbl} {total}")
        return lines


class Histogram(_Family):
    type = "histogram"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        buckets = DEFAULT_BUCKETS if buckets is None else tuple(buckets)
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"{name}: buckets must be ascending, non-empty")
        if any(b == math.inf for b in buckets):
            raise ValueError(f"{name}: +Inf bucket is implicit")
        self.buckets = tuple(float(b) for b in buckets)
        super().__init__(name, help, labelnames)

    def _make_child(self):
        return _HistogramValue(self.buckets)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    @property
    def count(self) -> int:
        return self.labels().count

    @property
    def sum(self) -> float:
        return self.labels().sum


class Registry:
    """Holds metric families plus scrape-time collector callbacks.

    ``counter``/``gauge``/``histogram`` are get-or-create: a second call
    with the same name returns the existing family (and raises if the type
    or labelnames disagree) so the serving modules and the catalog can both
    reference a metric without import-order coupling.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}
        self._collectors: List = []

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name} re-registered with a different "
                        f"type/labels ({fam.type}{fam.labelnames} vs "
                        f"{cls.type}{tuple(labelnames)})")
                return fam
            fam = cls(name, help, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str, labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames, buckets=buckets)

    def add_collector(self, fn) -> None:
        """``fn(registry)`` runs at every render — refresh gauges whose truth
        lives elsewhere (device HBM, cache-dir sizes) only when scraped."""
        with self._lock:
            self._collectors.append(fn)

    def families(self) -> List[_Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def render(self) -> str:
        for fn in list(self._collectors):
            try:
                fn(self)
            except Exception:  # a broken collector must never fail a scrape
                pass
        lines: List[str] = []
        for fam in self.families():
            lines.extend(fam.render())
        return "\n".join(lines) + "\n"

    # -- test helpers
    def get_sample_value(self, name: str,
                         labels: Optional[Dict[str, str]] = None):
        """Value of one sample, or None — mirrors prometheus_client's
        helper so tests read counters without parsing exposition text."""
        base = name
        for suffix in ("_total", "_sum", "_count", "_bucket"):
            if name.endswith(suffix) and name[:-len(suffix)] in self._families:
                base = name[:-len(suffix)]
                break
        fam = self._families.get(base) or self._families.get(name)
        if fam is None:
            return None
        labels = dict(labels or {})
        le = labels.pop("le", None)
        try:
            child = fam.labels(**labels) if labels or fam.labelnames else fam.labels()
        except ValueError:
            return None
        if isinstance(child, _HistogramValue):
            if name.endswith("_sum"):
                return child.sum
            if name.endswith("_count"):
                return child.count
            if le is not None:
                bound = math.inf if le in ("+Inf", "inf") else float(le)
                cum = 0
                for b, c in zip(fam.buckets + (math.inf,), child._counts):
                    cum += c
                    if b == bound:
                        return cum
                return None
            return child.count
        return child.value


#: process-wide default registry — servers and jobs share it so one
#: /metrics endpoint exposes every subsystem loaded in the process
REGISTRY = Registry()
