"""Prometheus metrics and their text exposition, on the standard library.

The port's stand-in for the part of ``prometheus_client`` that the
services use, which the card machine does not have: a
:class:`CollectorRegistry` of metrics and custom collectors (objects with
``collect()``), :class:`Counter`, :class:`Gauge` and :class:`Histogram`
with ``labels()`` and the constructor arguments of ``prometheus_client``
(``labelnames``, ``namespace``, ``subsystem``, ``registry``,
``buckets``), :class:`GaugeMetricFamily` for custom collectors, and
:func:`generate_latest`, which writes text format 0.0.4 as
``prometheus_client`` writes it: ``# HELP`` and ``# TYPE`` lines,
escaped label values in sorted label order, cumulative ``_bucket``
samples with an ``le`` label up to ``+Inf`` then ``_count`` and
``_sum``, and numbers in Go's float format.

A counter's family name drops a trailing ``_total`` and its sample is
that name with ``_total`` appended, whatever it was declared as (a
counter declared ``traffic_bytes`` is exposed as
``traffic_bytes_total``), as ``prometheus_client`` does. The
``_created`` series that ``prometheus_client`` adds are not written.

``get()`` reads a counter's or a gauge's value (or a child's, after
``labels()``) in the process.
"""

from __future__ import annotations

import copy
import math
import threading
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"

INF = float("inf")


class Sample(NamedTuple):
    name: str
    labels: Dict[str, str]
    value: float


class Metric:
    """One family as a collector yields it: name, type, help, samples."""

    def __init__(self, name: str, documentation: str, typ: str):
        self.name = name
        self.documentation = documentation
        self.type = typ
        self.samples: List[Sample] = []

    def add_sample(self, name: str, labels: Dict[str, str],
                   value: float) -> None:
        self.samples.append(Sample(name, labels, value))


class GaugeMetricFamily(Metric):
    """A gauge family for custom collectors; ``labels`` names the label
    values that each :meth:`add_metric` call gives in order."""

    def __init__(self, name: str, documentation: str,
                 labels: Optional[Sequence[str]] = None):
        super().__init__(name, documentation, "gauge")
        self._labelnames = tuple(labels or ())

    def add_metric(self, labels: Sequence[str], value: float) -> None:
        self.add_sample(self.name, dict(zip(self._labelnames, labels)),
                        value)


class CollectorRegistry:
    """The collectors of one endpoint, collected in registration order."""

    def __init__(self):
        self._lock = threading.Lock()
        self._collectors: List[object] = []
        self._names: Dict[str, object] = {}

    def register(self, collector) -> None:
        names = tuple(getattr(collector, "_exposed_names", lambda: ())())
        with self._lock:
            taken = [n for n in names if n in self._names]
            if taken:
                raise ValueError(f"Duplicated timeseries in "
                                 f"CollectorRegistry: {taken}")
            for n in names:
                self._names[n] = collector
            self._collectors.append(collector)

    def unregister(self, collector) -> None:
        with self._lock:
            self._collectors.remove(collector)
            self._names = {n: c for n, c in self._names.items()
                           if c is not collector}

    def collect(self) -> Iterable[Metric]:
        with self._lock:
            collectors = list(self._collectors)
        for collector in collectors:
            yield from collector.collect()


class _Value:
    """One number under a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float) -> None:
        with self._lock:
            self._value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def get(self) -> float:
        with self._lock:
            return self._value


class _MetricBase:
    """A family with or without labels. A family with ``labelnames``
    holds one child a label set, made by :meth:`labels`; one without is
    its own single series."""

    _type = ""

    def __init__(self, name: str, documentation: str, labelnames=(),
                 namespace: str = "", subsystem: str = "",
                 registry: Optional[CollectorRegistry] = None):
        full = "_".join(p for p in (namespace, subsystem, name) if p)
        if self._type == "counter" and full.endswith("_total"):
            full = full[:-len("_total")]
        self._name = full
        self._documentation = documentation
        self._labelnames = tuple(labelnames)
        self._labelvalues: Tuple[str, ...] = ()
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], "_MetricBase"] = {}
        if not self._is_parent():
            self._init_series()
        if registry is not None:
            registry.register(self)

    def _is_parent(self) -> bool:
        return bool(self._labelnames) and not self._labelvalues

    def labels(self, **labels) -> "_MetricBase":
        if sorted(labels) != sorted(self._labelnames):
            raise ValueError(f"{self._name} has labels "
                             f"{self._labelnames}, not {sorted(labels)}")
        values = tuple(str(labels[n]) for n in self._labelnames)
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._child(values)
            return child

    def _child(self, values: Tuple[str, ...]) -> "_MetricBase":
        child = copy.copy(self)
        child._labelvalues = values
        child._lock = threading.Lock()
        child._children = {}
        child._init_series()
        return child

    def _init_series(self) -> None:
        self._value = _Value()

    def _exposed_names(self) -> Tuple[str, ...]:
        return (self._name,)

    def _require_series(self) -> None:
        if self._is_parent():
            raise ValueError(f"{self._name} has labels: call labels() first")

    def get(self) -> float:
        self._require_series()
        return self._value.get()

    def _series_samples(self) -> List[Tuple[str, Dict[str, str], float]]:
        raise NotImplementedError

    def collect(self) -> List[Metric]:
        family = Metric(self._name, self._documentation, self._type)
        if self._is_parent():
            with self._lock:
                children = list(self._children.items())
        else:
            children = [((), self)]
        for values, child in children:
            base = dict(zip(self._labelnames, values))
            for suffix, labels, value in child._series_samples():
                family.add_sample(self._name + suffix, {**base, **labels},
                                  value)
        return [family]


class Counter(_MetricBase):
    """A total that only goes up."""

    _type = "counter"

    def inc(self, amount: float = 1.0) -> None:
        self._require_series()
        if amount < 0:
            raise ValueError("Counters can only be incremented by "
                             "non-negative amounts.")
        self._value.inc(amount)

    def _series_samples(self):
        return [("_total", {}, self._value.get())]


class Gauge(_MetricBase):
    """A value that goes up and down, or is set."""

    _type = "gauge"

    def inc(self, amount: float = 1.0) -> None:
        self._require_series()
        self._value.inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._require_series()
        self._value.inc(-amount)

    def set(self, value: float) -> None:
        self._require_series()
        self._value.set(value)

    def _series_samples(self):
        return [("", {}, self._value.get())]


class Histogram(_MetricBase):
    """Observations counted into cumulative buckets, with their sum."""

    _type = "histogram"

    def __init__(self, name: str, documentation: str, labelnames=(),
                 namespace: str = "", subsystem: str = "",
                 registry: Optional[CollectorRegistry] = None, *,
                 buckets: Sequence[float]):
        bounds = sorted(float(b) for b in buckets)
        if bounds[-1] != INF:
            bounds.append(INF)
        self._upper_bounds = bounds
        super().__init__(name, documentation, labelnames, namespace,
                         subsystem, registry)

    def _init_series(self) -> None:
        self._series_lock = threading.Lock()
        self._counts = [0.0] * len(self._upper_bounds)
        self._sum = 0.0

    def _exposed_names(self) -> Tuple[str, ...]:
        return (self._name, self._name + "_bucket", self._name + "_count",
                self._name + "_sum")

    def observe(self, amount: float) -> None:
        self._require_series()
        with self._series_lock:
            self._sum += amount
            for i, bound in enumerate(self._upper_bounds):
                if amount <= bound:
                    self._counts[i] += 1
                    break

    def _series_samples(self):
        with self._series_lock:
            counts, total = list(self._counts), self._sum
        out, acc = [], 0.0
        for bound, n in zip(self._upper_bounds, counts):
            acc += n
            out.append(("_bucket", {"le": float_to_go_string(bound)}, acc))
        out.append(("_count", {}, acc))
        out.append(("_sum", {}, total))
        return out


def float_to_go_string(d) -> str:
    """A float as Go's strconv writes it (``prometheus_client``'s
    ``floatToGoString``): ``+Inf``, ``-Inf``, ``NaN``, else Python's
    repr, in exponent form once a positive number has over six digits
    before the point."""
    d = float(d)
    if d == INF:
        return "+Inf"
    if d == -INF:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label_value(text: str) -> str:
    return (text.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r"\""))


def _sample_line(sample: Sample) -> str:
    labels = ""
    if sample.labels:
        labels = "{" + ",".join(
            f'{k}="{_escape_label_value(str(v))}"'
            for k, v in sorted(sample.labels.items())) + "}"
    return f"{sample.name}{labels} {float_to_go_string(sample.value)}\n"


def generate_latest(registry: CollectorRegistry) -> bytes:
    """Every family of ``registry`` in Prometheus text format 0.0.4."""
    out = []
    for family in registry.collect():
        name, typ = family.name, family.type
        if typ == "counter":
            name += "_total"
        elif typ == "unknown":
            typ = "untyped"
        out.append(f"# HELP {name} {_escape_help(family.documentation)}\n")
        out.append(f"# TYPE {name} {typ}\n")
        out.extend(_sample_line(s) for s in family.samples)
    return "".join(out).encode("utf-8")
