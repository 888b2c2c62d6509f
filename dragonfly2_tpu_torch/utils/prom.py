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
``labels()``) in the process. :func:`text_string_to_metric_families`
reads the text format back into families as ``prometheus_client.parser``
does.
"""

from __future__ import annotations

import copy
import math
import re
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


_LABEL_RE = re.compile(r'\s*([a-zA-Z_][a-zA-Z0-9_]*)\s*=\s*"((?:[^"\\]|\\.)*)"\s*,?')
_ESCAPES = {"\\\\": "\\", "\\n": "\n", '\\"': '"'}


def _unescape(text: str, pattern: str) -> str:
    return re.sub(pattern, lambda m: _ESCAPES[m.group(0)], text)


def _parse_value(text: str):
    """A sample value as ``prometheus_client``'s parser gives it: an int
    where the text is one, else a float."""
    try:
        return int(text)
    except ValueError:
        return float(text)


def _parse_sample(line: str) -> Sample:
    brace = line.find("{")
    space = min((i for i in (line.find(" "), line.find("\t")) if i >= 0),
                default=-1)
    labels: Dict[str, str] = {}
    if brace >= 0 and (space < 0 or brace < space):
        name = line[:brace].strip()
        pos = brace + 1
        while True:
            while pos < len(line) and line[pos] in " \t,":
                pos += 1
            if line.startswith("}", pos):
                break
            m = _LABEL_RE.match(line, pos)
            if m is None:
                raise ValueError(f"Invalid labels: {line}")
            if m.group(1) in labels:
                raise ValueError(f"duplicate label name: {line}")
            labels[m.group(1)] = _unescape(m.group(2), r'\\[\\n"]')
            pos = m.end()
        rest = line[pos + 1:]
    else:
        if space < 0:
            raise ValueError(f"no value: {line}")
        name, rest = line[:space], line[space + 1:]
    values = rest.split()
    if not values:
        raise ValueError(f"no value: {line}")
    return Sample(name, labels, _parse_value(values[0]))


def _family(name: str, documentation: str, typ: str,
            samples: List[Sample]) -> Metric:
    if typ == "counter":
        if name.endswith("_total"):
            name = name[:-6]
        else:
            samples = [Sample(s.name + "_total", s.labels, s.value)
                       for s in samples]
    family = Metric(name, documentation,
                    "unknown" if typ == "untyped" else typ)
    family.samples = samples
    return family


_ALLOWED_SUFFIXES = {"summary": ("_count", "_sum", ""),
                     "histogram": ("_count", "_sum", "_bucket")}


def text_string_to_metric_families(text: str) -> Iterable[Metric]:
    """The families of a text-format exposition, grouped and named as
    ``prometheus_client.parser.text_string_to_metric_families`` groups
    and names them: a ``# HELP`` or ``# TYPE`` line opens a family, a
    counter's family drops its ``_total`` (its samples keep it), and a
    sample outside the open family's names is a family of its own."""
    name, documentation, typ = "", "", "untyped"
    samples: List[Sample] = []
    allowed: List[str] = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                continue
            candidate = parts[2]
            if parts[1] == "HELP":
                if candidate != name:
                    if name:
                        yield _family(name, documentation, typ, samples)
                    name, typ, samples = candidate, "untyped", []
                    allowed = [candidate]
                documentation = (_unescape(parts[3], r"\\[\\n]")
                                 if len(parts) == 4 else "")
            else:
                if len(parts) < 4:
                    raise ValueError(f"TYPE without a type: {line}")
                if candidate != name:
                    if name:
                        yield _family(name, documentation, typ, samples)
                    name, documentation, samples = candidate, "", []
                typ = parts[3]
                allowed = [name + suffix for suffix in
                           _ALLOWED_SUFFIXES.get(typ, ("",))]
        elif line:
            sample = _parse_sample(line)
            if sample.name in allowed:
                samples.append(sample)
                continue
            if name:
                yield _family(name, documentation, typ, samples)
            name, documentation, typ, samples, allowed = (
                "", "", "untyped", [], [])
            yield _family(sample.name, "", "untyped", [sample])
    if name:
        yield _family(name, documentation, typ, samples)
