"""Daemon (dfdaemon) metrics.

Reference counterpart: client/daemon/metrics/metrics.go — proxy request
counts, piece/task download outcomes, and traffic split by seed-peer vs
peer role. Private registry per daemon instance (many daemons share a
process in the harness).

Port of ``dragonfly2_tpu/client/metrics.py`` without ``prometheus_client``,
which the port does not import: the same families, names and labels as
in-process counters and gauges (``inc``, ``dec``, ``set``, ``labels``,
and ``get`` to read one). ``registry`` maps each family's full name to
it; the port has no Prometheus exposition.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

NAMESPACE = "dragonfly"
SUBSYSTEM = "dfdaemon"


class _Value:
    """One series: a float under a lock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def get(self) -> float:
        with self._lock:
            return self._value


class Counter(_Value):
    """A counter family; with ``labelnames``, one series per label set."""

    def __init__(self, name: str, documentation: str, labelnames=(),
                 namespace: str = "", subsystem: str = "",
                 registry: Dict[str, object] | None = None):
        super().__init__()
        self.name = "_".join(p for p in (namespace, subsystem, name) if p)
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], _Value] = {}
        if registry is not None:
            registry[self.name] = self

    def labels(self, **labels) -> "_Value":
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = type(self)._child()
            return child

    @staticmethod
    def _child() -> _Value:
        return _Value()


class _GaugeValue(_Value):
    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)


class Gauge(Counter, _GaugeValue):
    """A gauge family: a counter that can also go down or be set."""

    @staticmethod
    def _child() -> _Value:
        return _GaugeValue()


class DaemonMetrics:
    def __init__(self, version: str = ""):
        self.registry: Dict[str, object] = {}
        ns, sub = NAMESPACE, SUBSYSTEM
        self.download_task_count = Counter(
            "download_task_total", "Started download tasks.",
            namespace=ns, subsystem=sub, registry=self.registry)
        self.download_task_failure = Counter(
            "download_task_failure_total", "Failed download tasks.",
            namespace=ns, subsystem=sub, registry=self.registry)
        self.download_traffic = Counter(
            "download_traffic_bytes", "Bytes downloaded, by source type.",
            labelnames=("type",),  # p2p | back_to_source | reuse
            namespace=ns, subsystem=sub, registry=self.registry)
        self.upload_piece_count = Counter(
            "upload_piece_total", "Pieces served to child peers.",
            namespace=ns, subsystem=sub, registry=self.registry)
        self.upload_traffic = Counter(
            "upload_traffic_bytes", "Bytes uploaded to child peers.",
            namespace=ns, subsystem=sub, registry=self.registry)
        self.proxy_request_count = Counter(
            "proxy_request_total", "Proxy requests, by routing.",
            labelnames=("via",),  # mesh | direct | tunnel
            namespace=ns, subsystem=sub, registry=self.registry)
        self.probe_count = Counter(
            "probe_total", "Network-topology probes sent, by outcome.",
            labelnames=("outcome",),  # ok | failed
            namespace=ns, subsystem=sub, registry=self.registry)
        self.concurrent_tasks = Gauge(
            "concurrent_tasks", "Currently running peer tasks.",
            namespace=ns, subsystem=sub, registry=self.registry)
        self.version = Gauge(
            "version", "Version info of the service.",
            labelnames=("version",),
            namespace=ns, subsystem=sub, registry=self.registry)
        if version:
            self.version.labels(version=version).set(1)
