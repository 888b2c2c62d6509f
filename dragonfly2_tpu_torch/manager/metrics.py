"""Manager Prometheus metrics (reference: manager/metrics/metrics.go)."""

from __future__ import annotations

from dragonfly2_tpu_torch.utils.prom import CollectorRegistry, Counter, Gauge

NAMESPACE = "dragonfly"
SUBSYSTEM = "manager"


class ManagerMetrics:
    def __init__(self, version: str = ""):
        self.registry = CollectorRegistry()
        ns, sub = NAMESPACE, SUBSYSTEM
        self.request_count = Counter(
            "request_total", "REST requests, by method and outcome.",
            labelnames=("method", "status"),
            namespace=ns, subsystem=sub, registry=self.registry)
        self.keepalive_count = Counter(
            "keepalive_total", "Keepalive ticks accepted.",
            namespace=ns, subsystem=sub, registry=self.registry)
        self.model_created_count = Counter(
            "model_created_total", "Models ingested, by type.",
            labelnames=("type",),
            namespace=ns, subsystem=sub, registry=self.registry)
        self.search_scheduler_cluster_count = Counter(
            "search_scheduler_cluster_total", "Searcher invocations.",
            namespace=ns, subsystem=sub, registry=self.registry)
        self.version = Gauge(
            "version", "Version info of the service.",
            labelnames=("version",),
            namespace=ns, subsystem=sub, registry=self.registry)
        if version:
            self.version.labels(version=version).set(1)
