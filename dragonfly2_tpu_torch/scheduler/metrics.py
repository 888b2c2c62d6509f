"""Scheduler Prometheus metrics.

Reference counterpart: scheduler/metrics/metrics.go:46-273 — the namespace
(``dragonfly``), subsystem (``scheduler``), and the core counter/histogram
set are kept: peer registration and announce traffic, download outcomes
with a duration histogram, probe sync counts, schedule latency, traffic by
type, and the version-info gauge. Cluster-state gauges (host/task/peer
counts) are custom collectors over the live resource managers instead of
mutated counters.
"""

from __future__ import annotations

from dragonfly2_tpu_torch.utils.prom import (
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
)
from dragonfly2_tpu_torch.utils.prom import GaugeMetricFamily

NAMESPACE = "dragonfly"
SUBSYSTEM = "scheduler"


class _ResourceCollector:
    """Live host/task/peer gauges read from the resource managers."""

    def __init__(self, resource):
        self._resource = resource

    def collect(self):
        for name, manager in (
            ("hosts", self._resource.host_manager),
            ("tasks", self._resource.task_manager),
            ("peers", self._resource.peer_manager),
        ):
            g = GaugeMetricFamily(
                f"{NAMESPACE}_{SUBSYSTEM}_resource_{name}",
                f"Number of live {name} in the resource model.",
            )
            g.add_metric([], len(manager))
            yield g

    def describe(self):
        return []


class SchedulerMetrics:
    def __init__(self, resource=None, version: str = ""):
        self.registry = CollectorRegistry()
        ns, sub = NAMESPACE, SUBSYSTEM
        self.register_peer_count = Counter(
            "register_peer_total", "RegisterPeer requests.",
            namespace=ns, subsystem=sub, registry=self.registry)
        self.register_peer_failure = Counter(
            "register_peer_failure_total", "Failed RegisterPeer requests.",
            namespace=ns, subsystem=sub, registry=self.registry)
        self.announce_peer_count = Counter(
            "announce_peer_total", "AnnouncePeer stream messages.",
            namespace=ns, subsystem=sub, registry=self.registry)
        self.download_peer_finished = Counter(
            "download_peer_finished_total", "Finished peer downloads.",
            namespace=ns, subsystem=sub, registry=self.registry)
        self.download_peer_failure = Counter(
            "download_peer_finished_failure_total", "Failed peer downloads.",
            namespace=ns, subsystem=sub, registry=self.registry)
        self.download_peer_duration = Histogram(
            "download_peer_duration_milliseconds",
            "Peer download duration in ms.",
            namespace=ns, subsystem=sub, registry=self.registry,
            buckets=(100, 200, 500, 1000, 3000, 5000, 10000, 20000, 60000,
                     120000, 300000))
        self.schedule_duration = Histogram(
            "schedule_duration_seconds",
            "Parent-scheduling latency per attempt.",
            namespace=ns, subsystem=sub, registry=self.registry,
            buckets=(.0001, .00025, .0005, .001, .0025, .005, .01, .025,
                     .05, .1, .25, .5, 1.0))
        self.sync_probes_count = Counter(
            "sync_probes_total", "SyncProbes stream messages.",
            namespace=ns, subsystem=sub, registry=self.registry)
        self.probes_stored = Counter(
            "probes_stored_total", "Probe results stored in the topology.",
            namespace=ns, subsystem=sub, registry=self.registry)
        self.traffic = Counter(
            "traffic_bytes", "Download traffic by type.",
            labelnames=("type",),
            namespace=ns, subsystem=sub, registry=self.registry)
        self.announce_host_count = Counter(
            "announce_host_total", "AnnounceHost requests.",
            namespace=ns, subsystem=sub, registry=self.registry)
        self.leave_host_count = Counter(
            "leave_host_total", "LeaveHost requests.",
            namespace=ns, subsystem=sub, registry=self.registry)
        self.version = Gauge(
            "version", "Version info of the service.",
            labelnames=("version",),
            namespace=ns, subsystem=sub, registry=self.registry)
        if version:
            self.version.labels(version=version).set(1)
        if resource is not None:
            self.registry.register(_ResourceCollector(resource))
