"""Daemon (dfdaemon) Prometheus metrics.

Reference counterpart: client/daemon/metrics/metrics.go — proxy request
counts, piece/task download outcomes, and traffic split by seed-peer vs
peer role. Private registry per daemon instance (many daemons share a
process in the harness).
"""

from __future__ import annotations

from dragonfly2_tpu_torch.utils.prom import CollectorRegistry, Counter, Gauge

NAMESPACE = "dragonfly"
SUBSYSTEM = "dfdaemon"


class DaemonMetrics:
    def __init__(self, version: str = ""):
        self.registry = CollectorRegistry()
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
