"""Trainer Prometheus metrics (reference: trainer/metrics/metrics.go)."""

from __future__ import annotations

from dragonfly2_tpu_torch.utils.prom import CollectorRegistry, Counter, Gauge, Histogram

NAMESPACE = "dragonfly"
SUBSYSTEM = "trainer"


class TrainerMetrics:
    def __init__(self, version: str = ""):
        self.registry = CollectorRegistry()
        ns, sub = NAMESPACE, SUBSYSTEM
        self.train_request_count = Counter(
            "train_request_total", "Train streams accepted.",
            namespace=ns, subsystem=sub, registry=self.registry)
        self.train_request_failure = Counter(
            "train_request_failure_total", "Train streams aborted.",
            namespace=ns, subsystem=sub, registry=self.registry)
        self.dataset_bytes = Counter(
            "dataset_bytes", "Dataset bytes ingested, by type.",
            labelnames=("type",),  # gnn | mlp | cost
            namespace=ns, subsystem=sub, registry=self.registry)
        self.train_cycles = Counter(
            "train_cycles_total",
            "Interval-driver cycles that retrained a host (new segments "
            "had arrived).",
            namespace=ns, subsystem=sub, registry=self.registry)
        self.train_cycle_skips = Counter(
            "train_cycle_skips_total",
            "Interval-driver cycles skipped for a host (no new "
            "segments since the last cycle).",
            namespace=ns, subsystem=sub, registry=self.registry)
        self.federated_rounds = Counter(
            "federated_rounds_total",
            "Federated rounds committed by the attached "
            "FederationCoordinator.",
            namespace=ns, subsystem=sub, registry=self.registry)
        self.federated_updates_screened = Counter(
            "federated_updates_screened_total",
            "Per-cluster updates rejected by the federated admission "
            "screen (nonfinite / norm_bound / holdout_regression).",
            namespace=ns, subsystem=sub, registry=self.registry)
        self.training_duration = Histogram(
            "training_duration_seconds", "One training job's duration.",
            labelnames=("model",),
            namespace=ns, subsystem=sub, registry=self.registry,
            buckets=(1, 5, 15, 30, 60, 120, 300, 600, 1800))
        self.train_samples_per_sec = Gauge(
            "train_samples_per_sec", "Last job's throughput per chip.",
            labelnames=("model",),
            namespace=ns, subsystem=sub, registry=self.registry)
        self.version = Gauge(
            "version", "Version info of the service.",
            labelnames=("version",),
            namespace=ns, subsystem=sub, registry=self.registry)
        if version:
            self.version.labels(version=version).set(1)
