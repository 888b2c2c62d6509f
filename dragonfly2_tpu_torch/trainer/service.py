"""Trainer service: client-streaming dataset ingest — port of
``dragonfly2_tpu/trainer/service.py``.

Reference counterpart: trainer/service/service_v1.go:59-162 — the first
message identifies the source scheduler host, chunks append to per-host
dataset files by request type, and EOF kicks off training asynchronously.
Our chunks additionally carry ``new_file`` marking rotated-file boundaries
(each CSV segment has its own header; see trainer.storage).

The five messages carry JAX's codec tags, and ``TRAINER_SPEC`` is JAX's:
``serve([(TRAINER_SPEC, service)])`` serves ``Train`` over the port's
wire (``rpc/service.py``). ``Train`` takes any iterator of requests and a
context whose ``abort`` takes a
:class:`~dragonfly2_tpu_torch.rpc.status.StatusCode` and raises
(:class:`~dragonfly2_tpu_torch.rpc.status.CallContext` in process).
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Optional

from dragonfly2_tpu_torch.rpc.codec import message
from dragonfly2_tpu_torch.rpc.service import MethodKind, ServiceSpec
from dragonfly2_tpu_torch.rpc.status import StatusCode
from dragonfly2_tpu_torch.trainer.storage import (
    DOWNLOAD_PREFIX,
    NETWORK_TOPOLOGY_PREFIX,
    REPLAY_PREFIX,
    TrainerStorage,
)
from dragonfly2_tpu_torch.trainer.training import Training

logger = logging.getLogger(__name__)


@message("trainer.TrainGnnRequest")
@dataclass
class TrainGnnRequest:
    dataset: bytes = b""
    new_file: bool = False


@message("trainer.TrainMlpRequest")
@dataclass
class TrainMlpRequest:
    dataset: bytes = b""
    new_file: bool = False


@message("trainer.TrainCostRequest")
@dataclass
class TrainCostRequest:
    """Replay-plane decision corpus chunks (scheduler storage's rotated
    ``replay.*.csv`` files) — the learned piece-cost model's training
    data (docs/REPLAY.md)."""

    dataset: bytes = b""
    new_file: bool = False


@message("trainer.TrainRequest")
@dataclass
class TrainRequest:
    host_id: str = ""
    ip: str = ""
    hostname: str = ""
    # Manager-assigned scheduler row id — keys model uploads so clusters
    # never evict each other's active models (manager/models/model.go
    # unique (type, version, scheduler_id)).
    scheduler_id: int = 0
    gnn: Optional[TrainGnnRequest] = None
    mlp: Optional[TrainMlpRequest] = None
    cost: Optional[TrainCostRequest] = None


@message("trainer.TrainResponse")
@dataclass
class TrainResponse:
    host_id: str = ""
    accepted_bytes: int = 0


TRAINER_SPEC = ServiceSpec(
    name="df2.trainer.Trainer",
    methods={"Train": MethodKind.STREAM_UNARY},
)


def _context_active(context) -> bool:
    """True when the RPC is still live. Duck-typed: in-process test
    harnesses may pass contexts without ``is_active``."""
    is_active = getattr(context, "is_active", None)
    return bool(is_active()) if callable(is_active) else True


class TrainerService:
    """``Train`` stream handler + async training kick-off.

    ``train_async=False`` runs training inline before replying — used by
    tests and by deployments where the driver wants backpressure on the
    announcer instead of queued jobs.
    """

    def __init__(
        self,
        storage: TrainerStorage,
        training: Training,
        train_async: bool = True,
        metrics=None,
    ) -> None:
        self.storage = storage
        self.training = training
        self.train_async = train_async
        self.metrics = metrics  # TrainerMetrics or None
        self._jobs: list[threading.Thread] = []
        # host_id -> (ip, hostname, scheduler_id) of every source that
        # streamed datasets this process — what the interval cycle
        # driver retrains from without an operator (or an announcer EOF)
        # kicking each cycle.
        self._host_identities: dict = {}
        self._cycle_stop = threading.Event()
        self._cycle_thread: Optional[threading.Thread] = None
        self._federation = None  # FederationCoordinator, when attached

    def attach_federation(self, coordinator) -> None:
        """Attach a ``trainer.federation.FederationCoordinator``: every
        training cycle then also drives one quorum-committed federated
        round (screened aggregation + durable journal) after the
        per-host jobs. Quorum failures are logged, counted, and retried
        on the next cycle — the journal keeps partial rounds."""
        self._federation = coordinator

    def Train(self, request_iterator, context) -> TrainResponse:
        first: Optional[TrainRequest] = None
        accepted = 0
        written: list[str] = []
        try:
            for req in request_iterator:
                if first is None:
                    if not req.host_id:
                        context.abort(
                            StatusCode.INVALID_ARGUMENT,
                            "first TrainRequest must carry host_id",
                        )
                    first = req
                if req.gnn is not None:
                    written.append(
                        self.storage.append(
                            NETWORK_TOPOLOGY_PREFIX, req.host_id,
                            req.gnn.dataset, req.gnn.new_file,
                        )
                    )
                    accepted += len(req.gnn.dataset)
                    if self.metrics:
                        self.metrics.dataset_bytes.labels(type="gnn").inc(
                            len(req.gnn.dataset))
                if req.mlp is not None:
                    written.append(
                        self.storage.append(
                            DOWNLOAD_PREFIX, req.host_id,
                            req.mlp.dataset, req.mlp.new_file,
                        )
                    )
                    accepted += len(req.mlp.dataset)
                    if self.metrics:
                        self.metrics.dataset_bytes.labels(type="mlp").inc(
                            len(req.mlp.dataset))
                if req.cost is not None:
                    written.append(
                        self.storage.append(
                            REPLAY_PREFIX, req.host_id,
                            req.cost.dataset, req.cost.new_file,
                        )
                    )
                    accepted += len(req.cost.dataset)
                    if self.metrics:
                        self.metrics.dataset_bytes.labels(type="cost").inc(
                            len(req.cost.dataset))
        except Exception:
            if self.metrics:
                self.metrics.train_request_failure.inc()
            # A stream that dies mid-upload rolls back its segments: the
            # announcer retries with the FULL dataset next tick, so keeping
            # partial (possibly row-truncated) files would duplicate every
            # delivered record and can break CSV parsing.
            if first is not None:
                self.storage.close_host(first.host_id)
                self.storage.discard_files(sorted(set(written)))
            raise
        finally:
            if first is not None:
                self.storage.close_host(first.host_id)

        if first is None:
            context.abort(StatusCode.INVALID_ARGUMENT, "empty Train stream")

        if not _context_active(context):
            # The client died mid-upload but its cancellation raced the
            # final ReceiveMessage: grpc surfaces that ordering as a
            # CLEAN end of stream (grpc/_server.py _look_for_request
            # raises StopIteration when the receive loop drained before
            # the CANCELLED state landed), so the except-path rollback
            # above never fired. A half-uploaded dataset must not
            # survive either way — the announcer retries with the FULL
            # snapshot next tick, and keeping the partial segments would
            # duplicate every delivered record. This was the
            # order-dependent test_failed_stream_rolls_back_segments
            # flake: load delayed cancellation processing past the
            # drained receive queue. The port's wire gives the same
            # sequence: a client that half-closes after its last chunk
            # (END) and hangs up before the reply ends the stream
            # cleanly, and only is_active() sees it gone.
            if self.metrics:
                self.metrics.train_request_failure.inc()
            self.storage.discard_files(sorted(set(written)))
            context.abort(StatusCode.CANCELLED,
                          "Train stream terminated mid-upload")

        if self.metrics:
            self.metrics.train_request_count.inc()
        self._host_identities[first.host_id] = (
            first.ip, first.hostname, first.scheduler_id)
        if self.train_async:
            self._jobs = [j for j in self._jobs if j.is_alive()]
            job = threading.Thread(
                target=self._safe_train,
                args=(first.ip, first.hostname, first.host_id,
                      first.scheduler_id),
                name=f"train-{first.host_id}",
                daemon=True,
            )
            job.start()
            self._jobs.append(job)
        else:
            self._safe_train(first.ip, first.hostname, first.host_id,
                             first.scheduler_id)
        return TrainResponse(host_id=first.host_id, accepted_bytes=accepted)

    def _safe_train(self, ip: str, hostname: str, host_id: str,
                    scheduler_id: int = 0) -> None:
        try:
            outcome = self.training.train(ip, hostname, host_id, scheduler_id)
            if outcome.errors:
                logger.error("training for %s finished with errors: %s",
                             host_id, outcome.errors)
        except Exception:  # noqa: BLE001 — job boundary
            logger.exception("training job for %s crashed", host_id)

    def wait_idle(self, timeout: Optional[float] = None) -> None:
        """Join outstanding async jobs (tests / graceful shutdown)."""
        for job in self._jobs:
            job.join(timeout)
        self._jobs = [j for j in self._jobs if j.is_alive()]

    # -- interval cycle driver (df2-trainer --train-interval) --------------

    def run_training_cycle(self) -> dict:
        """One continuous-learning cycle: retrain + register for every
        source host with NEW closed dataset segments; hosts with nothing
        new are skipped. Counted in TrainerMetrics (``train_cycles`` /
        ``train_cycle_skips``) so the loop's liveness is observable."""
        trained, skipped = [], []
        for host_id, (ip, hostname, scheduler_id) in list(
                self._host_identities.items()):
            if self.storage.has_closed_segments(host_id):
                self._safe_train(ip, hostname, host_id, scheduler_id)
                trained.append(host_id)
                if self.metrics:
                    self.metrics.train_cycles.inc()
            else:
                skipped.append(host_id)
                if self.metrics:
                    self.metrics.train_cycle_skips.inc()
        cycle = {"trained": trained, "skipped": skipped}
        if self._federation is not None:
            try:
                report = self._federation.run_round()
                cycle["federated"] = report.to_dict()
                if self.metrics:
                    self.metrics.federated_rounds.inc()
                    if report.screened:
                        self.metrics.federated_updates_screened.inc(
                            len(report.screened))
            except Exception as exc:  # noqa: BLE001 — cycle must not die
                logger.warning("federated round failed: %s", exc)
                cycle["federated"] = {"error": str(exc)}
        return cycle

    def start_cycle_driver(self, interval_s: float) -> None:
        """Retrain on a timer whenever new dataset segments arrived —
        the continuous-learning loop runs without an operator (or a
        stream EOF) kicking each cycle. Idempotent; ``stop_cycle_driver``
        (or process exit — the thread is a daemon) ends it."""
        if interval_s <= 0 or self._cycle_thread is not None:
            return

        def loop() -> None:
            while not self._cycle_stop.wait(interval_s):
                try:
                    self.run_training_cycle()
                except Exception:  # noqa: BLE001 — the driver must not die
                    logger.exception("interval training cycle failed")

        self._cycle_stop.clear()
        self._cycle_thread = threading.Thread(
            target=loop, name="trainer-cycle-driver", daemon=True)
        self._cycle_thread.start()

    def stop_cycle_driver(self) -> None:
        self._cycle_stop.set()
        if self._cycle_thread is not None:
            self._cycle_thread.join(timeout=5)
            self._cycle_thread = None
