"""Batched piece-finished reporting to the scheduler.

Per-piece ``download_piece_finished`` RPCs are the scheduler-facing
analogue of the per-piece TCP connect the data plane just amortized: a
1000-piece task used to make 1000 synchronous scheduler calls from the
piece workers' hot path. :class:`PieceReportBatcher` coalesces them
through a small bounded-flush buffer:

- flush when ``flush_count`` reports are buffered (bounds batch size),
- flush when ``flush_deadline`` elapses since the first buffered report
  (bounds staleness — scheduling decisions that read parent
  ``piece_updated_at`` stay ≤ one deadline behind), and
- flush on ``close()`` (task end, success OR failure), so every
  reported piece is delivered exactly once even on early exit.

Delivery prefers the scheduler's native batched form
(``download_pieces_finished``, scheduler/service.py and the DF2 wire's
``WirePiecesFinished``) and falls back to per-piece calls for schedulers
that predate it.

Flush failures are NOT silently dropped (they were, pre-ISSUE-5): a
failed batched flush retries inline with full-jitter backoff up to
``retry_limit`` attempts, then parks the reports in a bounded pending
queue redelivered ahead of the next flush. Only pending-queue overflow
and a close() whose final attempt still fails drop reports — and both
count the drop in the ``"recovery"`` debug block
(``report_flush_dropped``) instead of losing them without a trace.
``on_delivery(ok)`` tells the owning conductor how the scheduler is
responding, feeding its bounded-grace degradation decision.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Callable, List, Optional

from dragonfly2_tpu_torch.utils.backoff import full_jitter

logger = logging.getLogger(__name__)


class PieceReportBatcher:
    """Coalesces PieceFinished reports; thread-safe; one per conductor."""

    def __init__(self, scheduler, flush_count: int = 16,
                 flush_deadline: float = 0.05, stats=None,
                 retry_limit: int = 2, retry_base: float = 0.05,
                 retry_cap: float = 0.5, pending_cap: int = 1024,
                 on_delivery: Optional[Callable[[bool], None]] = None,
                 recovery=None):
        self.scheduler = scheduler
        self.flush_count = max(int(flush_count), 1)
        self.flush_deadline = flush_deadline
        self.retry_limit = max(int(retry_limit), 0)
        self.retry_base = retry_base
        self.retry_cap = retry_cap
        self.pending_cap = max(int(pending_cap), 1)
        self.on_delivery = on_delivery
        if stats is None:
            from dragonfly2_tpu_torch.client.dataplane import STATS as stats
        self.stats = stats
        if recovery is None:
            from dragonfly2_tpu_torch.client.recovery import RECOVERY as recovery
        self.recovery = recovery
        # Buffered (report, trace_link) pairs: the link is the member
        # piece's piece.fetch span identity, carried so the batch-flush
        # span can link back to the pieces it coalesced (None when
        # tracing is off — zero retained state).
        self._buf: List = []
        # Task trace context the owning conductor binds at run() start;
        # deadline-timer deliveries (fresh threads) parent their batch
        # span here instead of starting orphan traces.
        self.trace_ctx = None
        self._lock = threading.Lock()
        # Serializes deliveries: flush()/close() must not return while a
        # deadline-timer delivery is still in flight, or the conductor's
        # task-level "finished" report could overtake the final pieces.
        # Also guards ``_pending`` (only touched during deliveries).
        self._deliver_lock = threading.Lock()
        self._pending: List = []
        self._rng = random.Random()
        self._timer: Optional[threading.Timer] = None
        self._closed = False
        # Optional executor for count-triggered flushes (fn -> None):
        # the async download engine binds its dl-ctl runner here so the
        # flush RPC (and its retry-ladder sleeps) never runs on an
        # event-loop thread. None = flush inline on the reporting
        # thread (the historical per-task-worker behavior).
        self.flush_executor: Optional[Callable[[Callable[[], None]],
                                               None]] = None

    # -- producer side -----------------------------------------------------

    def report(self, piece_finished, trace_link=None) -> None:
        """Buffer one report; may flush inline (count trigger) or arm the
        deadline timer. After ``close()`` a straggler report (a worker
        finishing its last piece during shutdown) is delivered
        immediately instead of being silently dropped. ``trace_link`` is
        the reporting piece's span identity (trace_id, span_id) for the
        batch span's links, or None with tracing off."""
        straggler = None
        trigger = False
        with self._lock:
            if self._closed:
                straggler = [(piece_finished, trace_link)]
            else:
                self._buf.append((piece_finished, trace_link))
                if len(self._buf) >= self.flush_count:
                    trigger = True
                elif self._timer is None and self.flush_deadline > 0:
                    self._timer = threading.Timer(self.flush_deadline,
                                                  self.flush)
                    self._timer.daemon = True
                    self._timer.start()
        if trigger:
            # Drained under flush()'s deliver-lock-first discipline (a
            # concurrent flush may win the race and deliver it — fine,
            # someone delivers it exactly once).
            if self.flush_executor is not None:
                self.flush_executor(self.flush)
            else:
                self.flush()
        elif straggler:
            with self._deliver_lock:
                self._deliver_locked(straggler)

    def flush(self) -> None:
        """Deliver everything buffered (and anything parked pending from
        earlier failed flushes) AND wait out any in-flight delivery (a
        deadline timer mid-RPC) — when flush returns, every report made
        before it has reached the scheduler, is parked in the bounded
        pending queue for the next attempt, or has been dropped WITH a
        ``report_flush_dropped`` count. The deliver lock is taken BEFORE
        the buffer is drained: a batch is never in limbo (taken from the
        buffer but not yet under the lock), so this barrier cannot be
        overtaken by a concurrent timer delivery."""
        with self._deliver_lock:
            with self._lock:
                batch = self._take_locked()
            if batch or self._pending:
                self._deliver_locked(batch)

    def close(self) -> None:
        """Final flush (same in-flight barrier); subsequent reports
        deliver synchronously. Reports still undeliverable after the
        final retry ladder are dropped and counted."""
        with self._deliver_lock:
            with self._lock:
                self._closed = True
                batch = self._take_locked()
            if batch or self._pending:
                self._deliver_locked(batch)

    # -- internals ---------------------------------------------------------

    def _take_locked(self) -> List:
        batch, self._buf = self._buf, []
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        return batch

    def _notify(self, ok: bool) -> None:
        if self.on_delivery is not None:
            try:
                self.on_delivery(ok)
            except Exception:  # noqa: BLE001 — observer must not break delivery
                logger.debug("on_delivery hook failed", exc_info=True)

    def _deliver_locked(self, batch: List) -> None:
        """Send pending + one batch of (report, link) pairs; caller
        holds ``_deliver_lock``. The flush rides one ``piece.report_batch``
        span parented under the task trace, carrying links to the member
        piece spans — the coalescing is visible in the trace, not just
        in the rpcs_saved counter."""
        from dragonfly2_tpu_torch.utils.tracing import default_tracer

        tracer = default_tracer()
        if not tracer.enabled or self.trace_ctx is None:
            return self._deliver_batch(batch)
        # remote_parent below both parents the span AND binds the
        # contextvar for the RPC inside it — timer threads need nothing
        # more, and a worker thread's own piece.fetch context must not
        # be clobbered for the rest of its span.
        links = [link for _, link in (self._pending + batch)
                 if link is not None]
        with tracer.span("piece.report_batch", remote_parent=self.trace_ctx,
                         links=links, pieces=len(batch),
                         pending=len(self._pending)):
            return self._deliver_batch(batch)

    def _deliver_batch(self, batch: List) -> None:
        batched = getattr(self.scheduler, "download_pieces_finished", None)
        if batched is None:
            # Legacy scheduler: per-piece calls, per-piece error
            # isolation (no batched flush to retry).
            for report, _link in self._pending + batch:
                try:
                    self.scheduler.download_piece_finished(report)
                except Exception:
                    logger.debug("piece finished report failed",
                                 exc_info=True)
            self._pending = []
            return
        # Pending-first preserves report order across a recovery.
        pending_count = len(self._pending)
        todo = self._pending + batch
        self._pending = []
        if not todo:
            return
        retried = False
        for attempt in range(self.retry_limit + 1):
            try:
                batched([report for report, _link in todo])
            except Exception:
                logger.debug("batched piece report failed (%d pieces, "
                             "attempt %d)", len(todo), attempt + 1,
                             exc_info=True)
                self.recovery.tick("report_flush_retries")
                self._notify(False)
                if attempt < self.retry_limit:
                    retried = True
                    time.sleep(full_jitter(attempt, self.retry_base,
                                           self.retry_cap, self._rng))
                continue
            # Count only batched deliveries that actually landed: the
            # report_rpcs_saved counter is the amortization contract,
            # and a failed flush saves nothing.
            self.stats.report_flush(len(todo))
            # Reports that landed after ≥1 failure: the whole batch when
            # an inline retry saved it, else just the parked reports a
            # later flush carried through.
            redelivered = len(todo) if retried else pending_count
            if redelivered:
                self.recovery.tick("report_flush_redelivered", redelivered)
            self._notify(True)
            return
        # Retry ladder exhausted. After close() there is no later flush
        # to redeliver from — drop and count. Mid-task, park in the
        # bounded pending queue (oldest dropped on overflow, counted).
        if self._closed:
            self.recovery.tick("report_flush_dropped", len(todo))
            return
        self._pending = todo
        overflow = len(self._pending) - self.pending_cap
        if overflow > 0:
            del self._pending[:overflow]
            self.recovery.tick("report_flush_dropped", overflow)
