"""Failure-recovery counters — the ``/debug/vars`` ``"recovery"`` block.

Every hardened unhappy path ticks a counter here, so chaos runs (and
operators staring at a misbehaving swarm) can see recovery WORKING, not
just infer it from the absence of errors:

- ``md5_mismatch_pieces`` — pieces whose digest check failed at store
  time (corruption on the wire or a lying parent).
- ``corrupt_refetched`` — corrupted pieces that were later re-fetched
  (steered to a different parent by the dispatcher's avoid map) and
  stored successfully.
- ``parents_blacklisted`` — parents banned for the rest of the task
  after repeat corruption.
- ``metadata_retries`` / ``metadata_sync_giveups`` — metadata-poll
  failures retried under the jittered budget, and syncers that
  exhausted it.
- ``piece_retries`` / ``piece_retry_exhausted`` — failed piece fetches
  re-queued under backoff, and pieces that burned the whole budget
  (the conductor degrades to back-to-source instead of spinning).
- ``source_run_retries`` — back-to-source coalesced runs retried after
  a transient stream failure (previously: first error failed the task).
- ``scheduler_degraded_to_source`` — conductors that gave up on an
  unreachable scheduler after the bounded grace and went back-to-source
  instead of burning the full task deadline.
- ``report_flush_retries`` / ``report_flush_redelivered`` /
  ``report_flush_dropped`` — piece-report batcher flush failures
  retried with backoff, reports that landed on a retry, and reports
  dropped when the bounded pending queue overflowed or close() gave up.
- ``piece_failed_report_retries`` / ``reports_dropped`` — piece-failed
  scheduler reports retried once, and those dropped after the retry.
- ``enospc_fail_fast`` — tasks failed immediately on a disk-full write
  instead of hanging workers on a doomed requeue loop.
- ``scheduler_failovers`` / ``scheduler_reregisters`` /
  ``scheduler_failover_pieces_replayed`` — peer-keyed scheduler calls
  that hit a dead/unreachable replica and walked the ring, announce
  sessions transparently re-established on a new replica, and stored
  pieces replayed into the new replica's resource view so its parent
  decisions resume from truth instead of zero.
- ``scheduler_handoff_rehomed`` / ``scheduler_handoff_stranded`` —
  in-flight peers cooperatively re-homed off a replica removed by
  ``update_targets`` (planned membership change / rolling restart), and
  peers that could not be re-homed (no reachable replacement) and
  stayed pinned to the retired client.
- ``reload_pieces_verified`` / ``reload_pieces_dropped`` — journaled
  pieces re-hashed OK at storage reload after a restart, and pieces
  dropped there (md5 mismatch, short data file, or journaled before
  the wire digest arrived) so a resume never trusts bad bytes.
- ``reload_orphans_swept`` — task/peer directories whose metadata
  journal was missing or corrupt, quarantined+deleted at reload
  instead of leaking their data files forever.
- ``tasks_resumed`` / ``resume_pieces_reused`` — downloads that
  adopted a crash-recovered partial store, and the verified pieces
  they skipped re-downloading (reported to the scheduler through the
  idempotent piece-upsert path instead of re-fetched).
- ``seed_tasks_reannounced`` — completed replicas a restarted daemon
  re-announced to the scheduler so it resumes serving as a parent
  instead of going dark.
- ``seed_tasks_rerouted`` — announced completed replicas re-routed to
  a task's NEW ring owner after a scheduler-membership change (the
  cross-replica seed-visibility half of cluster scale-out: a
  downloader whose task now hashes to a different replica must still
  be offered this seed).

``recovery_p50_ms`` / ``recovery_p99_ms`` summarize piece-recovery
latency: the time from a piece's FIRST failed fetch to its eventual
successful store (ring of the last 4096). ``reroute_p50_ms`` /
``reroute_p99_ms`` summarize scheduler re-route latency: first failed
peer-keyed call → session re-established and the call retried OK on a live replica (the number
the ``bench.py chaos`` scheduler-kill rung bounds by
``scheduler_grace``).
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, List

from dragonfly2_tpu_torch.utils.debugmon import register_debug_var
from dragonfly2_tpu_torch.utils.percentile import percentile

COUNTER_KEYS = (
    "md5_mismatch_pieces",
    "corrupt_refetched",
    "parents_blacklisted",
    "metadata_retries",
    "metadata_sync_giveups",
    "piece_retries",
    "piece_retry_exhausted",
    "source_run_retries",
    "scheduler_degraded_to_source",
    "report_flush_retries",
    "report_flush_redelivered",
    "report_flush_dropped",
    "piece_failed_report_retries",
    "reports_dropped",
    "enospc_fail_fast",
    "scheduler_failovers",
    "scheduler_reregisters",
    "scheduler_failover_pieces_replayed",
    "scheduler_handoff_rehomed",
    "scheduler_handoff_stranded",
    "reload_pieces_verified",
    "reload_pieces_dropped",
    "reload_orphans_swept",
    "tasks_resumed",
    "resume_pieces_reused",
    "seed_tasks_reannounced",
    "seed_tasks_rerouted",
)


class RecoveryStats:
    """Thread-safe recovery counters for one scope. Components default
    to the process-wide :data:`RECOVERY` (what ``/debug/vars`` shows);
    tests and the chaos bench inject a fresh instance."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {k: 0 for k in COUNTER_KEYS}
        self._recoveries: collections.deque = collections.deque(maxlen=4096)
        self._reroutes: collections.deque = collections.deque(maxlen=4096)

    def tick(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + n

    def observe_recovery(self, seconds: float) -> None:
        """One piece recovered: first failure → successful store."""
        with self._lock:
            self._recoveries.append(seconds)

    def observe_reroute(self, seconds: float) -> None:
        """One scheduler failover: first failed peer-keyed call →
        session re-established (and the call retried) on a live
        replica."""
        with self._lock:
            self._reroutes.append(seconds)

    def get(self, key: str) -> int:
        with self._lock:
            return self._counts.get(key, 0)

    def recovery_samples(self) -> List[float]:
        with self._lock:
            return list(self._recoveries)

    def reroute_samples(self) -> List[float]:
        with self._lock:
            return list(self._reroutes)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            out: Dict[str, float] = dict(self._counts)
            samples = sorted(self._recoveries)
            reroutes = sorted(self._reroutes)
        out["recovery_samples"] = len(samples)
        out["recovery_p50_ms"] = round(percentile(samples, 0.50) * 1e3, 3)
        out["recovery_p99_ms"] = round(percentile(samples, 0.99) * 1e3, 3)
        out["reroute_samples"] = len(reroutes)
        out["reroute_p50_ms"] = round(percentile(reroutes, 0.50) * 1e3, 3)
        out["reroute_p99_ms"] = round(percentile(reroutes, 0.99) * 1e3, 3)
        return out


#: Process-wide default scope — published as the ``"recovery"`` block.
RECOVERY = RecoveryStats()

register_debug_var("recovery", RECOVERY.snapshot)
