"""Scheduler control-plane counters + latency rings.

The control plane (announce → filter → evaluate → decision, plus the
resource-manager GC sweeps) is the third measured hot path of the request
ladder, next to serving (``batcher_stats``) and the client data plane
(``data_plane``). Components tick a :class:`ControlPlaneStats` — their
own, or the process-wide :data:`STATS` instance — and the snapshot is
published on ``/debug/vars`` as ``"scheduler"`` via
:func:`dragonfly2_tpu_torch.utils.debugmon.register_debug_var`.

Counter semantics (see docs/SCHEDULER.md):

- ``schedules`` / ``decisions`` / ``back_to_source`` — announce-path
  scheduling attempts vs candidate-parent decisions delivered vs
  back-to-source verdicts. ``schedule_ms_p50/p99`` come from a ring of
  the last 4096 announce→decision latencies.
- ``filter_ms_*`` / ``evaluate_ms_*`` — the two phases of
  ``find_candidate_parents`` (candidate filtering vs batched scoring).
- ``piece_reports`` / ``report_batches`` — piece-finished reports
  processed vs batched RPCs that carried them (PR 3's
  ``download_pieces_finished`` form).
- ``peer_reregistrations`` — ``register_peer`` calls that found the
  peer already registered and served the idempotent upsert path (a
  failover or handoff re-home re-establishing its session here) instead
  of rejecting the duplicate.
- ``bad_node_fast`` / ``bad_node_slow`` — ``is_bad_node`` verdicts
  served from the O(1) windowed Welford aggregates vs the legacy
  numpy-over-history path (duck-typed peers without stats). On the real
  resource model this must stay ~100% fast: the slow counter existing is
  what lets a regression be SEEN.
- ``gc_pause_ms_*`` / ``gc_budget_overruns`` / ``gc_reclaimed`` — per
  ``run_gc`` tick pause times (the pauses the incremental sweep bounds),
  ticks that overran their time budget, and items reclaimed.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict

from dragonfly2_tpu_torch.utils.debugmon import register_debug_var
from dragonfly2_tpu_torch.utils.percentile import percentile


class _Ring:
    """Bounded sample ring with p50/p99 readout."""

    __slots__ = ("_vals", "count")

    def __init__(self, maxlen: int = 4096):
        self._vals: deque = deque(maxlen=maxlen)
        self.count = 0

    def add(self, v: float) -> None:
        self._vals.append(v)
        self.count += 1

    def percentiles(self) -> tuple[float, float]:
        vals = sorted(self._vals)
        return percentile(vals, 0.50), percentile(vals, 0.99)


class ControlPlaneStats:
    """Thread-safe control-plane counters for one scheduler scope.

    Components default to the process-wide :data:`STATS` instance (what
    ``/debug/vars`` shows); the bench and tests inject a fresh instance
    for hermetic measurement.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.schedules = 0
        self.decisions = 0
        self.back_to_source = 0
        self.piece_reports = 0
        self.report_batches = 0
        self.peer_reregistrations = 0
        self.task_reannounces = 0
        self.source_claims = 0
        self.source_claims_granted = 0
        # Geo bridge election (docs/GEO.md): cross-cluster candidate
        # asks resolved per filter pass — grants (the asking peer is /
        # became its cluster's WAN bridge) vs denials (steered back to
        # same-cluster parents). Zero for cluster-blind fleets.
        self.bridge_grants = 0
        self.bridge_denials = 0
        self.bad_node_fast = 0
        self.bad_node_slow = 0
        # Learned-cost seam (docs/REPLAY.md): is_bad_node verdicts served
        # by the learned piece-cost model vs degraded to the 3-sigma rule
        # path on a modelguard trip (cost_guard_trips) or scorer failure.
        self.bad_node_learned = 0
        self.bad_node_learned_bad = 0
        self.cost_guard_trips = 0
        self.cost_fallbacks = 0
        # Replay recorder (docs/REPLAY.md): decisions captured, events
        # finalized with outcomes, pending entries evicted unfinished,
        # candidate sets truncated to the schema arity.
        self.replay_decisions = 0
        self.replay_finalized = 0
        self.replay_evicted = 0
        self.replay_truncated = 0
        # Batched sink appends: one per capture-thread drain, so
        # finalized / appends_batched is the realized IO amortization.
        self.replay_appends_batched = 0
        self.gc_ticks = 0
        self.gc_budget_overruns = 0
        self.gc_reclaimed = 0
        # Per-traffic-class control-plane counters (docs/QOS.md): ticked
        # only for class-tagged peers, so class-blind fleets export
        # empty dicts at zero cost.
        self.announces_by_class: Dict[str, int] = {}
        self.schedules_by_class: Dict[str, int] = {}
        self.decisions_by_class: Dict[str, int] = {}
        self._schedule_ms = _Ring(4096)
        self._filter_ms = _Ring(2048)
        self._evaluate_ms = _Ring(2048)
        self._gc_pause_ms = _Ring(2048)

    # -- ticks -------------------------------------------------------------

    def observe_schedule(self, ms: float, *, decided: bool,
                         traffic_class: str = "") -> None:
        with self._lock:
            self.schedules += 1
            if decided:
                self.decisions += 1
            self._schedule_ms.add(ms)
            if traffic_class:
                self.schedules_by_class[traffic_class] = \
                    self.schedules_by_class.get(traffic_class, 0) + 1
                if decided:
                    self.decisions_by_class[traffic_class] = \
                        self.decisions_by_class.get(traffic_class, 0) + 1

    def observe_announce_class(self, traffic_class: str) -> None:
        """One class-tagged register_peer (class-blind peers don't tick)."""
        with self._lock:
            self.announces_by_class[traffic_class] = \
                self.announces_by_class.get(traffic_class, 0) + 1

    def observe_back_to_source(self) -> None:
        with self._lock:
            self.back_to_source += 1

    def observe_filter(self, ms: float) -> None:
        with self._lock:
            self._filter_ms.add(ms)

    def observe_evaluate(self, ms: float) -> None:
        with self._lock:
            self._evaluate_ms.add(ms)

    def observe_piece_reports(self, n: int, *, batched: bool = False) -> None:
        with self._lock:
            self.piece_reports += n
            if batched:
                self.report_batches += 1

    def observe_reregistration(self) -> None:
        with self._lock:
            self.peer_reregistrations += 1

    def observe_task_reannounce(self) -> None:
        with self._lock:
            self.task_reannounces += 1

    def observe_source_claim(self, *, granted: bool) -> None:
        """One claim_source_run call (fan-out dissemination); granted
        means a run was leased (vs wait/done verdicts)."""
        with self._lock:
            self.source_claims += 1
            if granted:
                self.source_claims_granted += 1

    def observe_bridge(self, *, granted: bool) -> None:
        """One cross-cluster bridge-election verdict (docs/GEO.md)."""
        with self._lock:
            if granted:
                self.bridge_grants += 1
            else:
                self.bridge_denials += 1

    def observe_bad_node(self, *, fast: bool) -> None:
        # Lock-free: this fires once per CANDIDATE inside the filter hot
        # loop — taking the shared stats lock there would re-introduce
        # the cross-thread contention the sharded managers remove. A
        # rare lost increment under preemption is acceptable for a
        # monitoring counter (same stance as racecheck.acquire_count).
        if fast:
            self.bad_node_fast += 1
        else:
            self.bad_node_slow += 1

    def observe_bad_node_learned(self, *, bad: bool) -> None:
        # Lock-free for the same reason as observe_bad_node: one tick
        # per candidate inside the filter hot loop.
        self.bad_node_learned += 1
        if bad:
            self.bad_node_learned_bad += 1

    def observe_cost_guard_trip(self) -> None:
        self.cost_guard_trips += 1

    def observe_cost_fallback(self) -> None:
        self.cost_fallbacks += 1

    def observe_replay(self, *, decision: bool = False,
                       finalized: bool = False, evicted: bool = False,
                       truncated: bool = False,
                       appended_batch: bool = False) -> None:
        # Lock-free and EXACT: the recorder's single capture thread is
        # the only writer of these counters, and taking the shared
        # stats lock here would let capture stall announce threads
        # mid-observe_schedule (the recorder overhead guard's budget).
        if decision:
            self.replay_decisions += 1
        if finalized:
            self.replay_finalized += 1
        if evicted:
            self.replay_evicted += 1
        if truncated:
            self.replay_truncated += 1
        if appended_batch:
            self.replay_appends_batched += 1

    def observe_gc(self, ms: float, *, overran: bool, reclaimed: int) -> None:
        with self._lock:
            self.gc_ticks += 1
            if overran:
                self.gc_budget_overruns += 1
            self.gc_reclaimed += reclaimed
            self._gc_pause_ms.add(ms)

    # -- read side ---------------------------------------------------------

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            sched_p50, sched_p99 = self._schedule_ms.percentiles()
            filt_p50, filt_p99 = self._filter_ms.percentiles()
            ev_p50, ev_p99 = self._evaluate_ms.percentiles()
            gc_p50, gc_p99 = self._gc_pause_ms.percentiles()
            return {
                "schedules": self.schedules,
                "decisions": self.decisions,
                "back_to_source": self.back_to_source,
                "schedule_ms_p50": round(sched_p50, 4),
                "schedule_ms_p99": round(sched_p99, 4),
                "filter_ms_p50": round(filt_p50, 4),
                "filter_ms_p99": round(filt_p99, 4),
                "evaluate_ms_p50": round(ev_p50, 4),
                "evaluate_ms_p99": round(ev_p99, 4),
                "piece_reports": self.piece_reports,
                "report_batches": self.report_batches,
                "peer_reregistrations": self.peer_reregistrations,
                "task_reannounces": self.task_reannounces,
                "source_claims": self.source_claims,
                "source_claims_granted": self.source_claims_granted,
                "bridge_grants": self.bridge_grants,
                "bridge_denials": self.bridge_denials,
                "bad_node_fast": self.bad_node_fast,
                "bad_node_slow": self.bad_node_slow,
                "bad_node_learned": self.bad_node_learned,
                "bad_node_learned_bad": self.bad_node_learned_bad,
                "cost_guard_trips": self.cost_guard_trips,
                "cost_fallbacks": self.cost_fallbacks,
                "replay_decisions": self.replay_decisions,
                "replay_finalized": self.replay_finalized,
                "replay_evicted": self.replay_evicted,
                "replay_truncated": self.replay_truncated,
                "replay_appends_batched": self.replay_appends_batched,
                "gc_ticks": self.gc_ticks,
                "gc_budget_overruns": self.gc_budget_overruns,
                "gc_reclaimed": self.gc_reclaimed,
                "gc_pause_ms_p50": round(gc_p50, 4),
                "gc_pause_ms_p99": round(gc_p99, 4),
                "announces_by_class": dict(self.announces_by_class),
                "schedules_by_class": dict(self.schedules_by_class),
                "decisions_by_class": dict(self.decisions_by_class),
            }


# Process-wide instance, published as the "scheduler" block on
# /debug/vars (mirrors client/dataplane.py's "data_plane" block).
STATS = ControlPlaneStats()

register_debug_var("scheduler", STATS.snapshot)
