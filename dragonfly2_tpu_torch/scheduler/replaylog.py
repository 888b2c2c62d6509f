"""Announce-stream recorder — the replay plane's capture side.

Records FULL scheduling decision events at the scheduler (docs/REPLAY.md):
the post-filter candidate set with its feature matrix (the exact
``build_feature_matrix`` layout the evaluators rank from), each
candidate's windowed Welford piece-cost snapshot, the delivered ranking,
and — once the child's download terminates — each candidate's REALIZED
piece-cost statistics plus the child's outcome. PR-12's ``TraceLog``
captures feature batches alone (enough to replay a model's *scores*);
these events additionally carry outcomes, which is what lets the offline
replay harness (:mod:`.replay`) score any evaluator by realized-cost
regret instead of rank-correlation proxies.

Hot-path discipline (the ``bench.py replay`` recorder overhead guard
holds announce p99 within 5% of recorder-off): the announce thread
extracts the decision-time evidence — pure-Python feature rows + O(1)
Welford snapshots, tens of µs — and appends ONE tuple to a bounded FIFO;
record assembly, float32 folding, realized-cost reads and dataset IO all
happen on the recorder's capture thread, which drains up to
``DRAIN_BATCH_MAX`` queued items per wakeup — one 2-D float32 fold, one
ring extend and ONE dataset-sink append per drain (counted as
``replay_appends_batched``) — and sleeps between drains so
it never holds the GIL for a full switch-interval slice (measured: a
busy capture thread without the sleep cost ~2x announce p99 on a 1-core
box). Synchronous extraction is deliberate: captured a beat later the
rows already reflect the decision's own consequences (measured: the
child's finished count jumped to the full piece count before an async
capture ran). Outcomes ride the same FIFO, so a child's terminal event
always processes after its decisions. Zero work when disabled: the
scheduling core and service check ``recorder is not None`` — the
fault-injection plane's ``ACTIVE is None`` discipline.

Event lifecycle: a decision opens a PENDING entry holding references to
the candidate peers; the child's terminal report (finished / failed /
back-to-source-finished / leave) finalizes every pending entry of that
child — realized costs are read from the candidates at that moment —
and the finalized :class:`~dragonfly2_tpu_torch.schema.ReplayDecision` is
appended to the scheduler's rotating dataset sink (``replay.*.csv``
next to the Download/NetworkTopology training data) and to a bounded
in-memory ring. Children that never terminate (GC'd mid-download) are
evicted oldest-first past ``max_pending`` with an empty outcome; a
capture queue past ``queue_capacity`` drops NEW decisions, and past 2x
that even outcomes (both counted; stranded pendings fall back to the
eviction path) — the recorder's footprint is bounded no matter what
the swarm does.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import fields as dataclass_fields
from typing import Dict, List, Optional, Sequence

import numpy as np

from dragonfly2_tpu_torch.schema import (
    MAX_REPLAY_CANDIDATES,
    REPLAY_SCHEMA_VERSION,
    ReplayCandidate,
    ReplayDecision,
    ReplayFeatureRow,
)
from dragonfly2_tpu_torch.scheduler import controlstats
from dragonfly2_tpu_torch.scheduler.evaluator import scoring
from dragonfly2_tpu_torch.scheduler.evaluator.base import (
    PEER_STATE_RECEIVED_NORMAL,
    PEER_STATE_RUNNING,
)

#: The schema record's field order IS the canonical feature layout; a
#: drift here would silently corrupt every recorded corpus.
_FEATURE_FIELDS = tuple(f.name for f in dataclass_fields(ReplayFeatureRow))
if _FEATURE_FIELDS != scoring.FEATURE_NAMES:  # pragma: no cover - import guard
    raise ImportError(
        "schema.ReplayFeatureRow fields "
        f"{_FEATURE_FIELDS} drifted from scoring.FEATURE_NAMES "
        f"{scoring.FEATURE_NAMES}; keep them in lockstep")

VERDICT_PARENTS = "parents"
VERDICT_BACK_TO_SOURCE = "back_to_source"

DEFAULT_MAX_PENDING = 4096
DEFAULT_RING_CAPACITY = 4096
DEFAULT_QUEUE_CAPACITY = 8192

#: Max queued items processed per capture-thread wakeup. Batching a
#: drain turns N ring appends + N dataset-sink calls + N per-row
#: float32 folds into ONE ring extend, ONE buffered sink call and ONE
#: 2-D array cast — under burst load the amortized per-event cost
#: drops ~an order of magnitude — while the cap bounds the continuous
#: GIL hold (the announce-overhead guard's budget; see _capture_loop).
DRAIN_BATCH_MAX = 32


_SEED_READY_STATES = (PEER_STATE_RECEIVED_NORMAL, PEER_STATE_RUNNING)


def _feature_rows(child, candidates, total_piece_count) -> list:
    """Per-candidate feature tuples as PURE PYTHON floats, value-for-
    value what ``build_feature_matrix`` computes (same attribute reads,
    same derived idc/location folds; the float32 rounding happens once
    at finalize). Pure Python because this runs ON THE ANNOUNCE THREAD
    inside the 5% overhead budget: numpy scalar writes cost ~4x the
    plain attribute reads here. Bit-identity with the staged matrix is
    regression-tested (tests/test_replay.py)."""
    child_host = child.host
    child_finished = child.finished_piece_count()
    child_idc = child_host.idc
    child_location = child_host.location
    rows = []
    for parent in candidates:
        host = parent.host
        is_seed = bool(getattr(host.type, "is_seed", bool(host.type)))
        rows.append((
            parent.finished_piece_count(),
            child_finished,
            total_piece_count,
            host.upload_count,
            host.upload_failed_count,
            host.free_upload_count(),
            host.concurrent_upload_limit,
            1.0 if is_seed else 0.0,
            1.0 if is_seed and parent.state() in _SEED_READY_STATES else 0.0,
            scoring.idc_match(host.idc, child_idc),
            scoring.location_matches(host.location, child_location),
        ))
    return rows


def welford_snapshot(candidate) -> tuple:
    """``(n, last, prior_mean, prior_pstd)`` for any PeerLike — the O(1)
    aggregates when the peer carries them, the numpy formulas otherwise
    (the same duck-typing split as ``BaseEvaluator.is_bad_node``)."""
    stats_of = getattr(candidate, "piece_cost_stats", None)
    if stats_of is not None:
        return stats_of().snapshot()
    costs = np.asarray(candidate.piece_costs(), dtype=np.float64)
    n = len(costs)
    if n == 0:
        return 0, 0.0, 0.0, 0.0
    if n == 1:
        return 1, float(costs[-1]), 0.0, 0.0
    prior = costs[:-1]
    return n, float(costs[-1]), float(prior.mean()), float(prior.std())


def snapshot_mean(snapshot: tuple) -> float:
    """Windowed mean cost INCLUDING the latest sample, from a
    :func:`welford_snapshot` tuple; -1.0 when no samples exist."""
    n, last, prior_mean, _ = snapshot
    if n <= 0:
        return -1.0
    return ((n - 1) * prior_mean + last) / n


class _Pending:
    __slots__ = ("seq", "task_id", "peer_id", "total_piece_count",
                 "chosen", "decided_at", "ids", "ranks", "features",
                 "snapshots", "refs")

    def __init__(self, seq, task_id, peer_id, total_piece_count, chosen,
                 decided_at, ids, ranks, features, snapshots, refs):
        self.seq = seq
        self.task_id = task_id
        self.peer_id = peer_id
        self.total_piece_count = total_piece_count
        self.chosen = chosen
        self.decided_at = decided_at
        self.ids = ids
        self.ranks = ranks
        self.features = features
        self.snapshots = snapshots
        self.refs = refs


class ReplayRecorder:
    """Bounded, versioned announce-decision recorder.

    ``storage`` is a scheduler :class:`~dragonfly2_tpu_torch.scheduler.storage.
    storage.Storage` (finalized events ride its rotating ``replay``
    dataset: size rotation, bounded backups, snapshot/remove for the
    trainer announcer); ``None`` keeps events only in the in-memory ring
    — the hermetic test/bench mode. Call :meth:`close` (or
    :meth:`finalize_all`, which drains first) on teardown.
    """

    def __init__(self, storage=None, *,
                 max_pending: int = DEFAULT_MAX_PENDING,
                 ring_capacity: int = DEFAULT_RING_CAPACITY,
                 queue_capacity: int = DEFAULT_QUEUE_CAPACITY,
                 stats: Optional[controlstats.ControlPlaneStats] = None):
        self.storage = storage
        self.max_pending = max_pending
        self.queue_capacity = queue_capacity
        self._stats = stats if stats is not None else controlstats.STATS
        # Capture FIFO — the ONLY thing announce threads touch. One
        # condition guards it; appends are O(1) and never block on IO.
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self.dropped = 0
        self._closed = False
        self._busy = False  # capture thread mid-_process
        # Capture-thread state (no lock needed: single consumer).
        self._seq = 0
        self._pending: Dict[str, List[_Pending]] = {}
        self._pending_count = 0
        self._pending_order: deque = deque()
        # Finalized ring, read by events() from any thread.
        self._ring_lock = threading.Lock()
        self._ring: deque = deque(maxlen=ring_capacity)
        self._worker = threading.Thread(
            target=self._capture_loop, name="replay-recorder", daemon=True)
        self._worker.start()

    # -- hot-path capture (scheduling core / service hooks) ---------------

    def record_decision(self, peer, candidates: Sequence, ranked: Sequence,
                        total_piece_count: int) -> None:
        """One delivered candidate-parents decision: ``candidates`` in
        filter order, ``ranked`` the delivered top-k (subset of
        ``candidates``, best first).

        Feature rows and Welford snapshots are extracted HERE, on the
        announce thread: they are the decision-time evidence — captured
        a beat later they would already reflect the decision's own
        consequences (measured: the child's finished count had jumped
        to the full piece count before an async capture ran, skewing
        every training row). The extraction is pure Python over
        O(candidates) attributes (~tens of µs, inside the 5% overhead
        guard); record ASSEMBLY and IO stay on the capture thread."""
        # Shed BEFORE extracting: a saturated queue is exactly the
        # overloaded case — charging the announce thread the full
        # extraction cost for an event that is about to be dropped
        # would spend the overhead budget on discarded work.
        with self._cond:
            if self._closed or len(self._queue) >= self.queue_capacity:
                # Bounded capture: shedding NEW decisions (counted) is
                # the safe overflow behavior — outcomes get 2x headroom
                # below because dropping one strands pending entries
                # until eviction.
                self.dropped += 1
                return
        candidates = tuple(candidates)
        truncated = len(candidates) > MAX_REPLAY_CANDIDATES
        if truncated:
            candidates = candidates[:MAX_REPLAY_CANDIDATES]
        features = _feature_rows(peer, candidates, total_piece_count)
        snapshots = [welford_snapshot(c) for c in candidates]
        item = ("decision", peer, candidates,
                tuple(c.id for c in ranked), total_piece_count,
                time.time_ns(), features, snapshots, truncated)
        with self._cond:
            if self._closed or len(self._queue) >= self.queue_capacity:
                self.dropped += 1  # filled while extracting — still shed
                return
            self._queue.append(item)
            self._cond.notify()

    def record_back_to_source(self, peer) -> None:
        """A back-to-source verdict: no candidates, finalized on the
        capture thread immediately (there is no per-candidate realized
        cost to wait for; the verdict itself is part of the decision
        sequence)."""
        item = ("b2s", peer, peer.task.id, peer.task.total_piece_count,
                time.time_ns())
        with self._cond:
            if self._closed or len(self._queue) >= self.queue_capacity:
                self.dropped += 1
                return
            self._queue.append(item)
            self._cond.notify()

    def record_outcome(self, peer) -> None:
        """The child's terminal report: finalize every pending decision
        for it, reading each candidate's cost statistics as the realized
        costs. Rides the same FIFO as decisions, so a peer's outcome
        always processes after its decisions.

        Outcomes get 2x the decision headroom before shedding (dropping
        one strands its pending entries until the ``max_pending``
        eviction sweeps them with an empty outcome — degraded labels,
        but bounded; an UNbounded outcome queue would instead pin peer
        references without limit on exactly the overloaded path the
        shedding protects)."""
        item = ("outcome", peer, peer.fsm.current,
                float(getattr(peer, "cost", 0.0)))
        with self._cond:
            if (self._closed
                    or len(self._queue) >= 2 * self.queue_capacity):
                self.dropped += 1
                return
            self._queue.append(item)
            self._cond.notify()

    # -- capture thread ----------------------------------------------------

    def _capture_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue and self._closed:
                    return
                self._busy = True
            # One drain = up to DRAIN_BATCH_MAX items staged, then ONE
            # commit: one 2-D float32 fold over every staged feature
            # row, one ring extend, one dataset-sink append. Realized
            # costs are still read per item AT PROCESS TIME, so
            # batching never shifts what a record observes. The yield
            # AFTER EVERY ITEM is load-bearing: a burst of queued
            # events would otherwise keep this thread GIL-resident for
            # a full sys.setswitchinterval slice (5 ms default), and
            # any announce thread colliding with that slice eats it
            # whole — measured ~2x announce p99 per-item, and a
            # drain-sized hold measured 1.47x on the p99 guard (bound
            # 1.05x) before the per-item sleep was restored. The sleep
            # caps the continuous hold at ONE item's work (~0.1 ms)
            # and keeps this thread mostly unrunnable so it rarely
            # contends for the core; ~1k items/s of capture throughput
            # is far above any realistic decision rate (the 100k-peer
            # cluster ladder averages ~170/s) — batching buys the IO
            # and fold amortization, not a GIL-budget increase.
            staged: list = []
            processed = 0
            while True:
                with self._cond:
                    if not self._queue or processed >= DRAIN_BATCH_MAX:
                        break
                    item = self._queue.popleft()
                try:
                    self._process(item, staged)
                except Exception:  # noqa: BLE001 — capture must never die
                    import logging

                    logging.getLogger(__name__).exception(
                        "replay capture failed for %s event", item[0])
                processed += 1
                time.sleep(0.001)
            try:
                self._commit(staged)
            except Exception:  # noqa: BLE001 — capture must never die
                import logging

                logging.getLogger(__name__).exception(
                    "replay batch commit failed (%d records)", len(staged))
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()
            time.sleep(0.001)

    def _process(self, item, staged: list) -> None:
        """Process one queued item, appending any finalized output onto
        ``staged`` (see _commit) instead of touching the ring/sink."""
        kind = item[0]
        if kind == "decision":
            (_, peer, candidates, ranked_ids, total, decided_at,
             features, snapshots, truncated) = item
            self._capture_decision(peer, candidates, ranked_ids, total,
                                   decided_at, features, snapshots,
                                   truncated, staged)
        elif kind == "b2s":
            _, peer, task_id, total, decided_at = item
            seq = self._seq
            self._seq += 1
            staged.append(("ready", ReplayDecision(
                version=REPLAY_SCHEMA_VERSION, seq=seq,
                task_id=task_id, peer_id=peer.id,
                total_piece_count=total,
                verdict=VERDICT_BACK_TO_SOURCE,
                decided_at=decided_at, finalized_at=time.time_ns(),
            )))
            self._stats.observe_replay(decision=True, finalized=True)
        elif kind == "outcome":
            _, peer, state, cost = item
            batch = self._pending.pop(peer.id, None)
            if not batch:
                return
            self._pending_count -= len(batch)
            for pending in batch:
                self._stage_finalize(staged, pending, outcome=state,
                                     outcome_cost=cost)
                self._stats.observe_replay(finalized=True)
            self._maybe_compact_order()
        else:  # finalize_all
            batches = list(self._pending.values())
            self._pending.clear()
            self._pending_count = 0
            self._pending_order.clear()
            for batch in batches:
                for pending in batch:
                    self._stage_finalize(staged, pending, outcome="",
                                         outcome_cost=0.0)
                    self._stats.observe_replay(finalized=True)

    def _capture_decision(self, peer, candidates, ranked_ids, total,
                          decided_at, features, snapshots,
                          truncated, staged: list) -> None:
        if truncated:
            self._stats.observe_replay(truncated=True)
        rank_of = {cid: i for i, cid in enumerate(ranked_ids)}
        seq = self._seq
        self._seq += 1
        pending = _Pending(
            seq=seq, task_id=peer.task.id, peer_id=peer.id,
            total_piece_count=total,
            chosen=ranked_ids[0] if ranked_ids else "",
            decided_at=decided_at,
            ids=[c.id for c in candidates],
            ranks=[rank_of.get(c.id, -1) for c in candidates],
            features=features,
            snapshots=snapshots,
            refs=list(candidates),
        )
        self._pending.setdefault(peer.id, []).append(pending)
        self._pending_order.append((peer.id, seq))
        self._pending_count += 1
        self._stats.observe_replay(decision=True)
        if self._pending_count > self.max_pending:
            evicted = self._pop_oldest()
            if evicted is not None:
                # A child that never terminated: finalize with what we
                # have (realized costs up to NOW, empty outcome) rather
                # than leaking the entry.
                self._stage_finalize(staged, evicted, outcome="",
                                     outcome_cost=0.0)
                self._stats.observe_replay(evicted=True)

    # -- read side --------------------------------------------------------

    def rebind_stats(self, stats: controlstats.ControlPlaneStats) -> None:
        """Point the recorder's counters at a different stats block —
        benches inject a rung-scoped hermetic block. Must be called
        BEFORE any record_* call; rebinding mid-capture would split one
        rung's counters across two blocks."""
        self._stats = stats

    def drain(self, timeout: float = 10.0) -> bool:
        """Block until the capture queue is empty AND the worker is idle
        (tests/benches: every record_* call made before this has been
        fully processed)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._queue or self._busy:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(timeout=min(left, 0.05))
        return True

    def events(self) -> List[ReplayDecision]:
        """Finalized events in the in-memory ring (newest-capped)."""
        with self._ring_lock:
            return list(self._ring)

    def pending_count(self) -> int:
        return self._pending_count

    def flush(self) -> None:
        if self.storage is not None:
            self.storage.replay.flush()

    def finalize_all(self) -> None:
        """Finalize everything still pending (bench/daemon teardown) —
        realized costs as of now, empty outcome. Runs ON the capture
        thread (enqueued behind every earlier event) so pending state is
        never touched cross-thread; returns after it completed."""
        with self._cond:
            self._queue.append(("finalize_all",))
            self._cond.notify()
        self.drain()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._worker.join(timeout=5)

    # -- internals --------------------------------------------------------

    def _maybe_compact_order(self) -> None:
        """Prune finalized entries out of the eviction-order deque.

        Outcome finalization pops entries from ``_pending`` but leaves
        their ``(peer_id, seq)`` tuples behind — on a healthy swarm
        (outcomes always arrive, so ``_pop_oldest`` never runs) the
        deque would otherwise grow one stale tuple per decision
        FOREVER. Amortized: rebuild only when stale entries dominate
        (> 4x the live count, past a small floor), so the O(order)
        sweep costs O(1) per finalized event. Capture-thread only."""
        if len(self._pending_order) <= max(4 * self._pending_count, 64):
            return
        live = {(p.peer_id, p.seq)
                for batch in self._pending.values() for p in batch}
        self._pending_order = deque(
            entry for entry in self._pending_order if entry in live)

    def _pop_oldest(self) -> Optional[_Pending]:
        while self._pending_order:
            peer_id, seq = self._pending_order.popleft()
            batch = self._pending.get(peer_id)
            if not batch:
                continue
            for i, pending in enumerate(batch):
                if pending.seq == seq:
                    batch.pop(i)
                    if not batch:
                        del self._pending[peer_id]
                    self._pending_count -= 1
                    return pending
        return None

    def _stage_finalize(self, staged: list, pending: _Pending, *,
                        outcome: str, outcome_cost: float) -> None:
        """Read the realized evidence NOW (batching must not shift what
        a record observes: the realized costs are 'as of the terminal
        event's processing', exactly as the per-event path read them)
        and stage the record's ingredients for _commit; the float32
        feature fold is deferred so one drain folds every row at once."""
        realized = [welford_snapshot(ref) for ref in pending.refs]
        staged.append(("fin", pending, outcome, outcome_cost, realized,
                       time.time_ns()))

    def _commit(self, staged: list) -> None:
        """Assemble and append every record staged by one drain: ONE
        float32 fold over all feature rows (the rounding makes each
        stored row exactly what ``build_feature_matrix`` would have
        staged — one 2-D vectorized cast for the whole drain, not one
        per row, capture-thread budget), ONE ring extend, ONE buffered
        dataset-sink call."""
        if not staged:
            return
        rows: list = []
        for entry in staged:
            if entry[0] == "fin":
                rows.extend(entry[1].features)
        # Feature rows are fixed-arity tuples, so the fold is a single
        # [total_rows, FEATURE_DIM] cast.
        rows32 = np.asarray(rows, np.float32).tolist() if rows else []
        records = []
        ri = 0
        for ei, entry in enumerate(staged):
            # Same GIL discipline as the drain loop: record assembly is
            # pure Python, so yield every few records to keep the
            # continuous hold at one item's scale.
            if ei and ei % 2 == 0:
                time.sleep(0.001)
            if entry[0] == "ready":
                records.append(entry[1])
                continue
            _, pending, outcome, outcome_cost, realized, finalized_at = entry
            candidates = []
            for i, cid in enumerate(pending.ids):
                n0, last0, mean0, pstd0 = pending.snapshots[i]
                row32 = rows32[ri]
                ri += 1
                candidates.append(ReplayCandidate(
                    id=cid, rank=pending.ranks[i],
                    features=ReplayFeatureRow(
                        **dict(zip(_FEATURE_FIELDS, row32))),
                    cost_n=int(n0), cost_last=float(last0),
                    cost_prior_mean=float(mean0),
                    cost_prior_pstd=float(pstd0),
                    realized_n=int(realized[i][0]),
                    realized_cost=float(snapshot_mean(realized[i])),
                ))
            records.append(ReplayDecision(
                version=REPLAY_SCHEMA_VERSION, seq=pending.seq,
                task_id=pending.task_id, peer_id=pending.peer_id,
                total_piece_count=pending.total_piece_count,
                verdict=VERDICT_PARENTS, chosen=pending.chosen,
                outcome=outcome, outcome_cost=outcome_cost,
                decided_at=pending.decided_at, finalized_at=finalized_at,
                candidates=candidates,
            ))
        if not records:
            return
        with self._ring_lock:
            self._ring.extend(records)
        if self.storage is not None:
            self.storage.create_replay_batch(records)
        self._stats.observe_replay(appended_batch=True)
