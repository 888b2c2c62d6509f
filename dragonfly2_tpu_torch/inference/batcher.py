"""Request micro-batching — port of ``dragonfly2_tpu/inference/batcher.py``.

One scorer dispatch per request makes latency grow with queue depth under
concurrent scheduler threads. :class:`MicroBatcher` coalesces requests
that arrive while a dispatch is in flight into ONE padded device call,
so N concurrent requests share one dispatch; the worst-case extra
latency is one in-flight dispatch, and throughput scales to ``max_rows``
rows per dispatch.

**Lanes.** The batcher shards into ``lanes`` independent lanes, each
with its own request queue, worker thread and in-flight slot; the
scorer's staging pool grows to ``2 × lanes`` buffers per bucket, so lane
workers stage, dispatch and retire concurrently. Requests take a lane
round-robin at arrival.

**Load-aware lane activation.** Requests round-robin over the ACTIVE
lane subset, which starts at one lane and grows only when the assigned
lane's queue depth reaches ``lane_grow_depth`` (by default the number of
nominal requests one ``max_rows`` dispatch drains): while a lane's
backlog fits one padded dispatch, more lanes only fragment coalescing.
The active set shrinks after ``SHRINK_AFTER_IDLE_ADMITS`` empty-queue
admissions in a row. ``lane_grow_depth=0`` keeps every lane active from
the start (static sharding).

**Bounded admission.** Each lane's queue takes a depth cap
(``queue_depth``; 0 = unbounded). A request whose round-robin lane is at
its cap fails at once with :class:`BatcherSaturatedError`: no spill to
sibling lanes, and requests already queued are never dropped. The
inference service maps the error to RESOURCE_EXHAUSTED and the ``ml``
evaluator absorbs it in its rule fallback, so a saturated serving plane
degrades to rule scoring instead of stacking queues.

Per lane, the worker loop is a two-stage pipeline with one in-flight
slot: batch N is dispatched asynchronously (``score_async`` returns an
unmaterialized handle), and while the device works on it the worker
drains its queue and stages batch N+1 into the scorer's preallocated
host buffers; it blocks on N's result only after N+1 is dispatched.
Scorers without ``score_async`` run synchronously. On the card this
needs a handle that waits for its own dispatch only: the port's scorers
copy each result to pinned host memory at dispatch time and record an
event there (``inference/scorer.py``).

Batch close is deadline-aware: with ``max_wait_s=0`` a lane never waits
— it blocks for the first request, then drains whatever queued meanwhile.
A positive ``max_wait_s`` holds every batch open up to that long for
stragglers; ``adaptive_wait_s`` opens that window only when the lane's
queue depth strictly grows, so the idle path keeps the zero-wait
guarantee.

The JAX package's ``infer.batch`` tracing span around each dispatch is
not ported (the port has no tracer yet).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

_SOJOURN_RING = 4096  # per-lane request-latency samples kept for p99


class BatcherSaturatedError(RuntimeError):
    """The assigned lane's queue is at its depth cap; the request was
    shed (fail-fast) instead of queued. Callers degrade to rule-based
    scoring — the error is expected under overload, not a fault."""


class _Pending:
    __slots__ = ("features", "event", "result", "error", "t_enqueue")

    def __init__(self, features: np.ndarray):
        self.features = features
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[Exception] = None
        self.t_enqueue = 0.0


class _Inflight:
    """A dispatched-but-unmaterialized batch: the request group plus a
    blocking fetch of the stacked scores (a ScoreHandle.materialize for
    async scorers, a lambda over the already-computed array for sync
    ones)."""

    __slots__ = ("group", "fetch")

    def __init__(self, group: List[_Pending],
                 fetch: Callable[[], np.ndarray]):
        self.group = group
        self.fetch = fetch


class _Lane:
    """One shard of the batcher: a bounded queue, a pipelined worker
    with one in-flight slot, and single-writer counters (the worker
    owns every counter except ``sheds``, which ``MicroBatcher.score``
    increments under the batcher's close lock)."""

    def __init__(self, scorer, index: int, max_rows: int,
                 max_wait_s: float, adaptive_wait_s: float,
                 adaptive_open_depth: int, queue_depth: int):
        self.scorer = scorer
        self.index = index
        self.max_rows = max_rows
        self.max_wait_s = max_wait_s
        self.adaptive_wait_s = adaptive_wait_s
        self.adaptive_open_depth = adaptive_open_depth
        self.queue_depth = queue_depth
        self.queue: "queue.Queue[Optional[_Pending]]" = queue.Queue(
            maxsize=queue_depth)
        self.dispatches = 0
        self.coalesced_requests = 0
        self.pipelined_dispatches = 0   # staged while another was in flight
        self.stage_overlap_s = 0.0      # assembly time hidden behind device
        self.window_wait_s = 0.0        # deliberate batch-window wait
        self.block_s = 0.0              # time actually blocked on results
        self.adaptive_opens = 0         # times the adaptive window opened
        self.max_queue_depth = 0
        self.sheds = 0                  # written by score() under close lock
        self.bucket_hits: Dict[int, int] = {}
        self._last_depth = 0
        # Request sojourn (enqueue → result fan-out) ring, single-writer
        # (the worker); stats() reads it racily, which can at worst mix
        # samples from adjacent requests — fine for a monitoring p99.
        self._sojourn_ms = np.zeros(_SOJOURN_RING, np.float32)
        self._sojourn_n = 0
        self.worker = threading.Thread(
            target=self._loop, daemon=True,
            name=f"infer-microbatch-{index}")
        self.worker.start()

    # -- worker loop: stage half + dispatch half ---------------------------

    def _window_deadline(self) -> float:
        """Batch-close deadline for the group being assembled, or 0.0
        for "never wait". A fixed ``max_wait_s`` wins; otherwise the
        adaptive controller opens a window only on queue growth.

        (An EWMA hold-until-device-done window was tried here and
        removed: on hosts with noisy device times the predictor
        systematically overholds, inflating mid-load p50/p99 by more
        than its coalescing gain is worth.)"""
        depth = self.queue.qsize()
        if depth > self.max_queue_depth:
            self.max_queue_depth = depth
        # Track depth on EVERY batch regardless of which window source
        # wins — otherwise the growth test below would compare against a
        # depth from many batches ago and misread a steady queue as
        # growing.
        prev_depth, self._last_depth = self._last_depth, depth
        if self.max_wait_s > 0:
            return time.monotonic() + self.max_wait_s
        if self.adaptive_wait_s > 0:
            # STRICT growth: a steady queue (light load in equilibrium,
            # or full saturation where the drain fills the batch anyway)
            # never pays the window — only a building backlog does, and
            # there the bigger batch is what drains it.
            growing = (depth >= self.adaptive_open_depth
                       and depth > prev_depth)
            if growing:
                self.adaptive_opens += 1
                return time.monotonic() + self.adaptive_wait_s
        return 0.0

    def _loop(self) -> None:
        carry: Optional[_Pending] = None
        inflight: Optional[_Inflight] = None
        while True:
            if carry is not None:
                first, carry = carry, None
            elif inflight is not None:
                # Stage half: batch N is on the device; grab whatever is
                # queued for N+1 without blocking. Only when the queue is
                # empty do we give up the overlap and retire N (its
                # callers must not wait for traffic that may never come).
                try:
                    first = self.queue.get_nowait()
                except queue.Empty:
                    inflight = self._retire(inflight)
                    first = self.queue.get()
            else:
                first = self.queue.get()
            if first is None:
                # close(): serve everything already queued, then exit
                # — callers racing a model reload must never hang.
                inflight = self._retire(inflight)
                self._drain_remaining()
                return
            t_stage = time.monotonic()
            window_wait = 0.0
            group: List[_Pending] = [first]
            rows = len(first.features)
            saw_sentinel = False
            # Drain whatever is already queued, up to the device batch.
            # A positive window (fixed or adaptive) also holds the batch
            # open for stragglers until the deadline — measured from the
            # FIRST request, so its queueing delay is bounded by the
            # window regardless of how many stragglers trickle in.
            deadline = self._window_deadline()
            while rows < self.max_rows:
                try:
                    if deadline:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        # Window wait is accounted separately from
                        # assembly: it is a deliberate straggler hold,
                        # and folding it into stage_overlap_s would pin
                        # overlap_ratio at ~1 whenever a window is on.
                        t_wait = time.monotonic()
                        try:
                            nxt = self.queue.get(timeout=remaining)
                        finally:
                            window_wait += time.monotonic() - t_wait
                    else:
                        nxt = self.queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    saw_sentinel = True
                    break
                if rows + len(nxt.features) > self.max_rows:
                    # Doesn't fit this dispatch — it LEADS the next group
                    # (re-queueing to the back would let a stream of small
                    # requests starve a large one past its timeout).
                    carry = nxt
                    break
                group.append(nxt)
                rows += len(nxt.features)
            # Dispatch half: ship N+1 to the device, THEN block for N —
            # the whole point of the in-flight slot.
            staged = self._stage_dispatch(group)
            self.window_wait_s += window_wait
            if inflight is not None:
                self.stage_overlap_s += max(
                    time.monotonic() - t_stage - window_wait, 0.0)
                if staged is not None:
                    self.pipelined_dispatches += 1
                inflight = self._retire(inflight)
            inflight = staged
            if saw_sentinel:
                inflight = self._retire(inflight)
                if carry is not None:
                    inflight = self._retire(self._stage_dispatch([carry]))
                self._drain_remaining()
                return

    def _drain_remaining(self) -> None:
        while True:
            try:
                pending = self.queue.get_nowait()
            except queue.Empty:
                return
            if pending is not None:
                self._retire(self._stage_dispatch([pending]))

    def _stage_dispatch(self, group: List[_Pending]) -> Optional[_Inflight]:
        """Assemble and dispatch one group (the JAX package's
        ``_stage_dispatch_impl``; its span wrapper is not ported). Returns the in-flight record,
        or None when there is nothing left to retire — the sync-scorer
        path fans results out right here (its scores exist the moment
        score() returns; parking them in the in-flight slot would make
        callers wait out the NEXT batch's compute for zero overlap), and
        so does the error path."""
        self.dispatches += 1
        self.coalesced_requests += len(group)
        try:
            stacked = (group[0].features if len(group) == 1 else
                       np.concatenate([p.features for p in group], axis=0))
            score_async = getattr(self.scorer, "score_async", None)
            if score_async is not None:
                handle = score_async(stacked)
                bucket = getattr(handle, "bucket", len(stacked))
                self.bucket_hits[bucket] = self.bucket_hits.get(bucket, 0) + 1
                return _Inflight(group, handle.materialize)
            self._fan_out(group, self.scorer.score(stacked))
            return None
        except Exception as exc:  # noqa: BLE001 — fan the error out
            for p in group:
                p.error = exc
                p.event.set()
            return None

    def _retire(self, inflight: Optional[_Inflight]) -> None:
        """Block on an in-flight dispatch and fan its results (or its
        error) out to the waiting callers. Always returns None so callers
        can write ``inflight = self._retire(inflight)``."""
        if inflight is None:
            return None
        t0 = time.monotonic()
        try:
            scores = inflight.fetch()
        except Exception as exc:  # noqa: BLE001 — fan the error out
            for p in inflight.group:
                p.error = exc
                p.event.set()
            return None
        self.block_s += time.monotonic() - t0
        try:
            self._fan_out(inflight.group, scores)
        except Exception as exc:  # noqa: BLE001 — a malformed result
            # (wrong shape, non-array) must fan out like any scorer
            # error; letting it propagate would kill the worker and hang
            # every later caller until timeout.
            for p in inflight.group:
                p.error = exc
                p.event.set()
        return None

    def _fan_out(self, group: List[_Pending], scores: np.ndarray) -> None:
        # Slice everything BEFORE waking anyone: if the result is
        # malformed this throws with no events set, so the caller's
        # error fan-out reaches the whole group cleanly.
        off = 0
        outs = []
        for p in group:
            n = len(p.features)
            outs.append(scores[off:off + n])
            off += n
        now = time.monotonic()
        for p, out in zip(group, outs):
            self._sojourn_ms[self._sojourn_n % _SOJOURN_RING] = (
                now - p.t_enqueue) * 1e3
            self._sojourn_n += 1
            p.result = out
            p.event.set()

    def sojourn_p99_ms(self) -> float:
        n = min(self._sojourn_n, _SOJOURN_RING)
        if n == 0:
            return 0.0
        return float(np.percentile(self._sojourn_ms[:n], 99))

    def stats(self) -> dict:
        dispatches = self.dispatches
        coalesced = self.coalesced_requests
        return {
            "lane": self.index,
            "dispatches": dispatches,
            "coalesced_requests": coalesced,
            "coalesce_factor": round(coalesced / dispatches, 2)
            if dispatches else 0.0,
            "pipelined_dispatches": self.pipelined_dispatches,
            "sheds": self.sheds,
            "adaptive_opens": self.adaptive_opens,
            "max_queue_depth": self.max_queue_depth,
            "p99_ms": round(self.sojourn_p99_ms(), 4),
        }


class MicroBatcher:
    """Thread-safe coalescing front for a :class:`ParentScorer`, sharded
    into ``lanes`` independent pipelined workers with per-lane bounded
    admission (see the module docstring for the shed policy)."""

    # Nominal parent-selection request size (the reference caps candidate
    # sets at filterParentLimit=15, constants.go:33-37) — used only to
    # derive the default lane-growth threshold from max_rows.
    NOMINAL_REQUEST_ROWS = 16
    # Consecutive empty-queue admissions before the active set shrinks by
    # one lane: long enough that a brief lull inside a busy period does
    # not flap, short enough that an idle batcher re-consolidates within
    # a few dozen requests.
    SHRINK_AFTER_IDLE_ADMITS = 64

    def __init__(self, scorer, max_rows: Optional[int] = None,
                 max_wait_s: float = 0.0, adaptive_wait_s: float = 0.0,
                 adaptive_open_depth: int = 2, lanes: int = 1,
                 queue_depth: int = 0,
                 lane_grow_depth: Optional[int] = None):
        self.scorer = scorer
        # Clamp to the scorer's capacity: a dispatch larger than
        # max_batch has no bucket and would fail EVERY coalesced request
        # in it — but only under load, when batches actually fill, which
        # is exactly when an oversized --batch-max-rows would detonate.
        self.max_rows = (min(max_rows, scorer.max_batch) if max_rows
                         else scorer.max_batch)
        if self.max_rows <= 0:
            raise ValueError(f"max_rows must be positive, got {max_rows}")
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        if queue_depth < 0:
            raise ValueError(
                f"queue_depth must be >= 0 (0 = unbounded), "
                f"got {queue_depth}")
        self.queue_depth = queue_depth
        if lane_grow_depth is None:
            # Grow only once a single lane's backlog exceeds what ONE
            # padded dispatch can drain — below that, extra lanes would
            # fragment coalescing for zero drain-rate gain.
            lane_grow_depth = max(1, self.max_rows
                                  // self.NOMINAL_REQUEST_ROWS)
        if lane_grow_depth and queue_depth:
            # The growth trigger must be reachable under the admission
            # cap, or a tiny cap would shed forever on one lane while
            # the others never activate.
            lane_grow_depth = min(lane_grow_depth, queue_depth)
        self.lane_grow_depth = lane_grow_depth
        self._active = 1 if lane_grow_depth else lanes
        self._idle_admits = 0
        self.lane_activations = 0
        # The scorer's staging pool is sized for one pipelined worker
        # (2 buffers per bucket). N lanes each keep one dispatch in
        # flight while staging the next, so they need 2×N buffers to
        # never wait on the completion guard; scorers that can't grow
        # their pool still work — lanes just serialize on the guard.
        ensure = getattr(scorer, "ensure_staging_depth", None)
        if ensure is not None and lanes > 1:
            ensure(2 * lanes)
        self._closed = False
        self._close_lock = threading.Lock()
        self._lanes = [
            _Lane(scorer, i, self.max_rows, max_wait_s, adaptive_wait_s,
                  adaptive_open_depth, queue_depth)
            for i in range(lanes)
        ]
        self._rr = itertools.count()

    @property
    def lanes(self) -> int:
        return len(self._lanes)

    @property
    def dispatches(self) -> int:
        return sum(lane.dispatches for lane in self._lanes)

    @property
    def coalesced_requests(self) -> int:
        return sum(lane.coalesced_requests for lane in self._lanes)

    @property
    def sheds(self) -> int:
        return sum(lane.sheds for lane in self._lanes)

    def score(self, features: np.ndarray, timeout: float = 30.0) -> np.ndarray:
        """Blocking; same contract as ParentScorer.score, plus
        :class:`BatcherSaturatedError` when the assigned lane is at its
        depth cap."""
        if len(features) == 0:
            return np.zeros(0, np.float32)
        if len(features) > self.max_rows:
            raise ValueError(
                f"batch {len(features)} exceeds max {self.max_rows}")
        # Preserve the caller's dtype: pair scorers take int32 host
        # indexes, and a float32 coercion would silently corrupt indexes
        # above 2^24. Float inputs still normalize to float32.
        features = np.asarray(features)
        if features.dtype.kind == "f":
            features = features.astype(np.float32, copy=False)
        pending = _Pending(features)
        # closed-check + enqueue under the same lock close() takes to set
        # the flag — otherwise a request can slip in after the final
        # drain and hang until its timeout. The shed counter and the
        # lane-activation state share the lock so concurrent callers
        # don't lose increments.
        with self._close_lock:
            if self._closed:
                raise RuntimeError(
                    "micro-batcher is closed (model reloaded)")
            lane = self._lanes[next(self._rr) % self._active]
            if self.lane_grow_depth:
                depth = lane.queue.qsize()
                if depth == 0:
                    self._idle_admits += 1
                    if (self._idle_admits >= self.SHRINK_AFTER_IDLE_ADMITS
                            and self._active > 1):
                        self._active -= 1
                        self._idle_admits = 0
                else:
                    self._idle_admits = 0
                    if (depth >= self.lane_grow_depth
                            and self._active < len(self._lanes)):
                        self._active += 1
                        self.lane_activations += 1
            pending.t_enqueue = time.monotonic()
            try:
                lane.queue.put_nowait(pending)
            except queue.Full:
                lane.sheds += 1
                raise BatcherSaturatedError(
                    f"lane {lane.index} queue at depth cap "
                    f"{self.queue_depth}; request shed") from None
        if not pending.event.wait(timeout=timeout):
            raise TimeoutError("micro-batched scoring timed out")
        if pending.error is not None:
            raise pending.error
        return pending.result

    def stats(self) -> dict:
        """Snapshot of pipeline counters, aggregated across lanes plus a
        ``per_lane`` breakdown (overlap_ratio = fraction of result-wait
        time hidden behind batch assembly). Lane counters are single-
        writer (each lane's worker); the aggregate is a racy-but-
        consistent-enough monitoring snapshot."""
        per_lane = [lane.stats() for lane in self._lanes]
        dispatches = sum(s["dispatches"] for s in per_lane)
        coalesced = sum(s["coalesced_requests"] for s in per_lane)
        pipelined = sum(s["pipelined_dispatches"] for s in per_lane)
        sheds = sum(s["sheds"] for s in per_lane)
        stage_overlap_s = sum(lane.stage_overlap_s for lane in self._lanes)
        window_wait_s = sum(lane.window_wait_s for lane in self._lanes)
        block_s = sum(lane.block_s for lane in self._lanes)
        bucket_hits: Dict[int, int] = {}
        for lane in self._lanes:
            # dict(d) is one C-level copy under the GIL, safe against a
            # concurrent insert where iterating the live dict would raise.
            for b, hits in dict(lane.bucket_hits).items():
                bucket_hits[b] = bucket_hits.get(b, 0) + hits
        busy = stage_overlap_s + block_s
        offered = coalesced + sheds
        return {
            "lanes": len(per_lane),
            "active_lanes": self._active,
            "lane_activations": self.lane_activations,
            "lane_grow_depth": self.lane_grow_depth,
            "queue_depth_cap": self.queue_depth,
            "dispatches": dispatches,
            "coalesced_requests": coalesced,
            "coalesce_factor": round(coalesced / dispatches, 2)
            if dispatches else 0.0,
            "pipelined_dispatches": pipelined,
            "inflight_depth_avg": round(pipelined / dispatches, 3)
            if dispatches else 0.0,
            "stage_overlap_s": round(stage_overlap_s, 4),
            "window_wait_s": round(window_wait_s, 4),
            "block_s": round(block_s, 4),
            "overlap_ratio": round(stage_overlap_s / busy, 3)
            if busy > 0 else 0.0,
            "adaptive_opens": sum(s["adaptive_opens"] for s in per_lane),
            "max_queue_depth": max(
                (s["max_queue_depth"] for s in per_lane), default=0),
            "sheds": sheds,
            "shed_rate": round(sheds / offered, 4) if offered else 0.0,
            "bucket_hits": dict(sorted(bucket_hits.items())),
            "per_lane": per_lane,
        }

    def close(self) -> None:
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        # Outside the lock — no score() can enqueue past the flag, so
        # each queue only drains from here. A bounded queue can still be
        # full behind a dispatch wedged in the device; a timed put (like
        # the bounded join below) keeps shutdown from hanging on it —
        # the lane worker is a daemon thread either way.
        for lane in self._lanes:
            try:
                lane.queue.put(None, timeout=5)
            except queue.Full:
                pass
        for lane in self._lanes:
            lane.worker.join(timeout=5)
