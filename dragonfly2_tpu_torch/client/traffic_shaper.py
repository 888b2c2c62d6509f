"""Per-task bandwidth allocation.

Reference counterpart: client/daemon/peer/traffic_shaper.go:36-271 — two
strategies: ``plain`` (every task draws from one global token bucket) and
``sampling`` (per-second usage sampling; each task gets a per-task limiter
whose rate is recomputed from observed demand, surplus redistributed to
needy tasks, with a bandwidth floor of one piece size per task).
"""

from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from dragonfly2_tpu_torch.client.piece import DEFAULT_PIECE_SIZE
from dragonfly2_tpu_torch.utils.ratelimit import INF, Limiter

TYPE_PLAIN = "plain"
TYPE_SAMPLING = "sampling"


class TrafficShaper:
    """Interface (traffic_shaper.go:36-54)."""

    def start(self) -> None: ...
    def stop(self) -> None: ...

    def add_task(self, task_id: str, content_length: int = -1,
                 traffic_class: str = "") -> None:
        """Register a task; ``traffic_class`` scopes its share under the
        hierarchical (class-weighted) allocation when the shaper has
        class weights configured, and is ignored otherwise."""

    def remove_task(self, task_id: str) -> None: ...
    def record(self, task_id: str, n: int) -> None:
        """Account ``n`` bytes downloaded for the task."""

    def wait_n(self, task_id: str, n: int) -> None:
        """Block until the task may transfer ``n`` bytes.

        Granularity contract: p2p workers and the unknown-length stream
        path wait once per piece; the coalesced back-to-source path
        waits once per RUN, BEFORE its single ranged GET is issued —
        waiting between pieces of one open response would idle the
        source connection mid-body into origin send-timeouts. ``record``
        is per piece on every path, so demand sampling sees the same
        signal regardless of how many pieces share one request."""

    def reserve_n(self, task_id: str, n: int) -> float:
        """Nonblocking form of ``wait_n`` for the event-loop download
        engine: deduct the tokens NOW and return the delay (seconds) the
        caller should park on its timer wheel before transferring —
        loops never sleep a rate limit. Same once-per-piece /
        once-per-run granularity contract as ``wait_n``."""
        return 0.0

    def return_n(self, task_id: str, n: int) -> None:
        """Refund tokens a caller reserved but provably never moved
        (a stream that died mid-body refunds its unreceived tail) — the
        upload engine's unsent-reservation refund, download side."""


class PlainTrafficShaper(TrafficShaper):
    """All tasks share the global limiter (traffic_shaper.go plain mode)."""

    def __init__(self, total_rate_bps: float = INF):
        self._limiter = Limiter(total_rate_bps,
                                burst=int(total_rate_bps) if total_rate_bps != INF else None)

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def add_task(self, task_id: str, content_length: int = -1,
                 traffic_class: str = "") -> None:
        pass

    def remove_task(self, task_id: str) -> None:
        pass

    def record(self, task_id: str, n: int) -> None:
        pass

    def wait_n(self, task_id: str, n: int) -> None:
        self._limiter.wait_n(min(n, self._limiter.burst))

    def reserve_n(self, task_id: str, n: int) -> float:
        return self._limiter.reserve_n(min(n, self._limiter.burst))

    def return_n(self, task_id: str, n: int) -> None:
        self._limiter.return_n(min(n, self._limiter.burst))


@dataclass
class _TaskEntry:
    limiter: Limiter
    used: int = 0           # bytes since last sample
    needed: int = 0         # bytes requested since last sample
    content_length: int = -1
    traffic_class: str = ""  # QoS class scoping this task's share
    created_at: float = field(default_factory=time.time)


class _ShaperShard:
    """One shard of the task map: its own lock + dict, so the per-piece
    ``wait_n``/``record`` hot path of one task never serializes against
    another task's (they hash to different shards 1-1/N of the time)."""

    __slots__ = ("lock", "tasks")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.tasks: Dict[str, _TaskEntry] = {}


class SamplingTrafficShaper(TrafficShaper):
    """Per-second demand sampling with surplus redistribution
    (traffic_shaper.go:139-271).

    The task map is sharded (crc32(task_id) % ``shards``, same scheme as
    the scheduler's resource managers): ``wait_n``/``record`` are taken
    once per piece by EVERY worker of EVERY task, and with the
    event-loop upload engine raising connection density per daemon, one
    global lock on that path was the next serialization point. Only the
    once-per-interval ``update_limits`` sweep touches all shards (one at
    a time — never holding two shard locks at once)."""

    def __init__(self, total_rate_bps: float, interval: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 shards: int = 8, class_weights: Optional[Dict[str, float]]
                 = None, qos_stats=None):
        self.total_rate = float(total_rate_bps)
        self.interval = interval
        self._clock = clock
        #: Hierarchical mode (docs/QOS.md): class weight splits the link
        #: first, demand-proportional shares within the class, and a
        #: class's unused budget is redistributed to over-demand classes.
        #: None = the historical flat demand-proportional allocation.
        self.class_weights = dict(class_weights) if class_weights else None
        if qos_stats is None and self.class_weights is not None:
            from dragonfly2_tpu_torch.client.qos import QOS as qos_stats
        self.qos_stats = qos_stats
        self._shards: Tuple[_ShaperShard, ...] = tuple(
            _ShaperShard() for _ in range(max(shards, 1)))
        # Serializes task ADMISSION only (rare — once per task): two
        # concurrent add_tasks reading the same count would both grant
        # total/n for the same n, oversubscribing the link until the
        # next sweep. The per-piece wait_n/record path never takes it.
        self._admission_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _shard(self, task_id: str) -> _ShaperShard:
        return self._shards[
            zlib.crc32(task_id.encode()) % len(self._shards)]

    def _entry(self, task_id: str) -> Optional[_TaskEntry]:
        shard = self._shard(task_id)
        with shard.lock:
            return shard.tasks.get(task_id)

    def _all_entries(self) -> List[_TaskEntry]:
        out: List[_TaskEntry] = []
        for shard in self._shards:
            with shard.lock:
                out.extend(shard.tasks.values())
        return out

    def task_count(self) -> int:
        return sum(len(s.tasks) for s in self._shards)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="traffic-shaper", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.update_limits()

    def add_task(self, task_id: str, content_length: int = -1,
                 traffic_class: str = "") -> None:
        # A new task starts with an equal share of the total rate
        # (traffic_shaper.go AddTask: totalRateLimit / (nTasks+1)).
        # Lock order: admission → shard (shard locks stay leaves).
        with self._admission_lock:
            n = self.task_count() + 1
            share = self.total_rate / n
            shard = self._shard(task_id)
            with shard.lock:
                shard.tasks[task_id] = _TaskEntry(
                    limiter=Limiter(share, burst=int(share)),
                    content_length=content_length,
                    traffic_class=traffic_class,
                )

    def remove_task(self, task_id: str) -> None:
        shard = self._shard(task_id)
        with shard.lock:
            shard.tasks.pop(task_id, None)

    def record(self, task_id: str, n: int) -> None:
        shard = self._shard(task_id)
        with shard.lock:
            entry = shard.tasks.get(task_id)
            if entry is not None:
                entry.used += n
                klass = entry.traffic_class
            else:
                klass = ""
        if klass and self.qos_stats is not None:
            self.qos_stats.shaper_grant(klass, n)

    def wait_n(self, task_id: str, n: int) -> None:
        shard = self._shard(task_id)
        with shard.lock:
            entry = shard.tasks.get(task_id)
            if entry is not None:
                entry.needed += n
                limiter = entry.limiter
            else:
                limiter = None
        if limiter is not None:
            limiter.wait_n(min(n, limiter.burst))

    def reserve_n(self, task_id: str, n: int) -> float:
        shard = self._shard(task_id)
        with shard.lock:
            entry = shard.tasks.get(task_id)
            if entry is None:
                return 0.0
            entry.needed += n
            limiter = entry.limiter
        return limiter.reserve_n(min(n, limiter.burst))

    def return_n(self, task_id: str, n: int) -> None:
        entry = self._entry(task_id)
        if entry is not None:
            entry.limiter.return_n(min(n, entry.limiter.burst))

    def update_limits(self) -> None:
        """Recompute per-task rates from last-interval demand: tasks that
        used less than their allocation donate the surplus to those that
        wanted more, floored at one piece size/sec each.

        Stages every entry's demand shard by shard (resetting the
        counters under each shard lock), then sets rates lock-free: the
        limiters have their own locks, and an entry removed mid-sweep
        just gets one harmless final ``set_rate``. The share math over
        the staged snapshot is identical to the old single-lock sweep."""
        staged: List[Tuple[_TaskEntry, int]] = []
        for shard in self._shards:
            with shard.lock:
                for entry in shard.tasks.values():
                    staged.append((entry, max(entry.used, entry.needed)))
                    entry.used = 0
                    entry.needed = 0
        if not staged:
            return
        if self.class_weights is not None:
            self._update_limits_hierarchical(staged)
            return
        self._apply_shares(staged, self.total_rate)

    def _apply_shares(self, staged: List[Tuple[_TaskEntry, int]],
                      budget: float) -> None:
        """Demand-proportional split of ``budget`` over ``staged`` with
        the per-task one-piece/sec floor — the original flat allocation,
        reused per class by the hierarchical path."""
        total_demand = sum(d for _, d in staged)
        for entry, demand in staged:
            if total_demand > 0:
                share = budget * (demand / total_demand)
            else:
                share = budget / len(staged)
            share = min(max(share, DEFAULT_PIECE_SIZE), self.total_rate)
            entry.limiter.set_rate(share, burst=int(share))

    def _update_limits_hierarchical(
            self, staged: List[Tuple[_TaskEntry, int]]) -> None:
        """Class-weighted link split: each PRESENT class gets
        ``total_rate * w_c / W``; a class that demands less than its
        budget donates the surplus, redistributed to over-demand classes
        proportional to their unmet demand (single water-fill pass).
        Within a class the flat demand-proportional math applies
        unchanged, so one bulk tenant can saturate only bulk's share."""
        by_class: Dict[str, List[Tuple[_TaskEntry, int]]] = {}
        for entry, demand in staged:
            by_class.setdefault(entry.traffic_class, []).append(
                (entry, demand))
        weight_total = sum(
            self.class_weights.get(c, 1.0) for c in by_class)
        budget: Dict[str, float] = {}
        demand_eff: Dict[str, float] = {}
        for klass, items in by_class.items():
            budget[klass] = (self.total_rate
                             * self.class_weights.get(klass, 1.0)
                             / weight_total)
            # Effective demand never reads below the per-task floor the
            # flat math guarantees — idle classes still donate the rest.
            demand_eff[klass] = max(
                float(sum(d for _, d in items)),
                len(items) * float(DEFAULT_PIECE_SIZE))
        alloc = {c: min(budget[c], demand_eff[c]) for c in by_class}
        surplus = self.total_rate - sum(alloc.values())
        unmet = {c: max(0.0, demand_eff[c] - budget[c]) for c in by_class}
        unmet_total = sum(unmet.values())
        if surplus > 0 and unmet_total > 0:
            for klass in by_class:
                alloc[klass] += surplus * unmet[klass] / unmet_total
        for klass, items in by_class.items():
            self._apply_shares(items, alloc[klass])
            if self.qos_stats is not None and klass:
                self.qos_stats.shaper_rate(klass, alloc[klass])


def new_traffic_shaper(kind: str, total_rate_bps: float = INF,
                       class_weights: Optional[Dict[str, float]] = None,
                       ) -> TrafficShaper:
    """(traffic_shaper.go:36-54 NewTrafficShaper)"""
    if kind == TYPE_SAMPLING and total_rate_bps != INF:
        return SamplingTrafficShaper(total_rate_bps,
                                     class_weights=class_weights)
    return PlainTrafficShaper(total_rate_bps)
