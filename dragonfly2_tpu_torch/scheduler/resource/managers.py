"""Sharded Host/Task/Peer managers with incremental TTL garbage collection.

Reference counterparts: scheduler/resource/{host,task,peer}_manager.go —
each is a concurrent map plus a pkg/gc-registered reclaim pass. TTLs match
the reference's semantics: hosts go when their last announce is stale and
they have no peers; tasks go when peerless and stale; peers go when their
state is terminal (or stale) — leaving cascades DAG cleanup.

Scale shape (swarm-scale control plane):

- **Sharded state.** Each manager's map is split into ``shard_count``
  shards (``crc32(id) % N`` — deterministic across processes so tests
  can assert routing), each with its own lock. Announce-path lookups and
  stores contend only within one shard, and a GC snapshot copies one
  shard's values, never the whole map.
- **Incremental GC.** ``run_gc`` is a TIME-BOUNDED sweep tick: it
  resumes from a persistent cursor (shard index + leftover items from a
  partially-swept shard), processes items until ``gc_budget_s`` elapses,
  and saves its position. Reclaim therefore never pauses the announce
  path for more than a bounded slice; a 100k-host sweep becomes many
  short ticks instead of one long stall. A tick that could not finish a
  full pass within budget counts as a ``gc_budget_overrun`` on the
  control-plane stats ("the sweep is falling behind"), and every tick's
  pause lands in the ``gc_pause_ms`` ring (docs/SCHEDULER.md).

Lock order: shard locks are leaves acquired before (never after) the
task/host/peer object locks they cascade into — the racecheck stress
suite (tests/test_scheduler_stress.py) certifies the order graph acyclic.
"""

from __future__ import annotations

import logging
import random
import threading
import time
import zlib
from time import perf_counter
from typing import Dict, Iterator, List, Optional

from dragonfly2_tpu_torch.scheduler import controlstats
from dragonfly2_tpu_torch.scheduler.resource.host import Host
from dragonfly2_tpu_torch.scheduler.resource.peer import Peer, PeerState
from dragonfly2_tpu_torch.scheduler.resource.task import Task, TaskEvent
from dragonfly2_tpu_torch.utils.gc import GC

logger = logging.getLogger(__name__)

DEFAULT_HOST_TTL = 6 * 60.0          # reference: host gc interval semantics
DEFAULT_TASK_TTL = 30 * 60.0
DEFAULT_PEER_TTL = 24 * 60 * 60.0
DEFAULT_GC_INTERVAL = 60.0

DEFAULT_SHARD_COUNT = 8
# Per-tick sweep budget: the longest announce-path stall one GC tick may
# cause. Items are processed in chunks of _GC_CHECK_EVERY between budget
# checks, so the realized pause can exceed the budget by one chunk's
# worth of per-item work (plus GIL/lock wait time on a contended box —
# the pause ring reports the realized wall time, not the budget).
DEFAULT_GC_BUDGET_S = 0.050
_GC_CHECK_EVERY = 16


def shard_index(item_id: str, shard_count: int) -> int:
    """Deterministic id → shard routing (stable across processes, unlike
    builtin ``hash`` under PYTHONHASHSEED randomization)."""
    return zlib.crc32(item_id.encode("utf-8", "surrogatepass")) % shard_count


class _Shard:
    __slots__ = ("items", "lock")

    def __init__(self):
        self.items: Dict[str, object] = {}
        self.lock = threading.RLock()


class _ShardedManager:
    """Common sharded-map + incremental-GC machinery."""

    GC_TASK_ID = "abstract"

    def __init__(self, ttl: float, gc: GC | None, interval: float,
                 shard_count: int = DEFAULT_SHARD_COUNT,
                 gc_budget_s: float = DEFAULT_GC_BUDGET_S,
                 stats: controlstats.ControlPlaneStats | None = None):
        if shard_count < 1:
            raise ValueError("shard_count must be >= 1")
        self.ttl = ttl
        self.gc_budget_s = gc_budget_s
        self._shards = [_Shard() for _ in range(shard_count)]
        self._stats = stats if stats is not None else controlstats.STATS
        # GC sweep state: one sweeper at a time; the cursor and the
        # partially-swept shard's leftover survive across ticks.
        self._gc_lock = threading.Lock()
        self._gc_shard_cursor = 0
        self._gc_pending: List[object] = []
        # Shards snapshotted since the current pass began — pass
        # completion must survive budget-truncated slices, or a tiny
        # budget could never finish (and never report) a full pass.
        self._gc_shards_swept = 0
        if gc is not None:
            # The interval task must finish a FULL pass per firing —
            # slice-per-interval would cap reclaim throughput at one
            # budget slice per minute and let huge maps outrun their
            # TTLs. run_gc_until_complete keeps each contiguous pause
            # bounded by the budget and yields between slices.
            gc.add(self.GC_TASK_ID, interval, self.run_gc_until_complete)

    # -- sharded map ----------------------------------------------------------

    @property
    def shard_count(self) -> int:
        return len(self._shards)

    def _shard(self, item_id: str) -> _Shard:
        return self._shards[shard_index(item_id, len(self._shards))]

    def _load(self, item_id: str):
        shard = self._shard(item_id)
        with shard.lock:
            return shard.items.get(item_id)

    def _store(self, item) -> None:
        shard = self._shard(item.id)
        with shard.lock:
            shard.items[item.id] = item

    def _setdefault(self, item):
        shard = self._shard(item.id)
        with shard.lock:
            return shard.items.setdefault(item.id, item)

    def _pop(self, item_id: str):
        shard = self._shard(item_id)
        with shard.lock:
            return shard.items.pop(item_id, None)

    def __iter__(self) -> Iterator:
        for shard in self._shards:
            with shard.lock:
                snapshot = list(shard.items.values())
            yield from snapshot

    def __len__(self) -> int:
        total = 0
        for shard in self._shards:
            with shard.lock:
                total += len(shard.items)
        return total

    # -- incremental GC -------------------------------------------------------

    def _gc_one(self, item, now: float) -> int:
        """Apply this manager's reclaim rule to one item; return the
        number of items deleted (0 or 1)."""
        raise NotImplementedError

    def run_gc(self, budget_s: float | None = None) -> int:
        """One incremental sweep tick; returns items reclaimed.

        Stops at the current pass's boundary or the moment ``budget_s``
        (default: the manager's ``gc_budget_s``) is spent — whichever
        comes first — saving the cursor (shard position + leftover of a
        partially-swept shard + shards swept this pass) so the next tick
        resumes exactly where this one left off. Always makes progress:
        at least one shard snapshot (or one leftover chunk) is processed
        per call even with a zero budget.
        """
        reclaimed, _ = self._sweep_slice(budget_s)
        return reclaimed

    def run_gc_until_complete(self, yield_s: float = 0.001) -> int:
        """Sweep slices until one full pass completes, sleeping between
        slices so announce threads reclaim the locks/GIL. Total reclaim
        work per firing matches the pre-shard full sweep; the longest
        CONTIGUOUS stall stays bounded by ``gc_budget_s``."""
        total = 0
        while True:
            reclaimed, completed = self._sweep_slice(None)
            total += reclaimed
            if completed:
                return total
            time.sleep(yield_s)

    def _sweep_slice(self, budget_s: float | None) -> tuple[int, bool]:
        budget = self.gc_budget_s if budget_s is None else budget_s
        start = perf_counter()
        now = time.time()
        reclaimed = 0
        completed = False
        with self._gc_lock:
            progress = False
            stop = False
            while not stop:
                if not self._gc_pending:
                    if self._gc_shards_swept >= len(self._shards):
                        self._gc_shards_swept = 0  # pass done; next call
                        completed = True           # starts a fresh one
                        break
                    if progress and perf_counter() - start >= budget:
                        break
                    shard = self._shards[self._gc_shard_cursor]
                    with shard.lock:
                        self._gc_pending = list(shard.items.values())
                    self._gc_shard_cursor = (
                        (self._gc_shard_cursor + 1) % len(self._shards))
                    self._gc_shards_swept += 1
                    progress = True
                processed = 0
                while self._gc_pending:
                    item = self._gc_pending.pop()
                    reclaimed += self._gc_one(item, now)
                    processed += 1
                    # Draining a leftover counts as progress too — the
                    # outer budget check must fire before snapshotting
                    # ANOTHER shard, or a slice that spent its whole
                    # budget on leftover would still copy a full shard.
                    progress = True
                    if (processed % _GC_CHECK_EVERY == 0
                            and perf_counter() - start >= budget):
                        stop = True
                        break
        self._stats.observe_gc((perf_counter() - start) * 1e3,
                               overran=not completed, reclaimed=reclaimed)
        return reclaimed, completed


class HostManager(_ShardedManager):
    GC_TASK_ID = "host"

    def __init__(self, ttl: float = DEFAULT_HOST_TTL,
                 gc: GC | None = None, interval: float = DEFAULT_GC_INTERVAL,
                 shard_count: int = DEFAULT_SHARD_COUNT,
                 gc_budget_s: float = DEFAULT_GC_BUDGET_S,
                 stats: controlstats.ControlPlaneStats | None = None):
        super().__init__(ttl, gc, interval, shard_count, gc_budget_s, stats)

    def load(self, host_id: str) -> Optional[Host]:
        return self._load(host_id)

    def store(self, host: Host) -> None:
        self._store(host)

    def load_or_store(self, host: Host) -> Host:
        return self._setdefault(host)

    def delete(self, host_id: str) -> None:
        self._pop(host_id)

    def load_random_hosts(self, n: int, blocklist: set[str] | None = None,
                          rng=None) -> list[Host]:
        """Up to n random hosts excluding the blocklist (reference:
        host_manager LoadRandomHosts — the probe-target pre-sample).

        ``random.sample`` over shard-local id views: no O(N) shuffle of
        the whole host-id list per probe tick, no per-call import, no
        global lock, and the draw stays uniform without replacement over
        the eligible ids.
        """
        block = blocklist if blocklist is not None else ()
        ids: List[str] = []
        for shard in self._shards:
            with shard.lock:
                ids.extend(h for h in shard.items if h not in block)
        if not ids:
            return []
        picked = (rng or random).sample(ids, min(n, len(ids)))
        out = []
        for host_id in picked:
            host = self._load(host_id)
            if host is not None:
                out.append(host)
        return out

    def _gc_one(self, host, now: float) -> int:
        if now - host.updated_at <= self.ttl:
            return 0
        if host.peer_count == 0:
            logger.info("gc reclaiming idle host %s", host.id)
            self.delete(host.id)
            return 1
        # Stale but still owning peers: mark peers left so the peer
        # GC can cascade (reference: host_manager RunGC leave path).
        host.leave_peers()
        return 0


class TaskManager(_ShardedManager):
    GC_TASK_ID = "task"

    def __init__(self, ttl: float = DEFAULT_TASK_TTL,
                 gc: GC | None = None, interval: float = DEFAULT_GC_INTERVAL,
                 shard_count: int = DEFAULT_SHARD_COUNT,
                 gc_budget_s: float = DEFAULT_GC_BUDGET_S,
                 stats: controlstats.ControlPlaneStats | None = None):
        super().__init__(ttl, gc, interval, shard_count, gc_budget_s, stats)

    def load(self, task_id: str) -> Optional[Task]:
        return self._load(task_id)

    def store(self, task: Task) -> None:
        self._store(task)

    def load_or_store(self, task: Task) -> Task:
        return self._setdefault(task)

    def delete(self, task_id: str) -> None:
        self._pop(task_id)

    def _gc_one(self, task, now: float) -> int:
        if task.peer_count() == 0 and now - task.updated_at > self.ttl:
            logger.info("gc reclaiming peerless task %s", task.id)
            if task.fsm.can(TaskEvent.LEAVE):
                task.fsm.fire(TaskEvent.LEAVE)
            self.delete(task.id)
            return 1
        return 0


class PeerManager(_ShardedManager):
    GC_TASK_ID = "peer"

    def __init__(self, ttl: float = DEFAULT_PEER_TTL,
                 gc: GC | None = None, interval: float = DEFAULT_GC_INTERVAL,
                 shard_count: int = DEFAULT_SHARD_COUNT,
                 gc_budget_s: float = DEFAULT_GC_BUDGET_S,
                 stats: controlstats.ControlPlaneStats | None = None):
        super().__init__(ttl, gc, interval, shard_count, gc_budget_s, stats)

    def load(self, peer_id: str) -> Optional[Peer]:
        return self._load(peer_id)

    def store(self, peer: Peer) -> None:
        shard = self._shard(peer.id)
        with shard.lock:
            shard.items[peer.id] = peer
            peer.task.store_peer(peer)
            peer.host.store_peer(peer)

    def load_or_store(self, peer: Peer) -> Peer:
        shard = self._shard(peer.id)
        with shard.lock:  # RLock: store() re-enters it
            existing = shard.items.get(peer.id)
            if existing is not None:
                return existing
            self.store(peer)
            return peer

    def delete(self, peer_id: str) -> None:
        """Remove the peer everywhere: manager map, task DAG (with upload
        slot release), host registry. The DAG/host cascade runs OUTSIDE
        the shard lock so shard locks stay leaves of the lock order."""
        peer = self._pop(peer_id)
        if peer is None:
            return
        task = peer.task
        if peer_id in task.dag:
            task.delete_peer_in_edges(peer_id)
            task.delete_peer_out_edges(peer)
            task.delete_peer(peer_id)
        peer.host.delete_peer(peer_id)

    def _gc_one(self, peer, now: float) -> int:
        if peer.fsm.current == PeerState.LEAVE:
            logger.info("gc reclaiming left peer %s", peer.id)
            self.delete(peer.id)
            return 1
        if now - peer.updated_at > self.ttl:
            # Stale peers are led through Leave so children reschedule
            # before the vertex disappears.
            peer.leave()
        return 0
