"""Swarm-wide source-claim coordination for cold-blob fan-out.

When several cold peers of one task are told to back-to-source at the
same time (the origin-stampede shape: N daemons pulling one fresh
checkpoint), each of them used to fetch the WHOLE file from the origin —
origin egress scaled with the number of back-source peers, not with the
file size. :class:`SourceClaims` turns the stampede into a dissemination
pipeline: the scheduler leases DISJOINT contiguous piece runs to the
claimants, every piece reported finished anywhere in the swarm is marked
landed (it is now mesh-servable and never needs the origin again), and a
claimant that died mid-run loses its lease after ``lease_ttl`` so the
pieces are re-claimable.

Rarest-first comes for free at this layer: an unclaimed, unlanded piece
has ZERO replicas anywhere, so every grant is of the rarest pieces by
construction. The seeded scan offset staggers WHERE in the file the
claim cursor starts (different tasks start in different regions), and
within a task the central lease map is what makes concurrent claimants
disjoint.

The client half lives in ``client/peer_task.py`` (hybrid back-to-source:
origin workers fetch granted runs while the mesh syncers fill the rest
from partial parents); see docs/FANOUT.md.
"""

from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

#: A claimant that has not claimed (or landed) anything for this long
#: forfeits its leases — the pieces become claimable again.
DEFAULT_LEASE_TTL = 45.0


@dataclass
class ClaimGrant:
    """One claim verdict.

    ``first``/``count`` describe a granted contiguous run (``first`` is
    -1 when nothing was granted). ``wait`` means every remaining piece
    is leased to other live claimants — the mesh will deliver them, poll
    again later. ``done`` means every piece has landed somewhere in the
    swarm: the origin is no longer needed for this task at all.
    """

    first: int = -1
    count: int = 0
    wait: bool = False
    done: bool = False


class SourceClaims:
    """Per-task lease map over the piece index space.

    All methods are thread-safe; the scheduler calls :meth:`claim` from
    announce-stream threads and :meth:`mark_landed` from piece-report
    paths concurrently.
    """

    def __init__(self, total_pieces: int, *,
                 lease_ttl: float = DEFAULT_LEASE_TTL,
                 seed: int | str = 0):
        if total_pieces <= 0:
            raise ValueError(f"total_pieces must be > 0, got {total_pieces}")
        self.total = total_pieces
        self.lease_ttl = lease_ttl
        # Seeded scan offset (the "seeded tie-break"): claims scan the
        # piece ring starting here, so different tasks pull different
        # regions of their files first — a fleet preheating many shards
        # spreads origin reads instead of hammering every shard's head.
        if isinstance(seed, str):
            seed = zlib.crc32(seed.encode())
        self.scan_start = seed % total_pieces
        self._landed: set[int] = set()
        self._leases: Dict[int, Tuple[str, float]] = {}  # num → (peer, exp)
        self._granted_runs = 0
        self._expired_leases = 0
        self._lock = threading.Lock()

    # -- swarm state -----------------------------------------------------

    def mark_landed(self, num: int) -> None:
        """A replica of this piece exists somewhere in the swarm — it is
        mesh-servable and never needs an origin claim again."""
        if num < 0 or num >= self.total:
            return
        with self._lock:
            self._landed.add(num)
            self._leases.pop(num, None)

    def release(self, peer_id: str) -> int:
        """Drop every lease held by ``peer_id`` (the claimant failed);
        returns how many pieces were freed."""
        with self._lock:
            mine = [n for n, (p, _) in self._leases.items() if p == peer_id]
            for n in mine:
                del self._leases[n]
            return len(mine)

    # -- claiming --------------------------------------------------------

    def claim(self, peer_id: str, run_len: int,
              now: Optional[float] = None) -> ClaimGrant:
        """Grant the next contiguous run of claimable pieces (not landed,
        not under a live lease) to ``peer_id``. Also renews the caller's
        existing leases — a claimant polling for more work is alive."""
        now = time.monotonic() if now is None else now
        run_len = max(int(run_len), 1)
        with self._lock:
            expired = [n for n, (_, exp) in self._leases.items() if exp < now]
            for n in expired:
                del self._leases[n]
            self._expired_leases += len(expired)
            renewed_exp = now + self.lease_ttl
            for n, (p, _) in list(self._leases.items()):
                if p == peer_id:
                    self._leases[n] = (p, renewed_exp)
            if len(self._landed) >= self.total:
                return ClaimGrant(done=True)

            def claimable(n: int) -> bool:
                return n not in self._landed and n not in self._leases

            first = -1
            for i in range(self.total):
                n = (self.scan_start + i) % self.total
                if claimable(n):
                    first = n
                    break
            if first < 0:
                return ClaimGrant(wait=True)
            # Extend the run forward in piece order (never wrapping the
            # ring: a run must be one contiguous byte range so the
            # client fetches it with ONE ranged GET).
            count = 0
            while (count < run_len and first + count < self.total
                   and claimable(first + count)):
                count += 1
            for n in range(first, first + count):
                self._leases[n] = (peer_id, renewed_exp)
            self._granted_runs += 1
            return ClaimGrant(first=first, count=count)

    # -- introspection ---------------------------------------------------

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "total": self.total,
                "landed": len(self._landed),
                "leased": len(self._leases),
                "granted_runs": self._granted_runs,
                "expired_leases": self._expired_leases,
            }


class BridgeClaims:
    """Per-(task, cluster) WAN-bridge election (docs/GEO.md).

    In a geo-hierarchical swarm only a small set of *bridge peers* per
    cluster may fetch pieces across the WAN; everyone else is steered to
    same-cluster parents. Election is claim-style, exactly like
    :class:`SourceClaims` leases: the first peer in a cluster that
    *needs* a cross-cluster parent acquires the cluster's bridge lease
    on demand, renews it by continuing to ask, and forfeits it after
    ``lease_ttl`` of silence (a dead bridge must not strand its cluster
    behind the WAN). Terminal peer handlers release explicitly, so a
    finished bridge hands the role over immediately.

    ``max_bridges`` bounds concurrent WAN pullers per cluster — the knob
    that trades re-convergence speed against the amplification bound
    (every extra bridge is an extra potential WAN copy of a piece).
    """

    def __init__(self, *, max_bridges: int = 1,
                 lease_ttl: float = DEFAULT_LEASE_TTL):
        self.max_bridges = max(1, int(max_bridges))
        self.lease_ttl = lease_ttl
        # cluster → {peer_id → lease expiry}
        self._bridges: Dict[str, Dict[str, float]] = {}
        self._elections = 0
        self._renewals = 0
        self._denials = 0
        self._expired = 0
        self._lock = threading.Lock()

    def acquire(self, cluster: str, peer_id: str,
                now: Optional[float] = None) -> bool:
        """True iff ``peer_id`` is (now) a bridge for ``cluster`` —
        granted when it already holds a lease (renewal) or a slot is
        free/expired; denied otherwise. Called from the candidate
        filter, so it must stay O(bridges-per-cluster)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            held = self._bridges.setdefault(cluster, {})
            expiry = held.get(peer_id)
            if expiry is not None:
                held[peer_id] = now + self.lease_ttl
                self._renewals += 1
                return True
            stale = [p for p, exp in held.items() if exp < now]
            for p in stale:
                del held[p]
            self._expired += len(stale)
            if len(held) < self.max_bridges:
                held[peer_id] = now + self.lease_ttl
                self._elections += 1
                return True
            self._denials += 1
            return False

    def is_bridge(self, cluster: str, peer_id: str,
                  now: Optional[float] = None) -> bool:
        """Lease probe without election or renewal."""
        now = time.monotonic() if now is None else now
        with self._lock:
            expiry = self._bridges.get(cluster, {}).get(peer_id)
            return expiry is not None and expiry >= now

    def release(self, peer_id: str) -> int:
        """Drop every bridge lease ``peer_id`` holds (terminal peer);
        returns how many clusters lost their bridge."""
        with self._lock:
            freed = 0
            for held in self._bridges.values():
                if held.pop(peer_id, None) is not None:
                    freed += 1
            return freed

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "clusters": {c: len(h) for c, h in self._bridges.items()
                             if h},
                "elections": self._elections,
                "renewals": self._renewals,
                "denials": self._denials,
                "expired": self._expired,
            }
