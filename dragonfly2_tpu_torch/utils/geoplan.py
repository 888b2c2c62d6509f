"""Deterministic WAN link emulation for geo-hierarchical swarms.

``utils/faultplan.py`` made *failures* injectable on one box; this
module does the same for *geography*. A :class:`GeoPlan` maps peer
addresses to named clusters and describes every cross-cluster link with
a :class:`LinkSpec` (latency + jitter, bandwidth, partitioned). The two
download engines consult the process-wide :data:`ACTIVE` plan at their
dial and body-read sites, so a multi-site swarm — with real WAN latency
asymmetry, bandwidth caps, and mid-swarm partitions — runs entirely on
loopback (docs/GEO.md).

The faultplan discipline applies unchanged:

- ``ACTIVE is None`` means zero work: one module attribute read on the
  hot path and nothing else. Every hook guards on it.
- Determinism is a hard contract. Per-link jitter comes from a
  ``random.Random(f"{seed}:{src}->{dst}")`` stream, the clock is
  injectable, and every shaping decision appends to ``history`` — two
  identically-driven plans with the same seed produce bit-identical
  histories (tests/test_geoplan.py, same contract as test_faultplan.py).
- Shaping raises/returns REAL failure shapes: a partitioned dial is a
  ``ConnectionRefusedError`` and a partitioned in-flight stream is a
  ``ConnectionResetError``, raised by the caller so recovery paths are
  exercised exactly as a real WAN outage would.

Addresses unknown to the plan (the origin, scheduler RPC targets, any
same-cluster peer) are unshaped and uncounted — WAN accounting covers
exactly the cross-cluster data plane, which is what the amplification
bound in ``bench.py geo`` measures.

Bandwidth emulation is an aggregate per-link debt clock: every body
chunk received over a shaped link advances the link's ``ready_at`` by
``nbytes / bandwidth_bps``, and :meth:`GeoPlan.pace` answers how long
the reader must park before its next read. Concurrent streams over one
link therefore SHARE the link's capacity, like real circuits do. The
async engine parks the socket on the timer wheel for that long; the
threaded engine sleeps its worker.
"""

from __future__ import annotations

import random
import re
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "ACTIVE",
    "GeoPlan",
    "LinkSpec",
    "install",
    "uninstall",
    "validate_cluster_id",
]

#: Valid cluster identity: leading alphanumeric, then a bounded run of
#: the charset every downstream consumer (debug-vars keys, Prometheus
#: label values, trace attributes, GEO wire JSON) passes through
#: verbatim. Whitespace is the headline rejection (the ISSUE contract);
#: the charset bound keeps ids safe as metric label values.
_CLUSTER_ID_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9._:-]{0,63}\Z")


def validate_cluster_id(value: str, *, flag: str = "--cluster-id") -> str:
    """Validate an operator-supplied cluster id; raises ``ValueError``
    with a message naming the flag on empty/whitespace/overlong ids.
    The CLIs call this only when the flag was given — absent flag means
    cluster-blind, which is a configuration, not an error."""
    if not isinstance(value, str) or not value.strip():
        raise ValueError(
            f"{flag} must be a non-empty cluster id (e.g. 'site-a')")
    if value != value.strip() or any(ch.isspace() for ch in value):
        raise ValueError(
            f"{flag} must not contain whitespace: {value!r}")
    if _CLUSTER_ID_RE.match(value) is None:
        raise ValueError(
            f"{flag} must match [A-Za-z0-9][A-Za-z0-9._:-]{{0,63}}: "
            f"{value!r}")
    return value


@dataclass
class LinkSpec:
    """One directed cross-cluster link's shape.

    ``bandwidth_bps == 0`` leaves throughput unshaped (the link is
    still counted). ``partitioned`` makes dials refuse and in-flight
    streams reset until healed."""

    latency_s: float = 0.0
    jitter_s: float = 0.0
    bandwidth_bps: float = 0.0
    partitioned: bool = False

    def to_dict(self) -> dict:
        return {"latency_s": self.latency_s, "jitter_s": self.jitter_s,
                "bandwidth_bps": self.bandwidth_bps,
                "partitioned": self.partitioned}


class GeoPlan:
    """One node's view of the emulated topology.

    Every process in a multi-site bench installs its OWN plan (it must
    know which cluster *it* is in to classify a destination address as
    local or WAN); the plans differ only in ``cluster`` and share the
    same seed, so per-link decision streams agree across the fleet.
    """

    def __init__(self, cluster: str,
                 clusters: Optional[Dict[str, Iterable[str]]] = None,
                 links: Optional[Dict[Tuple[str, str], LinkSpec]] = None,
                 *, seed: int = 0, clock=time.monotonic):
        self.cluster = cluster
        self.seed = seed
        self.clock = clock
        self.links: Dict[Tuple[str, str], LinkSpec] = dict(links or {})
        self._addr_cluster: Dict[str, str] = {}
        for cid, addrs in (clusters or {}).items():
            for addr in addrs:
                self._addr_cluster[addr] = cid
        self._lock = threading.Lock()
        self._rngs: Dict[Tuple[str, str], random.Random] = {}
        self._ready_at: Dict[Tuple[str, str], float] = {}
        self._counts: Dict[Tuple[str, str], Dict[str, int]] = {}
        #: Bit-identity witness: every shaping decision, in call order.
        self.history: List[tuple] = []

    # -- topology ----------------------------------------------------------

    def assign(self, addr: str, cluster: str) -> None:
        """Late-bind an address to a cluster (bench fleets learn their
        daemons' ephemeral ports only after spawn)."""
        with self._lock:
            self._addr_cluster[addr] = cluster

    def cluster_of(self, addr: str) -> Optional[str]:
        return self._addr_cluster.get(addr)

    def is_wan(self, addr: str) -> bool:
        """True when ``addr`` lives in a DIFFERENT known cluster — the
        cross-cluster trace-attribute predicate."""
        dst = self._addr_cluster.get(addr)
        return dst is not None and dst != self.cluster

    def _link(self, addr: str) -> Tuple[Optional[Tuple[str, str]],
                                        Optional[LinkSpec]]:
        dst = self._addr_cluster.get(addr)
        if dst is None or dst == self.cluster:
            return None, None
        key = (self.cluster, dst)
        spec = self.links.get(key)
        if spec is None:
            # Unspecified cross-cluster link: unshaped but COUNTED —
            # amplification accounting must not depend on an operator
            # remembering to describe every pair.
            spec = self.links[key] = LinkSpec()
        return key, spec

    def _count(self, key: Tuple[str, str]) -> Dict[str, int]:
        c = self._counts.get(key)
        if c is None:
            c = self._counts[key] = {"dials": 0, "refused": 0,
                                     "resets": 0, "bytes": 0}
        return c

    def _rng(self, key: Tuple[str, str]) -> random.Random:
        rng = self._rngs.get(key)
        if rng is None:
            rng = self._rngs[key] = random.Random(
                f"{self.seed}:{key[0]}->{key[1]}")
        return rng

    # -- shaping sites (engine hooks) --------------------------------------

    def dial(self, addr: str) -> Tuple[bool, float]:
        """Fresh-connect site → ``(refused, delay_s)``. Callers raise
        ``ConnectionRefusedError`` on refusal and park/sleep the
        delay before connecting."""
        key, spec = self._link(addr)
        if key is None:
            return False, 0.0
        link = f"{key[0]}->{key[1]}"
        with self._lock:
            c = self._count(key)
            if spec.partitioned:
                c["refused"] += 1
                self.history.append(("refuse", link))
                return True, 0.0
            delay = spec.latency_s
            if spec.jitter_s > 0.0:
                delay += self._rng(key).uniform(0.0, spec.jitter_s)
            c["dials"] += 1
            self.history.append(("dial", link, round(delay, 9)))
            return False, delay

    def refuse(self, addr: str) -> bool:
        """Mid-stream partition probe (body-read site). True means the
        caller must fail the stream with ``ConnectionResetError`` —
        a WAN partition kills established circuits too, which is what
        forces the partitioned site onto the crash-safe resume path."""
        key, spec = self._link(addr)
        if key is None or not spec.partitioned:
            return False
        with self._lock:
            self._count(key)["resets"] += 1
            self.history.append(("reset", f"{key[0]}->{key[1]}"))
        return True

    def pace(self, addr: str, nbytes: int) -> float:
        """Account ``nbytes`` just received over the link and return how
        long the reader must park before reading again (0.0 = link not
        shaped / not WAN / debt already paid). ``nbytes == 0`` queries
        the current debt without recording anything."""
        key, spec = self._link(addr)
        if key is None:
            return 0.0
        now = self.clock()
        with self._lock:
            if nbytes > 0:
                self._count(key)["bytes"] += nbytes
                if spec.bandwidth_bps > 0.0:
                    ready = max(self._ready_at.get(key, now), now)
                    ready += nbytes / spec.bandwidth_bps
                    self._ready_at[key] = ready
                delay = max(0.0, self._ready_at.get(key, now) - now)
                self.history.append(
                    ("pace", f"{key[0]}->{key[1]}", nbytes,
                     round(delay, 9)))
                return delay
            return max(0.0, self._ready_at.get(key, now) - now)

    # -- partitions --------------------------------------------------------

    def partition(self, cluster: str, other: Optional[str] = None) -> None:
        """Partition every link touching ``cluster`` (or just the
        ``cluster``↔``other`` pair). Links are directed; both
        directions flip so the cut is symmetric."""
        with self._lock:
            for key, spec in self._links_touching(cluster, other):
                spec.partitioned = True
                self.history.append(("partition", f"{key[0]}->{key[1]}"))

    def heal(self, cluster: str, other: Optional[str] = None) -> None:
        with self._lock:
            for key, spec in self._links_touching(cluster, other):
                spec.partitioned = False
                self.history.append(("heal", f"{key[0]}->{key[1]}"))

    def _links_touching(self, cluster: str, other: Optional[str]):
        for key, spec in self.links.items():
            if cluster not in key:
                continue
            if other is not None and other not in key:
                continue
            yield key, spec

    # -- read side ---------------------------------------------------------

    def snapshot(self) -> dict:
        """WAN accounting for this node — the ``geo`` sub-block bench
        fleets sum for the amplification verdict."""
        with self._lock:
            per_link = {f"{s}->{d}": dict(c)
                        for (s, d), c in sorted(self._counts.items())}
            return {
                "cluster": self.cluster,
                "wan_dials": sum(c["dials"] for c in self._counts.values()),
                "wan_refused": sum(c["refused"]
                                   for c in self._counts.values()),
                "wan_resets": sum(c["resets"]
                                  for c in self._counts.values()),
                "wan_bytes": sum(c["bytes"] for c in self._counts.values()),
                "links": per_link,
            }

    # -- wire form (daemon_proc GEO command) -------------------------------

    def to_dict(self) -> dict:
        clusters: Dict[str, List[str]] = {}
        with self._lock:
            for addr, cid in self._addr_cluster.items():
                clusters.setdefault(cid, []).append(addr)
            links = {f"{s}|{d}": spec.to_dict()
                     for (s, d), spec in self.links.items()}
        return {"cluster": self.cluster, "seed": self.seed,
                "clusters": {c: sorted(a) for c, a in clusters.items()},
                "links": links}

    @classmethod
    def from_dict(cls, data: dict, *, clock=time.monotonic) -> "GeoPlan":
        links: Dict[Tuple[str, str], LinkSpec] = {}
        for key, spec in (data.get("links") or {}).items():
            src, _, dst = key.partition("|")
            links[(src, dst)] = LinkSpec(**spec)
        return cls(data["cluster"], clusters=data.get("clusters"),
                   links=links, seed=int(data.get("seed", 0)), clock=clock)


#: Process-wide plan. None (the default) = single-site process, every
#: hook is a single attribute read. Same discipline as faultplan.ACTIVE.
ACTIVE: Optional[GeoPlan] = None


def install(plan: GeoPlan) -> GeoPlan:
    global ACTIVE
    ACTIVE = plan
    return plan


def uninstall() -> None:
    global ACTIVE
    ACTIVE = None
