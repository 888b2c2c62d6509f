"""Parent-selection retry loop + candidate filtering.

Reference counterpart: scheduler/scheduling/scheduling.go:43-536. Semantics
preserved (same filters, same back-to-source decision ladder, same retry
budgets — defaults from scheduler/config/constants.go: filter 15, candidates
4, retry 10, retry-back-to-source 5, max schedule count 30); transport
decoupled: decisions are delivered through the peer's attached
``announce_channel`` (the gRPC service layer binds a stream; tests bind a
recorder), so the core never imports a wire format.

The hot loop (FindCandidateParents → evaluate) is where the <1 ms p50
target lives: filtering is O(filter_limit) set/DAG checks and scoring is one
batched evaluator call (rule-based numpy or the TPU MLEvaluator).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from time import perf_counter
from typing import List, Optional, Protocol, Sequence

from dragonfly2_tpu_torch.scheduler import controlstats
from dragonfly2_tpu_torch.scheduler.resource.peer import Peer, PeerState
from dragonfly2_tpu_torch.utils import tracing
from dragonfly2_tpu_torch.utils.dag import CycleError, VertexNotFoundError
from dragonfly2_tpu_torch.utils.hosttypes import HostType

logger = logging.getLogger(__name__)

DEFAULT_FILTER_PARENT_LIMIT = 15
DEFAULT_CANDIDATE_PARENT_LIMIT = 4


class PeerChannel(Protocol):
    """Where scheduling decisions go (one per peer announce session)."""

    def send_candidate_parents(self, peer: Peer, parents: Sequence[Peer]) -> bool:
        """v2 NormalTaskResponse. Returns False if the channel is gone."""
        ...

    def send_need_back_to_source(self, peer: Peer, description: str) -> bool:
        """v2 NeedBackToSourceResponse."""
        ...


class ScheduleError(RuntimeError):
    pass


@dataclass
class SchedulingConfig:
    retry_limit: int = 10
    retry_back_to_source_limit: int = 5
    retry_interval: float = 0.05  # seconds
    max_schedule_count: int = 30
    filter_parent_limit: int = DEFAULT_FILTER_PARENT_LIMIT
    candidate_parent_limit: int = DEFAULT_CANDIDATE_PARENT_LIMIT


class Scheduling:
    def __init__(self, evaluator, config: SchedulingConfig | None = None,
                 stats: controlstats.ControlPlaneStats | None = None,
                 recorder=None):
        self.evaluator = evaluator
        self.config = config or SchedulingConfig()
        # Control-plane counters (/debug/vars "scheduler"): filter and
        # evaluate phase timings land here per find_candidate_parents.
        self.stats = stats if stats is not None else controlstats.STATS
        # Optional announce-stream recorder (replaylog.ReplayRecorder):
        # decision events for the offline replay plane. None = zero work
        # on the hot path (docs/REPLAY.md).
        self.recorder = recorder

    def apply_dynconfig(self, cfg: dict) -> None:
        """Manager-pushed overrides for the dynconfig-tunable limits
        (scheduler/config/constants.go:33-37: filterParentLimit and
        candidateParentLimit are cluster-config overridable)."""
        for key in ("filter_parent_limit", "candidate_parent_limit",
                    "retry_limit", "retry_back_to_source_limit"):
            if key in cfg:
                setattr(self.config, key, int(cfg[key]))

    # -- v2 entry point -------------------------------------------------------

    def schedule_candidate_parents(self, peer: Peer, blocklist: set[str] | None = None) -> bool:
        """The v2 retry loop (scheduling.go:80-214).

        Ladder per iteration:
        1. task can back-to-source AND (peer asked for it OR schedule count
           exhausted) → NeedBackToSourceResponse
        2. task can back-to-source AND retries exceeded
           retry_back_to_source_limit → NeedBackToSourceResponse
        3. retries exceeded retry_limit → ScheduleError
        4. candidates found AND channel accepts them → done (DAG edges added)
        else: sleep retry_interval, retry.

        Returns True when candidate parents were delivered, False when
        the verdict was back-to-source (the service layer's latency ring
        distinguishes the two).
        """
        blocklist = blocklist or set()
        cfg = self.config
        n = 0
        while True:
            if peer.task.can_back_to_source():
                if peer.need_back_to_source or peer.schedule_count >= cfg.max_schedule_count:
                    self._send_back_to_source(
                        peer,
                        f"peer need_back_to_source={peer.need_back_to_source} "
                        f"schedule_count={peer.schedule_count}",
                    )
                    return False
                if n >= cfg.retry_back_to_source_limit:
                    self._send_back_to_source(
                        peer, "scheduling exceeded RetryBackToSourceLimit"
                    )
                    return False

            if n >= cfg.retry_limit:
                raise ScheduleError(
                    f"peer {peer.id} scheduling exceeded RetryLimit {cfg.retry_limit}"
                )

            # Reschedule from a clean slate: detach from current parents.
            peer.task.delete_peer_in_edges(peer.id)

            candidates = self.find_candidate_parents(peer, blocklist)
            if candidates:
                channel = getattr(peer, "announce_channel", None)
                if channel is None:
                    raise ScheduleError(f"peer {peer.id} has no announce channel")
                if channel.send_candidate_parents(peer, candidates):
                    for parent in candidates:
                        try:
                            if peer.task.can_add_peer_edge(parent.id, peer.id):
                                peer.task.add_peer_edge(parent, peer)
                        except (CycleError, VertexNotFoundError):
                            # The parent was reclaimed (GC) between the
                            # check and the edge add; the client will
                            # report a piece failure and reschedule.
                            continue
                    peer.schedule_count += 1
                    return True
                logger.warning("peer %s channel rejected candidates", peer.id)

            n += 1
            logger.info("peer %s schedule retry %d", peer.id, n)
            if cfg.retry_interval > 0:
                time.sleep(cfg.retry_interval)

    # -- v1 entry point -------------------------------------------------------

    def schedule_parent_and_candidate_parents(
        self, peer: Peer, blocklist: set[str] | None = None
    ) -> tuple[Optional[Peer], List[Peer]]:
        """The v1 flavor (scheduling.go:218-388): returns (main parent,
        candidates) for a PeerPacket instead of streaming; back-to-source
        intent is signaled on the peer. Retries are the caller's loop in v1,
        so this is single-shot.

        Like the reference (scheduling.go:326-337), the peer detaches from
        its current parents BEFORE candidate search; on a no-candidate
        round it stays detached and recovery comes from the caller's retry
        loop / back-to-source ladder."""
        blocklist = blocklist or set()
        # Detach from current parents BEFORE filtering, like the v2 loop:
        # otherwise can_add_peer_edge's duplicate-edge check permanently
        # rejects the currently-attached (possibly best) parent.
        peer.task.delete_peer_in_edges(peer.id)
        candidates = self.find_candidate_parents(peer, blocklist)
        if not candidates:
            if peer.task.can_back_to_source() and peer.schedule_count == 0:
                peer.need_back_to_source = True
            return None, []
        for parent in candidates:
            if peer.task.can_add_peer_edge(parent.id, peer.id):
                peer.task.add_peer_edge(parent, peer)
        peer.schedule_count += 1
        return candidates[0], candidates

    # -- candidate selection --------------------------------------------------

    def find_candidate_parents(self, peer: Peer, blocklist: set[str]) -> List[Peer]:
        """(scheduling.go:391-430) running peers only; filter → evaluate →
        truncate to candidate_parent_limit."""
        if not peer.fsm.is_state(PeerState.RUNNING):
            logger.debug("peer %s state %s cannot schedule", peer.id, peer.fsm.current)
            return []
        # Trace instrumentation follows the faultplan discipline: one
        # enabled check when tracing is off; per-phase spans (not
        # per-candidate) when on, so the announce p99 overhead guard's
        # 1.05 bound holds at swarm rates.
        tracer = tracing.default_tracer()
        counts = {"bad_node": 0, "sampled": 0} if tracer.enabled else None
        t0 = perf_counter()
        candidates = self._filter_candidate_parents(peer, blocklist, counts)
        t1 = perf_counter()
        self.stats.observe_filter((t1 - t0) * 1e3)
        if counts is not None:
            tracer.emit("sched.filter", start=time.time() - (t1 - t0),
                        duration_s=t1 - t0, peer_id=peer.id,
                        sampled=counts["sampled"],
                        bad_nodes=counts["bad_node"],
                        passed=len(candidates))
        if not candidates:
            return []
        ranked = self.evaluator.evaluate_parents(
            candidates, peer, peer.task.total_piece_count
        )
        t2 = perf_counter()
        self.stats.observe_evaluate((t2 - t1) * 1e3)
        delivered = list(ranked[: self.config.candidate_parent_limit])
        if getattr(peer, "traffic_class", "") == "interactive" \
                and len(delivered) > 1:
            # Interactive pulls steer to the least-loaded delivered
            # parents (stable sort — evaluator rank breaks ties), so a
            # latency-bound stream avoids queuing at a parent already
            # fanning out to a bulk swarm. Other classes keep the pure
            # evaluator order.
            delivered.sort(key=lambda c: len(c.children()))
        if counts is not None:
            tracer.emit("sched.evaluate", start=time.time() - (t2 - t1),
                        duration_s=t2 - t1, peer_id=peer.id,
                        evaluator=type(self.evaluator).__name__,
                        candidates=len(candidates),
                        delivered=len(delivered),
                        chosen=delivered[0].id if delivered else "")
        if self.recorder is not None:
            self.recorder.record_decision(
                peer, candidates, delivered, peer.task.total_piece_count)
        return delivered

    def find_partial_parents(self, peer: Peer, blocklist: set[str]) -> List[Peer]:
        """Best-effort mesh assist for a BACK_TO_SOURCE claimant (the
        fan-out dissemination pipeline): the same six filters and
        evaluator ranking as the normal path, but (a) the requesting
        peer may be in any active state — claimants are BackToSource,
        not Running — and (b) only candidates that actually HOLD pieces
        (or are seeds) qualify: a claimant needs pieces NOW, not a peer
        that may have some later. No DAG edges are added — claimants
        serve each other symmetrically, which an acyclic parent graph
        cannot express."""
        candidates = [
            c for c in self._filter_candidate_parents(peer, blocklist)
            if c.finished_piece_count() > 0 or c.host.type.is_seed
        ]
        if not candidates:
            return []
        ranked = self.evaluator.evaluate_parents(
            candidates, peer, peer.task.total_piece_count
        )
        return list(ranked[: self.config.candidate_parent_limit])

    def find_success_parent(self, peer: Peer, blocklist: set[str]) -> Optional[Peer]:
        """(scheduling.go:433-462) best fully-downloaded parent, for task
        reuse paths."""
        candidates = [
            p
            for p in self._filter_candidate_parents(peer, blocklist)
            if p.fsm.is_state(PeerState.SUCCEEDED)
        ]
        if not candidates:
            return None
        ranked = self.evaluator.evaluate_parents(
            candidates, peer, peer.task.total_piece_count
        )
        return ranked[0]

    def _filter_candidate_parents(self, peer: Peer, blocklist: set[str],
                                  counts: "dict | None" = None) -> List[Peer]:
        """(scheduling.go:465-536) — the six filters, applied to a random
        sample of filter_parent_limit peers from the task DAG.

        Child-side (per-announce) values — host id, DAG handle, the
        evaluator's bad-node check — are bound once outside the loop so
        every candidate pays only its own per-parent work. ``counts``
        (tracing on only) collects the sampled size and bad-node
        verdicts for the ``sched.filter`` span.
        """
        task = peer.task
        dag = task.dag
        peer_id = peer.id
        peer_host_id = peer.host.id
        # Geo steering (docs/GEO.md): a cluster-tagged child may only
        # take CROSS-cluster parents while it holds its cluster's WAN
        # bridge lease; election is on demand and resolved at most once
        # per filter pass (the tri-state also renews a held lease).
        # Cluster-blind peers ('' either side) skip all of this.
        peer_cluster = getattr(peer, "cluster_id", "")
        bridge_ok: "bool | None" = None
        can_add_peer_edge = task.can_add_peer_edge
        is_bad_node = self.evaluator.is_bad_node
        out = []
        for candidate in dag.random_vertices(self.config.filter_parent_limit):
            if counts is not None:
                counts["sampled"] += 1
            if candidate.id in blocklist:
                continue
            # Cycle-safe (also rejects self and duplicate edges).
            if not can_add_peer_edge(candidate.id, peer_id):
                continue
            # Same host cannot serve itself (dfdaemon cannot express mutual
            # downloads between two local tasks).
            if candidate.host.id == peer_host_id:
                continue
            if peer_cluster:
                cand_cluster = getattr(candidate, "cluster_id", "")
                if cand_cluster and cand_cluster != peer_cluster:
                    if bridge_ok is None:
                        bridge_ok = task.ensure_bridge_claims().acquire(
                            peer_cluster, peer_id)
                        self.stats.observe_bridge(granted=bridge_ok)
                    if not bridge_ok:
                        continue
            if is_bad_node(candidate):
                if counts is not None:
                    counts["bad_node"] += 1
                continue
            # A normal-host parent must itself have a source of pieces:
            # a parent, back-to-source, a completed download — or an
            # actual piece inventory (partial peers serve while they
            # download: a Running peer holding verified pieces is a
            # valid parent even with no in-edges, e.g. one resumed from
            # a crash journal or fed by a claim-granted origin run).
            # Seeds are exempt (they fetch on demand).
            try:
                in_degree = dag.vertex(candidate.id).in_degree
            except VertexNotFoundError:
                # Sampled, then reclaimed by a concurrent GC sweep —
                # a vanished candidate is just a filtered candidate.
                continue
            if (
                candidate.host.type == HostType.NORMAL
                and in_degree == 0
                and candidate.finished_piece_count() == 0
                and not candidate.fsm.is_state(PeerState.BACK_TO_SOURCE, PeerState.SUCCEEDED)
            ):
                continue
            if candidate.host.free_upload_count() <= 0:
                continue
            out.append(candidate)
        return out

    # -- helpers --------------------------------------------------------------

    def _send_back_to_source(self, peer: Peer, description: str) -> None:
        channel = getattr(peer, "announce_channel", None)
        if channel is None:
            raise ScheduleError(f"peer {peer.id} has no announce channel")
        if not channel.send_need_back_to_source(peer, description):
            raise ScheduleError(f"peer {peer.id} channel closed")
        peer.task.back_to_source_peers.add(peer.id)
        self.stats.observe_back_to_source()
        if self.recorder is not None:
            self.recorder.record_back_to_source(peer)
