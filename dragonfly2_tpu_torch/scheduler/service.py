"""Scheduler service — the announce/probe event loop over the resource model.

Reference counterpart: scheduler/service/service_v2.go:88-1459 (AnnouncePeer
dispatch and its typed sub-request handlers) plus the v1-only pieces our
clients still need (createDownloadRecord, service_v1.go:1418). Transport
neutral: gRPC binds these methods to a stream (rpc layer), the in-process
harness calls them directly. Scheduling decisions reach the peer through its
``announce_channel`` (see scheduling.core.PeerChannel).

Flow per download (call stack 3.2 in SURVEY.md):
  register_peer → (size-scope fast path | normal) → download_peer_started →
  schedule_candidate_parents → piece finished/failed reports →
  download_peer_finished → Download record appended to the dataset sink.
"""

from __future__ import annotations

import logging
import sys
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from dragonfly2_tpu_torch.schema import records as schema
from dragonfly2_tpu_torch.scheduler import controlstats
from dragonfly2_tpu_torch.scheduler.networktopology.store import NetworkTopologyStore, Probe
from dragonfly2_tpu_torch.scheduler.resource.host import Host
from dragonfly2_tpu_torch.scheduler.resource.peer import Peer, PeerEvent, PeerState
from dragonfly2_tpu_torch.scheduler.resource.resource import Resource
from dragonfly2_tpu_torch.scheduler.resource.task import (
    Piece,
    SizeScope,
    Task,
    TaskEvent,
    TaskState,
)
from dragonfly2_tpu_torch.scheduler.scheduling.core import ScheduleError, Scheduling
from dragonfly2_tpu_torch.scheduler.storage.storage import Storage
from dragonfly2_tpu_torch.utils import tracing

logger = logging.getLogger(__name__)


class ServiceError(Exception):
    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code


NOT_FOUND = "NotFound"
INVALID_ARGUMENT = "InvalidArgument"
FAILED_PRECONDITION = "FailedPrecondition"
INTERNAL = "Internal"


@dataclass
class RegisterPeerRequest:
    host_id: str
    task_id: str
    peer_id: str
    url: str = ""
    tag: str = ""
    application: str = ""
    priority: int = 0
    filtered_query_params: List[str] = field(default_factory=list)
    request_header: Dict[str, str] = field(default_factory=dict)
    piece_length: int = 0
    need_back_to_source: bool = False
    # dfget --range spec ("a-b"); rides to seed triggers so a seed
    # downloads the same window the task id was derived from.
    url_range: str = ""
    # Set ONLY by the failover/re-home path (BalancedSchedulerClient
    # _reestablish): this registration moves an in-flight session off a
    # lost replica. Distinguishes a true failover from a benign client
    # register retry — both land in the idempotent-upsert branch, but
    # only the failover is an SLO breach worth tail-keeping the trace.
    reestablish: bool = False
    # QoS identity (docs/QOS.md): traffic class + optional tenant id,
    # "" = class-blind. Stored on the Peer for class-aware candidate
    # ordering, per-class scheduler counters and class-tagged SLOs.
    traffic_class: str = ""
    tenant: str = ""
    # Geo cluster identity (docs/GEO.md): "" defers to the announced
    # host's cluster, so daemons need not repeat it per registration.
    cluster_id: str = ""


@dataclass
class RegisterPeerResponse:
    """Size-scope dispatch result (service_v2.go:829-982)."""

    size_scope: SizeScope
    direct_piece: bytes = b""  # TINY payload, inline
    content_length: int = -1
    total_piece_count: int = 0


@dataclass
class AnnounceTaskRequest:
    """A daemon re-announcing a COMPLETED local replica after restart
    (KeepStorage reload) — the reference's AnnounceTask surface
    (scheduler v1, used by dfcache import and persisted-cache reload).
    The scheduler learns: this host holds the whole task and can serve
    as a parent right now."""

    host_id: str
    task_id: str
    peer_id: str
    url: str = ""
    tag: str = ""
    application: str = ""
    content_length: int = -1
    total_piece_count: int = 0
    piece_md5_sign: str = ""


@dataclass
class SourceClaimRequest:
    """A back-to-source peer asking for its next DISJOINT origin run
    (fan-out dissemination, resource/claims.py). ``task_id`` rides along
    for wire affinity (the balanced client walks the task ring);
    in-process the peer's task resolves it."""

    peer_id: str
    task_id: str = ""
    total_pieces: int = 0
    # run_len <= 0 is a PROBE: no lease is taken — the reply only
    # carries the ranked partial parents. Mesh children use this as a
    # light mid-download parent refresh (no DAG edges, no scheduling
    # ladder, no schedule_count growth) to re-aim their syncers at
    # whoever actually accumulated pieces.
    run_len: int = 8


@dataclass
class SourceClaimReply:
    """Claim verdict + a mesh assist: candidate parents that HOLD pieces
    right now (peer_id, "ip:download_port") so the claimant's syncers
    can pull everything it was NOT granted from the swarm instead of
    the origin."""

    first: int = -1
    count: int = 0
    wait: bool = False
    done: bool = False
    parents: List[tuple] = field(default_factory=list)


@dataclass
class PieceFinished:
    peer_id: str
    piece_number: int
    parent_id: str = ""  # empty for back-to-source
    offset: int = 0
    length: int = 0
    digest: str = ""
    cost_ns: int = 0
    traffic_type: str = "remote_peer"


@dataclass
class ProbeResult:
    """One measured RTT from the probing host to ``dest_host_id``."""

    dest_host_id: str
    rtt_seconds: float
    created_at: float = field(default_factory=time.time)


class SchedulerService:
    """One scheduler instance's service surface."""

    def __init__(
        self,
        resource: Resource,
        scheduling: Scheduling,
        storage: Optional[Storage] = None,
        network_topology: Optional[NetworkTopologyStore] = None,
        seed_peer_client=None,
        metrics=None,
        stats: Optional[controlstats.ControlPlaneStats] = None,
    ):
        self.resource = resource
        self.scheduling = scheduling
        self.storage = storage
        self.network_topology = network_topology
        # SeedPeerClient protocol: trigger_task(task, url_meta) — implemented
        # by the daemon's seeder binding (resource/seed_peer.go:101).
        self.seed_peer_client = seed_peer_client
        # Geo federation (docs/GEO.md): per-cluster seed clients for
        # cross-site preheat — a manager job targeting cluster X warms
        # X's seed/bridge daemon, not whichever seed happens to be the
        # default. Empty for single-site deployments.
        self._cluster_seed_clients: Dict[str, object] = {}
        # SchedulerMetrics (scheduler/metrics.py) or None — instrumentation
        # is optional so unit tests and embedded uses stay dependency-free.
        self.metrics = metrics
        # Control-plane counters (/debug/vars "scheduler" block):
        # announce→decision latency ring + piece-report throughput.
        self.stats = stats if stats is not None else controlstats.STATS

    # ------------------------------------------------------------------
    # Host lifecycle (service_v2.go:AnnounceHost at 594, LeaveHost at 658)
    # ------------------------------------------------------------------

    def announce_host(self, host: Host) -> None:
        if self.metrics:
            self.metrics.announce_host_count.inc()
        existing = self.resource.host_manager.load(host.id)
        if existing is None:
            self.resource.host_manager.store(host)
            return
        # Refresh telemetry in place — identity fields are immutable.
        for attr in ("ip", "port", "download_port", "cpu", "memory",
                     "network", "disk", "build", "concurrent_upload_limit",
                     "os", "platform", "platform_family", "platform_version",
                     "kernel_version", "cluster_id"):
            setattr(existing, attr, getattr(host, attr))
        existing.touch()

    def leave_host(self, host_id: str) -> None:
        if self.metrics:
            self.metrics.leave_host_count.inc()
        host = self.resource.host_manager.load(host_id)
        if host is None:
            raise ServiceError(NOT_FOUND, f"host {host_id} not found")
        host.leave_peers()
        if self.network_topology is not None:
            self.network_topology.delete_host(host_id)
        self.resource.host_manager.delete(host_id)

    def list_host_snapshot(self) -> list:
        """Plain-dict host list for sync-peers reconciliation
        (scheduler/job/job.go:224 syncPeers result)."""
        out = []
        for host in self.resource.host_manager:
            out.append({
                "host_id": host.id,
                "hostname": host.hostname,
                "ip": host.ip,
                "port": host.port,
                "download_port": host.download_port,
                "type": getattr(host.type, "value", str(host.type)),
                "idc": host.network.idc if host.network else "",
                "location": host.network.location if host.network else "",
            })
        return out

    # ------------------------------------------------------------------
    # Peer registration (service_v2.go:829-982 handleRegisterPeerRequest)
    # ------------------------------------------------------------------

    def register_peer(self, req: RegisterPeerRequest,
                      channel=None) -> RegisterPeerResponse:
        tracer = tracing.default_tracer()
        if not tracer.enabled:
            return self._register_peer_impl(req, channel)
        with tracer.span("sched.register", peer_id=req.peer_id,
                         task_id=req.task_id, priority=req.priority) as rec:
            resp = self._register_peer_impl(req, channel)
            rec["attrs"]["size_scope"] = getattr(
                resp.size_scope, "name", str(resp.size_scope))
            return resp

    def _register_peer_impl(self, req: RegisterPeerRequest,
                            channel=None) -> RegisterPeerResponse:
        if self.metrics:
            self.metrics.register_peer_count.inc()
        host = self.resource.host_manager.load(req.host_id)
        if host is None:
            if self.metrics:
                self.metrics.register_peer_failure.inc()
            raise ServiceError(NOT_FOUND, f"host {req.host_id} not announced")
        # Priority gates that REJECT must fire before any resource is
        # created — a stored-then-rejected peer would pin its task and
        # host against GC in a zombie initial state.
        if req.priority == 1:
            if self.metrics:
                self.metrics.register_peer_failure.inc()
            raise ServiceError(FAILED_PRECONDITION,
                               "LEVEL1 peer is forbidden")
        if req.priority == 2:
            if self.metrics:
                self.metrics.register_peer_failure.inc()
            raise ServiceError(NOT_FOUND,
                               "LEVEL2 peer downloads back-to-source "
                               "without candidates")
        # tag/application repeat across the whole fleet ("pytorch",
        # "inference", ...): intern so every peer and task retains the
        # one canonical copy, not a per-registration wire decode.
        tag = sys.intern(req.tag)
        application = sys.intern(req.application)
        traffic_class = sys.intern(req.traffic_class)
        tenant = sys.intern(req.tenant)
        cluster_id = sys.intern(req.cluster_id)
        task = self.resource.task_manager.load_or_store(
            Task(req.task_id, url=req.url, tag=tag,
                 application=application,
                 filtered_query_params=req.filtered_query_params,
                 request_header=req.request_header,
                 piece_length=req.piece_length,
                 url_range=req.url_range)
        )
        peer = self.resource.peer_manager.load_or_store(
            Peer(req.peer_id, task, host, tag=tag,
                 application=application, priority=req.priority,
                 traffic_class=traffic_class, tenant=tenant,
                 cluster_id=cluster_id)
        )
        if traffic_class:
            self.stats.observe_announce_class(traffic_class)
        peer.need_back_to_source = req.need_back_to_source
        if channel is not None:
            peer.announce_channel = channel

        # Idempotent re-registration (a peer past PENDING registered
        # before): the failover/handoff path re-establishing a session
        # lost with a dead replica — or replayed onto THIS replica after
        # a restart. A cheap upsert, never an error: the channel above is
        # refreshed so new decisions reach the peer, the FSM is left
        # alone (the peer is mid-download), and the caller replays
        # started/pieces right after. Counted so rolling restarts are
        # visible on /debug/vars.
        if not peer.fsm.is_state(PeerState.PENDING):
            self.stats.observe_reregistration()
            if req.reestablish:
                # The failover/re-home path landing here — tail-keep
                # the task's trace on this replica too (the daemon side
                # promoted at the failover). A benign register RETRY
                # (first attempt landed, reply lost) also takes this
                # branch and must NOT promote — only the wire-flagged
                # re-establish does.
                tracing.promote_current_trace("failover")
            return self._scope_response(task, task.size_scope())

        # Priority ladder (service_v2.go:1308-1375 downloadTaskBySeedPeer;
        # the LEVEL1/LEVEL2 rejections fired above, pre-storage): LEVEL3
        # makes THIS peer back-source first instead of warming a seed;
        # 0/4/5/6 take the seed-peer warm-up path (host-type nuances
        # collapsed — one seed role here). Application-table priority
        # lookup for LEVEL0 is a manager concern the caller resolves.
        if req.priority == 3:
            peer.need_back_to_source = True
        else:
            self._maybe_trigger_seed_peer(task)

        scope = task.size_scope()
        succeeded = task.fsm.is_state(TaskState.SUCCEEDED)
        if succeeded and scope == SizeScope.EMPTY:
            peer.fsm.fire(PeerEvent.REGISTER_EMPTY)
        elif succeeded and scope == SizeScope.TINY and task.direct_piece:
            peer.fsm.fire(PeerEvent.REGISTER_TINY)
        elif scope == SizeScope.SMALL and task.has_available_peer():
            peer.fsm.fire(PeerEvent.REGISTER_SMALL)
        else:
            peer.fsm.fire(PeerEvent.REGISTER_NORMAL)
        return self._scope_response(task, scope)

    @staticmethod
    def _scope_response(task: Task, scope: SizeScope) -> RegisterPeerResponse:
        """Scope → register-response mapping, shared by fresh
        registration (which fires the matching FSM event first) and the
        idempotent re-registration upsert (which answers from task
        state without touching the mid-download peer's FSM)."""
        succeeded = task.fsm.is_state(TaskState.SUCCEEDED)
        if succeeded and scope == SizeScope.EMPTY:
            return RegisterPeerResponse(SizeScope.EMPTY, content_length=0)
        if succeeded and scope == SizeScope.TINY and task.direct_piece:
            return RegisterPeerResponse(
                SizeScope.TINY, direct_piece=task.direct_piece,
                content_length=task.content_length,
                total_piece_count=task.total_piece_count,
            )
        return RegisterPeerResponse(
            SizeScope.NORMAL if scope == SizeScope.UNKNOW else scope,
            content_length=task.content_length,
            total_piece_count=task.total_piece_count,
        )

    def announce_task(self, req: AnnounceTaskRequest) -> None:
        """Install a completed replica into the resource view: task
        upserted to SUCCEEDED with the announced shape, and a SUCCEEDED
        peer bound to the announcing host so scheduling offers it as a
        candidate parent immediately (children then sync the piece
        inventory straight from the daemon's upload server).

        Idempotent per (peer, host); a stale peer record under the same
        id but a DIFFERENT host (the daemon restarted on a new port —
        host identity hashes the port) is replaced, not refreshed:
        children must never be pointed at the dead listener."""
        host = self.resource.host_manager.load(req.host_id)
        if host is None:
            raise ServiceError(NOT_FOUND, f"host {req.host_id} not announced")
        if req.content_length < 0 or req.total_piece_count <= 0:
            raise ServiceError(INVALID_ARGUMENT,
                               "announce_task needs the completed shape "
                               "(content_length, total_piece_count)")
        task = self.resource.task_manager.load_or_store(
            Task(req.task_id, url=req.url, tag=req.tag,
                 application=req.application)
        )
        if task.fsm.can(TaskEvent.DOWNLOAD):
            task.fsm.fire(TaskEvent.DOWNLOAD)
        task.report_success(req.content_length, req.total_piece_count)
        existing = self.resource.peer_manager.load(req.peer_id)
        if existing is not None:
            if (existing.host.id == host.id
                    and existing.fsm.is_state(PeerState.SUCCEEDED)):
                self.stats.observe_task_reannounce()
                return  # already known exactly as announced
            self.leave_peer(req.peer_id)
        peer = Peer(req.peer_id, task, host,
                    tag=req.tag, application=req.application)
        self.resource.peer_manager.store(peer)
        peer.fsm.fire(PeerEvent.REGISTER_NORMAL)
        peer.fsm.fire(PeerEvent.DOWNLOAD)
        peer.finished_pieces.update(range(req.total_piece_count))
        peer.fsm.fire(PeerEvent.DOWNLOAD_SUCCEEDED)
        self.stats.observe_task_reannounce()
        logger.info("task %s re-announced by %s (%d pieces, host %s)",
                    req.task_id[:16], req.peer_id[-16:],
                    req.total_piece_count, req.host_id[:16])

    def _maybe_trigger_seed_peer(self, task: Task) -> None:
        """First download of a pending task fans a seed-peer back-source
        trigger (service_v2.go:1308 downloadTaskBySeedPeer; async like the
        reference's goroutine)."""
        if self.seed_peer_client is None:
            return
        if not task.fsm.is_state(TaskState.PENDING):
            return
        if task.fsm.can(TaskEvent.DOWNLOAD):
            task.fsm.fire(TaskEvent.DOWNLOAD)
        threading.Thread(
            target=self._trigger_seed_peer_safe, args=(task,),
            name=f"seed-trigger-{task.id[:8]}", daemon=True,
        ).start()

    def _trigger_seed_peer_safe(self, task: Task) -> None:
        try:
            self.seed_peer_client.trigger_task(task)
        except Exception:
            logger.exception("seed peer trigger failed for task %s", task.id)

    def register_seed_client(self, cluster_id: str, client) -> None:
        """Bind a seed-peer client to a geo cluster (docs/GEO.md) so
        cluster-targeted preheats warm THAT site's bridge. The default
        ``seed_peer_client`` keeps serving untargeted preheats."""
        self._cluster_seed_clients[cluster_id] = client

    def preheat(self, url: str, *, tag: str = "",
                filtered_query_params: Optional[List[str]] = None,
                request_header: Optional[Dict[str, str]] = None,
                cluster: str = "") -> str:
        """Warm a URL onto the seed peers, synchronously — the scheduler
        half of the manager's preheat job (scheduler/job/job.go:152-222:
        resolve task id, TriggerTask on the seed, job status from the
        outcome). ``cluster`` routes to that cluster's registered seed
        client (cross-site preheat); "" keeps the default seed. Returns
        the task id."""
        from dragonfly2_tpu_torch.utils import idgen

        seed_client = self.seed_peer_client
        if cluster:
            seed_client = self._cluster_seed_clients.get(cluster)
            if seed_client is None:
                raise ServiceError(
                    FAILED_PRECONDITION,
                    f"no seed client registered for cluster {cluster!r}")
        if seed_client is None:
            raise ServiceError(FAILED_PRECONDITION, "no seed peer client")
        task_id = idgen.task_id_v1(
            url, tag=tag,
            filters="&".join(filtered_query_params or []),
        )
        task = self.resource.task_manager.load_or_store(
            Task(task_id, url=url, tag=tag,
                 filtered_query_params=list(filtered_query_params or []),
                 request_header=dict(request_header or {}))
        )
        if not cluster and task.fsm.is_state(TaskState.SUCCEEDED):
            # Untargeted preheat: any warm replica satisfies it. A
            # cluster-targeted preheat must still trigger — the task
            # being warm at ANOTHER site is exactly the situation the
            # cross-site warm-up exists for.
            return task_id
        ok = seed_client.trigger_task(task)
        if ok is False:
            raise ServiceError(INTERNAL, f"seed trigger failed for {url}")
        return task_id

    # ------------------------------------------------------------------
    # Download lifecycle
    # ------------------------------------------------------------------

    def download_peer_started(self, peer_id: str) -> None:
        """(service_v2.go DownloadPeerStartedRequest) → schedule.

        Idempotent for a peer already RUNNING: the failover path replays
        ``started`` when it re-homes a session, and the replay's job is
        exactly the reschedule below (the new replica must start issuing
        parent decisions). Any other out-of-order state still raises."""
        peer = self._peer(peer_id)
        if peer.task.fsm.can(TaskEvent.DOWNLOAD):
            peer.task.fsm.fire(TaskEvent.DOWNLOAD)
        if peer.fsm.is_state(PeerState.BACK_TO_SOURCE):
            # Failover replays 'started' before 'back_to_source_started'
            # in session order; a peer that already degraded needs no
            # parent decisions — the replay is a no-op, not an FSM
            # violation.
            return
        if peer.fsm.can(PeerEvent.DOWNLOAD):
            peer.fsm.fire(PeerEvent.DOWNLOAD)
        elif not peer.fsm.is_state(PeerState.RUNNING):
            peer.fsm.fire(PeerEvent.DOWNLOAD)  # raises InvalidTransition
        self._schedule_timed(peer)

    def download_peer_back_to_source_started(self, peer_id: str) -> None:
        peer = self._peer(peer_id)
        if peer.task.fsm.can(TaskEvent.DOWNLOAD):
            peer.task.fsm.fire(TaskEvent.DOWNLOAD)
        # Same idempotency contract as download_peer_started: a replayed
        # back-to-source start on a peer already in BACK_TO_SOURCE is an
        # upsert of task membership, not an FSM violation.
        if peer.fsm.can(PeerEvent.DOWNLOAD_BACK_TO_SOURCE):
            peer.fsm.fire(PeerEvent.DOWNLOAD_BACK_TO_SOURCE)
        elif not peer.fsm.is_state(PeerState.BACK_TO_SOURCE):
            peer.fsm.fire(PeerEvent.DOWNLOAD_BACK_TO_SOURCE)
        peer.task.back_to_source_peers.add(peer.id)

    def claim_source_run(self, req: SourceClaimRequest) -> SourceClaimReply:
        """Lease the next disjoint origin run to a back-to-source peer
        (fan-out dissemination: concurrent cold starters pull DISJOINT
        ranges so origin egress stays ≈1× the file, resource/claims.py)
        and offer the claimant candidate partial parents for everything
        it was not granted. See docs/FANOUT.md."""
        from dragonfly2_tpu_torch.scheduler.resource.claims import ClaimGrant

        peer = self._peer(req.peer_id)
        task = peer.task
        parents = self.scheduling.find_partial_parents(
            peer, set(peer.block_parents))
        if req.run_len <= 0:
            grant = ClaimGrant()  # probe: parents only, no lease
        else:
            total = req.total_pieces or task.total_piece_count
            if total <= 0:
                raise ServiceError(INVALID_ARGUMENT,
                                   "claim_source_run needs total_pieces "
                                   "(task shape unknown)")
            claims = task.ensure_source_claims(total)
            grant = claims.claim(req.peer_id, req.run_len)
            self.stats.observe_source_claim(granted=grant.first >= 0)
        return SourceClaimReply(
            first=grant.first, count=grant.count,
            wait=grant.wait, done=grant.done,
            parents=[(p.id, f"{p.host.ip}:{p.host.download_port}")
                     for p in parents if p.id != req.peer_id],
        )

    _RECEIVED_STATES = (PeerState.RECEIVED_EMPTY, PeerState.RECEIVED_TINY,
                        PeerState.RECEIVED_SMALL, PeerState.RECEIVED_NORMAL)

    def _heal_downloading_fsm(self, peer: Peer, parent_id: str) -> None:
        """A piece report from a peer still in a Received* state means
        its download-started RPC was lost (network fault / failover
        replay gap): the peer is provably downloading, but Received* is
        a bad-node state (evaluator_base.go:211-218), so until healed
        the whole swarm refuses to use its pieces — a claimant told
        "wait, the mesh will deliver" can then stall the full
        source_fallback_wait on a mesh that refuses to serve it. Upsert
        the observed truth into the FSM, same discipline as the replayed
        back_to_source_started handler."""
        if not peer.fsm.is_state(*self._RECEIVED_STATES):
            return
        event = (PeerEvent.DOWNLOAD if parent_id
                 else PeerEvent.DOWNLOAD_BACK_TO_SOURCE)
        if peer.fsm.can(event):
            peer.fsm.fire(event)
            if not parent_id:
                peer.task.back_to_source_peers.add(peer.id)

    def download_piece_finished(self, report: PieceFinished) -> None:
        """(service_v2.go:1095 handleDownloadPieceFinishedRequest)"""
        peer = self._peer(report.peer_id)
        self._heal_downloading_fsm(peer, report.parent_id)
        # Interned: the retained Piece records would otherwise pin one
        # fresh wire-decoded copy of the parent id / traffic type PER
        # PIECE — at swarm scale that is pure duplicate string memory.
        piece = Piece(
            number=report.piece_number,
            parent_id=sys.intern(report.parent_id),
            offset=report.offset, length=report.length,
            digest=report.digest, cost=report.cost_ns / 1e9,
            traffic_type=sys.intern(report.traffic_type),
        )
        peer.store_piece(piece)
        peer.task.mark_piece_landed(report.piece_number)
        self.stats.observe_piece_reports(1)
        # Back-to-source pieces become task pieces (the metadata other
        # peers will sync).
        if not report.parent_id:
            peer.task.store_piece(piece)
        parent = self.resource.peer_manager.load(report.parent_id) \
            if report.parent_id else None
        if parent is not None:
            parent.piece_updated_at = time.time()

    def download_pieces_finished(self,
                                 reports: Sequence[PieceFinished]) -> None:
        """Batched ``download_piece_finished`` — the native form the
        client's :class:`~dragonfly2_tpu_torch.client.piece_reporter.
        PieceReportBatcher` flushes (one RPC, N pieces). Peer/parent
        lookups are amortized across the batch; per-piece semantics are
        identical to N individual calls. A piece whose peer vanished
        mid-batch is skipped (its NOT_FOUND would otherwise drop the
        rest of the batch) — matching the per-call form, where each
        report fails independently."""
        tracer = tracing.default_tracer()
        if not tracer.enabled:
            return self._pieces_finished_impl(reports)
        with tracer.span("sched.piece_batch", pieces=len(reports)):
            return self._pieces_finished_impl(reports)

    def _pieces_finished_impl(self,
                              reports: Sequence[PieceFinished]) -> None:
        peers: Dict[str, Optional[Peer]] = {}
        parents: Dict[str, Optional[Peer]] = {}
        stored = 0
        for report in reports:
            if report.peer_id in peers:
                peer = peers[report.peer_id]
            else:
                try:
                    peer = peers[report.peer_id] = self._peer(report.peer_id)
                except ServiceError:
                    # Negative-cache the vanished peer: ONE lookup (and
                    # one log line) for the whole batch, not one per
                    # report.
                    peer = peers[report.peer_id] = None
                    logger.debug("batched piece report for unknown peer %s",
                                 report.peer_id)
            if peer is None:
                continue
            self._heal_downloading_fsm(peer, report.parent_id)
            # Same interning contract as the per-call form above.
            piece = Piece(
                number=report.piece_number,
                parent_id=sys.intern(report.parent_id),
                offset=report.offset, length=report.length,
                digest=report.digest, cost=report.cost_ns / 1e9,
                traffic_type=sys.intern(report.traffic_type),
            )
            peer.store_piece(piece)
            peer.task.mark_piece_landed(report.piece_number)
            stored += 1
            if not report.parent_id:
                peer.task.store_piece(piece)
            elif report.parent_id not in parents:
                parents[report.parent_id] = self.resource.peer_manager.load(
                    report.parent_id)
        now = time.time()
        for parent in parents.values():
            if parent is not None:
                parent.piece_updated_at = now
        # Count STORED reports only, matching the per-call form (whose
        # NOT_FOUND path never reaches its observe call); the batch RPC
        # itself is counted regardless.
        self.stats.observe_piece_reports(stored, batched=True)

    def download_piece_failed(self, peer_id: str, parent_id: str,
                              piece_number: int) -> None:
        """(service_v2.go handleDownloadPieceFailedRequest) — block the
        failing parent and reschedule."""
        peer = self._peer(peer_id)
        if parent_id:
            peer.block_parents.add(parent_id)
        if peer.fsm.is_state(PeerState.BACK_TO_SOURCE):
            # A hybrid claimant's mesh fetch failed: it gets fresh
            # partial parents from its next claim reply; the Running-
            # peer retry ladder would just burn its back-to-source
            # resend budget (find_candidate_parents filters non-Running
            # requesters) and sleep the announce thread.
            return
        self._schedule_timed(peer)

    def _schedule_timed(self, peer: Peer) -> None:
        tracer = tracing.default_tracer()
        if not tracer.enabled:
            return self._schedule_timed_impl(peer)
        with tracer.span("sched.schedule", peer_id=peer.id,
                         task_id=peer.task.id,
                         schedule_count=peer.schedule_count) as rec:
            try:
                self._schedule_timed_impl(peer, rec["attrs"])
            except BaseException:
                # A scheduling failure (ScheduleError exhausting the
                # retry ladder) degrades the peer to back-to-source on
                # the daemon side — keep THIS side's spans too, or the
                # trace that explains the degrade ends daemon-only when
                # the announce stream closes.
                tracing.promote_current_trace("degraded_to_source")
                raise

    def _schedule_timed_impl(self, peer: Peer,
                             span_attrs: "dict | None" = None) -> None:
        start = time.perf_counter()
        decided = False
        try:
            decided = self.scheduling.schedule_candidate_parents(
                peer, set(peer.block_parents))
        finally:
            elapsed = time.perf_counter() - start
            self.stats.observe_schedule(
                elapsed * 1e3, decided=bool(decided),
                traffic_class=getattr(peer, "traffic_class", ""))
            if span_attrs is not None:
                span_attrs["decided"] = bool(decided)
            if self.metrics:
                self.metrics.schedule_duration.observe(elapsed)

    @staticmethod
    def _release_bridge(task: Task, peer_id: str) -> None:
        """Terminal peers hand their WAN bridge role over immediately
        (docs/GEO.md) — same discipline as the source-claim release: a
        finished/failed/left bridge must not make its cluster idle out
        the lease TTL before another peer may cross the WAN."""
        if task.bridge_claims is not None:
            task.bridge_claims.release(peer_id)

    def download_peer_finished(self, peer_id: str, cost_seconds: float = 0.0) -> None:
        peer = self._peer(peer_id)
        peer.cost = cost_seconds
        self._tail_verdict(cost_seconds,
                           getattr(peer, "traffic_class", ""))
        if peer.fsm.is_state(PeerState.SUCCEEDED):
            return  # duplicate terminal report (failover replay / race)
        peer.fsm.fire(PeerEvent.DOWNLOAD_SUCCEEDED)
        if peer.task.source_claims is not None:
            # A finished claimant has no pending work: any lease it
            # still holds covers a piece whose landing report was lost,
            # and the next claimant must not idle out the lease TTL (or
            # its own source_fallback_wait) for bytes nobody will
            # deliver.
            peer.task.source_claims.release(peer_id)
        self._release_bridge(peer.task, peer_id)
        if self.metrics:
            self.metrics.download_peer_finished.inc()
            self.metrics.download_peer_duration.observe(cost_seconds * 1e3)
            self.metrics.traffic.labels(type="p2p").inc(
                max(peer.task.content_length, 0))
        self._create_download_record(peer)
        self._record_replay_outcome(peer)

    def download_peer_back_to_source_finished(
        self, peer_id: str, content_length: int, total_piece_count: int,
        cost_seconds: float = 0.0,
    ) -> None:
        peer = self._peer(peer_id)
        peer.cost = cost_seconds
        self._tail_verdict(cost_seconds,
                           getattr(peer, "traffic_class", ""))
        # Idempotent on an already-Succeeded peer: the hybrid fan-out
        # path can complete via the MESH a beat before the
        # NeedBackToSource decision is consumed (the conductor then
        # reports the peer-level finish first), and failover replays
        # redeliver terminal events — the task-shape upsert below must
        # still land either way.
        if not peer.fsm.is_state(PeerState.SUCCEEDED):
            peer.fsm.fire(PeerEvent.DOWNLOAD_SUCCEEDED)
        task = peer.task
        if task.source_claims is not None:
            # Same as download_peer_finished: a finished claimant's
            # surviving leases cover lost landing reports — free them so
            # the next claimant can grab those pieces immediately.
            task.source_claims.release(peer_id)
        self._release_bridge(task, peer_id)
        task.report_success(content_length, total_piece_count)
        if task.fsm.can(TaskEvent.DOWNLOAD_SUCCEEDED):
            task.fsm.fire(TaskEvent.DOWNLOAD_SUCCEEDED)
        if self.metrics:
            self.metrics.download_peer_finished.inc()
            self.metrics.download_peer_duration.observe(cost_seconds * 1e3)
            self.metrics.traffic.labels(type="back_to_source").inc(
                max(content_length, 0))
        self._create_download_record(peer)
        self._record_replay_outcome(peer)

    def download_peer_failed(self, peer_id: str) -> None:
        peer = self._peer(peer_id)
        tracing.promote_current_trace("failed")
        peer.fsm.fire(PeerEvent.DOWNLOAD_FAILED)
        if peer.task.source_claims is not None:
            peer.task.source_claims.release(peer_id)
        self._release_bridge(peer.task, peer_id)
        peer.task.peer_failed_count += 1
        if self.metrics:
            self.metrics.download_peer_failure.inc()
        self._create_download_record(peer)
        self._record_replay_outcome(peer)

    def download_peer_back_to_source_failed(self, peer_id: str) -> None:
        peer = self._peer(peer_id)
        tracing.promote_current_trace("failed")
        peer.fsm.fire(PeerEvent.DOWNLOAD_FAILED)
        if self.metrics:
            self.metrics.download_peer_failure.inc()
        task = peer.task
        task.back_to_source_peers.discard(peer.id)
        if task.source_claims is not None:
            # Free the failed claimant's leases NOW instead of waiting
            # out the TTL — surviving claimants pick the pieces up on
            # their next claim poll.
            task.source_claims.release(peer_id)
        self._release_bridge(task, peer_id)
        if task.fsm.can(TaskEvent.DOWNLOAD_FAILED):
            task.fsm.fire(TaskEvent.DOWNLOAD_FAILED)
        # Unverified metadata dies with the failed back-source attempt
        # (service_v2.go: task pieces reset).
        task.pieces.clear()
        task.content_length = -1
        task.total_piece_count = 0
        self._create_download_record(peer)
        self._record_replay_outcome(peer)

    @staticmethod
    def _tail_verdict(cost_seconds: float, traffic_class: str = "") -> None:
        """Scheduler-side tail-sampling verdict at a successful task
        end: a task slower than the tracer's SLO keeps its trace HERE
        too (the daemon promotes its own half with the same shared
        trace id; both sides decide locally from the same number). The
        SLO is class-tagged: an interactive task past ITS bound is slow
        even when far under the fleet-wide one."""
        tracer = tracing.default_tracer()
        sampler = getattr(tracer, "sampler", None)
        if (sampler is not None
                and cost_seconds > sampler.slo_for(traffic_class)):
            tracing.promote_current_trace("slow")

    def leave_peer(self, peer_id: str) -> None:
        peer = self._peer(peer_id)
        if peer.task.source_claims is not None:
            peer.task.source_claims.release(peer_id)
        self._release_bridge(peer.task, peer_id)
        peer.leave()
        self._record_replay_outcome(peer)
        peer.task.delete_peer_in_edges(peer.id)
        peer.task.delete_peer_out_edges(peer)
        self.resource.peer_manager.delete(peer_id)

    # ------------------------------------------------------------------
    # Introspection
    # ------------------------------------------------------------------

    def stat_task(self, task_id: str) -> Task:
        task = self.resource.task_manager.load(task_id)
        if task is None:
            raise ServiceError(NOT_FOUND, f"task {task_id} not found")
        return task

    def stats_snapshot(self) -> Dict[str, object]:
        """Control-plane counters + resource-view sizes + resident
        memory for THIS replica — what the cluster bench polls per
        replica (wire: the ``Stats`` unary) so per-replica decisions/
        sec, GC pauses and RSS are bench numbers, not inferences from
        the driver side."""
        from dragonfly2_tpu_torch.utils.meminfo import peak_rss_mb, rss_mb

        return {
            "stats": self.stats.snapshot(),
            "hosts": len(self.resource.host_manager),
            "tasks": len(self.resource.task_manager),
            "peers": len(self.resource.peer_manager),
            "rss_mb": round(rss_mb(), 1),
            "peak_rss_mb": round(peak_rss_mb(), 1),
        }

    def _peer(self, peer_id: str) -> Peer:
        peer = self.resource.peer_manager.load(peer_id)
        if peer is None:
            raise ServiceError(NOT_FOUND, f"peer {peer_id} not found")
        return peer

    # ------------------------------------------------------------------
    # Probes (service_v2.go:684-826 SyncProbes)
    # ------------------------------------------------------------------

    def probe_started(self, host_id: str) -> List[Host]:
        """Candidates for the prober to ICMP-ping (FindProbedHosts:
        networktopology/network_topology.go:166-223)."""
        if self.metrics:
            self.metrics.sync_probes_count.inc()
        if self.network_topology is None:
            raise ServiceError(FAILED_PRECONDITION, "network topology disabled")
        if self.resource.host_manager.load(host_id) is None:
            raise ServiceError(NOT_FOUND, f"host {host_id} not announced")
        return self.network_topology.find_probed_hosts(host_id)

    def probe_finished(self, host_id: str, results: Sequence[ProbeResult]) -> int:
        if self.network_topology is None:
            raise ServiceError(FAILED_PRECONDITION, "network topology disabled")
        stored = 0
        for result in results:
            if self.resource.host_manager.load(result.dest_host_id) is None:
                continue
            self.network_topology.store(host_id, result.dest_host_id)
            self.network_topology.enqueue_probe(
                host_id,
                Probe(host_id=result.dest_host_id,
                      rtt=result.rtt_seconds, created_at=result.created_at),
            )
            stored += 1
        if self.metrics:
            self.metrics.sync_probes_count.inc()
            self.metrics.probes_stored.inc(stored)
        return stored

    def probe_failed(self, host_id: str,
                     results: Sequence[ProbeResult]) -> None:
        for result in results:
            logger.debug("probe %s -> %s failed", host_id, result.dest_host_id)

    def sync_replica_probes(self, delta: dict, since: float) -> dict:
        """Anti-entropy exchange with a peer scheduler replica: merge the
        caller's probe-window delta, answer with ours since the caller's
        watermark. Replaces the reference's shared-Redis probe state
        (probes.go:115-186) with symmetric push-pull — either side's tick
        converges both. The reply may echo an edge the caller itself
        just pushed (merging stamps it newly-seen here); that costs one
        deduped round trip and is deliberate — excluding pushed edges
        from the reply would also drop THIS replica's own probes on
        shared edges while the caller advances its watermark past them,
        losing them permanently."""
        if self.network_topology is None:
            raise ServiceError(FAILED_PRECONDITION, "network topology disabled")
        if delta:
            self.network_topology.merge_delta(delta)
        return self.network_topology.export_delta(since)

    # ------------------------------------------------------------------
    # Dataset sink (service_v1.go:1418 createDownloadRecord)
    # ------------------------------------------------------------------

    def _record_replay_outcome(self, peer: Peer) -> None:
        """Finalize the replay plane's pending decision events for a
        peer that just reached a terminal state (realized candidate
        costs are read at this moment). Zero work when no recorder is
        installed on the scheduling core (docs/REPLAY.md)."""
        recorder = getattr(self.scheduling, "recorder", None)
        if recorder is not None:
            recorder.record_outcome(peer)

    def _create_download_record(self, peer: Peer) -> None:
        if self.storage is None:
            return
        try:
            record = build_download_record(peer)
            self.storage.create_download(record)
        except Exception:
            logger.exception("create download record failed for %s", peer.id)


# ----------------------------------------------------------------------
# Record builders (resource objects → schema records)
# ----------------------------------------------------------------------


def host_record(host: Host) -> schema.Host:
    return schema.Host(
        id=host.id, type=host.type.type_name, hostname=host.hostname,
        ip=host.ip, port=host.port, download_port=host.download_port,
        os=host.os, platform=host.platform,
        platform_family=host.platform_family,
        platform_version=host.platform_version,
        kernel_version=host.kernel_version,
        concurrent_upload_limit=host.concurrent_upload_limit,
        concurrent_upload_count=host.concurrent_upload_count,
        upload_count=host.upload_count,
        upload_failed_count=host.upload_failed_count,
        cpu=host.cpu, memory=host.memory, network=host.network,
        disk=host.disk, build=host.build,
        scheduler_cluster_id=host.scheduler_cluster_id,
        created_at=int(host.created_at * 1e9),
        updated_at=int(host.updated_at * 1e9),
    )


def build_download_record(peer: Peer) -> schema.Download:
    """One finished/failed peer download → an MLP training example
    (service_v1.go:1418-1496; schema scheduler/storage/types.go:189-225)."""
    task = peer.task
    parents = []
    for parent in list(peer.parents())[: schema.MAX_PARENTS]:
        pieces = [
            schema.Piece(
                length=pp.length, cost=int(pp.cost * 1e9),
                created_at=int(peer.created_at * 1e9),
            )
            for pp in list(peer.pieces.values())
            if pp.parent_id == parent.id
        ][: schema.MAX_PIECES_PER_PARENT]
        parents.append(
            schema.Parent(
                id=parent.id, tag=parent.tag, application=parent.application,
                state=parent.fsm.current, cost=int(parent.cost * 1e9),
                upload_piece_count=len(pieces),
                finished_piece_count=parent.finished_piece_count(),
                host=host_record(parent.host), pieces=pieces,
                created_at=int(parent.created_at * 1e9),
                updated_at=int(parent.updated_at * 1e9),
            )
        )
    return schema.Download(
        id=str(uuid.uuid4()), tag=peer.tag, application=peer.application,
        state=peer.fsm.current,
        cost=int(peer.cost * 1e9),
        finished_piece_count=peer.finished_piece_count(),
        task=schema.Task(
            id=task.id, url=task.url, type=task.type.value,
            content_length=max(task.content_length, 0),
            total_piece_count=task.total_piece_count,
            back_to_source_limit=task.back_to_source_limit,
            back_to_source_peer_count=len(task.back_to_source_peers),
            state=task.fsm.current,
            created_at=int(task.created_at * 1e9),
            updated_at=int(task.updated_at * 1e9),
        ),
        host=host_record(peer.host),
        parents=parents,
        created_at=int(peer.created_at * 1e9),
        updated_at=int(peer.updated_at * 1e9),
    )
