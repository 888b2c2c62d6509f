"""Scheduler gRPC surface — the AnnouncePeer/SyncProbes wire binding.

Reference counterpart: scheduler/rpcserver/scheduler_server_v2.go (the bidi
``AnnouncePeer`` stream with typed sub-requests, service_v2.go:88-300
dispatch) and ``SyncProbes`` (service_v2.go:684-826). The transport-neutral
:class:`~dragonfly2_tpu_torch.scheduler.service.SchedulerService` does the work;
this module adds (1) wire messages, (2) the server stream pump, and (3)
``GrpcSchedulerClient`` — the daemon-side adapter satisfying the conductor's
``SchedulerAPI`` protocol so daemons run against a remote scheduler
unchanged (pkg/rpc/scheduler/client role, with per-task scheduler affinity
left to the caller's consistent-hash ring, client_v1.go:171).

Design decision — ONE protocol, not two: the reference carries a legacy v1
surface (RegisterPeerTask/ReportPieceResult, service_v1.go:95-1343) purely
for protobuf backward compatibility with old Go daemons. This framework's
wire format (DF2 codec) is new, so no deployed client speaks the old
protobuf — a "v1" shim would have zero possible callers. The v1 protocol's
BEHAVIORS (size-scope fast paths at registration, piece-result-driven
rescheduling, per-peer download records) all live in the merged surface and
are covered by tests; only the duplicate wire shape is dropped.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from dragonfly2_tpu_torch.utils import faultplan
from dragonfly2_tpu_torch.utils import tracing

from dragonfly2_tpu_torch.rpc.codec import message
from dragonfly2_tpu_torch.rpc.service import MethodKind, ServiceSpec
from dragonfly2_tpu_torch.scheduler.resource.host import Host
from dragonfly2_tpu_torch.scheduler.resource.task import SizeScope
from dragonfly2_tpu_torch.scheduler.service import (
    AnnounceTaskRequest,
    PieceFinished,
    ProbeResult,
    RegisterPeerRequest,
    RegisterPeerResponse,
    SchedulerService,
    ServiceError,
    SourceClaimReply,
    SourceClaimRequest,
)
from dragonfly2_tpu_torch.utils.hosttypes import HostType

logger = logging.getLogger(__name__)


# ----------------------------------------------------------------------
# Wire messages
# ----------------------------------------------------------------------


@message("scheduler.AnnounceHostRequest")
@dataclass
class AnnounceHostRequest:
    id: str = ""
    hostname: str = ""
    ip: str = ""
    port: int = 0
    download_port: int = 0
    type: str = "normal"
    idc: str = ""
    location: str = ""
    cluster_id: str = ""  # geo cluster ("" = cluster-blind, docs/GEO.md)
    concurrent_upload_limit: int = 0
    telemetry: dict = field(default_factory=dict)

    @classmethod
    def from_host(cls, host: Host) -> "AnnounceHostRequest":
        import dataclasses

        return cls(
            id=host.id, hostname=host.hostname, ip=host.ip, port=host.port,
            download_port=host.download_port, type=host.type.type_name,
            idc=host.network.idc, location=host.network.location,
            cluster_id=getattr(host, "cluster_id", ""),
            concurrent_upload_limit=host.concurrent_upload_limit,
            # psutil snapshot + platform identity (announcer.go:45-158) —
            # the MLP's machine features must survive the wire.
            telemetry={
                "cpu": dataclasses.asdict(host.cpu),
                "memory": dataclasses.asdict(host.memory),
                "disk": dataclasses.asdict(host.disk),
                "build": dataclasses.asdict(host.build),
                "network_counts": {
                    "tcp_connection_count":
                        host.network.tcp_connection_count,
                    "upload_tcp_connection_count":
                        host.network.upload_tcp_connection_count,
                },
                "platform": {
                    "os": host.os,
                    "platform": host.platform,
                    "platform_family": host.platform_family,
                    "platform_version": host.platform_version,
                    "kernel_version": host.kernel_version,
                },
            },
        )

    def to_host(self) -> Host:
        from dragonfly2_tpu_torch.schema import records

        t = self.telemetry or {}
        cpu_kw = dict(t.get("cpu", {}))
        if "times" in cpu_kw:
            cpu_kw["times"] = records.CPUTimes(**cpu_kw["times"])
        network = records.Network(
            idc=self.idc, location=self.location,
            **t.get("network_counts", {}),
        )
        return Host(
            id=self.id, hostname=self.hostname, ip=self.ip, port=self.port,
            download_port=self.download_port,
            type=HostType.from_name(self.type),
            cluster_id=self.cluster_id,
            concurrent_upload_limit=self.concurrent_upload_limit,
            network=network,
            cpu=records.CPU(**cpu_kw),
            memory=records.Memory(**t.get("memory", {})),
            disk=records.Disk(**t.get("disk", {})),
            build=records.Build(**t.get("build", {})),
            **t.get("platform", {}),
        )


@message("scheduler.Empty")
@dataclass
class Empty:
    pass


@message("scheduler.HostID")
@dataclass
class HostID:
    host_id: str = ""


@message("scheduler.PeerID")
@dataclass
class PeerID:
    peer_id: str = ""


@message("scheduler.TaskID")
@dataclass
class TaskID:
    task_id: str = ""


@message("scheduler.WireAnnounceTask")
@dataclass
class WireAnnounceTask:
    """Restart re-announce of a completed local replica (KeepStorage
    reload → the daemon resumes serving as a parent)."""

    host_id: str = ""
    task_id: str = ""
    peer_id: str = ""
    url: str = ""
    tag: str = ""
    application: str = ""
    content_length: int = -1
    total_piece_count: int = 0
    piece_md5_sign: str = ""


@message("scheduler.SchedulerStatsReply")
@dataclass
class SchedulerStatsReply:
    """One replica's control-plane numbers (the ``Stats`` unary): the
    ``scheduler`` counter block plus resource-view sizes and resident
    memory — what the cluster bench reads per replica."""

    stats: dict = field(default_factory=dict)
    hosts: int = 0
    tasks: int = 0
    peers: int = 0
    rss_mb: float = 0.0
    peak_rss_mb: float = 0.0


@message("scheduler.StatTaskResponse")
@dataclass
class StatTaskResponse:
    task_id: str = ""
    state: str = ""
    content_length: int = -1
    total_piece_count: int = 0
    peer_count: int = 0


# -- AnnouncePeer sub-requests (service_v2.go typed oneof) --------------


@message("scheduler.WireRegisterPeer")
@dataclass
class WireRegisterPeer:
    host_id: str = ""
    task_id: str = ""
    peer_id: str = ""
    url: str = ""
    tag: str = ""
    application: str = ""
    priority: int = 0
    request_header: Dict[str, str] = field(default_factory=dict)
    filtered_query_params: List[str] = field(default_factory=list)
    piece_length: int = 0
    need_back_to_source: bool = False
    url_range: str = ""
    reestablish: bool = False  # failover re-home, not a fresh register
    traffic_class: str = ""    # QoS class ("" = class-blind)
    tenant: str = ""
    cluster_id: str = ""       # geo cluster ("" = cluster-blind)


@message("scheduler.WirePeerEvent")
@dataclass
class WirePeerEvent:
    """started | back_to_source_started | finished | back_to_source_finished
    | failed | back_to_source_failed — the non-payload lifecycle events."""

    peer_id: str = ""
    event: str = ""
    cost_seconds: float = 0.0
    content_length: int = -1
    total_piece_count: int = 0


@message("scheduler.WirePieceFinished")
@dataclass
class WirePieceFinished:
    peer_id: str = ""
    piece_number: int = 0
    parent_id: str = ""
    offset: int = 0
    length: int = 0
    digest: str = ""
    cost_ns: int = 0
    traffic_type: str = "remote_peer"


@message("scheduler.WirePiecesFinished")
@dataclass
class WirePiecesFinished:
    """Batched piece-finished reports — one stream message for a whole
    PieceReportBatcher flush (the wire half of
    SchedulerService.download_pieces_finished)."""

    pieces: List[WirePieceFinished] = field(default_factory=list)


@message("scheduler.WirePieceFailed")
@dataclass
class WirePieceFailed:
    peer_id: str = ""
    parent_id: str = ""
    piece_number: int = 0


# -- AnnouncePeer responses --------------------------------------------


@message("scheduler.WireRegisterResponse")
@dataclass
class WireRegisterResponse:
    size_scope: str = "normal"
    direct_piece: bytes = b""
    content_length: int = -1
    total_piece_count: int = 0


@message("scheduler.WireParent")
@dataclass
class WireParent:
    peer_id: str = ""
    addr: str = ""


@message("scheduler.WireCandidateParents")
@dataclass
class WireCandidateParents:
    parents: List[WireParent] = field(default_factory=list)


@message("scheduler.WireSourceClaim")
@dataclass
class WireSourceClaim:
    """Back-to-source origin-run claim (fan-out dissemination): the
    scheduler leases disjoint piece runs so concurrent cold starters
    never pull the same bytes from the origin."""

    peer_id: str = ""
    task_id: str = ""
    total_pieces: int = 0
    run_len: int = 8


@message("scheduler.WireSourceClaimReply")
@dataclass
class WireSourceClaimReply:
    first: int = -1
    count: int = 0
    wait: bool = False
    done: bool = False
    parents: List[WireParent] = field(default_factory=list)


@message("scheduler.WireNeedBackToSource")
@dataclass
class WireNeedBackToSource:
    reason: str = ""


@message("scheduler.WireError")
@dataclass
class WireError:
    code: str = ""
    message: str = ""


# -- SyncProbes ---------------------------------------------------------


@message("scheduler.WireProbeStarted")
@dataclass
class WireProbeStarted:
    host_id: str = ""


@message("scheduler.WireProbeCandidates")
@dataclass
class WireProbeCandidates:
    hosts: List[WireParent] = field(default_factory=list)  # peer_id=host_id


@message("scheduler.WireProbeResult")
@dataclass
class WireProbeResult:
    dest_host_id: str = ""
    rtt_seconds: float = 0.0
    ok: bool = True


@message("scheduler.WireProbeFinished")
@dataclass
class WireProbeFinished:
    host_id: str = ""
    results: List[WireProbeResult] = field(default_factory=list)


@message("scheduler.ReplicaProbeDelta")
@dataclass
class ReplicaProbeDelta:
    """Anti-entropy exchange between scheduler replicas: the caller's
    probe-window delta rides the request, the callee's rides the reply.
    ``since`` is the caller's last-merged watermark for this peer."""

    since: float = 0.0
    delta: dict = field(default_factory=dict)


@message("scheduler.ReplicaProbeDeltaReply")
@dataclass
class ReplicaProbeDeltaReply:
    delta: dict = field(default_factory=dict)


@message("scheduler.HostListResponse")
@dataclass
class HostListResponse:
    """Host snapshot for the manager's sync-peers reconciliation
    (scheduler/job/job.go:224 syncPeers result payload)."""

    hosts: list = field(default_factory=list)  # list of plain dicts


SCHEDULER_SPEC = ServiceSpec(
    name="df2.scheduler.Scheduler",
    methods={
        "AnnounceHost": MethodKind.UNARY_UNARY,
        "AnnounceTask": MethodKind.UNARY_UNARY,
        "LeaveHost": MethodKind.UNARY_UNARY,
        "LeavePeer": MethodKind.UNARY_UNARY,
        "StatTask": MethodKind.UNARY_UNARY,
        "Stats": MethodKind.UNARY_UNARY,
        "ListHosts": MethodKind.UNARY_UNARY,
        "ClaimSource": MethodKind.UNARY_UNARY,
        "AnnouncePeer": MethodKind.STREAM_STREAM,
        "SyncProbes": MethodKind.STREAM_STREAM,
        "SyncReplicaProbes": MethodKind.UNARY_UNARY,
    },
)


# ----------------------------------------------------------------------
# Server
# ----------------------------------------------------------------------


class _StreamChannel:
    """scheduling.core.PeerChannel bound to the response stream's queue."""

    def __init__(self, outbound: "queue.Queue"):
        self.outbound = outbound
        self.closed = False

    def send_candidate_parents(self, peer, parents) -> bool:
        if self.closed:
            return False
        self.outbound.put(WireCandidateParents([
            WireParent(p.id, f"{p.host.ip}:{p.host.download_port}")
            for p in parents
        ]))
        return True

    def send_need_back_to_source(self, peer, description: str) -> bool:
        if self.closed:
            return False
        self.outbound.put(WireNeedBackToSource(description))
        return True


class SchedulerRpcService:
    """gRPC method surface over a SchedulerService."""

    def __init__(self, service: SchedulerService):
        self.service = service

    # -- unary ----------------------------------------------------------

    def AnnounceHost(self, request: AnnounceHostRequest, context) -> Empty:  # noqa: N802
        self.service.announce_host(request.to_host())
        return Empty()

    def AnnounceTask(self, request: WireAnnounceTask, context) -> Empty:  # noqa: N802
        self._guard(context, self.service.announce_task, AnnounceTaskRequest(
            host_id=request.host_id, task_id=request.task_id,
            peer_id=request.peer_id, url=request.url, tag=request.tag,
            application=request.application,
            content_length=request.content_length,
            total_piece_count=request.total_piece_count,
            piece_md5_sign=request.piece_md5_sign,
        ))
        return Empty()

    def ClaimSource(self, request: WireSourceClaim,  # noqa: N802
                    context) -> WireSourceClaimReply:
        reply = self._guard(
            context, self.service.claim_source_run,
            SourceClaimRequest(
                peer_id=request.peer_id, task_id=request.task_id,
                total_pieces=request.total_pieces, run_len=request.run_len,
            ))
        return WireSourceClaimReply(
            first=reply.first, count=reply.count,
            wait=reply.wait, done=reply.done,
            parents=[WireParent(pid, addr) for pid, addr in reply.parents],
        )

    def LeaveHost(self, request: HostID, context) -> Empty:  # noqa: N802
        self._guard(context, self.service.leave_host, request.host_id)
        return Empty()

    def LeavePeer(self, request: PeerID, context) -> Empty:  # noqa: N802
        self._guard(context, self.service.leave_peer, request.peer_id)
        return Empty()

    def StatTask(self, request: TaskID, context) -> StatTaskResponse:  # noqa: N802
        task = self._guard(context, self.service.stat_task, request.task_id)
        return StatTaskResponse(
            task_id=task.id, state=task.fsm.current,
            content_length=task.content_length,
            total_piece_count=task.total_piece_count,
            peer_count=task.peer_count(),
        )

    def ListHosts(self, request: Empty, context) -> HostListResponse:  # noqa: N802
        return HostListResponse(hosts=self.service.list_host_snapshot())

    def Stats(self, request: Empty, context) -> SchedulerStatsReply:  # noqa: N802
        snap = self.service.stats_snapshot()
        return SchedulerStatsReply(
            stats=snap["stats"], hosts=snap["hosts"], tasks=snap["tasks"],
            peers=snap["peers"], rss_mb=snap["rss_mb"],
            peak_rss_mb=snap["peak_rss_mb"])

    def SyncReplicaProbes(self, request: ReplicaProbeDelta,  # noqa: N802
                          context) -> ReplicaProbeDeltaReply:
        delta = self._guard(context, self.service.sync_replica_probes,
                            request.delta, request.since)
        return ReplicaProbeDeltaReply(delta=delta)

    @staticmethod
    def _guard(context, fn, *args):
        from dragonfly2_tpu_torch.rpc.status import RpcError, StatusCode

        try:
            return fn(*args)
        except ServiceError as exc:
            code = (StatusCode.NOT_FOUND if exc.code == "NotFound"
                    else StatusCode.FAILED_PRECONDITION)
            context.abort(code, str(exc))

    # -- AnnouncePeer bidi ----------------------------------------------

    def AnnouncePeer(self, request_iterator, context):  # noqa: N802
        outbound: "queue.Queue" = queue.Queue()
        channel = _StreamChannel(outbound)
        done = object()
        # The stream's invocation metadata carries the TASK trace
        # context (injected when the daemon opened the stream inside its
        # peer_task.run span): the pump thread adopts it so every
        # dispatched handler's spans — register, schedule, filter/
        # evaluate, piece batches — join the daemon's trace id. The
        # rpc-layer server span lives on the response-iterating thread
        # and cannot cover the pump.
        remote_ctx = tracing.extract_metadata(context.invocation_metadata())
        # Whether this stream delivered a task-terminal event (or a
        # size-scope fast path that legitimately has none): only then is
        # a stream close CLEAN. A stream that just stops — daemon
        # SIGKILL, network loss, operator Ctrl-C — is an anomaly, and
        # its scheduler-side spans are exactly what tail sampling must
        # keep (nothing else will ever promote them: the peer vanished).
        stream_state = {"terminal": False}

        def pump() -> None:
            tracing.adopt_trace_context(remote_ctx)
            if remote_ctx is not None:
                # This stream owns the scheduler-side verdict for the
                # task trace (the finish/promote in the finally below):
                # promise it so the dispatch handlers' spans may buffer.
                tracing.default_tracer().expect_trace(remote_ctx[0])
            try:
                for req in request_iterator:
                    if self.service.metrics:
                        self.service.metrics.announce_peer_count.inc()
                    self._dispatch(req, channel, outbound, stream_state)
            except Exception as exc:
                logger.debug("announce stream pump ended: %s", exc)
            finally:
                channel.closed = True
                outbound.put(done)
                if remote_ctx is not None:
                    tracer = tracing.default_tracer()
                    if stream_state["terminal"] or self._peer_terminal(
                            stream_state.get("peer_id", "")):
                        # Clean close: anything still buffered was
                        # in-SLO (breaches promoted at their terminal
                        # handlers).
                        tracer.finish_trace(remote_ctx[0])
                    else:
                        tracer.promote_trace(remote_ctx[0], "stream_lost")

        threading.Thread(target=pump, name="announce-pump", daemon=True).start()
        while True:
            item = outbound.get()
            if item is done:
                return
            yield item

    @staticmethod
    def _is_scheduling_request(req) -> bool:
        """Only registration and download-start drive scheduling; errors on
        report-only messages (piece results, finish/fail events) must not
        abort a progressing download — in-process the conductor swallows
        those same exceptions."""
        return isinstance(req, WireRegisterPeer) or (
            isinstance(req, WirePeerEvent) and req.event == "started"
        )

    #: WirePeerEvent kinds after which a stream close is CLEAN.
    _TERMINAL_EVENTS = frozenset((
        "finished", "back_to_source_finished",
        "failed", "back_to_source_failed",
    ))

    def _peer_terminal(self, peer_id: str) -> bool:
        """True when the stream's peer reached a terminal FSM state by
        some OTHER route — a terminal event can land on a failed-over
        session or still sit in the closing client's send queue, and a
        stream closed after the peer finished is a clean close, not a
        lost one."""
        if not peer_id:
            return False
        from dragonfly2_tpu_torch.scheduler.resource.peer import PeerState

        peer = self.service.resource.peer_manager.load(peer_id)
        return peer is not None and peer.fsm.is_state(
            PeerState.SUCCEEDED, PeerState.FAILED, PeerState.LEAVE)

    def _dispatch(self, req, channel, outbound: "queue.Queue",
                  stream_state: "dict | None" = None) -> None:
        svc = self.service
        try:
            if isinstance(req, WireRegisterPeer):
                resp = svc.register_peer(
                    RegisterPeerRequest(
                        host_id=req.host_id, task_id=req.task_id,
                        peer_id=req.peer_id, url=req.url, tag=req.tag,
                        application=req.application, priority=req.priority,
                        request_header=dict(req.request_header),
                        filtered_query_params=list(req.filtered_query_params),
                        piece_length=req.piece_length,
                        need_back_to_source=req.need_back_to_source,
                        url_range=req.url_range,
                        reestablish=req.reestablish,
                        traffic_class=req.traffic_class,
                        tenant=req.tenant,
                        cluster_id=req.cluster_id,
                    ),
                    channel=channel,
                )
                if stream_state is not None:
                    stream_state["peer_id"] = req.peer_id
                    if (resp.size_scope == SizeScope.EMPTY
                            or (resp.size_scope == SizeScope.TINY
                                and resp.direct_piece)):
                        # Size-scope fast path: the client returns
                        # straight from register — no terminal event
                        # ever comes, and that close is clean.
                        stream_state["terminal"] = True
                outbound.put(WireRegisterResponse(
                    size_scope=resp.size_scope.value,
                    direct_piece=resp.direct_piece,
                    content_length=resp.content_length,
                    total_piece_count=resp.total_piece_count,
                ))
            elif isinstance(req, WirePeerEvent):
                self._peer_event(req)
                if (stream_state is not None
                        and req.event in self._TERMINAL_EVENTS):
                    stream_state["terminal"] = True
            elif isinstance(req, WirePieceFinished):
                svc.download_piece_finished(PieceFinished(
                    peer_id=req.peer_id, piece_number=req.piece_number,
                    parent_id=req.parent_id, offset=req.offset,
                    length=req.length, digest=req.digest,
                    cost_ns=req.cost_ns, traffic_type=req.traffic_type,
                ))
            elif isinstance(req, WirePiecesFinished):
                svc.download_pieces_finished([
                    PieceFinished(
                        peer_id=p.peer_id, piece_number=p.piece_number,
                        parent_id=p.parent_id, offset=p.offset,
                        length=p.length, digest=p.digest,
                        cost_ns=p.cost_ns, traffic_type=p.traffic_type,
                    )
                    for p in req.pieces
                ])
            elif isinstance(req, WirePieceFailed):
                svc.download_piece_failed(
                    req.peer_id, req.parent_id, req.piece_number)
            else:
                outbound.put(WireError("InvalidArgument",
                                       f"unknown request {type(req).__name__}"))
        except ServiceError as exc:
            if self._is_scheduling_request(req):
                outbound.put(WireError(exc.code, str(exc)))
            else:
                logger.debug("report dispatch failed: %s", exc)
        except Exception as exc:  # scheduling errors → peer-visible error
            logger.exception("announce dispatch failed")
            if self._is_scheduling_request(req):
                outbound.put(WireError("Internal",
                                       f"{type(exc).__name__}: {exc}"))

    def _peer_event(self, req: WirePeerEvent) -> None:
        svc = self.service
        event = req.event
        if event == "started":
            svc.download_peer_started(req.peer_id)
        elif event == "back_to_source_started":
            svc.download_peer_back_to_source_started(req.peer_id)
        elif event == "finished":
            svc.download_peer_finished(req.peer_id, req.cost_seconds)
        elif event == "back_to_source_finished":
            svc.download_peer_back_to_source_finished(
                req.peer_id, req.content_length, req.total_piece_count,
                req.cost_seconds)
        elif event == "failed":
            svc.download_peer_failed(req.peer_id)
        elif event == "back_to_source_failed":
            svc.download_peer_back_to_source_failed(req.peer_id)
        else:
            raise ServiceError("InvalidArgument", f"unknown event {event!r}")

    # -- SyncProbes bidi -------------------------------------------------

    def SyncProbes(self, request_iterator, context):  # noqa: N802
        from dragonfly2_tpu_torch.rpc.status import RpcError, StatusCode

        try:
            yield from self._sync_probes(request_iterator)
        except ServiceError as exc:
            code = (StatusCode.NOT_FOUND if exc.code == "NotFound"
                    else StatusCode.FAILED_PRECONDITION)
            context.abort(code, str(exc))

    def _sync_probes(self, request_iterator):
        for req in request_iterator:
            if isinstance(req, WireProbeStarted):
                hosts = self.service.probe_started(req.host_id)
                yield WireProbeCandidates([
                    WireParent(h.id, f"{h.ip}:{h.port}") for h in hosts
                ])
            elif isinstance(req, WireProbeFinished):
                ok = [ProbeResult(r.dest_host_id, r.rtt_seconds)
                      for r in req.results if r.ok]
                failed = [ProbeResult(r.dest_host_id, r.rtt_seconds)
                          for r in req.results if not r.ok]
                if ok:
                    self.service.probe_finished(req.host_id, ok)
                if failed:
                    self.service.probe_failed(req.host_id, failed)


# ----------------------------------------------------------------------
# Client adapter (daemon side)
# ----------------------------------------------------------------------


class _AnnounceSession:
    """One open AnnouncePeer stream for one peer.

    A stream whose read loop ended WITHOUT a deliberate ``close()`` is
    marked ``dead``: the server vanished (replica kill/restart) or the
    channel broke. Sends on a dead session raise ``ServiceError
    ("Unavailable")`` instead of silently enqueueing into a stream
    nobody consumes — the raise is what lets the balanced client's
    failover path notice replica loss from the very next peer-keyed
    call instead of waiting out the conductor's whole grace window."""

    def __init__(self, responses, send_queue: "queue.Queue",
                 peer_id: str = ""):
        self.responses = responses
        self.send_queue = send_queue
        self.peer_id = peer_id
        self.register_reply: "queue.Queue" = queue.Queue()
        self.dead = False
        self.closing = False

    def send(self, msg) -> None:
        if self.dead:
            raise ServiceError(
                "Unavailable", "announce stream lost (scheduler gone)")
        self.send_queue.put(msg)

    def close(self) -> None:
        self.closing = True
        self.send_queue.put(None)


class GrpcSchedulerClient:
    """SchedulerAPI over the wire — what the conductor/daemon use when the
    scheduler is a separate process."""

    def __init__(self, target: str, tls=None):
        from dragonfly2_tpu_torch.rpc.client import ServiceClient

        self.target = target
        self.tls = tls
        self._client = ServiceClient(target, SCHEDULER_SPEC, tls=tls)
        self._sessions: Dict[str, _AnnounceSession] = {}
        self._lock = threading.Lock()
        # Set by BalancedSchedulerClient: called (self, peer_id,
        # dead_session) from the read loop when a REGISTERED peer's
        # announce stream dies without close() — the proactive failover
        # trigger that covers peers with no RPC in flight (e.g.
        # idle-waiting for a parent decision when the replica is
        # killed). The session identity lets the hook ignore a stream
        # that was already replaced on this same client.
        self.on_session_lost = None

    @staticmethod
    def _inject(method: str) -> None:
        """Chaos hook: when a FaultPlan is installed, the scheduler.rpc
        site can turn this call into UNAVAILABLE / DEADLINE_EXCEEDED
        (raised as ServiceError, what the failover paths key on) or an
        injected stall. A single None check when no plan is installed."""
        plan = faultplan.ACTIVE
        if plan is not None:
            faultplan.maybe_raise_rpc(plan, "scheduler.rpc", context=method)

    def probe_sync(self, host_id: str = ""):
        """Probe-loop adapter for the daemon's Prober (SyncProbes stream).

        ``host_id`` is unused for a single target; the balanced client
        hashes it so probe streams spread across replicas.
        """
        from dragonfly2_tpu_torch.client.networktopology import GrpcProbeSync

        return GrpcProbeSync(self.target, tls=self.tls)

    # -- host lifecycle --------------------------------------------------

    def announce_host(self, host: Host) -> None:
        self._inject("announce_host")
        self._client.AnnounceHost(AnnounceHostRequest.from_host(host),
                                  timeout=10)

    def announce_task(self, req: AnnounceTaskRequest) -> None:
        """Restart re-announce of a completed replica (unary). A
        NOT_FOUND abort ("host not announced" on a replica that joined
        after our announce) is surfaced as the in-process ServiceError
        so the balanced client's host-teaching heal path stays one
        code path for both transports."""
        from dragonfly2_tpu_torch.rpc.status import RpcError, StatusCode

        self._inject("announce_task")
        try:
            self._client.AnnounceTask(WireAnnounceTask(
                host_id=req.host_id, task_id=req.task_id,
                peer_id=req.peer_id, url=req.url, tag=req.tag,
                application=req.application,
                content_length=req.content_length,
                total_piece_count=req.total_piece_count,
                piece_md5_sign=req.piece_md5_sign,
            ), timeout=10)
        except RpcError as err:
            if err.code() == StatusCode.NOT_FOUND:
                raise ServiceError("NotFound", err.details()) from err
            raise

    def claim_source_run(self, req: SourceClaimRequest) -> SourceClaimReply:
        """Disjoint origin-run claim (unary). NOT_FOUND (peer unknown to
        a restarted replica) surfaces as the in-process ServiceError so
        the balanced client's failover re-registration heals it."""
        from dragonfly2_tpu_torch.rpc.status import RpcError, StatusCode

        self._inject("claim_source_run")
        try:
            # 30 s: a fleet-wide cold burst (registration storm + spawn
            # wave on a small box) can queue unary calls behind the
            # announce streams; a timed-out claim degrades the claimant
            # to a FULL local origin pull, which is far costlier than
            # waiting out the burst.
            reply = self._client.ClaimSource(WireSourceClaim(
                peer_id=req.peer_id, task_id=req.task_id,
                total_pieces=req.total_pieces, run_len=req.run_len,
            ), timeout=30)
        except RpcError as err:
            if err.code() == StatusCode.NOT_FOUND:
                raise ServiceError("NotFound", err.details()) from err
            raise
        return SourceClaimReply(
            first=reply.first, count=reply.count,
            wait=reply.wait, done=reply.done,
            parents=[(p.peer_id, p.addr) for p in reply.parents],
        )

    def leave_host(self, host_id: str) -> None:
        self._client.LeaveHost(HostID(host_id), timeout=10)

    def leave_peer(self, peer_id: str) -> None:
        self._client.LeavePeer(PeerID(peer_id), timeout=10)

    def sync_replica_probes(self, delta: dict, since: float = 0.0) -> dict:
        """Anti-entropy exchange: push our probe delta, pull the peer's."""
        reply = self._client.SyncReplicaProbes(
            ReplicaProbeDelta(since=since, delta=delta), timeout=10)
        return reply.delta

    def stat_task(self, task_id: str) -> StatTaskResponse:
        return self._client.StatTask(TaskID(task_id), timeout=10)

    def stats(self) -> SchedulerStatsReply:
        """This replica's control-plane snapshot (cluster bench gauge)."""
        return self._client.Stats(Empty(), timeout=10)

    # -- SchedulerAPI ----------------------------------------------------

    def register_peer(self, req: RegisterPeerRequest,
                      channel=None) -> RegisterPeerResponse:
        self._inject("register_peer")
        send_queue: "queue.Queue" = queue.Queue()

        def requests():
            while True:
                item = send_queue.get()
                if item is None:
                    return
                yield item

        responses = self._client.AnnouncePeer(requests())
        session = _AnnounceSession(responses, send_queue, req.peer_id)
        with self._lock:
            displaced = self._sessions.get(req.peer_id)
            self._sessions[req.peer_id] = session
        if displaced is not None:
            # Re-register over an existing session (failover healing
            # back onto this same client): the displaced stream must be
            # poisoned, or its request-pump generator blocks on
            # send_queue.get() forever and the server keeps the old
            # AnnouncePeer stream open, pushing decisions into the
            # shared conductor channel.
            displaced.close()
        session.send(WireRegisterPeer(
            host_id=req.host_id, task_id=req.task_id, peer_id=req.peer_id,
            url=req.url, tag=req.tag, application=req.application,
            priority=req.priority, request_header=dict(req.request_header),
            filtered_query_params=list(req.filtered_query_params),
            piece_length=req.piece_length,
            need_back_to_source=req.need_back_to_source,
            url_range=req.url_range,
            reestablish=req.reestablish,
            traffic_class=req.traffic_class,
            tenant=req.tenant,
        ))
        reader = threading.Thread(
            target=self._read_loop, args=(session, channel),
            name=f"announce-read-{req.peer_id[-8:]}", daemon=True,
        )
        reader.start()
        try:
            reply = session.register_reply.get(timeout=30)
        except queue.Empty:
            self._drop_session(req.peer_id)
            raise ServiceError(
                "DeadlineExceeded",
                f"scheduler did not answer register for {req.peer_id} in 30s",
            ) from None
        if isinstance(reply, WireError):
            self._drop_session(req.peer_id)
            raise ServiceError(reply.code, reply.message)
        if isinstance(reply, Exception):
            self._drop_session(req.peer_id)
            raise reply
        return RegisterPeerResponse(
            size_scope=SizeScope(reply.size_scope),
            direct_piece=reply.direct_piece,
            content_length=reply.content_length,
            total_piece_count=reply.total_piece_count,
        )

    def _read_loop(self, session: _AnnounceSession, channel) -> None:
        from dragonfly2_tpu_torch.client.peer_task import (
            CandidateParents,
            NeedBackToSource,
            ParentInfo,
            ScheduleFailed,
        )

        registered = False
        try:
            for resp in session.responses:
                if isinstance(resp, WireRegisterResponse) and not registered:
                    registered = True
                    session.register_reply.put(resp)
                elif isinstance(resp, WireError) and not registered:
                    registered = True
                    session.register_reply.put(resp)
                elif isinstance(resp, WireCandidateParents):
                    if channel is not None:
                        channel.decisions.put(CandidateParents([
                            ParentInfo(p.peer_id, p.addr)
                            for p in resp.parents
                        ]))
                elif isinstance(resp, WireNeedBackToSource):
                    if channel is not None:
                        channel.decisions.put(NeedBackToSource(resp.reason))
                elif isinstance(resp, WireError):
                    # Post-registration scheduling errors must reach the
                    # conductor — in-process they raise out of
                    # download_peer_started and trigger back-to-source.
                    logger.warning("scheduler error on stream: %s %s",
                                   resp.code, resp.message)
                    if channel is not None:
                        channel.decisions.put(
                            ScheduleFailed(f"{resp.code}: {resp.message}"))
        except Exception as exc:
            if not registered:
                session.register_reply.put(exc)
            else:
                logger.debug("announce read loop ended: %s", exc)
        finally:
            # Stream over without close(): the scheduler is gone (or the
            # channel died). Poison the session so the next send fails
            # fast into the failover path rather than black-holing, and
            # fire the proactive hook — a peer with NO call in flight
            # (waiting on a decision) must not sit out the grace window.
            if not session.closing:
                session.dead = True
                hook = self.on_session_lost
                if hook is not None and registered:
                    try:
                        hook(self, session.peer_id, session)
                    except Exception:  # noqa: BLE001 — observer only
                        logger.debug("session-lost hook failed",
                                     exc_info=True)
                # After failover the peer finalizes on its NEW owner, so
                # no later call on THIS client will ever pop the entry —
                # dropping here keeps _sessions from accumulating one
                # dead stream per failed-over peer under replica churn.
                # Sends racing the pop still fail fast on session.dead;
                # after it, _require_session raises NotFound, which the
                # failover path treats the same. The only= guard matters
                # because the hook may already have re-homed the peer
                # onto THIS client (replica restarted on the same
                # address) — that fresh session must survive. The dead
                # session itself is closed unconditionally (close only
                # poisons its OWN queue): when the guard no-ops, nothing
                # else ever unblocks its request-pump thread.
                session.close()
                self._drop_session(session.peer_id, only=session)

    def _session(self, peer_id: str) -> Optional[_AnnounceSession]:
        with self._lock:
            return self._sessions.get(peer_id)

    def _require_session(self, peer_id: str) -> _AnnounceSession:
        session = self._session(peer_id)
        if session is None:
            raise ServiceError("NotFound", f"no announce session for {peer_id}")
        return session

    def _drop_session(self, peer_id: str, *,
                      only: Optional[_AnnounceSession] = None) -> None:
        """Pop and close the peer's session. With ``only``, drop it only
        if the mapped session IS that one — a dead stream's cleanup must
        not tear down a fresh session re-established on this same client
        (replica restarted on the same address) in the meantime."""
        with self._lock:
            session = self._sessions.get(peer_id)
            if session is None or (only is not None and session is not only):
                return
            del self._sessions[peer_id]
        session.close()

    def _send_event(self, peer_id: str, event: str, *, cost: float = 0.0,
                    content_length: int = -1, total: int = 0,
                    final: bool = False) -> None:
        self._inject(event)
        session = self._require_session(peer_id)
        session.send(WirePeerEvent(
            peer_id=peer_id, event=event, cost_seconds=cost,
            content_length=content_length, total_piece_count=total,
        ))
        if final:
            self._drop_session(peer_id)

    def download_peer_started(self, peer_id: str) -> None:
        self._send_event(peer_id, "started")

    def download_peer_back_to_source_started(self, peer_id: str) -> None:
        self._send_event(peer_id, "back_to_source_started")

    def download_piece_finished(self, report: PieceFinished) -> None:
        self._inject("download_piece_finished")
        session = self._require_session(report.peer_id)
        session.send(self._wire_piece(report))

    def download_pieces_finished(self, reports) -> None:
        """Batched flush → ONE stream message (WirePiecesFinished). All
        reports in one flush belong to one conductor, hence one peer
        session."""
        self._inject("download_pieces_finished")
        reports = list(reports)
        if not reports:
            return
        session = self._require_session(reports[0].peer_id)
        session.send(WirePiecesFinished(
            pieces=[self._wire_piece(r) for r in reports]))

    @staticmethod
    def _wire_piece(report: PieceFinished) -> WirePieceFinished:
        return WirePieceFinished(
            peer_id=report.peer_id, piece_number=report.piece_number,
            parent_id=report.parent_id, offset=report.offset,
            length=report.length, digest=report.digest,
            cost_ns=report.cost_ns, traffic_type=report.traffic_type,
        )

    def download_piece_failed(self, peer_id: str, parent_id: str,
                              piece_number: int) -> None:
        self._inject("download_piece_failed")
        session = self._require_session(peer_id)
        session.send(WirePieceFailed(
            peer_id=peer_id, parent_id=parent_id, piece_number=piece_number))

    def download_peer_finished(self, peer_id: str,
                               cost_seconds: float = 0.0) -> None:
        self._send_event(peer_id, "finished", cost=cost_seconds, final=True)

    def download_peer_back_to_source_finished(
        self, peer_id: str, content_length: int, total_piece_count: int,
        cost_seconds: float = 0.0,
    ) -> None:
        self._send_event(
            peer_id, "back_to_source_finished", cost=cost_seconds,
            content_length=content_length, total=total_piece_count,
            final=True,
        )

    def download_peer_failed(self, peer_id: str) -> None:
        self._send_event(peer_id, "failed", final=True)

    def download_peer_back_to_source_failed(self, peer_id: str) -> None:
        self._send_event(peer_id, "back_to_source_failed", final=True)

    def close(self) -> None:
        with self._lock:
            sessions = list(self._sessions.values())
            self._sessions.clear()
        for s in sessions:
            s.close()
        self._client.close()


class _PeerFinalizedError(Exception):
    """The peer finalized while a re-home was in flight — the rehome
    must not resurrect its owner mapping."""


class _PeerSessionState:
    """Everything needed to re-establish one peer's announce session on
    a different replica: the original registration request, the
    conductor's decision channel, and the replayable download state
    (started markers + every piece reported so far). ``lock``
    serializes failovers for the peer — concurrent failing calls from
    the reporter and the conductor must re-home ONCE."""

    __slots__ = ("request", "channel", "target", "started",
                 "back_to_source_started", "pieces", "lock", "trace_ctx")

    def __init__(self, request: RegisterPeerRequest, channel, target: str):
        self.request = request
        self.channel = channel
        self.target = target
        self.started = False
        self.back_to_source_started = False
        self.pieces: Dict[int, PieceFinished] = {}
        self.lock = threading.Lock()
        # The task trace active when the peer registered (None with
        # tracing off): a failover/re-home — which runs on whatever
        # thread noticed the dead replica — re-registers UNDER this
        # context, so the re-established session on the new replica
        # continues the SAME task trace.
        self.trace_ctx = tracing.current_trace_context()


class BalancedSchedulerClient:
    """Multi-scheduler SchedulerAPI: task-affine routing over a hash ring.

    Fills the round-2 gap "the consistent-hash ring exists but nothing uses
    it": daemons and CLIs take N ``--scheduler`` targets; ``register_peer``
    picks the task's owner via the ring (every peer of a task lands on the
    same scheduler replica, pkg/balancer/consistent_hashing.go:51-124 /
    scheduler client_v1.go:171 hash key = TaskId) and walks the ring on
    UNAVAILABLE, so losing a replica only moves its tasks. Host
    announce/leave fan out to every replica (each replica keeps its own
    resource view).

    Peer-keyed calls follow the session created at registration — and
    when that session's replica dies mid-download, the call FAILS OVER
    instead of degrading: the ring walk picks a live replica, the peer
    is re-registered there (an idempotent upsert server-side), the
    replayable state (started marker, every reported piece) is pushed so
    the new replica's parent decisions resume from truth, and the failed
    call is retried. Replica loss becomes a re-route measured in the
    ``recovery`` debug block (``reroute_p50/p99_ms``), not a
    degrade-to-source.

    ``update_targets`` is the dynconfig observer hook; removing a target
    with in-flight peers triggers the cooperative half of the same
    machinery — peers are re-homed onto their new ring owners while the
    draining replica still answers, which is what makes a rolling
    restart zero-drop.

    Target selection is health-aware: before walking the ring, each
    candidate's DF2 health service (rpc/health.py, auto-mounted on every
    server) is consulted through a short-TTL cache, and targets that
    report NOT_SERVING (draining for shutdown, hot-reload grace) are
    DEPRIORITIZED — tried only after every SERVING target failed, so a
    fleet that is entirely draining still gets a best-effort attempt
    instead of an instant "no schedulers". Targets that fail a walk with
    a connection error are negative-cached for a SHORT TTL so the next
    call does not re-pay the dead target's dial timeout, while a
    recovered replica rejoins within ``NEGATIVE_HEALTH_TTL``.
    """

    #: How long a per-target health verdict is trusted before re-probing.
    HEALTH_TTL = 5.0
    #: How long a walk-observed connection failure keeps a target
    #: deprioritized. Deliberately < HEALTH_TTL: a dead target must not
    #: stall every caller for a dial timeout, but a restarted replica
    #: should rejoin the walk quickly.
    NEGATIVE_HEALTH_TTL = 1.0
    #: Retry delay after a FAILED seed re-route. Membership updates fire
    #: only when the target set changes, so without a timer a transient
    #: re-announce failure (common during the exact churn window the
    #: re-route runs in) would leave the seed invisible at its owner
    #: until the NEXT change — possibly forever on a stable fleet.
    SEED_REROUTE_RETRY_S = 30.0
    #: How long update_targets waits for the removed replica's handoff
    #: threads before detaching them. Each re-home can block up to a
    #: register timeout per candidate replica; an unbounded join would
    #: stall the dynconfig observer (and every later membership update,
    #: including the one adding the recovered replica) behind the
    #: slowest peer. Stragglers finish in the background — a peer that
    #: could not move stays pinned to the retired client, which still
    #: closes on its last finalize.
    HANDOFF_DRAIN_JOIN_S = 10.0

    def __init__(self, targets, client_factory=None, tls=None,
                 health_probe=None, recovery=None, cluster_id="",
                 target_clusters=None):
        from dragonfly2_tpu_torch.client.recovery import RECOVERY
        from dragonfly2_tpu_torch.rpc.client import HashRing

        self._factory = client_factory or (
            (lambda t: GrpcSchedulerClient(t, tls=tls)) if tls is not None
            else GrpcSchedulerClient)
        self.ring = HashRing(targets)
        # Geo awareness (docs/GEO.md): when the daemon knows its own
        # cluster AND the per-target cluster map, the ring walk prefers
        # same-cluster replicas — crossing the WAN to a remote-site
        # scheduler only after every local one is down or draining.
        # Either empty → cluster-blind: the walk below is byte-identical
        # to the pre-geo ordering.
        self._cluster_id = cluster_id or ""
        self._target_clusters: Dict[str, str] = dict(target_clusters or {})
        self._clients: Dict[str, GrpcSchedulerClient] = {}
        self._peer_owner: Dict[str, GrpcSchedulerClient] = {}
        # peer_id → replayable session state (failover + handoff input).
        self._peer_states: Dict[str, _PeerSessionState] = {}
        # host_id → last announced Host: a replica that joined after the
        # daemon announced (rolling restart) learns the host during
        # session re-establishment.
        self._known_hosts: Dict[str, Host] = {}
        # task_id → (AnnounceTaskRequest, owning target): every
        # completed replica announced through this client, so a
        # membership change can RE-ROUTE the announcement to the task's
        # NEW ring owner (cross-replica seed visibility: downloaders of
        # the task register at the new owner, which otherwise never
        # heard of this seed).
        self._announced_tasks: Dict[str, tuple] = {}
        # One pending retry timer for failed seed re-routes (None when
        # none is armed); guarded by self._lock, like the closed flag —
        # detached re-route stragglers consult it so a post-close sweep
        # can neither dial fresh channels nor re-arm the timer.
        self._reroute_retry_timer: Optional[threading.Timer] = None
        self._closed = False
        # Serializes whole re-route sweeps: a retry timer firing while
        # a membership change sweeps would snapshot the same records
        # with the same prev_target and double-count each move.
        self._reroute_sweep_lock = threading.Lock()
        # task_id → monotonic time of its last forget: an announce_task
        # whose wire call was IN FLIGHT when the daemon deleted the
        # bytes must not insert its record afterwards (resurrecting the
        # dark seed). Pruned at forget time (amortized threshold), so
        # it stays bounded by the recent forget rate, not by lifetime
        # task churn.
        self._recent_forgets: Dict[str, float] = {}
        self._forgets_prune_at = 1024
        # Clients removed from the ring but still owning in-flight peers;
        # closed when their last peer finalizes.
        self._retired: set = set()
        self._lock = threading.Lock()
        self._tls = tls
        # Failover/handoff counters + the re-route latency ring
        # (/debug/vars "recovery" block unless a bench injects its own).
        self.recovery = recovery if recovery is not None else RECOVERY
        # target → health status string; tests inject a fake probe.
        self._health_probe = health_probe or self._grpc_health_probe
        self._health_clients: Dict[str, object] = {}
        # target → (serving, trusted_until). Always touched under
        # self._lock — update_targets mutates it from other threads.
        self._health_cache: Dict[str, tuple[bool, float]] = {}

    # -- health-aware target ordering -----------------------------------

    def _grpc_health_probe(self, target: str) -> str:
        from dragonfly2_tpu_torch.rpc.client import ServiceClient
        from dragonfly2_tpu_torch.rpc.health import HEALTH_SPEC, HealthCheckRequest

        with self._lock:
            cli = self._health_clients.get(target)
            if cli is None:
                cli = ServiceClient(target, HEALTH_SPEC, tls=self._tls,
                                    retries=0)
                self._health_clients[target] = cli
        return cli.Check(HealthCheckRequest(service=""), timeout=1.0).status

    def _serving(self, target: str) -> bool:
        """False only when the target AFFIRMATIVELY reports NOT_SERVING
        (or recently failed a walk — the negative cache); probe errors
        (no health service, network blip) leave the target in the
        normal walk — the walk's own error handling decides."""
        now = time.monotonic()
        with self._lock:
            cached = self._health_cache.get(target)
        if cached is not None and now < cached[1]:
            return cached[0]
        from dragonfly2_tpu_torch.rpc.health import NOT_SERVING

        try:
            serving = self._health_probe(target) != NOT_SERVING
        except Exception:  # noqa: BLE001 — absence of proof isn't proof
            serving = True
        with self._lock:
            cur = self._health_cache.get(target)
            if (cur is not None and not cur[0]
                    and time.monotonic() < cur[1]):
                # A walk failed this target while our probe was in
                # flight — that negative verdict is fresher evidence
                # than a probe begun before the failure (and probe
                # errors default to serving=True). Don't clobber it.
                return False
            self._health_cache[target] = (serving, now + self.HEALTH_TTL)
        return serving

    def _note_unreachable(self, target: str) -> None:
        """A walk just paid this target's connection failure — feed the
        health cache a short negative verdict so the NEXT walks skip to
        live replicas instead of re-paying the dial timeout each call."""
        with self._lock:
            self._health_cache[target] = (
                False, time.monotonic() + self.NEGATIVE_HEALTH_TTL)

    def _walk_healthy(self, key: str):
        """Ring order with NOT_SERVING targets moved to the back. Lazy:
        each target is probed only when the walk reaches it, so a
        first-target success never pays for probing the rest of the
        fleet (cold-cache probes cost up to 1 s each).

        With a geo cluster configured, targets KNOWN to sit in a remote
        cluster are deferred behind every local serving target (but
        still ahead of drained ones): scheduler RPCs stay on-site until
        the local replicas are gone. Targets absent from the cluster map
        are treated as local — an unlabeled fleet keeps the plain
        health-aware order."""
        remote, drained = [], []
        for target in self.ring.walk(key):
            if (self._cluster_id and self._target_clusters.get(
                    target, self._cluster_id) != self._cluster_id):
                remote.append(target)
                continue
            if self._serving(target):
                yield target
            else:
                drained.append(target)
        for target in remote:
            if self._serving(target):
                yield target
            else:
                drained.append(target)
        yield from drained

    # -- target management (dynconfig observer) ------------------------

    def update_targets(self, targets) -> None:
        desired = set(targets)
        for t in desired - self.ring.targets:
            # A joiner starts with an empty resource view; it learns
            # our hosts lazily — _register_at re-announces the cached
            # Host when a register bounces on "not announced". No eager
            # preload here: serial announce_host calls against a
            # not-yet-listening replacement would burn a dial timeout
            # per host on the dynconfig observer thread and delay the
            # removal/handoff half of this very update.
            self.ring.add(t)
        for t in self.ring.targets - desired:
            self.ring.remove(t)
            self._remove_target_client(t)
        # A concurrent failover walking a pre-removal ring snapshot can
        # re-create a client for a just-removed target AFTER the pop
        # above — sweep strays through the same retire-or-close path so
        # they don't leak a dead channel until process-level close().
        with self._lock:
            stray = [t for t in self._clients if t not in desired]
        for t in stray:
            self._remove_target_client(t)
        self._reroute_announced_tasks()

    def _reroute_announced_tasks(self) -> None:
        """Cross-replica seed visibility across membership changes: a
        completed replica announced task-affinely must be known by the
        task's CURRENT ring owner, because that is where the task's
        downloaders now register. Re-route exactly the announcements
        whose owner changed (≈K/N of them, the consistent-hash
        contract) through the ordinary task-affine announce path — no
        blind re-register against every replica. Concurrent with a
        bounded join, like the handoff drain: each re-announce can cost
        a walk of register timeouts and must not stall the dynconfig
        observer behind a slow fleet."""
        with self._reroute_sweep_lock:
            self._reroute_sweep()

    def _reroute_sweep(self) -> None:
        # Snapshot under the client lock, compute ring picks OUTSIDE it:
        # O(N) sha256 picks under self._lock would stall every RPC path
        # (register, peer calls, client lookup) behind the sweep at
        # exactly the churn moment the cluster is absorbing. ring.pick
        # is independently thread-safe.
        with self._lock:
            records = list(self._announced_tasks.items())
        if not records or not self.ring.targets:
            return
        moved = [
            (task_id, req) for task_id, (req, target) in records
            if self.ring.pick(task_id) != target
        ]
        if not moved:
            return
        # A replica loss on a seed-dense daemon moves hundreds of tasks
        # at once: a FIXED pool of workers drains the list (thread-per-
        # task would stack hundreds of idle threads at exactly the
        # churn moment the cluster is absorbing), bounding both the
        # announce burst and the thread cost.
        todo: "queue.Queue" = queue.Queue()
        for item in moved:
            todo.put(item)

        def reroute_worker() -> None:
            while True:
                try:
                    task_id, req = todo.get_nowait()
                except queue.Empty:
                    return
                with self._lock:
                    if self._closed or task_id not in self._announced_tasks:
                        # Forgotten (bytes deleted) or client shut down
                        # since the sweep snapshot — skip without an RPC.
                        continue
                try:
                    # announce_task itself ticks seed_tasks_rerouted,
                    # atomically with the record change, exactly once
                    # per actual move — a walk landing right back on
                    # the recorded target (owner still negative-cached)
                    # counts nothing, and its not-at-owner check
                    # re-arms the retry timer.
                    self.announce_task(req, refresh_only=True)
                except Exception as exc:  # noqa: BLE001 — best effort:
                    # the record keeps its OLD target, so a retry sees
                    # owner != recorded and re-attempts the move. The
                    # retry cannot wait for the next membership change
                    # (none may ever come on a now-stable fleet) — arm
                    # the bounded retry timer.
                    logger.warning("seed re-route for task %s failed: %s",
                                   task_id, exc)
                    self._arm_reroute_retry()

        workers = [threading.Thread(target=reroute_worker,
                                    name=f"seed-reroute-{i}", daemon=True)
                   for i in range(min(16, len(moved)))]
        for t in workers:
            t.start()
        deadline = time.monotonic() + self.HANDOFF_DRAIN_JOIN_S
        for t in workers:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                logger.warning("seed re-route detached straggler %s", t.name)

    def _arm_reroute_retry(self) -> None:
        """One-shot bounded retry of the seed re-route sweep; at most
        one timer pending at a time (re-armed from the sweep itself if
        failures persist)."""
        with self._lock:
            if self._reroute_retry_timer is not None or self._closed:
                return
            timer = threading.Timer(self.SEED_REROUTE_RETRY_S,
                                    self._reroute_retry_fire)
            timer.daemon = True
            self._reroute_retry_timer = timer
        timer.start()

    def _reroute_retry_fire(self) -> None:
        with self._lock:
            self._reroute_retry_timer = None
            if self._closed:
                return
        self._reroute_announced_tasks()

    def announced_task_targets(self) -> Dict[str, str]:
        """Snapshot of task_id → currently recorded owning target for
        every announced completed replica — the structural evidence the
        cluster bench's kill verdict checks (no record may still point
        at a dead target; counters alone can mask one failed move
        behind another task's extra tick)."""
        with self._lock:
            return {task_id: target
                    for task_id, (_req, target)
                    in self._announced_tasks.items()}

    #: How long a forget timestamp is kept to veto in-flight announces
    #: (an announce walk is bounded by a few register timeouts, far
    #: under this).
    FORGET_VETO_TTL_S = 600.0

    def forget_announced_task(self, task_id: str) -> None:
        """Drop a task's re-routable seed record — the daemon calls this
        when the LAST local replica of the task is deleted (explicit
        delete or storage GC): a membership change must never re-announce
        a seed whose bytes are gone, and the record must not grow
        one entry per task forever on a cache-churning daemon."""
        now = time.monotonic()
        with self._lock:
            self._announced_tasks.pop(task_id, None)
            self._recent_forgets[task_id] = now
            if len(self._recent_forgets) > self._forgets_prune_at:
                cutoff = now - self.FORGET_VETO_TTL_S
                self._recent_forgets = {
                    t: ts for t, ts in self._recent_forgets.items()
                    if ts >= cutoff}
                # Amortized: if churn keeps every entry inside the TTL,
                # double the threshold instead of rebuilding a big dict
                # under self._lock on EVERY forget.
                self._forgets_prune_at = max(
                    1024, 2 * len(self._recent_forgets))

    def sweep_seed_reroutes(self) -> None:
        """Public seam for one synchronous re-route sweep (the cluster
        bench drains stragglers through this before its verdict; the
        retry timer and ``update_targets`` use the same path)."""
        self._reroute_announced_tasks()

    def stats_at(self, target: str):
        """One replica's ``Stats`` snapshot through this client's
        channel — the public per-replica gauge seam benches poll."""
        return self._client_at(target).stats()

    def _remove_target_client(self, t: str) -> None:
        with self._lock:
            self._health_cache.pop(t, None)
            health = self._health_clients.pop(t, None)
            old = self._clients.pop(t, None)
        if health is not None:
            try:
                health.close()
            except Exception:  # noqa: BLE001
                pass
        if old is None:
            return
        retired = False
        with self._lock:
            if old in self._peer_owner.values():
                # In-flight peers still report through this client;
                # cooperative handoff tries to re-home them onto live
                # replicas while the removed one is still draining.
                # Whatever cannot move keeps reporting here; close when
                # the last peer finalizes.
                self._retired.add(old)
                retired = True
        if retired:
            self._drain_retired(old, t)
        else:
            old.close()

    def _drain_retired(self, old: "GrpcSchedulerClient",
                       removed_target: str) -> None:
        """Planned membership change: re-home the removed replica's
        in-flight peers through the ordinary re-registration path. The
        draining replica may well still be serving (a rolling restart
        announces NOT_SERVING before it dies), so a failed re-home is
        not fatal — the peer stays pinned to the retired client, which
        then closes on its final report as before."""
        with self._lock:
            to_move = [(pid, self._peer_states.get(pid))
                       for pid, owner in self._peer_owner.items()
                       if owner is old]
        workers = []
        for peer_id, state in to_move:
            if state is None:
                self.recovery.tick("scheduler_handoff_stranded")
                continue
            # Concurrent per-peer re-homes: each can block up to a full
            # register timeout per candidate replica, so a serial drain
            # would stall the dynconfig observer thread for N peers ×
            # timeout while later peers overshoot the drain window.
            t = threading.Thread(
                target=self._handoff_one,
                args=(peer_id, state, old, removed_target),
                name=f"handoff-{peer_id[-8:]}", daemon=True)
            t.start()
            workers.append(t)
        deadline = time.monotonic() + self.HANDOFF_DRAIN_JOIN_S
        for t in workers:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                logger.warning(
                    "handoff drain for %s detached straggler %s",
                    removed_target, t.name)
        self._maybe_close_retired(old)

    def _handoff_one(self, peer_id: str, state: "_PeerSessionState",
                     old: "GrpcSchedulerClient",
                     removed_target: str) -> None:
        with state.lock:
            with self._lock:
                if peer_id not in self._peer_states:
                    return  # finalized while the drain was queued
                if self._peer_owner.get(peer_id) is not old:
                    return  # a concurrent failover already moved it
            try:
                self._rehome_locked(peer_id, state, avoid=removed_target)
            except _PeerFinalizedError:
                return  # finished mid-drain: neither rehomed nor stranded
            except Exception as exc:  # noqa: BLE001 — best effort
                logger.warning("handoff of peer %s off %s failed: %s",
                               peer_id, removed_target, exc)
                self.recovery.tick("scheduler_handoff_stranded")
                return
        self.recovery.tick("scheduler_handoff_rehomed")

    def _maybe_close_retired(self, cli: "GrpcSchedulerClient") -> None:
        close_me = None
        with self._lock:
            if (cli in self._retired
                    and cli not in self._peer_owner.values()):
                self._retired.discard(cli)
                close_me = cli
        if close_me is not None:
            close_me.close()

    def _client_at(self, target: str) -> GrpcSchedulerClient:
        with self._lock:
            if self._closed:
                # A detached straggler (re-route/handoff worker past its
                # join bound) dialing after close() would create a
                # channel nothing will ever close.
                raise ConnectionError("scheduler client closed")
            cli = self._clients.get(target)
            if cli is None:
                cli = self._factory(target)
                try:
                    cli.on_session_lost = self._on_session_lost
                except Exception:  # noqa: BLE001 — stub clients may not care
                    pass
                self._clients[target] = cli
        return cli

    def _on_session_lost(self, cli: GrpcSchedulerClient,
                         peer_id: str, session=None) -> None:
        """Proactive failover: a registered peer's announce stream died
        without close(). Re-home it NOW — the reactive path only fires
        on the next peer-keyed call, and a peer idle-waiting for a
        parent decision makes none until the grace window has already
        degraded it to back-to-source."""
        with self._lock:
            owner = self._peer_owner.get(peer_id)
            state = self._peer_states.get(peer_id)
        if owner is not cli or state is None:
            return  # finalized or already re-homed
        t0 = time.monotonic()
        with state.lock:
            with self._lock:
                if self._peer_owner.get(peer_id) is not cli:
                    return  # raced a reactive failover that won
            if session is not None:
                # The owner-is-cli guard can't see a re-home back onto
                # the SAME client (replica restarted on its old port):
                # only the session identity can. A concurrent call that
                # beat us to state.lock installed a FRESH session there
                # — re-homing again would negative-cache the healthy
                # target and replay everything a second time.
                probe = getattr(cli, "_session", None)
                if probe is not None and probe(peer_id) is not session:
                    return
            if state.target:
                self._note_unreachable(state.target)
            try:
                self._rehome_locked(peer_id, state, avoid=state.target)
            except _PeerFinalizedError:
                return  # finalized mid-rehome — nothing left to re-route
            except Exception as exc:  # noqa: BLE001 — reactive path remains
                logger.warning("proactive failover for peer %s failed: %s",
                               peer_id, exc)
                return
            # Success-only, matching _peer_call: a failed proactive
            # attempt must not pre-count the failover the reactive
            # path will count when it succeeds.
            self.recovery.tick("scheduler_failovers")
        self.recovery.observe_reroute(time.monotonic() - t0)
        logger.info("peer %s proactively re-routed to %s after stream loss",
                    peer_id, state.target)

    # -- host lifecycle: fan out to every replica ----------------------

    def _fan_out(self, op, op_name: str) -> Tuple[List[tuple], int]:
        """Run ``op(client)`` against every replica CONCURRENTLY and
        return ([(target, exc)] failures, attempted count). Serial fan-out let one dead
        replica's dial timeout stall host announcement for the whole
        fleet; concurrent fan-out bounds the announce path to the
        slowest single replica. Failed targets feed the negative health
        cache so the ring walks route around them too."""
        targets = sorted(self.ring.targets)
        errors: List[tuple] = []
        errors_lock = threading.Lock()

        def call(target: str) -> None:
            try:
                op(self._client_at(target))
            except Exception as exc:  # noqa: BLE001 — per-replica
                if self._walk_retryable(exc):
                    # Transport failure or dead-replica code — real gRPC
                    # surfaces these as RpcError UNAVAILABLE /
                    # ServiceError, not ConnectionError.
                    self._note_unreachable(target)
                with errors_lock:
                    errors.append((target, exc))

        if len(targets) == 1:
            call(targets[0])
        else:
            threads = [threading.Thread(target=call, args=(t,),
                                        name=f"{op_name}-{t}", daemon=True)
                       for t in targets]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        return errors, len(targets)

    def announce_host(self, host: Host) -> None:
        """Best-effort fan-out; succeeds if at least one replica took it."""
        with self._lock:
            self._known_hosts[host.id] = host
        errors, attempted = self._fan_out(
            lambda cli: cli.announce_host(host), "announce-host")
        # Compare against the fan-out's own snapshot — the ring can gain
        # or lose targets mid-flight, and a total failure must raise.
        if errors and len(errors) == attempted:
            raise ConnectionError(f"announce_host failed everywhere: {errors}")
        for target, exc in errors:
            logger.warning("announce_host to %s failed: %s", target, exc)

    def leave_host(self, host_id: str) -> None:
        with self._lock:
            self._known_hosts.pop(host_id, None)
        errors, _ = self._fan_out(
            lambda cli: cli.leave_host(host_id), "leave-host")
        for target, _exc in errors:
            logger.warning("leave_host to %s failed", target)

    def stat_task(self, task_id: str):
        last: Optional[Exception] = None
        for target in self._walk_healthy(task_id):
            try:
                return self._client_at(target).stat_task(task_id)
            except Exception as exc:  # noqa: BLE001 — walk on dead replicas
                if not self._walk_retryable(exc):
                    raise
                self._note_unreachable(target)
                last = exc
        raise last if last is not None else ConnectionError("no schedulers")

    def announce_task(self, req, *, refresh_only: bool = False) -> None:
        """Restart re-announce of a completed replica — task-affine
        like register_peer (children of the task register at the same
        ring owner, so the replica answering their registration is the
        one that must know this parent), teaching the host on "not
        announced" exactly like ``_register_at``.

        ``refresh_only`` (the re-route sweep's mode) refreshes the
        task's record only if it STILL EXISTS at insert time: a
        concurrent ``forget_announced_task`` (the daemon deleted the
        bytes mid-sweep) must win — re-inserting would resurrect a
        dark seed that every later membership change re-announces. The
        fresh-announce path has the same race (the daemon's announce
        ticker checks replica validity, then storage GC deletes it
        while the wire call is in flight), closed by the
        ``_recent_forgets`` timestamp check below."""
        started_at = time.monotonic()
        last: Optional[Exception] = None
        for target in self._walk_healthy(req.task_id):
            cli = self._client_at(target)
            try:
                self._teach_host_and_retry(
                    cli, req.host_id, lambda: cli.announce_task(req))
            except Exception as exc:  # noqa: BLE001 — walk on dead replicas
                if not self._walk_retryable(exc):
                    raise
                self._note_unreachable(target)
                last = exc
                continue
            moved = False
            with self._lock:
                forgotten_at = self._recent_forgets.get(req.task_id)
                if forgotten_at is not None and forgotten_at >= started_at:
                    return  # bytes deleted mid-announce — don't resurrect
                existing = self._announced_tasks.get(req.task_id)
                if not refresh_only or existing is not None:
                    self._announced_tasks[req.task_id] = (req, target)
                    # The re-route counter ticks HERE, atomically with
                    # the record change — exactly once per actual move,
                    # however many sweeps (a detached straggler plus a
                    # retry-timer sweep) raced to make it.
                    moved = (refresh_only and existing is not None
                             and existing[1] != target)
            if moved:
                self.recovery.tick("seed_tasks_rerouted")
            if target != self.ring.pick(req.task_id):
                # The walk succeeded at a NON-owner (the owner was
                # drained/unreachable): downloaders will register at
                # the owner once it recovers, and on a stable fleet no
                # membership change ever re-evaluates the record — arm
                # the retry timer so the sweep moves it to the real
                # owner.
                self._arm_reroute_retry()
            return
        raise last if last is not None else ConnectionError("no schedulers")

    def probe_sync(self, host_id: str = ""):
        """Probe stream to this host's ring-stable replica — hashing the
        daemon's host_id spreads the fleet's probe load across replicas
        while keeping each daemon's stream sticky."""
        for target in self._walk_healthy(host_id or "probes"):
            return self._client_at(target).probe_sync(host_id)
        raise ConnectionError("no schedulers")

    # -- failover plumbing ----------------------------------------------

    @staticmethod
    def _walk_retryable(exc: Exception) -> bool:
        """May the ring walk continue past this failure? Transport-level
        errors and the dead-replica ServiceError codes walk on;
        scheduler REJECTIONS (invalid URL, forbidden priority) re-raise."""
        if isinstance(exc, ServiceError):
            return exc.code in ("DeadlineExceeded", "Unavailable")
        if isinstance(exc, (ConnectionError, OSError)):
            return True
        from dragonfly2_tpu_torch.rpc.status import RpcError, StatusCode

        return (isinstance(exc, RpcError)
                and exc.code() == StatusCode.UNAVAILABLE)

    @classmethod
    def _failover_retryable(cls, exc: Exception) -> bool:
        """May a PEER-KEYED call fail over? Everything the walk retries,
        plus NotFound: a replica that restarted (lost its resource view)
        or a client session dropped after an error both surface NotFound,
        and both are healed by re-registration."""
        if isinstance(exc, ServiceError) and exc.code == "NotFound":
            return True
        return cls._walk_retryable(exc)

    # -- SchedulerAPI ---------------------------------------------------

    def _teach_host_and_retry(self, cli: GrpcSchedulerClient,
                              host_id: str, call):
        """Host-keyed call against one replica, teaching it the host
        first when it answers "not announced" — a replica that joined
        after the daemon's announce (rolling restart) must be usable
        for fresh registrations, failover replays, and task
        re-announces alike."""
        try:
            return call()
        except ServiceError as exc:
            host = self._known_hosts.get(host_id)
            if (exc.code != "NotFound" or "not announced" not in str(exc)
                    or host is None):
                raise
            cli.announce_host(host)
            return call()

    def _register_at(self, cli: GrpcSchedulerClient,
                     req: RegisterPeerRequest,
                     channel) -> RegisterPeerResponse:
        return self._teach_host_and_retry(
            cli, req.host_id,
            lambda: cli.register_peer(req, channel=channel))

    def register_peer(self, req: RegisterPeerRequest,
                      channel=None) -> RegisterPeerResponse:
        last: Optional[Exception] = None
        for target in self._walk_healthy(req.task_id):
            cli = self._client_at(target)
            try:
                resp = self._register_at(cli, req, channel)
            except Exception as exc:  # noqa: BLE001
                if not self._walk_retryable(exc):
                    raise
                # Anything walk-retryable means the TARGET is gone/sick
                # (real gRPC surfaces dead replicas as RpcError
                # UNAVAILABLE / ServiceError, not ConnectionError).
                self._note_unreachable(target)
                last = exc
                continue
            if (resp.size_scope == SizeScope.EMPTY
                    or (resp.size_scope == SizeScope.TINY
                        and resp.direct_piece)):
                # The conductor returns straight from register for these
                # responses (TINY only short-circuits when the piece
                # rides inline; a bare TINY scope still downloads) —
                # no started/pieces/finished calls ever come,
                # so a session entry would leak forever and the handoff
                # machinery would keep re-homing a long-finished ghost.
                # The underlying announce stream (+ its read-loop thread)
                # must go too, or every EMPTY/TINY download pins one
                # gRPC stream until process exit. getattr: duck-typed
                # clients without announce sessions have nothing to drop.
                drop = getattr(cli, "_drop_session", None)
                if drop is not None:
                    drop(req.peer_id)
                return resp
            with self._lock:
                self._peer_owner[req.peer_id] = cli
                self._peer_states[req.peer_id] = _PeerSessionState(
                    req, channel, target)
            return resp
        raise last if last is not None else ConnectionError("no schedulers")

    def _reestablish(self, cli: GrpcSchedulerClient,
                     state: _PeerSessionState) -> None:
        """Re-create the peer's announce session on ``cli`` and replay
        its download state: register (idempotent upsert server-side,
        re-announcing the host first if this replica never saw it),
        started markers (the new replica resumes issuing parent
        decisions into the SAME conductor channel), then every piece
        reported so far (so finished counts / task metadata are truthful
        and duplicate redeliveries stay upserts)."""
        import dataclasses

        # Wire-flag the re-home (reestablish=True): the server's upsert
        # branch tail-keeps the trace only for THESE, not for a benign
        # client register retry that lands in the same branch.
        # state.request stays pristine.
        req = dataclasses.replace(state.request, reestablish=True)
        self._register_at(cli, req, state.channel)
        if state.started:
            cli.download_peer_started(req.peer_id)
        if state.back_to_source_started:
            cli.download_peer_back_to_source_started(req.peer_id)
        pieces = list(state.pieces.values())
        if pieces:
            cli.download_pieces_finished(pieces)
            self.recovery.tick("scheduler_failover_pieces_replayed",
                               len(pieces))
        self.recovery.tick("scheduler_reregisters")

    def _rehome_locked(self, peer_id: str, state: _PeerSessionState,
                       avoid: str = "") -> GrpcSchedulerClient:
        """Walk the ring (excluding ``avoid`` until last) and move the
        peer's session to the first replica that takes it. Caller holds
        ``state.lock``. Raises the last walk error when nothing does.

        Rides one ``sched_client.failover`` span under the task trace
        (the re-register inside inherits the context, so the NEW
        replica's spans join the same trace id), and a failover is an
        SLO breach by definition — the trace promotes out of the tail
        buffer whether or not the re-home succeeds."""
        tracer = tracing.default_tracer()
        if not tracer.enabled:
            return self._rehome_impl(peer_id, state, avoid)
        if state.trace_ctx is not None:
            tracer.promote_trace(state.trace_ctx[0], "failover")
        with tracer.span("sched_client.failover",
                         remote_parent=state.trace_ctx, peer_id=peer_id,
                         avoid=avoid) as rec:
            cli = self._rehome_impl(peer_id, state, avoid)
            rec["attrs"]["target"] = state.target
            return cli

    def _rehome_impl(self, peer_id: str, state: _PeerSessionState,
                     avoid: str = "") -> GrpcSchedulerClient:
        last: Optional[Exception] = None

        def candidates():
            # LAZY: _walk_healthy probes health per target as the walk
            # advances (cold probes cost up to 1 s each) — a first-
            # candidate success must not pay for probing the fleet
            # while every call for this peer queues on state.lock.
            for t in self._walk_healthy(state.request.task_id):
                if t != avoid:
                    yield t
            if avoid and avoid in self.ring.targets:
                # The failed target last: a transient blip (or a replica
                # restarted on the same port) heals by re-registering
                # there.
                yield avoid

        for target in candidates():
            if target not in self.ring.targets:
                # update_targets removed it while this walk was on a
                # pre-removal ring snapshot: registering here would pin
                # the peer to a replica about to die and resurrect the
                # client entry the removal just popped.
                continue
            cli = self._client_at(target)
            try:
                self._reestablish(cli, state)
            except Exception as exc:  # noqa: BLE001
                if not self._failover_retryable(exc):
                    raise
                if self._walk_retryable(exc):
                    # Dead/sick target (transport error or Unavailable/
                    # DeadlineExceeded) — NOT NotFound, which comes from
                    # a live replica that merely lost its resource view.
                    self._note_unreachable(target)
                last = exc
                continue
            with self._lock:
                if peer_id not in self._peer_states:
                    # Finalized while the re-establish was in flight
                    # (the terminal call can land directly on a
                    # still-serving owner without taking state.lock):
                    # writing the owner back would leak the entry
                    # forever and resurrect a finished peer. The ghost
                    # register on the new replica is left to server GC.
                    raise _PeerFinalizedError(peer_id)
                old = self._peer_owner.get(peer_id)
                self._peer_owner[peer_id] = cli
            state.target = target
            if old is not None and old is not cli:
                # The peer may still hold an OPEN announce session on
                # the old client (cooperative handoff, or failover off
                # a slow-but-alive replica): close it, or the starved
                # old replica keeps pushing decisions — including
                # NeedBackToSource at retry exhaustion — into the same
                # conductor channel the new session feeds, degrading a
                # healthy re-homed task. Dead streams drop idempotently.
                # getattr: duck-typed clients may have no sessions.
                drop = getattr(old, "_drop_session", None)
                if drop is not None:
                    drop(peer_id)
                self._maybe_close_retired(old)
            return cli
        raise last if last is not None else ConnectionError("no schedulers")

    def _peer_call(self, peer_id: str, op):
        """Run ``op(client)`` against the peer's owner; on a
        dead-replica failure, transparently fail over — re-register the
        peer on a live replica, replay its state, and retry the call
        once there. The re-route latency (first failure → retried OK)
        lands in the recovery ring the chaos bench bounds."""
        with self._lock:
            owner = self._peer_owner.get(peer_id)
            state = self._peer_states.get(peer_id)
        if owner is None and state is None:
            raise ServiceError("NotFound", f"no scheduler owns peer {peer_id}")
        cause: Optional[Exception] = None
        if owner is not None:
            try:
                return op(owner)
            except Exception as exc:  # noqa: BLE001
                if state is None or not self._failover_retryable(exc):
                    raise
                cause = exc
        t0 = time.monotonic()
        with state.lock:
            with self._lock:
                current = self._peer_owner.get(peer_id)
                finalized = peer_id not in self._peer_states
            if finalized:
                # The peer's terminal report finalized it while we
                # waited on the lock — re-homing now would resurrect a
                # finished peer (ghost RUNNING until GC) and leak the
                # owner entry forever. Surface the original failure.
                raise cause if cause is not None else ServiceError(
                    "NotFound", f"peer {peer_id} already finalized")
            if current is not None and current is not owner:
                # Another thread already re-homed this peer while we
                # waited on the lock — just retry on the new owner.
                try:
                    return op(current)
                except Exception as exc:  # noqa: BLE001
                    if not self._failover_retryable(exc):
                        raise
                    cause = exc
            failed_target = state.target
            # Walk-retryable = dead/sick target. NotFound is excluded:
            # it comes from a HEALTHY replica that merely lost its
            # resource view (restart) — re-registration heals it, so it
            # must be neither negative-cached (deprioritizing a live
            # target for every other walk) nor avoided in the re-home
            # (re-homing a task's peer AWAY from its healthy ring owner
            # would split the swarm across replicas: fresh registers of
            # the same task still walk to the owner).
            target_sick = cause is not None and self._walk_retryable(cause)
            if failed_target and target_sick:
                self._note_unreachable(failed_target)
            try:
                cli = self._rehome_locked(
                    peer_id, state,
                    avoid=failed_target if target_sick else "")
            except _PeerFinalizedError:
                # The terminal call landed directly on the old owner
                # while we were re-establishing — the peer is done;
                # surface the original failure, don't retry a finished
                # peer on the new replica.
                raise cause if cause is not None else ServiceError(
                    "NotFound", f"peer {peer_id} already finalized")
            except Exception as exc:  # noqa: BLE001
                logger.warning("failover for peer %s failed: %s",
                               peer_id, exc)
                raise (cause if cause is not None else exc) from exc
            result = op(cli)
            # Counted only once the retried call SUCCEEDS — after the
            # raced-rehome/finalize checks — so one replica loss
            # observed by N concurrent calls (or a failed proactive
            # attempt followed by this reactive one) is one failover,
            # exactly matching the reroute sample it produces, and a
            # rehome whose retry then fails (new replica also dying)
            # never reports a successful re-route it didn't deliver.
            self.recovery.tick("scheduler_failovers")
            self.recovery.observe_reroute(time.monotonic() - t0)
            logger.info("peer %s re-routed %s -> %s", peer_id,
                        failed_target, state.target)
            return result

    def leave_peer(self, peer_id: str) -> None:
        """Peers may leave after their terminal report finalized the owner
        mapping — fall back to asking every replica (NotFound tolerated)."""
        with self._lock:
            owner = self._peer_owner.get(peer_id)
        if owner is not None:
            owner.leave_peer(peer_id)
            return
        for target in sorted(self.ring.targets):
            try:
                self._client_at(target).leave_peer(peer_id)
            except Exception:  # noqa: BLE001 — replica may not know the peer
                continue

    def peer_session_targets(self) -> List[str]:
        """Snapshot of each live peer session's current target, taken
        under the lock — daemon threads register and finalize sessions
        concurrently (benches poll this to find the busiest replica)."""
        with self._lock:
            return [s.target for s in self._peer_states.values()]

    def _finalize(self, peer_id: str) -> None:
        with self._lock:
            self._peer_states.pop(peer_id, None)
            owner = self._peer_owner.pop(peer_id, None)
        if owner is not None:
            self._maybe_close_retired(owner)

    # Replay state is recorded BEFORE the wire call, under state.lock:
    # recording after leaves a window where the owner dies between the
    # RPC returning and the marker landing, and the proactive re-home
    # (fired from the read-loop thread the instant the stream breaks)
    # replays WITHOUT it — a peer re-registered minus its "started"
    # marker never gets parent decisions and degrades to back-to-source.
    # Over-recording is safe: started/piece replays are idempotent
    # upserts server-side, and the failed call is retried after replay.

    def _mark_started(self, peer_id: str,
                      back_to_source: bool = False) -> None:
        with self._lock:
            state = self._peer_states.get(peer_id)
        if state is None:
            return
        with state.lock:
            if back_to_source:
                state.back_to_source_started = True
            else:
                state.started = True

    def _record_pieces(self, peer_id: str, reports) -> None:
        with self._lock:
            state = self._peer_states.get(peer_id)
        if state is None:
            return
        with state.lock:
            for report in reports:
                state.pieces[report.piece_number] = report

    def download_peer_started(self, peer_id: str) -> None:
        self._mark_started(peer_id)
        self._peer_call(peer_id,
                        lambda cli: cli.download_peer_started(peer_id))

    def download_peer_back_to_source_started(self, peer_id: str) -> None:
        self._mark_started(peer_id, back_to_source=True)
        self._peer_call(
            peer_id,
            lambda cli: cli.download_peer_back_to_source_started(peer_id))

    def download_piece_finished(self, report: PieceFinished) -> None:
        self._record_pieces(report.peer_id, [report])
        self._peer_call(report.peer_id,
                        lambda cli: cli.download_piece_finished(report))

    def download_pieces_finished(self, reports) -> None:
        reports = list(reports)
        if not reports:
            return
        # One flush = one conductor = one peer = one owning scheduler.
        self._record_pieces(reports[0].peer_id, reports)
        self._peer_call(reports[0].peer_id,
                        lambda cli: cli.download_pieces_finished(reports))

    def download_piece_failed(self, peer_id: str, parent_id: str,
                              piece_number: int) -> None:
        self._peer_call(
            peer_id,
            lambda cli: cli.download_piece_failed(
                peer_id, parent_id, piece_number))

    def claim_source_run(self, req: SourceClaimRequest) -> SourceClaimReply:
        """Origin-run claim, peer-keyed: the claim ledger lives on the
        peer's owning replica (the same one its task's other peers
        register at, so the disjointness ledger is swarm-wide). After a
        failover the new owner starts a fresh ledger — the duplicate
        origin pulls that allows are bounded by whatever was in flight
        and are visible in the fan-out bench's amplification metric."""
        return self._peer_call(
            req.peer_id, lambda cli: cli.claim_source_run(req))

    def download_peer_finished(self, peer_id: str,
                               cost_seconds: float = 0.0) -> None:
        try:
            self._peer_call(
                peer_id,
                lambda cli: cli.download_peer_finished(peer_id, cost_seconds))
        finally:
            self._finalize(peer_id)

    def download_peer_back_to_source_finished(
        self, peer_id: str, content_length: int, total_piece_count: int,
        cost_seconds: float = 0.0,
    ) -> None:
        try:
            self._peer_call(
                peer_id,
                lambda cli: cli.download_peer_back_to_source_finished(
                    peer_id, content_length, total_piece_count, cost_seconds))
        finally:
            self._finalize(peer_id)

    def download_peer_failed(self, peer_id: str) -> None:
        try:
            self._peer_call(peer_id,
                            lambda cli: cli.download_peer_failed(peer_id))
        finally:
            self._finalize(peer_id)

    def download_peer_back_to_source_failed(self, peer_id: str) -> None:
        try:
            self._peer_call(
                peer_id,
                lambda cli: cli.download_peer_back_to_source_failed(peer_id))
        finally:
            self._finalize(peer_id)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            clients = list(self._clients.values()) + list(self._retired)
            self._clients.clear()
            self._retired.clear()
            self._peer_owner.clear()
            self._peer_states.clear()
            self._known_hosts.clear()
            self._announced_tasks.clear()
            retry = self._reroute_retry_timer
            self._reroute_retry_timer = None
            health_clients = list(self._health_clients.values())
            self._health_clients.clear()
            self._health_cache.clear()
        if retry is not None:
            retry.cancel()
        for cli in clients:
            cli.close()
        for cli in health_clients:
            try:
                cli.close()
            except Exception:  # noqa: BLE001 — shutdown best effort
                pass
