"""Peer-task engine: one conductor per running download.

Reference counterpart: client/daemon/peer/peertask_conductor.go:68-1021 and
peertask_manager.go:47-377. The conductor registers with the scheduler,
consumes scheduling decisions (candidate parents / back-to-source), syncs
piece metadata from each parent (the SyncPieceTasks role,
peertask_piecetask_synchronizer.go:45-300 — here an HTTP metadata poll
against the parent's upload server), fans piece downloads across a worker
pool fed by the scored :class:`PieceDispatcher`, verifies+stores pieces, and
reports every outcome back to the scheduler so the peer DAG and the ML
dataset stay truthful.

The scheduler is reached through the ``SchedulerAPI`` protocol — satisfied
directly by ``scheduler.service.SchedulerService`` in-process (single-proc
harness, tests) or by the gRPC client adapter (multi-process deployment).
"""

from __future__ import annotations

import io
import os
import json
import logging
import queue
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence

from dragonfly2_tpu_torch.client import source as source_mod
from dragonfly2_tpu_torch.client.downloader import (
    DownloadPieceError,
    DownloadPieceRequest,
    DownloadPieceResult,
    DispatcherClosedError,
    NativePieceFetcher,
    PieceDispatcher,
    PieceDownloader,
)
from dragonfly2_tpu_torch.client.piece import (
    PieceMetadata,
    Range,
    RangeNotSatisfiable,
    compute_piece_count,
    compute_piece_size,
    piece_range,
)
from dragonfly2_tpu_torch.client.piece_reporter import PieceReportBatcher
from dragonfly2_tpu_torch.client.recovery import RECOVERY
from dragonfly2_tpu_torch.client.storage import (
    DiskFullError,
    InvalidPieceDigestError,
    StorageManager,
    TaskStorage,
    WritePieceRequest,
)
from dragonfly2_tpu_torch.client.traffic_shaper import PlainTrafficShaper, TrafficShaper
from dragonfly2_tpu_torch.scheduler.service import (
    PieceFinished,
    RegisterPeerRequest,
    RegisterPeerResponse,
)
from dragonfly2_tpu_torch.utils import digest as digestutil
from dragonfly2_tpu_torch.utils import geoplan
from dragonfly2_tpu_torch.utils import tracing
from dragonfly2_tpu_torch.utils.backoff import full_jitter
from dragonfly2_tpu_torch.utils.hosttypes import HostType

logger = logging.getLogger(__name__)

TRAFFIC_REMOTE_PEER = "remote_peer"
TRAFFIC_BACK_TO_SOURCE = "back_to_source"
# Pieces replayed from a crash-recovered journal: no bytes moved, but
# the scheduler's piece upserts (and task metadata, parent_id="") must
# reflect them so decisions resume from truth.
TRAFFIC_RESUMED = "resumed_local"


class SchedulerAPI(Protocol):
    """What the conductor needs from a scheduler (in-process service or
    gRPC adapter — method-for-method with SchedulerService)."""

    def announce_host(self, host) -> None: ...
    def register_peer(self, req: RegisterPeerRequest, channel=None) -> RegisterPeerResponse: ...
    def download_peer_started(self, peer_id: str) -> None: ...
    def download_peer_back_to_source_started(self, peer_id: str) -> None: ...
    def download_piece_finished(self, report: PieceFinished) -> None: ...
    # Schedulers MAY also expose download_pieces_finished(reports) — the
    # batched form PieceReportBatcher prefers (it feature-detects with
    # getattr and falls back to per-piece calls).
    def download_piece_failed(self, peer_id: str, parent_id: str, piece_number: int) -> None: ...
    def download_peer_finished(self, peer_id: str, cost_seconds: float = 0.0) -> None: ...
    def download_peer_back_to_source_finished(
        self, peer_id: str, content_length: int, total_piece_count: int,
        cost_seconds: float = 0.0) -> None: ...
    def download_peer_failed(self, peer_id: str) -> None: ...
    def download_peer_back_to_source_failed(self, peer_id: str) -> None: ...


# ----------------------------------------------------------------------
# Scheduling decisions delivered to the conductor
# ----------------------------------------------------------------------


@dataclass(frozen=True)
class ParentInfo:
    peer_id: str
    addr: str  # host:download_port of the parent's upload server


@dataclass(frozen=True)
class CandidateParents:
    parents: Sequence[ParentInfo]


@dataclass(frozen=True)
class NeedBackToSource:
    reason: str


@dataclass(frozen=True)
class ScheduleFailed:
    """Scheduling gave up (retry limit without back-to-source permission).
    The wire analogue of ScheduleError raising out of
    download_peer_started in-process — the conductor degrades to a
    non-reporting back-to-source attempt either way."""

    reason: str


class QueueChannel:
    """PeerChannel bound to a conductor-side queue — the in-process stand-in
    for the v2 AnnouncePeer response stream."""

    def __init__(self) -> None:
        self.decisions: "queue.Queue" = queue.Queue()
        self.closed = False

    # scheduling.core.PeerChannel protocol (receives scheduler-side peers)
    def send_candidate_parents(self, peer, parents) -> bool:
        if self.closed:
            return False
        infos = [
            ParentInfo(p.id, f"{p.host.ip}:{p.host.download_port}")
            for p in parents
        ]
        self.decisions.put(CandidateParents(infos))
        return True

    def send_need_back_to_source(self, peer, description: str) -> bool:
        if self.closed:
            return False
        self.decisions.put(NeedBackToSource(description))
        return True

    def close(self) -> None:
        self.closed = True


# ----------------------------------------------------------------------
# Back-to-source claim state (shared by both run drivers)
# ----------------------------------------------------------------------


class _SourceClaimer:
    """Back-to-source claim-side state shared by the threaded and
    event-loop run drivers: the sequential local cursor, the one-way
    remote→local mode degrade, the in-flight piece holds the re-sweep
    must skip, and the error/abort ledger. Extracted verbatim from the
    old closure set so both drivers claim with IDENTICAL semantics —
    dispatcher steering, lease disjointness and the mesh-stall
    fallback cannot diverge between engines."""

    def __init__(self, conductor: "PeerTaskConductor", total: int,
                 run_len: int):
        self.c = conductor
        self.total = total
        self.run_len = run_len
        self.lock = threading.Lock()
        self.cursor = 0
        self.errors: List[str] = []
        # First error aborts the REMAINING work (claimants stop): a dead
        # source fails in seconds instead of grinding through N doomed
        # fetches before anyone looks at `errors`.
        self.abort = threading.Event()
        # Pieces some fetcher is currently working (kept through its
        # whole retry ladder): the re-sweep below must never double-claim
        # a run another fetcher holds in flight.
        self.inflight: set = set()
        # Swarm-coordinated origin claims (fan-out dissemination): when
        # the scheduler exposes the claim ledger AND this peer is
        # registered, origin fetches claim only DISJOINT leased runs and
        # the mesh delivers the rest. Any claim failure or mesh stall
        # degrades ONE WAY to local sequential claims — liveness never
        # depends on the scheduler or the mesh.
        self.local = not (
            conductor._registered and conductor.opts.source_claims
            and getattr(conductor.scheduler, "claim_source_run", None)
            is not None)

    def is_local(self) -> bool:
        with self.lock:
            return self.local

    def note_error(self, msg: str) -> None:
        with self.lock:
            self.errors.append(msg)
        self.abort.set()

    def fallback_to_local(self) -> bool:
        """One-way degrade to local sequential claims (claim failure /
        mesh stall); True when THIS call performed the flip."""
        with self.lock:
            if self.local:
                return False
            self.local = True
            self.cursor = 0
            return True

    def hold(self, first: int, count: int) -> None:
        with self.lock:
            self.inflight.update(range(first, first + count))

    def release(self, first: int, count: int) -> None:
        with self.lock:
            self.inflight.difference_update(range(first, first + count))

    def _claimable(self, n: int) -> bool:
        return n not in self.inflight and not self.c.store.has_piece(n)

    def local_claim(self) -> "tuple[int, int] | None":
        """Next run of ≤run_len CONTIGUOUS missing pieces (pieces
        already stored — e.g. partial p2p progress before the
        back-to-source decision, or mesh deliveries during the hybrid
        phase — break runs rather than being re-fetched)."""
        with self.lock:
            if self.abort.is_set():
                return None
            while (self.cursor < self.total
                   and not self._claimable(self.cursor)):
                self.cursor += 1
            if self.cursor >= self.total:
                return None
            start = self.cursor
            n = 0
            while (n < self.run_len and start + n < self.total
                   and self._claimable(start + n)):
                n += 1
            self.cursor = start + n
            return start, n

    def remote_claim(self) -> "tuple | None":
        """One scheduler claim poll → ('run', first, count), ('wait',),
        ('retry',) after a mode flip, or None (origin work exhausted AND
        the file is locally complete). Claim replies double as mesh
        discovery: every reply's partial parents get a syncer."""
        from dragonfly2_tpu_torch.scheduler.service import SourceClaimRequest

        c = self.c
        try:
            reply = c.scheduler.claim_source_run(SourceClaimRequest(
                peer_id=c.peer_id, task_id=c.task_id,
                total_pieces=self.total, run_len=self.run_len))
            # Duck-typed scheduler stand-ins may accept the call and
            # return garbage — a malformed reply degrades like a failed
            # one.
            parents = list(reply.parents)
            first, count = int(reply.first), int(reply.count)
        except Exception as exc:  # noqa: BLE001 — degrade, don't die
            logger.debug("source claim failed (%s); degrading to "
                         "local claims", exc)
            c.recovery.tick("source_claim_fallbacks")
            # Keyed by failure shape so a fleet report can tell a
            # saturated scheduler (DeadlineExceeded) from a legacy one
            # (AttributeError) at a glance.
            c.recovery.tick(
                f"source_claim_fallback_{type(exc).__name__}")
            with self.lock:
                self.local = True
            return ("retry",)
        for pid, addr in parents:
            c._start_syncer(ParentInfo(pid, addr))
        if first >= 0:
            return ("run", first, count)
        if c._source_complete():
            return None
        if (bool(getattr(reply, "done", False)) and not parents
                and not c._mesh_feeding()):
            # Every piece has landed SOMEWHERE (done: nobody else is
            # fetching from the origin, so local refetch duplicates a
            # bounded amount) but the swarm offers this peer no parent
            # and no syncer is live — the landed copies are unreachable
            # from here, and no amount of waiting delivers them. Degrade
            # to local claims NOW instead of idling out the full
            # source_fallback_wait window. A plain "wait" (not done)
            # keeps the stall discipline: other claimants are still
            # fetching, and their pieces become offerable parents the
            # moment they land.
            if self.fallback_to_local():
                c.recovery.tick("source_mesh_unreachable_fallbacks")
                logger.warning(
                    "task %s: file fully landed in an unreachable mesh "
                    "(no parents offered, no live syncer); claiming "
                    "from origin", c.task_id[:16])
            return ("retry",)
        return ("wait",)

    def claim(self) -> "tuple | None":
        if self.abort.is_set():
            return None
        if not self.is_local():
            return self.remote_claim()
        granted = self.local_claim()
        if granted is not None:
            return ("run", granted[0], granted[1])
        # Cursor exhausted. In pure-local mode that used to mean done —
        # but mesh deliveries may still be in flight (the hybrid phase),
        # and a mesh fetch that later FAILS re-opens a hole behind the
        # cursor: re-sweep (skipping runs other fetchers hold in flight)
        # until the file is complete.
        if self.c._source_complete():
            return None
        with self.lock:
            self.cursor = 0
        return ("wait",)

    def clip(self, first: int, count: int) -> "List[tuple]":
        """Locally-MISSING subruns of a granted run: a remote grant can
        race pieces landing here (mesh delivery, journal-resume replay
        still propagating) — re-downloading them would both waste origin
        bytes and re-fire piece sinks for bytes already on disk."""
        subruns: List[tuple] = []
        sub_first, sub_n = -1, 0
        for num in range(first, first + count):
            if self.c.store.has_piece(num):
                if sub_n:
                    subruns.append((sub_first, sub_n))
                sub_first, sub_n = -1, 0
                continue
            if sub_n == 0:
                sub_first = num
            sub_n += 1
        if sub_n:
            subruns.append((sub_first, sub_n))
        return subruns


# ----------------------------------------------------------------------
# Metadata sync engines
# ----------------------------------------------------------------------


class _SyncState:
    """Per-parent metadata-sync pacing/budget state, shared by the
    thread and event-loop sync engines (see ``_sync_poll_result``)."""

    __slots__ = ("failures", "not_ready_until", "seen_pieces", "interval")

    def __init__(self, opts: "PeerTaskOptions"):
        self.failures = 0
        # Partial-parent grace: a parent offered at registration may not
        # have CREATED its store yet (it registers, then attaches
        # storage) — its 404s within this window are "not ready", not
        # failures, or every cold fan-out child would burn its sync
        # budget on the very parents it is supposed to wait for.
        self.not_ready_until = (time.monotonic()
                                + opts.metadata_not_ready_grace)
        # Idle-adaptive pacing: fast polls while the parent produces,
        # doubling toward metadata_idle_poll_cap while it doesn't — a
        # 32-daemon fleet polling every idle parent at the fast
        # interval measurably starves the transfers the polls feed.
        self.seen_pieces = -1
        self.interval = opts.metadata_poll_interval


class _AsyncSyncer:
    """Thread-shaped handle for an event-loop metadata syncer: one
    keep-alive ``BufferedGetOp`` per poll over the ENGINE-WIDE socket
    pool (one pooled connection per parent per daemon, not per task),
    pacing parked on the engine's timer wheel. Pacing, budgets and the
    piece/availability plumbing are the conductor's ``_sync_poll_result``
    — byte-for-byte the thread syncer's semantics."""

    def __init__(self, conductor: "PeerTaskConductor", parent: ParentInfo):
        self.conductor = conductor
        self.parent = parent
        self.state = _SyncState(conductor.opts)
        self._done = threading.Event()

    # thread-compatible surface (the conductor's syncer map)
    def is_alive(self) -> bool:
        return not self._done.is_set()

    def join(self, timeout: "float | None" = None) -> None:
        self._done.wait(timeout)

    def start(self) -> None:
        self._poll()

    def _poll(self) -> None:
        from dragonfly2_tpu_torch.client.download_async import BufferedGetOp

        c = self.conductor
        if (self._done.is_set() or c._sync_stop.is_set()
                or self.parent.peer_id in c._banned_parents):
            self._done.set()
            return
        try:
            c.engine.submit(BufferedGetOp(
                c.task_id, self.parent.addr,
                f"/metadata/{c.task_id}?peerId={self.parent.peer_id}",
                timeout=c.opts.metadata_timeout, stats=c.stats,
                tls=c.engine.peer_tls_context,
                callback=self._on_poll))
        except RuntimeError:  # engine stopped (daemon shutdown)
            self._done.set()

    def _on_poll(self, status, headers, body, err) -> None:
        c = self.conductor
        try:
            wait = c._sync_poll_result(self.parent, self.state,
                                       status, body or b"", err)
        except Exception:  # noqa: BLE001 — a dead syncer, not a dead loop
            logger.exception("async metadata sync failed")
            wait = None
        if wait is None or c._sync_stop.is_set():
            self._done.set()
            return
        try:
            c.engine.call_later(wait, self._poll)
        except RuntimeError:
            self._done.set()


# ----------------------------------------------------------------------
# Conductor
# ----------------------------------------------------------------------


@dataclass
class PeerTaskOptions:
    piece_concurrency: int = 4
    back_source_concurrency: int = 4
    metadata_poll_interval: float = 0.2
    timeout: float = 120.0
    random_ratio: float = 0.1  # dispatcher exploration
    # dfget --disable-back-source: this peer must NEVER fetch origin
    # itself — downloads come from the mesh or fail (root.go flag).
    disable_back_source: bool = False
    # Use the C++ piece transfer loop (native/pieceio.cpp) when the
    # compiled module is loadable; False pins the pure-Python path.
    native_data_plane: bool = True
    # Back-to-source range coalescing: each worker claims up to this many
    # CONTIGUOUS missing pieces and fetches the run with ONE ranged GET,
    # splitting the stream into pieces on the fly (piece digests,
    # metadata, shaper and report semantics unchanged). 1 = one GET per
    # piece (the old behavior).
    coalesce_run: int = 8
    # Piece-finished report batching: flush to the scheduler when this
    # many reports are buffered or the deadline (seconds) passes since
    # the first buffered one. Task end always flushes.
    report_flush_count: int = 16
    report_flush_deadline: float = 0.05
    # -- failure-recovery budgets (ISSUE 5) -------------------------------
    # Every retry loop below replaces a magic constant with a
    # configurable budget + exponential backoff with full jitter
    # (utils/backoff.py); recovery events count in the /debug/vars
    # "recovery" block (client/recovery.py).
    #
    # Metadata-sync poll: give up on a parent after this many
    # CONSECUTIVE failures (was the hard-coded 3), each retried after a
    # jittered backoff on top of the poll interval; per-poll HTTP
    # timeout (was the hard-coded urlopen timeout=5).
    metadata_retry_limit: int = 3
    metadata_timeout: float = 5.0
    # Shared backoff shape for metadata/piece/source/report retries:
    # attempt k sleeps uniform[0, min(cap, base * 2**k)].
    backoff_base: float = 0.05
    backoff_cap: float = 2.0
    # Per-piece fetch budget: a piece that fails this many times stops
    # spinning on the mesh and degrades the task to back-to-source
    # (partial p2p progress is kept — stored pieces are skipped).
    piece_retry_limit: int = 16
    # Back-to-source coalesced-run budget: transient stream failures
    # retry the run this many times before failing the task (a dead
    # source still fails fast: every retry re-dials the same origin).
    source_retry_limit: int = 3
    # Parents whose pieces fail md5 this many times are blacklisted for
    # the rest of the task (the dispatcher drops + refuses their queue).
    corrupt_blacklist_threshold: int = 3
    # A scheduler that stops answering mid-task: after this many seconds
    # with failing scheduler RPCs AND no piece progress, degrade to
    # back-to-source instead of burning the full task timeout.
    # 0 disables the grace degradation.
    scheduler_grace: float = 10.0
    # Piece-report flush retry ladder + bounded pending queue
    # (client/piece_reporter.py).
    report_retry_limit: int = 2
    report_pending_cap: int = 1024
    # -- fan-out dissemination (ISSUE 9) ----------------------------------
    # Hybrid back-to-source: when the scheduler exposes
    # claim_source_run, origin fetches claim DISJOINT runs through the
    # swarm-wide lease ledger and the mesh (partial parents from the
    # claim replies) fills everything this peer was NOT granted —
    # origin egress for an N-daemon cold fan-out stays ≈1× the file.
    # False pins the pre-ISSUE-9 behavior (every b2s peer pulls the
    # whole file itself).
    source_claims: bool = True
    # Poll pacing while the claim verdict is "wait" (other claimants
    # hold the remaining leases; the mesh is delivering).
    claim_wait_interval: float = 0.25
    # No piece landed for this long while waiting on the mesh → claim
    # missing pieces LOCALLY from the origin regardless of leases
    # (liveness when the mesh stalls; duplicate origin bytes are the
    # bench's amplification metric, not a correctness issue).
    source_fallback_wait: float = 8.0
    # A parent answering 404 on its metadata endpoint within this grace
    # of sync start is "not ready yet" (offered at registration, store
    # not created) — polls don't count toward metadata_retry_limit.
    metadata_not_ready_grace: float = 10.0
    # Idle-adaptive sync polling: a poll that surfaces NO new pieces
    # doubles the next wait up to this cap; any new piece snaps back to
    # metadata_poll_interval. Keeps dissemination latency tight while a
    # parent is producing without a fleet-wide poll storm against the
    # parents that aren't. 0 pins the fixed interval.
    metadata_idle_poll_cap: float = 0.3
    # A (parent, piece) pair that answers 404 not-ready this many times
    # falls through to the normal failure path (a parent that
    # advertises a piece but never serves it must not park forever).
    piece_not_ready_limit: int = 64
    # Mid-download parent refresh: every interval without a decision,
    # ask the scheduler to re-evaluate candidates (a cold fan-out burst
    # wires children to whatever peers existed at registration — all
    # empty; refreshing re-ranks onto the by-then piece-RICH peers and
    # flattens the dissemination chains). 0 disables.
    reschedule_interval: float = 1.0
    # Live metadata syncers per task: each costs one keep-alive poll
    # loop against a parent — the cap bounds the fleet-wide poll load
    # while refreshes rotate onto better parents as syncers retire.
    max_syncers: int = 5


@dataclass
class PeerTaskResult:
    task_id: str
    peer_id: str
    success: bool
    content_length: int = -1
    direct_bytes: bytes | None = None  # EMPTY/TINY fast-path payload
    storage: Optional[TaskStorage] = None
    error: str = ""
    # True when served from completed local storage without a new
    # conductor run (peertask_reuse.go fast path).
    reused: bool = False
    # Crash-resume accounting: verified pieces adopted from a
    # journal-recovered partial store (skipped, not re-downloaded) and
    # their byte total — the daemon-kill chaos rung's re-download bound
    # is built from these.
    resumed_pieces: int = 0
    resumed_bytes: int = 0

    def read_all(self) -> bytes:
        if self.direct_bytes is not None:
            return self.direct_bytes
        if self.storage is None:
            raise RuntimeError("no storage for task")
        return b"".join(self.storage.iter_content())

    def save_to(self, path: str) -> None:
        if self.direct_bytes is not None:
            with open(path, "wb") as f:
                f.write(self.direct_bytes)
            return
        if self.storage is None:
            raise RuntimeError("no storage for task")
        with open(path, "wb") as f:
            for chunk in self.storage.iter_content():
                f.write(chunk)


class PeerTaskConductor:
    """Drives one peer download end to end
    (peertask_conductor.go:174-380 newPeerTaskConductor/start)."""

    def __init__(
        self,
        scheduler: SchedulerAPI,
        storage: StorageManager,
        *,
        host_id: str,
        task_id: str,
        peer_id: str,
        url: str,
        request_header: Dict[str, str] | None = None,
        shaper: TrafficShaper | None = None,
        options: PeerTaskOptions | None = None,
        is_seed: bool = False,
        piece_sink=None,
        metrics=None,
        url_range: "Range | None" = None,
        priority: int = 0,
        dataplane_stats=None,
        recovery_stats=None,
        engine=None,
        traffic_class: str = "",
        tenant: str = "",
    ):
        self.scheduler = scheduler
        self.storage_manager = storage
        self.host_id = host_id
        self.task_id = task_id
        self.peer_id = peer_id
        self.url = url
        self.request_header = dict(request_header or {})
        # dfget --range: the task's content IS this byte window of the
        # source (task id already embeds it — daemon.download_file).
        self.url_range = url_range
        # Priority ladder value forwarded verbatim to the scheduler
        # (service.py register_peer: LEVEL1/2 reject, LEVEL3 self
        # back-source, others warm a seed).
        self.priority = priority
        # QoS identity (client/qos.py): rides register_peer to the
        # scheduler, tags piece GETs so parents classify this stream,
        # and scopes the task-latency SLO. "" = class-blind.
        self.traffic_class = traffic_class
        self.tenant = tenant
        self.shaper = shaper or PlainTrafficShaper()
        self.opts = options or PeerTaskOptions()
        self.is_seed = is_seed
        # DaemonMetrics or None — piece-level traffic accounting.
        self.metrics = metrics
        # Optional hook called (store, PieceMetadata) after each verified
        # piece write — feeds the HBM sink (client/hbm_sink.py) without
        # bypassing storage.
        self.piece_sink = piece_sink

        if dataplane_stats is None:
            from dragonfly2_tpu_torch.client.dataplane import STATS as dataplane_stats
        self.stats = dataplane_stats
        # Module-level import (not lazy): any process that CAN download
        # publishes the "recovery" debug block from startup.
        self.recovery = recovery_stats if recovery_stats is not None else RECOVERY
        # Daemon-wide event-loop download engine (client/download_async).
        # None = the historical thread-per-worker engine: per-task sync/
        # piece/back-source threads. With an engine, metadata syncs,
        # piece fetches and coalesced source runs all run as nonblocking
        # state machines on the engine's fixed dl-loop pool, and this
        # conductor spawns ZERO download threads.
        self.engine = engine
        self._async_lock = threading.Lock()
        self._inflight_pieces = 0
        self._async_ops: set = set()
        self.channel = QueueChannel()
        # Swarm-visibility for rarest-first dispatch: per-parent piece
        # inventories from metadata syncs and the derived availability
        # count per piece (how many known parents hold it). Written
        # under _written_lock; read lock-free by the dispatcher's
        # rarity function (a stale count only reorders a pick).
        self._parent_pieces: Dict[str, set] = {}
        self._avail: Dict[int, int] = {}
        self.dispatcher = PieceDispatcher(
            random_ratio=self.opts.random_ratio,
            rarity_fn=self._piece_availability)
        self.downloader = PieceDownloader(stats=self.stats)
        self.native_fetcher = (
            NativePieceFetcher(stats=self.stats)
            if self.opts.native_data_plane and NativePieceFetcher.supported()
            else None
        )
        self.reporter = PieceReportBatcher(
            scheduler, flush_count=self.opts.report_flush_count,
            flush_deadline=self.opts.report_flush_deadline, stats=self.stats,
            retry_limit=self.opts.report_retry_limit,
            retry_base=self.opts.backoff_base,
            retry_cap=self.opts.backoff_cap,
            pending_cap=self.opts.report_pending_cap,
            on_delivery=self._note_scheduler,
            recovery=self.recovery)
        if self.engine is not None:
            # Count-triggered batch flushes otherwise run their RPC
            # (plus the retry ladder's jittered sleeps) on whichever
            # thread reported the 16th piece — a dl-loop in engine
            # mode. Route them to the engine's dl-ctl runner so a slow
            # scheduler never stalls the byte-moving loops.
            self.reporter.flush_executor = self.engine.offload
        # Keep-alive pool for parent metadata polls (one conn per
        # parent): syncers poll at metadata_poll_interval, and a
        # connection per poll would make the fleet's metadata plane a
        # TCP-handshake storm.
        from dragonfly2_tpu_torch.client.dataplane import HTTPConnectionPool

        self._meta_pool = HTTPConnectionPool(
            per_host=1, timeout=self.opts.metadata_timeout)
        self.store: Optional[TaskStorage] = None
        self.content_length = -1
        self.total_pieces = -1
        self.piece_size = compute_piece_size(-1)

        self._done = threading.Event()
        self._success = False
        self._error = ""
        self._enqueued: set[int] = set()
        self._written_lock = threading.Lock()
        self._written: set[int] = set()
        # Crash-resume bookkeeping: pieces adopted from a recovered
        # journal (already verified on disk — skipped, not fetched).
        self._resumed_pieces = 0
        self._resumed_bytes = 0
        self._sync_stop = threading.Event()
        self._syncers: Dict[str, threading.Thread] = {}
        self._workers: List[threading.Thread] = []
        self._started_at = 0.0
        self._rng = random.Random()
        # Failure-recovery bookkeeping (all under _written_lock):
        # per-piece failed-fetch attempts, first-failure timestamps (for
        # the recovery-latency ring), pieces that EVER failed md5, and
        # per-parent corruption counts feeding the blacklist.
        self._piece_attempts: Dict[int, int] = {}
        self._first_failure_at: Dict[int, float] = {}
        self._corrupt_pieces: set[int] = set()
        self._corrupt_counts: Dict[str, int] = {}
        self._banned_parents: set[str] = set()
        # Not-ready parks per (parent, piece): a partial parent that
        # 404s a piece it advertised gets the piece re-offered on the
        # next sync instead of a failure tick, bounded by
        # piece_not_ready_limit.
        self._not_ready_counts: Dict[tuple, int] = {}
        # Hybrid back-to-source state (fan-out dissemination).
        self._b2s_mode = False
        self._registered = False
        # Scheduler-health window for the bounded-grace degradation:
        # when RPCs started failing (None = healthy) and the last time
        # the task made progress (piece stored / decision received).
        self._sched_lock = threading.Lock()
        self._sched_fail_since: Optional[float] = None
        self._last_progress_at = time.monotonic()
        self._last_refresh_at = time.monotonic()
        # Task trace context (trace_id, span_id) of the root span —
        # worker/syncer/reporter threads adopt it explicitly (fresh
        # threads carry no contextvars), and the tail-sampling verdict
        # at task end promotes or discards the whole trace. None until
        # run() opens the root span (and forever, when tracing is off).
        self._trace_ctx: "Optional[tuple]" = None
        # Why this task left the happy path (degrade-to-source reasons
        # feed the tail-sampling keep decision).
        self._degraded_reason = ""
        self._first_decision_seen = False

    # -- public entry ------------------------------------------------------

    def run(self) -> PeerTaskResult:
        if not self.traffic_class:
            return self._run_with_trace()
        # Class-tagged task latency: the per-class p50/p99 the qos bench
        # gates on and /metrics exports (df2_qos_task_ms_p99_<class>).
        begin = time.monotonic()
        try:
            return self._run_with_trace()
        finally:
            from dragonfly2_tpu_torch.client.qos import QOS

            QOS.task_done(self.traffic_class,
                          (time.monotonic() - begin) * 1e3)

    def _run_with_trace(self) -> PeerTaskResult:
        # The conductor's task-level span (peertask_conductor.go:255
        # SpanRegisterTask): child rpc.client spans hang off it, so one
        # trace covers register → schedule → pieces → finish. At task
        # end the tail sampler gets its verdict: an SLO breach (failed /
        # degraded-to-source / slow; failover promotes at the failover
        # site) ships the buffered trace, a clean fast task drops it.
        tracer = tracing.default_tracer()
        if not tracer.enabled:
            return self._run()
        begin = time.monotonic()
        with tracer.span("peer_task.run", task_id=self.task_id,
                         peer_id=self.peer_id, url=self.url) as rec:
            self._trace_ctx = tracing.current_trace_context()
            # This conductor OWNS the trace's verdict (the promote/
            # finish below) — only promised traces may buffer.
            tracer.expect_trace(self._trace_ctx[0])
            self.reporter.trace_ctx = self._trace_ctx
            try:
                result = self._run()
            except BaseException:
                # An escaping exception is a failed task: keep the
                # trace (the root span closes after this and writes
                # through under the promotion).
                tracer.promote_trace(self._trace_ctx[0], "failed")
                raise
            rec["attrs"].update(
                success=result.success, error=result.error,
                resumed_pieces=result.resumed_pieces,
                degraded=self._degraded_reason)
        elapsed = time.monotonic() - begin
        reason = self._trace_keep_reason(result, elapsed, tracer)
        if reason:
            tracer.promote_trace(self._trace_ctx[0], reason)
        else:
            tracer.finish_trace(self._trace_ctx[0])
        return result

    def _trace_keep_reason(self, result: PeerTaskResult, elapsed: float,
                           tracer) -> str:
        """The tail-sampling SLO verdict for this task ('' = in SLO)."""
        if not result.success:
            return "failed"
        if self._degraded_reason:
            return "degraded_to_source"
        sampler = getattr(tracer, "sampler", None)
        if sampler is not None and elapsed > sampler.slo_for(
                self.traffic_class):
            return "slow"
        return ""

    def _run(self) -> PeerTaskResult:
        self._started_at = time.monotonic()
        try:
            register = RegisterPeerRequest(
                host_id=self.host_id, task_id=self.task_id,
                peer_id=self.peer_id, url=self.url,
                request_header=self.request_header,
                url_range=(f"{self.url_range.start}-{self.url_range.end}"
                           if self.url_range else ""),
                priority=self.priority,
                traffic_class=self.traffic_class,
                tenant=self.tenant,
            )
            try:
                with tracing.default_tracer().span("peer_task.register",
                                           task_id=self.task_id):
                    resp = self.scheduler.register_peer(
                        register, channel=self.channel)
                self._registered = True
            except Exception as exc:
                # Scheduler unreachable → degrade to pure back-to-source,
                # like the conductor's dummy-scheduler fallback
                # (peertask_conductor.go:285-289).
                logger.warning("register failed (%s); back-to-source", exc)
                self._degraded_reason = "register_failed"
                return self._run_back_to_source(report=False)

            from dragonfly2_tpu_torch.scheduler.resource.task import SizeScope

            if resp.size_scope == SizeScope.EMPTY:
                return PeerTaskResult(self.task_id, self.peer_id, True,
                                      content_length=0, direct_bytes=b"")
            if resp.size_scope == SizeScope.TINY and resp.direct_piece:
                return PeerTaskResult(
                    self.task_id, self.peer_id, True,
                    content_length=len(resp.direct_piece),
                    direct_bytes=resp.direct_piece,
                )

            resumed = self._attach_store()
            if resp.content_length >= 0:
                self._learn_length(resp.content_length, resp.total_piece_count)

            try:
                self.scheduler.download_peer_started(self.peer_id)
            except Exception as exc:
                logger.warning("download started failed (%s); back-to-source", exc)
                self._degraded_reason = "started_failed"
                return self._run_back_to_source(report=False)

            if resumed:
                # Registration is in: replay the recovered pieces into
                # the scheduler's view through the idempotent-upsert
                # path (PR 6 — duplicate replays never double-count),
                # so its parent decisions and finished counts resume
                # from truth instead of zero.
                self._replay_resumed(resumed)
            return self._pull_pieces()
        finally:
            self._shutdown_workers()

    # -- crash resume (journal-recovered partial stores) -------------------

    def _attach_store(self) -> "List[PieceMetadata]":
        """Bind task storage, adopting a journal-recovered partial
        store when one exists: its verified pieces seed the
        downloaded-set, so syncer enqueues skip them and only the
        missing tail is fetched. Returns the adopted pieces (empty on
        a fresh registration)."""
        resume = getattr(self.storage_manager, "register_or_resume", None)
        if resume is None:  # duck-typed stand-in without resume support
            self.store = self.storage_manager.register_task(
                self.task_id, self.peer_id)
            return []
        self.store, resumed = resume(self.task_id, self.peer_id)
        self.store.update(url=self.url)
        if not resumed:
            return []
        with self._written_lock:
            for piece in resumed:
                self._written.add(piece.num)
        self._resumed_pieces = len(resumed)
        self._resumed_bytes = sum(p.length for p in resumed)
        self.recovery.tick("tasks_resumed")
        self.recovery.tick("resume_pieces_reused", len(resumed))
        tracer = tracing.default_tracer()
        if tracer.enabled:
            tracer.emit("peer_task.resume", start=time.time(),
                        duration_s=0.0, pieces=self._resumed_pieces,
                        nbytes=self._resumed_bytes)
        meta = self.store.meta
        if meta.content_length >= 0:
            # The journal knows the task shape even when the scheduler
            # (also restarted) no longer does.
            self._learn_length(meta.content_length, meta.total_pieces)
        logger.info(
            "task %s resumed from journal: %d verified piece(s), %d bytes",
            self.task_id[:16], self._resumed_pieces, self._resumed_bytes)
        return resumed

    def _replay_resumed(self, resumed: "List[PieceMetadata]") -> None:
        for piece in resumed:
            self.reporter.report(PieceFinished(
                peer_id=self.peer_id, piece_number=piece.num, parent_id="",
                offset=piece.offset, length=piece.length,
                digest=f"md5:{piece.md5}" if piece.md5 else "",
                cost_ns=0, traffic_type=TRAFFIC_RESUMED,
            ))
        # Deliver the replay BEFORE any scheduling decision can race it:
        # the source-claim ledger must see the resumed pieces as landed,
        # or a back-to-source claim could be granted runs this daemon
        # already holds (re-downloading them from origin).
        self.reporter.flush()
        self._touch_progress()
        self._check_finished()  # crash AFTER the last piece, BEFORE done

    # -- scheduling decision loop (receivePeerPacket / pullPiecesWithP2P) --

    def _pull_pieces(self) -> PeerTaskResult:
        self._start_workers()
        deadline = time.monotonic() + self.opts.timeout
        while not self._done.is_set():
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return self._fail("peer task timeout")
            try:
                decision = self.channel.decisions.get(timeout=min(remaining, 0.5))
            except queue.Empty:
                self._check_finished()
                self._maybe_refresh_parents()
                if not self._done.is_set() and self._scheduler_stalled():
                    # Scheduler went UNAVAILABLE mid-task and nothing is
                    # progressing: degrade after the bounded grace
                    # instead of burning the full task deadline.
                    self._degraded_reason = "scheduler_stalled"
                    self.recovery.tick("scheduler_degraded_to_source")
                    logger.warning(
                        "peer %s: scheduler unresponsive past %.1fs grace; "
                        "degrading to back-to-source", self.peer_id,
                        self.opts.scheduler_grace)
                    return self._run_back_to_source(report=False)
                continue
            self._touch_progress()
            self._note_first_decision(type(decision).__name__)
            if isinstance(decision, NeedBackToSource):
                logger.info("peer %s told to back-to-source: %s",
                            self.peer_id, decision.reason)
                return self._run_back_to_source(report=True)
            if isinstance(decision, ScheduleFailed):
                logger.warning("peer %s scheduling failed (%s); "
                               "back-to-source", self.peer_id, decision.reason)
                self._degraded_reason = "schedule_failed"
                return self._run_back_to_source(report=False)
            if isinstance(decision, CandidateParents):
                for parent in decision.parents:
                    self._start_syncer(parent)
        if self._success:
            return PeerTaskResult(
                self.task_id, self.peer_id, True,
                content_length=self.content_length, storage=self.store,
                resumed_pieces=self._resumed_pieces,
                resumed_bytes=self._resumed_bytes,
            )
        return PeerTaskResult(self.task_id, self.peer_id, False,
                              storage=self.store, error=self._error,
                              resumed_pieces=self._resumed_pieces,
                              resumed_bytes=self._resumed_bytes)

    def _note_first_decision(self, kind: str) -> None:
        """Emit the schedule-wait span once: registration → the first
        scheduler decision reaching this conductor (the interval the
        announce p99 promises to keep small, seen from the peer)."""
        if self._first_decision_seen:
            return
        self._first_decision_seen = True
        tracer = tracing.default_tracer()
        if not tracer.enabled or self._trace_ctx is None:
            return
        wait_s = time.monotonic() - self._started_at
        tracer.emit("peer_task.schedule_wait",
                    start=time.time() - wait_s, duration_s=wait_s,
                    parent=self._trace_ctx, decision=kind,
                    peer_id=self.peer_id)

    def _maybe_refresh_parents(self) -> None:
        """Periodic LIGHT parent refresh while the download runs: a
        probe claim (run_len=0) returns the evaluator-ranked partial
        parents — the peers that actually accumulated pieces since this
        child registered — and fresh syncers re-aim at them. No DAG
        edges, no scheduling ladder, no schedule_count growth: a cold
        fan-out burst wires children to whatever (empty) peers existed
        at registration, and without this the dissemination tree stays
        a deep chain for the whole download."""
        interval = self.opts.reschedule_interval
        if interval <= 0 or self._done.is_set() or not self._registered:
            return
        probe = getattr(self.scheduler, "claim_source_run", None)
        if probe is None:
            return
        now = time.monotonic()
        if now - self._last_refresh_at < interval:
            return
        self._last_refresh_at = now
        from dragonfly2_tpu_torch.scheduler.service import SourceClaimRequest

        try:
            reply = probe(SourceClaimRequest(
                peer_id=self.peer_id, task_id=self.task_id, run_len=0))
            self._note_scheduler(True)
        except Exception:
            self._note_scheduler(False)
            logger.debug("parent refresh failed", exc_info=True)
            return
        self.recovery.tick("parent_refreshes")
        for pid, addr in reply.parents:
            self._start_syncer(ParentInfo(pid, addr))

    # -- scheduler health (bounded-grace degradation) ----------------------

    def _note_scheduler(self, ok: bool) -> None:
        """Observed outcome of a scheduler RPC (reports, batched
        flushes): opens/closes the grace window for mid-task
        degradation."""
        with self._sched_lock:
            if ok:
                self._sched_fail_since = None
            elif self._sched_fail_since is None:
                self._sched_fail_since = time.monotonic()

    def _touch_progress(self) -> None:
        with self._sched_lock:
            self._last_progress_at = time.monotonic()

    def _scheduler_stalled(self) -> bool:
        """True when the scheduler grace has run out: RPCs have been
        failing (or the scheduler has been silent since registration —
        no decision, no parents) AND no piece progress for the whole
        grace window. Progress without a scheduler (parents already
        syncing) never degrades — the mesh can finish the task alone."""
        grace = self.opts.scheduler_grace
        if grace <= 0:
            return False
        now = time.monotonic()
        with self._sched_lock:
            failing_since = self._sched_fail_since
            last_progress = self._last_progress_at
        if now - last_progress <= grace:
            return False
        if failing_since is not None and now - failing_since > grace:
            return True
        # Silent scheduler: registered + started fine, then nothing — no
        # LIVE parent is feeding us (dead syncer threads stay in the map
        # forever, so emptiness alone would mask an offered-then-died
        # parent) and the scheduler isn't rescheduling.
        feeding = any(t.is_alive() for t in self._syncers.values())
        return not feeding and now - self._started_at > grace

    def _mesh_feeding(self) -> bool:
        """Is any LIVE metadata syncer still connected to a parent? A
        source claimer told to WAIT (other claimants hold the leases)
        only profits from waiting while the mesh can actually deliver
        those pieces here — with no live syncer there is no path for
        them, and the claimer should degrade to local claims NOW instead
        of idling out the full ``source_fallback_wait`` window."""
        return any(t.is_alive() for t in self._syncers.values())

    # -- piece metadata sync per parent (synchronizer role) ----------------

    def _start_syncer(self, parent: ParentInfo) -> None:
        if parent.peer_id == self.peer_id:
            return
        if parent.peer_id in self._banned_parents:
            # Blacklisted for repeat corruption: a reschedule may
            # re-offer the parent, but this task wants nothing from it.
            return
        # Replace dead syncers: a reschedule may re-offer a parent whose
        # previous sync thread already exited, and a failed piece can only
        # be re-enqueued by a live syncer.
        existing = self._syncers.get(parent.peer_id)
        if existing is not None and existing.is_alive():
            return
        if (existing is None and self.opts.max_syncers > 0
                and sum(1 for t in self._syncers.values() if t.is_alive())
                >= self.opts.max_syncers):
            # Poll-load cap: every live syncer keep-alive-polls its
            # parent; an uncapped refresh stream would accrete one loop
            # per parent ever offered and the fleet's poll traffic
            # would swamp the mesh it feeds.
            return
        if self.engine is not None:
            syncer = _AsyncSyncer(self, parent)
            self._syncers[parent.peer_id] = syncer
            syncer.start()
            return
        t = threading.Thread(
            target=self._sync_parent, args=(parent,),
            name=f"piece-sync-{parent.peer_id[:8]}", daemon=True,
        )
        self._syncers[parent.peer_id] = t
        t.start()

    def _fetch_parent_metadata(self, parent: ParentInfo) -> tuple:
        """One metadata poll over the conductor's keep-alive pool —
        urllib's connection-per-poll made a fleet's metadata plane cost
        one TCP handshake per parent per poll interval. Returns
        (status, body bytes); transport failures raise."""
        host, sep, port = parent.addr.rpartition(":")
        if not sep or not port.isdigit():
            raise OSError(f"malformed parent address {parent.addr!r}")
        conn, resp = self._meta_pool.request(
            ("http", host, int(port)), "GET",
            f"/metadata/{self.task_id}?peerId={parent.peer_id}",
            headers={"Connection": "keep-alive"})
        try:
            body = resp.read()
            status = resp.status
        except Exception:
            conn.close()
            raise
        if resp.will_close or not resp.isclosed():
            conn.close()
        else:
            self._meta_pool.checkin(("http", host, int(port)), conn)
        return status, body

    def _sync_parent(self, parent: ParentInfo) -> None:
        tracing.adopt_trace_context(self._trace_ctx)
        state = _SyncState(self.opts)
        while not self._sync_stop.is_set():
            if parent.peer_id in self._banned_parents:
                return  # blacklisted mid-sync (repeat corruption)
            try:
                status, body = self._fetch_parent_metadata(parent)
                exc = None
            except Exception as poll_exc:  # noqa: BLE001 — budgeted below
                status, body, exc = -1, b"", poll_exc
            wait = self._sync_poll_result(parent, state, status, body, exc)
            if wait is None:
                return
            self._sync_stop.wait(wait)

    def _sync_poll_result(self, parent: ParentInfo, state: "_SyncState",
                          status: int, body: bytes,
                          exc: "Exception | None") -> "float | None":
        """Shared poll-outcome handler for BOTH sync engines (the thread
        loop above and the event-loop :class:`_AsyncSyncer`): applies the
        not-ready grace, the retry budget with jittered backoff, the
        idle-adaptive pacing, availability/enqueue updates and the
        giveup watchdog. Returns the wait before the next poll, or None
        to retire the syncer."""
        if exc is None:
            # The WHOLE shape-dependent decode is budgeted: a parent
            # answering 200 with a body that parses but isn't the
            # metadata shape (a list, a piece entry missing "offset")
            # must count against the retry budget and eventually hit
            # the giveup bookkeeping below — not escape and kill the
            # syncer with the parent's stale availability still
            # registered.
            try:
                if status == 404:
                    if time.monotonic() < state.not_ready_until:
                        self.recovery.tick("metadata_not_ready_polls")
                        return self.opts.metadata_poll_interval
                    raise OSError(f"metadata 404 from {parent.addr}")
                if status != 200:
                    raise OSError(
                        f"metadata status {status} from {parent.addr}")
                meta = json.loads(body)
                content_length = meta.get("contentLength", -1)
                total_pieces = meta.get("totalPieces", -1)
                done = bool(meta.get("done"))
                parsed = [PieceMetadata(
                    num=p["num"], md5=p.get("md5", ""),
                    offset=p["offset"], start=p["start"],
                    length=p["length"],
                ) for p in meta.get("pieces", [])]
            except Exception as parse_exc:  # noqa: BLE001 — budgeted
                exc = parse_exc
        if exc is None:
            state.failures = 0
            if content_length >= 0:
                self._learn_length(content_length, total_pieces)
            self._update_availability(
                parent.peer_id, {pm.num for pm in parsed})
            for pm in parsed:
                self._enqueue_piece(parent, pm)
            # Stay alive until the task completes: pieces that fail
            # download are discarded from _enqueued and only a live
            # syncer poll re-enqueues them.
            if done and self._all_written():
                return None
            cap = self.opts.metadata_idle_poll_cap
            if len(parsed) != state.seen_pieces or cap <= 0:
                state.seen_pieces = len(parsed)
                state.interval = self.opts.metadata_poll_interval
            else:
                state.interval = min(max(state.interval * 2, 1e-3), cap)
            return state.interval
        state.failures += 1
        logger.debug("metadata sync %s failed (%d): %s",
                     parent.addr, state.failures, exc)
        if state.failures > self.opts.metadata_retry_limit:
            # Watchdog gives up on the parent
            # (peertask_piecetask_synchronizer.go:70 watchdog).
            self.recovery.tick("metadata_sync_giveups")
            self._drop_parent_availability(parent.peer_id)
            # Async syncers run this handler on a loop thread — the
            # whole-parent failure RPC goes through the ctl runner.
            self._offload_control(
                lambda p=parent.peer_id: self._report_piece_failed(p, -1))
            return None
        # Budgeted retry with full jitter instead of hammering a
        # flapping parent at the poll interval.
        self.recovery.tick("metadata_retries")
        state.interval = self.opts.metadata_poll_interval
        return state.interval + full_jitter(
            state.failures - 1, self.opts.backoff_base,
            self.opts.backoff_cap, self._rng)

    # -- swarm availability (rarest-first input) ---------------------------

    def _piece_availability(self, num: int) -> int:
        """How many known live parents advertise the piece (0 = rarest).
        Lock-free read — the dispatcher calls this per candidate pick."""
        return self._avail.get(num, 0)

    def _update_availability(self, parent_id: str, nums: set) -> None:
        with self._written_lock:
            prev = self._parent_pieces.get(parent_id, set())
            for n in nums - prev:
                self._avail[n] = self._avail.get(n, 0) + 1
            self._parent_pieces[parent_id] = nums

    def _drop_parent_availability(self, parent_id: str) -> None:
        """The parent left the mesh (sync giveup / blacklist): its
        inventory no longer counts toward piece availability."""
        with self._written_lock:
            for n in self._parent_pieces.pop(parent_id, set()):
                count = self._avail.get(n, 0)
                if count <= 1:
                    self._avail.pop(n, None)
                else:
                    self._avail[n] = count - 1

    def _all_written(self) -> bool:
        if self.total_pieces < 0:
            return False
        with self._written_lock:
            return len(self._written) >= self.total_pieces

    def _enqueue_piece(self, parent: ParentInfo, piece: PieceMetadata) -> None:
        if parent.peer_id in self._banned_parents:
            return
        with self._written_lock:
            # Dedup on _enqueued alone: retry re-entry happens by the
            # failure path discarding the piece from _enqueued.
            if piece.num in self._enqueued or piece.num in self._written:
                return
            self._enqueued.add(piece.num)
        accepted = self.dispatcher.put(DownloadPieceRequest(
            task_id=self.task_id, src_peer_id=self.peer_id,
            dst_peer_id=parent.peer_id, dst_addr=parent.addr, piece=piece,
        ))
        if not accepted:
            # Parent was blacklisted between the check above and the put
            # (concurrent _on_piece_corrupt): un-mark the piece so a
            # healthy parent's syncer can still enqueue it — otherwise
            # it is stranded until the task deadline.
            with self._written_lock:
                self._enqueued.discard(piece.num)
            return
        if self.engine is not None:
            self._async_pump()

    # -- piece download workers (downloadPieceWorker) ----------------------

    def _start_workers(self) -> None:
        if self.engine is not None:
            # Event-loop mode: no worker threads — the pump keeps up to
            # piece_concurrency PieceFetchOps in flight on the engine.
            self._async_pump()
            return
        for i in range(self.opts.piece_concurrency):
            t = threading.Thread(
                target=self._piece_worker, name=f"piece-worker-{i}", daemon=True
            )
            self._workers.append(t)
            t.start()

    # -- event-loop piece pump (engine mode) -------------------------------

    def _async_pump(self) -> None:
        """Keep up to ``piece_concurrency`` PieceFetchOps in flight on
        the engine — the event-loop replacement for the worker-thread
        pool. Driven by enqueues (syncers) and completions (loop
        threads); safe from any thread."""
        if self.engine is None or self._done.is_set():
            return
        while True:
            with self._async_lock:
                if self._inflight_pieces >= self.opts.piece_concurrency:
                    return
                self._inflight_pieces += 1
            req = None
            closed = False
            try:
                req = self.dispatcher.get(timeout=0)
            except DispatcherClosedError:
                closed = True
            if req is None:
                with self._async_lock:
                    self._inflight_pieces -= 1
                # Lost-wakeup guard: an enqueue that raced the empty get
                # above may have seen our transient slot at the cap and
                # bailed without pumping. Its put() happens-before its
                # cap check, so after releasing the slot any stranded
                # piece is visible here — loop back for it.
                if closed or not self.dispatcher.pending():
                    return
                continue
            with self._written_lock:
                done_already = req.piece.num in self._written
            if done_already or (self.store is not None
                                and self.store.has_piece(req.piece.num)):
                with self._async_lock:
                    self._inflight_pieces -= 1
                continue
            try:
                self._async_submit_piece(req)
            except RuntimeError:
                # Engine stopped mid-shutdown: re-open the piece for a
                # (never-coming) retry and stop pumping — the task is
                # tearing down anyway.
                with self._async_lock:
                    self._inflight_pieces -= 1
                with self._written_lock:
                    self._enqueued.discard(req.piece.num)
                return

    def _async_submit_piece(self, req: DownloadPieceRequest) -> None:
        from dragonfly2_tpu_torch.client.download_async import PieceFetchOp

        begin_wall = time.time()
        holder = {}

        def on_done(md5_hex, cost_ns, err, _req=req, _t0=begin_wall):
            self._on_async_piece(_req, md5_hex, cost_ns, err, _t0,
                                 holder.get("op"))

        op = PieceFetchOp(
            req,
            open_fd=self.store.data_write_fd,
            reserve=lambda n: self.shaper.reserve_n(self.task_id, n),
            refund=lambda n: self.shaper.return_n(self.task_id, n),
            callback=on_done,
            timeout=self.downloader.timeout,
            stats=self.stats,
            tls=self.engine.peer_tls_context,
            chunk_hook=self.downloader.chunk_hook,
        )
        if self.traffic_class:
            op.qos_class = self.traffic_class
            op.qos_tenant = self.tenant
        holder["op"] = op
        with self._async_lock:
            self._async_ops.add(op)
        self.engine.submit(op)

    def _on_async_piece(self, req: DownloadPieceRequest,
                        md5_hex: "str | None", cost_ns: int,
                        err: "DownloadPieceError | None",
                        begin_wall: float, op) -> None:
        """Completion of one event-loop piece fetch (loop thread) —
        the async mirror of ``_fetch_one_piece``'s outcome handling."""
        delay = 0.0
        outcome = "stored"
        try:
            if err is None:
                self.dispatcher.report(DownloadPieceResult(
                    req.dst_peer_id, req.piece.num, fail=False,
                    cost_ns=cost_ns))
                self._record_fetched_piece(req, md5_hex, cost_ns)
            elif self._done.is_set():
                outcome = "cancelled"  # task over; no failure accounting
            elif err.fatal:
                outcome = "fatal"
                self.recovery.tick("enospc_fail_fast")
                self._fail(f"disk full: {err}")
            elif err.not_ready and self._note_piece_not_ready(req):
                outcome = "not_ready"
            else:
                outcome = "failed"
                logger.debug("piece %d from %s failed: %s",
                             req.piece.num, req.dst_peer_id, err)
                self.dispatcher.report(DownloadPieceResult(
                    req.dst_peer_id, req.piece.num, fail=True))
                # The failure RPC (up to 2 sync attempts) must not run
                # on this loop thread — a slow scheduler would stall
                # every task multiplexed here.
                self._offload_control(
                    lambda p=req.dst_peer_id, n=req.piece.num:
                    self._report_piece_failed(p, n))
                delay = self._note_piece_failure(req.piece.num)
        finally:
            self._emit_piece_span(req, begin_wall, outcome)
            with self._async_lock:
                self._inflight_pieces -= 1
                self._async_ops.discard(op)
            if delay > 0:
                try:
                    self.engine.call_later(delay, self._async_pump)
                except RuntimeError:
                    pass
            else:
                self._async_pump()

    def _emit_piece_span(self, req: DownloadPieceRequest,
                         begin_wall: float, outcome: str) -> None:
        """Retrospective ``piece.fetch`` span (loop threads multiplex
        many tasks, so the threaded engine's context-manager span can't
        wrap an async fetch)."""
        tracer = tracing.default_tracer()
        if not tracer.enabled:
            return
        tracer.emit("piece.fetch", start=begin_wall,
                    duration_s=max(time.time() - begin_wall, 0.0),
                    parent=self._trace_ctx, piece=req.piece.num,
                    parent_id=req.dst_peer_id, nbytes=req.piece.length,
                    outcome=outcome)

    def _piece_worker(self) -> None:
        # Fresh thread, fresh contextvar context: adopt the task trace
        # so piece spans (and the RPCs under them) join the root.
        tracing.adopt_trace_context(self._trace_ctx)
        while not self._done.is_set():
            try:
                req = self.dispatcher.get(timeout=0.2)
            except DispatcherClosedError:
                return
            if req is None:
                continue
            with self._written_lock:
                if req.piece.num in self._written:
                    continue
            tracer = tracing.default_tracer()
            if tracer.enabled:
                span_kw = {"piece": req.piece.num,
                           "parent_id": req.dst_peer_id,
                           "nbytes": req.piece.length}
                geo = geoplan.ACTIVE
                if geo is not None and geo.is_wan(req.dst_addr):
                    # Cross-cluster fetch: tag the span so trace analysis
                    # can separate WAN hops from intra-site traffic.
                    span_kw["cross_cluster"] = True
                with tracer.span("piece.fetch", **span_kw) as rec:
                    if not self._fetch_one_piece(req, rec.get("attrs")):
                        return
            elif not self._fetch_one_piece(req, None):
                return

    def _fetch_one_piece(self, req: DownloadPieceRequest,
                         span_attrs: "dict | None") -> bool:
        """Fetch+store one dispatched piece (the loop body of
        ``_piece_worker``); returns False only on a fatal error that
        must stop the worker. ``span_attrs`` is the live ``piece.fetch``
        span's attr dict (None with tracing off) — outcomes land there
        so the critical-path analyzer can tell a stored piece from a
        park or a failure."""
        self.shaper.wait_n(self.task_id, req.piece.length)
        begin = time.monotonic_ns()
        fetched_md5: str | None = None
        try:
            if (self.store is not None
                    and not self.store.has_piece(req.piece.num)):
                # Streaming data plane (C++ when available, pooled
                # keep-alive Python otherwise): socket → pwrite at
                # the piece offset → incremental md5, never a whole
                # piece in a Python bytes object.
                if self.native_fetcher is not None:
                    fetched_md5 = self._download_piece_native(req)
                else:
                    fetched_md5 = self._download_piece_streamed(req)
                data = None
            else:
                data = self.downloader.download_piece(req)
        except DownloadPieceError as exc:
            logger.debug("piece %d from %s failed: %s",
                         req.piece.num, req.dst_peer_id, exc)
            if exc.fatal:
                # Disk full: no other parent can fix this — fail the
                # task fast instead of hanging workers on a doomed
                # requeue loop.
                if span_attrs is not None:
                    span_attrs["outcome"] = "fatal"
                self.recovery.tick("enospc_fail_fast")
                self._fail(f"disk full: {exc}")
                return False
            if exc.not_ready and self._note_piece_not_ready(req):
                # Partial parent hasn't landed the piece yet: parked
                # (re-offered by the next metadata sync) — no
                # corruption/blacklist tick, no retry-budget burn,
                # no scheduler piece-failed report.
                if span_attrs is not None:
                    span_attrs["outcome"] = "not_ready"
                return True
            if span_attrs is not None:
                span_attrs["outcome"] = "failed"
            self.dispatcher.report(DownloadPieceResult(
                req.dst_peer_id, req.piece.num, fail=True))
            self._report_piece_failed(req.dst_peer_id, req.piece.num)
            # Requeue for another parent (or the same one later),
            # under the per-piece retry budget + jittered backoff.
            self._note_piece_failure(req.piece.num)
            return True
        cost = time.monotonic_ns() - begin
        if span_attrs is not None:
            span_attrs["outcome"] = "stored"
        self.dispatcher.report(DownloadPieceResult(
            req.dst_peer_id, req.piece.num, fail=False, cost_ns=cost))
        if fetched_md5 is not None:
            self._record_fetched_piece(req, fetched_md5, cost)
        else:
            self._store_piece(req, data, cost)
        return True

    def _download_piece_native(self, req: DownloadPieceRequest) -> str:
        """C data plane: the piece streams socket → data file inside one
        native call (recv+pwrite+md5, GIL released); returns the md5."""
        try:
            fd = self.store.data_write_fd()
        except OSError as exc:
            # Task directory raced away (concurrent delete_task/GC —
            # the documented ENOENT-under-churn case): surface as a
            # piece failure like the Python path does, not a dead
            # worker thread.
            raise DownloadPieceError(f"data file unavailable: {exc}") from exc
        try:
            return self.native_fetcher.fetch(req, fd)
        finally:
            os.close(fd)

    def _download_piece_streamed(self, req: DownloadPieceRequest) -> str:
        """Pure-Python mirror of the native path: the pooled keep-alive
        downloader streams the body chunkwise into the data file
        (pwrite at the piece offset, incremental md5)."""
        try:
            fd = self.store.data_write_fd()
        except OSError as exc:
            raise DownloadPieceError(f"data file unavailable: {exc}") from exc
        try:
            return self.downloader.fetch(req, fd)
        finally:
            os.close(fd)

    def _record_fetched_piece(self, req: DownloadPieceRequest, md5_hex: str,
                              cost_ns: int) -> None:
        piece = req.piece
        try:
            self.store.record_piece(piece, piece.length, md5_hex, cost_ns)
        except InvalidPieceDigestError as exc:
            self._on_piece_corrupt(req, exc)
            return
        except DiskFullError as exc:
            self.recovery.tick("enospc_fail_fast")
            self._fail(f"disk full: {exc}")
            return
        except Exception as exc:
            logger.warning("store piece %d failed: %s", piece.num, exc)
            self._report_piece_failed(req.dst_peer_id, piece.num)
            self._note_piece_failure(piece.num)
            return
        self._after_piece_stored(req, cost_ns)

    def _store_piece(self, req: DownloadPieceRequest, data: bytes,
                     cost_ns: int) -> None:
        piece = req.piece
        try:
            self.store.write_piece(
                WritePieceRequest(self.task_id, self.peer_id, piece),
                io.BytesIO(data),
            )
        except InvalidPieceDigestError as exc:
            self._on_piece_corrupt(req, exc)
            return
        except DiskFullError as exc:
            self.recovery.tick("enospc_fail_fast")
            self._fail(f"disk full: {exc}")
            return
        except Exception as exc:
            logger.warning("store piece %d failed: %s", piece.num, exc)
            self._report_piece_failed(req.dst_peer_id, piece.num)
            self._note_piece_failure(piece.num)
            return
        self._after_piece_stored(req, cost_ns)

    def _note_piece_not_ready(self, req: DownloadPieceRequest) -> bool:
        """A parent 404'd a piece it doesn't hold YET. Park the piece
        (un-mark it enqueued so the next metadata sync — of this parent
        once it lands the piece, or of any other — re-offers it) and
        tell the dispatcher nothing: "not yet" is not a failure, so no
        score penalty, no avoid-map entry, no retry-budget burn.
        Returns False once the (parent, piece) pair exhausted
        ``piece_not_ready_limit`` — the caller then takes the normal
        failure path (a parent forever advertising what it won't serve
        must not park pieces until the task deadline)."""
        key = (req.dst_peer_id, req.piece.num)
        with self._written_lock:
            count = self._not_ready_counts.get(key, 0) + 1
            self._not_ready_counts[key] = count
            if count > self.opts.piece_not_ready_limit > 0:
                return False
            self._enqueued.discard(req.piece.num)
        self.recovery.tick("piece_not_ready_parks")
        return True

    def _note_piece_failure(self, piece_num: int) -> float:
        """Count one failed attempt at a piece, re-open it for (other)
        syncers, and enforce the per-piece retry budget: an exhausted
        piece degrades the task to back-to-source instead of spinning on
        the mesh until the task deadline. Thread mode SLEEPS the jittered
        backoff here (pacing the calling worker); event-loop mode gets
        the delay returned instead and parks the pump on the engine's
        timer wheel — a loop thread never sleeps a backoff."""
        now = time.monotonic()
        with self._written_lock:
            attempts = self._piece_attempts.get(piece_num, 0) + 1
            self._piece_attempts[piece_num] = attempts
            self._first_failure_at.setdefault(piece_num, now)
            self._enqueued.discard(piece_num)
        self.recovery.tick("piece_retries")
        if attempts >= self.opts.piece_retry_limit > 0:
            self.recovery.tick("piece_retry_exhausted")
            self.channel.decisions.put(NeedBackToSource(
                f"piece {piece_num} exhausted its "
                f"{self.opts.piece_retry_limit}-attempt retry budget"))
            return 0.0
        # Jittered backoff before more work is grabbed for the piece: a
        # dead parent no longer gets hammered in a tight requeue loop.
        delay = full_jitter(attempts - 1, self.opts.backoff_base,
                            self.opts.backoff_cap, self._rng)
        if self.engine is None:
            self._done.wait(delay)
            return 0.0
        return delay

    def _on_piece_corrupt(self, req: DownloadPieceRequest, exc) -> None:
        """md5 mismatch at store time: steer the re-fetch to a DIFFERENT
        parent (dispatcher avoid map) and blacklist a parent that keeps
        serving corrupt bytes — today's behavior was to loop on the same
        parent forever."""
        piece = req.piece
        parent = req.dst_peer_id
        logger.warning("piece %d from %s corrupt: %s", piece.num, parent, exc)
        self.recovery.tick("md5_mismatch_pieces")
        with self._written_lock:
            self._corrupt_pieces.add(piece.num)
            count = self._corrupt_counts.get(parent, 0) + 1
            self._corrupt_counts[parent] = count
            self._first_failure_at.setdefault(piece.num, time.monotonic())
        self.dispatcher.report(DownloadPieceResult(
            parent, piece.num, fail=True))
        self.dispatcher.report_corrupt(parent, piece.num)
        self._report_piece_failed(parent, piece.num)
        if (count >= self.opts.corrupt_blacklist_threshold > 0
                and parent not in self._banned_parents):
            self._banned_parents.add(parent)
            self._drop_parent_availability(parent)
            self.recovery.tick("parents_blacklisted")
            logger.warning("parent %s blacklisted for task %s after %d "
                           "corrupt pieces", parent, self.task_id[:16], count)
            dropped = self.dispatcher.ban(parent)
            with self._written_lock:
                for r in dropped:
                    self._enqueued.discard(r.piece.num)
        self._note_piece_failure(piece.num)

    def _observe_piece_recovered(self, piece_num: int) -> None:
        """A piece that previously FAILED just stored successfully:
        record the recovery latency (first failure → stored) and, when
        the failure was corruption, the successful re-fetch."""
        with self._written_lock:
            first_failure = self._first_failure_at.pop(piece_num, None)
            recovered_corrupt = piece_num in self._corrupt_pieces
            self._corrupt_pieces.discard(piece_num)
        if first_failure is not None:
            self.recovery.observe_recovery(time.monotonic() - first_failure)
        if recovered_corrupt:
            self.recovery.tick("corrupt_refetched")

    def _after_piece_stored(self, req: DownloadPieceRequest,
                            cost_ns: int) -> None:
        piece = req.piece
        with self._written_lock:
            self._written.add(piece.num)
        self._touch_progress()
        self._observe_piece_recovered(piece.num)
        self._notify_piece_sink(piece.num)
        self.shaper.record(self.task_id, piece.length)
        if self.metrics:
            self.metrics.download_traffic.labels(type="p2p").inc(piece.length)
        # The calling worker is inside its piece.fetch span: hand the
        # span identity to the report batcher so the batch span links
        # back to the member pieces it carries.
        self.reporter.report(PieceFinished(
            peer_id=self.peer_id, piece_number=piece.num,
            parent_id=req.dst_peer_id, offset=piece.offset,
            length=piece.length, digest=f"md5:{piece.md5}" if piece.md5 else "",
            cost_ns=cost_ns, traffic_type=TRAFFIC_REMOTE_PEER,
        ), trace_link=((tracing.current_trace_context() or self._trace_ctx)
                       if tracing.default_tracer().enabled else None))
        self._check_finished()

    def _notify_piece_sink(self, piece_num: int) -> None:
        if self.piece_sink is None:
            return
        try:
            piece = self.store.meta.pieces[piece_num]
            self.piece_sink(self.store, piece)
        except Exception:
            logger.exception("piece sink failed for piece %d", piece_num)

    def _offload_control(self, fn) -> None:
        """Run a blocking control-plane RPC off the calling thread when
        that thread is an engine loop (completions and async sync polls
        dispatch there); threads-engine callers are per-task workers
        and pay inline, exactly as before."""
        eng = self.engine
        if eng is not None and getattr(eng, "running", False):
            eng.offload(fn)
        else:
            fn()

    def _report_piece_failed(self, parent_id: str, piece_number: int) -> None:
        """Tell the scheduler a piece (or a whole parent, number=-1)
        failed. Retried ONCE; a report dropped after the retry is
        counted (``reports_dropped``) instead of vanishing at debug
        level, and either outcome feeds the scheduler-health window."""
        for attempt in (0, 1):
            try:
                self.scheduler.download_piece_failed(
                    self.peer_id, parent_id, piece_number)
                self._note_scheduler(True)
                return
            except Exception:
                if attempt == 0:
                    self.recovery.tick("piece_failed_report_retries")
                    continue
                self.recovery.tick("reports_dropped")
                self._note_scheduler(False)
                logger.debug("piece failed report dropped after retry",
                             exc_info=True)

    # -- completion --------------------------------------------------------

    def _learn_length(self, content_length: int, total_pieces: int) -> None:
        if content_length < 0 or self.content_length >= 0:
            return
        self.content_length = content_length
        self.piece_size = compute_piece_size(content_length)
        self.total_pieces = (
            total_pieces if total_pieces and total_pieces > 0
            else compute_piece_count(content_length, self.piece_size)
        )
        if self.store is not None:
            self.store.update(content_length=content_length,
                              total_pieces=self.total_pieces)

    def _check_finished(self) -> None:
        if self._done.is_set() or self.total_pieces < 0:
            return
        with self._written_lock:
            complete = len(self._written) >= self.total_pieces
        if not complete:
            return
        if self._b2s_mode:
            # Hybrid back-to-source: the mesh delivered the last piece
            # while origin workers were claiming. The back-to-source
            # flow owns the task-level finish (mark_done + the
            # back_to_source_finished report carrying the task shape) —
            # just stop the loops; _download_source sees _done and
            # finalizes.
            self._success = True
            self._done.set()
            return
        try:
            self.store.mark_done()
        except Exception as exc:
            self._fail(f"finalize failed: {exc}")
            return
        cost = time.monotonic() - self._started_at
        # Every buffered piece report must land before the peer flips to
        # Succeeded — the scheduler's finished_piece_count and download
        # record are built from them.
        self.reporter.flush()
        try:
            self.scheduler.download_peer_finished(self.peer_id, cost)
        except Exception:
            logger.debug("peer finished report failed", exc_info=True)
        self._success = True
        self._done.set()

    def _fail(self, error: str) -> PeerTaskResult:
        self._error = error
        self._success = False
        self._done.set()
        self.reporter.flush()  # pieces that DID finish still count
        try:
            self.scheduler.download_peer_failed(self.peer_id)
        except Exception:
            pass
        return PeerTaskResult(self.task_id, self.peer_id, False,
                              storage=self.store, error=error,
                              resumed_pieces=self._resumed_pieces,
                              resumed_bytes=self._resumed_bytes)

    def _shutdown_workers(self) -> None:
        self._done.set()
        self._sync_stop.set()
        self.dispatcher.close()
        self.channel.close()
        if self.native_fetcher is not None:
            self.native_fetcher.close()
        with self._async_lock:
            pending_ops = list(self._async_ops)
        for op in pending_ops:
            op.cancel()  # event-loop fetches still in flight
        for t in self._workers:
            t.join(timeout=2)
        for t in self._syncers.values():
            t.join(timeout=2)
        # After the workers are down: drop the keep-alive pools and make
        # the exactly-once guarantee on buffered reports (close flushes;
        # stragglers from a timed-out join deliver synchronously).
        self.downloader.close()
        self._meta_pool.close()
        self.reporter.close()

    # -- back-to-source (pullPiecesFromSource / DownloadSource) ------------

    def _run_back_to_source(self, report: bool = True) -> PeerTaskResult:
        tracer = tracing.default_tracer()
        if not tracer.enabled:
            return self._run_back_to_source_impl(report)
        with tracer.span("peer_task.back_to_source", report=report,
                         degraded=self._degraded_reason) as rec:
            result = self._run_back_to_source_impl(report)
            rec["attrs"]["success"] = result.success
            return result

    def _run_back_to_source_impl(self, report: bool = True) -> PeerTaskResult:
        # Hybrid-mode flag read by _check_finished: mesh syncers/workers
        # stay live during back-to-source, and the task-level finish
        # belongs to THIS flow.
        self._b2s_mode = True
        if self.opts.disable_back_source:
            # Report like every other terminal failure (_fail / the
            # back-to-source exception path) so the scheduler's peer FSM
            # fails over and other peers are never scheduled against a
            # parent that will produce no pieces.
            if report:
                try:
                    self.scheduler.download_peer_failed(self.peer_id)
                except Exception:
                    pass
            self._error = ("back-to-source disabled "
                           "(--disable-back-source); no mesh parents "
                           "could serve the task")
            self._done.set()
            return PeerTaskResult(self.task_id, self.peer_id, False,
                                  storage=self.store, error=self._error,
                                  resumed_pieces=self._resumed_pieces,
                                  resumed_bytes=self._resumed_bytes)
        if self.store is None:
            # Degrade paths (register failed / scheduler silent) still
            # adopt a recovered journal — resume must not depend on a
            # healthy scheduler. No replay reports here: the peer may
            # never have registered.
            self._attach_store()
        if report:
            try:
                self.scheduler.download_peer_back_to_source_started(self.peer_id)
            except Exception:
                logger.debug("back-to-source started report failed", exc_info=True)
        try:
            content_length, total = self._download_source()
        except Exception as exc:
            self.reporter.flush()  # pieces that DID land still count
            if report:
                try:
                    self.scheduler.download_peer_back_to_source_failed(self.peer_id)
                except Exception:
                    pass
            self._error = f"back-to-source failed: {exc}"
            return PeerTaskResult(self.task_id, self.peer_id, False,
                                  storage=self.store, error=self._error,
                                  resumed_pieces=self._resumed_pieces,
                                  resumed_bytes=self._resumed_bytes)
        cost = time.monotonic() - self._started_at
        # Deliver every piece before the task-level success report: the
        # scheduler promotes back-source pieces into task metadata other
        # peers sync, and report_success reads the piece set.
        self.reporter.flush()
        if report:
            try:
                self.scheduler.download_peer_back_to_source_finished(
                    self.peer_id, content_length, total, cost)
            except Exception:
                logger.debug("back-to-source finished report failed",
                             exc_info=True)
        self._success = True
        return PeerTaskResult(self.task_id, self.peer_id, True,
                              content_length=content_length, storage=self.store,
                              resumed_pieces=self._resumed_pieces,
                              resumed_bytes=self._resumed_bytes)

    def _download_source(self) -> tuple[int, int]:
        """(piece_manager.go:301 DownloadSource; known-length concurrent
        ranged path at :791-891, unknown-length stream at :535)."""
        request = source_mod.Request(self.url, dict(self.request_header))
        client = source_mod.client_for(request)
        length = client.get_content_length(request)
        ranged = length >= 0 and client.is_support_range(request)
        if self.url_range is not None:
            # The task's content is the [start, end] window of the source
            # (dfget --range): piece fetches below shift by the window
            # start; storage offsets stay task-local. Needs a
            # range-capable source by construction.
            if not ranged:
                raise RuntimeError(
                    f"--range requires a range-capable source: {self.url}")
            if self.url_range.start >= length:
                raise RangeNotSatisfiable(
                    f"range start {self.url_range.start} beyond "
                    f"content length {length}")
            length = min(self.url_range.length,
                         length - self.url_range.start)
        if not ranged:
            return self._download_source_stream(request)

        self._learn_length(length, -1)
        total = self.total_pieces
        claimer = _SourceClaimer(self, total,
                                 max(int(self.opts.coalesce_run), 1))
        if self._async_source_target() is not None:
            # Event-loop driver: SourceRunOps stream granted runs on the
            # daemon-wide engine; the caller thread (which the threaded
            # driver spent join()ing its workers) orchestrates claims
            # and retries -- zero back-source threads.
            self._drive_source_async(claimer, length)
        else:
            self._drive_source_threads(claimer, client, length)
        if claimer.errors and not self._source_complete():
            raise RuntimeError("; ".join(claimer.errors[:3]))
        self.store.mark_done()
        return length, total

    def _drive_source_threads(self, claimer: "_SourceClaimer", client,
                              length: int) -> None:
        """The historical thread-per-worker run driver — only non-HTTP
        schemes (file/s3/…) and conductors running without an engine
        land here; every http(s)/proxied/credentialed origin rides the
        event loop."""
        total = claimer.total

        def fetch_run(first: int, count: int) -> "Exception | None":
            """Span-wrapped ``fetch_run_impl``: one ``source.fetch_run``
            span per ranged GET, carrying the run shape and its claim
            attribution (a scheduler-leased disjoint run vs the local
            sequential fallback) for the critical-path analyzer."""
            tracer = tracing.default_tracer()
            if not tracer.enabled:
                return fetch_run_impl(first, count)
            with tracer.span("source.fetch_run", first=first, count=count,
                             claimed=not claimer.is_local()) as rec:
                err = fetch_run_impl(first, count)
                if err is not None:
                    rec["attrs"]["error"] = f"{type(err).__name__}: {err}"
                return err

        def fetch_run_impl(first: int, count: int) -> "Exception | None":
            """ONE ranged GET covering pieces [first, first+count), split
            into pieces as the stream arrives. Per-piece semantics are
            identical to the old one-GET-per-piece loop: incremental
            wire md5 via DigestReader → set_piece_digest, write_piece
            offsets/lengths, shaper wait/record per piece, per-piece
            finished report (batched). Returns the failure (None on
            success) — the WORKER owns the retry budget; pieces that
            landed before a mid-run failure stay stored, and a retry of
            the same run drains them as span-bounded duplicates."""
            first_rng = piece_range(first, self.piece_size, length)
            last_rng = piece_range(first + count - 1, self.piece_size, length)
            run_rng = Range(first_rng.start,
                            last_rng.start + last_rng.length - first_rng.start)
            src_rng = (Range(self.url_range.start + run_rng.start,
                             run_rng.length)
                       if self.url_range is not None else run_rng)
            num = first
            # Shape the WHOLE run before the GET is issued (the old code
            # waited before each per-piece GET): blocking between pieces
            # of one open response would leave the source connection
            # idle mid-body, and origin/proxy send-timeouts would kill
            # the run. Per-piece `record` below still feeds the sampling
            # shaper's demand estimate at piece granularity.
            self.shaper.wait_n(self.task_id, run_rng.length)
            try:
                resp = client.download(
                    source_mod.Request(self.url, dict(self.request_header),
                                       rng=src_rng))
            except Exception as exc:
                # The GET was issued even though nothing landed — the
                # request counters must not flatter failed runs.
                self.stats.source_run(0, 0)
                return exc
            completed = 0
            completed_bytes = 0
            run_exc: "Exception | None" = None
            try:
                for num in range(first, first + count):
                    rng = piece_range(num, self.piece_size, length)
                    begin = time.monotonic_ns()
                    reader = digestutil.DigestReader(resp.body, "md5")
                    # write_piece reads EXACTLY rng.length bytes from the
                    # reader, so consecutive pieces split the run stream
                    # without any intermediate buffering.
                    self.store.write_piece(
                        WritePieceRequest(
                            self.task_id, self.peer_id,
                            PieceMetadata(num=num, md5="", offset=rng.start,
                                          start=rng.start, length=rng.length),
                        ),
                        reader,
                    )
                    cost = time.monotonic_ns() - begin
                    # Record the piece md5 observed on the wire so
                    # children can verify (back-source pieces define the
                    # task's truth).
                    self.store.set_piece_digest(num, reader.hexdigest(), cost)
                    with self._written_lock:
                        self._written.add(num)
                    self._touch_progress()
                    self._observe_piece_recovered(num)
                    self._notify_piece_sink(num)
                    self.shaper.record(self.task_id, rng.length)
                    if self.metrics:
                        self.metrics.download_traffic.labels(
                            type="back_to_source").inc(rng.length)
                    self.reporter.report(PieceFinished(
                        peer_id=self.peer_id, piece_number=num, parent_id="",
                        offset=rng.start, length=rng.length,
                        digest=f"md5:{reader.hexdigest()}", cost_ns=cost,
                        traffic_type=TRAFFIC_BACK_TO_SOURCE,
                    ))
                    completed += 1
                    completed_bytes += rng.length
            except Exception as exc:
                run_exc = exc
            finally:
                resp.close()
                # Counters record what actually LANDED: a run that died
                # mid-body must not claim its unwritten tail as saved
                # requests (the acceptance contract is counter-verified).
                self.stats.source_run(completed, completed_bytes)
            return run_exc

        def fetch_claimed(first: int, count: int) -> bool:
            """Fetch one claimed run with the source_retry_limit budget
            + full jitter (transient blips retry; disk-full is terminal
            immediately; an exhausted budget aborts remaining claims so
            a DEAD source still fails in ~retry_limit runs per worker).
            Returns False when the worker must stop."""
            attempts = 0
            while not claimer.abort.is_set():
                err = fetch_run(first, count)
                if err is None:
                    return True
                attempts += 1
                # Pieces still missing from the failed run opened
                # their recovery window now (closed when the retry
                # stores them — the recovery-latency ring).
                now = time.monotonic()
                with self._written_lock:
                    for num in range(first, first + count):
                        if not self.store.has_piece(num):
                            self._first_failure_at.setdefault(num, now)
                # Retry the SAME run (the claim cursor has moved on):
                # pieces that landed before the failure are drained
                # as duplicates by write_piece's span-bounded dedup.
                if isinstance(err, DiskFullError):
                    self.recovery.tick("enospc_fail_fast")
                    attempts = None  # terminal — no retry can help
                if (attempts is None
                        or attempts > self.opts.source_retry_limit):
                    claimer.note_error(
                        f"pieces {first}-{first + count - 1}: {err}")
                    return False
                self.recovery.tick("source_run_retries")
                logger.debug("source run %d-%d failed (attempt %d): %s",
                             first, first + count - 1, attempts, err)
                self._done.wait(full_jitter(
                    attempts - 1, self.opts.backoff_base,
                    self.opts.backoff_cap, self._rng))
            return True

        deadline = self._started_at + self.opts.timeout

        def worker() -> None:
            """Claims runs until the file is locally complete. A "wait"
            verdict means other claimants hold the remaining leases and
            the mesh is delivering them — poll again after a beat; a
            mesh that stalls past source_fallback_wait degrades the
            whole task ONE WAY to local sequential claims (origin
            completes the file regardless of swarm health)."""
            tracing.adopt_trace_context(self._trace_ctx)
            while not self._done.is_set():
                claimed = claimer.claim()
                if claimed is None:
                    return
                kind = claimed[0]
                if kind == "retry":
                    continue  # mode flipped; re-claim immediately
                if kind == "wait":
                    if self._source_complete() or claimer.abort.is_set():
                        return
                    with self._sched_lock:
                        last_progress = self._last_progress_at
                    now = time.monotonic()
                    stalled = (now - last_progress
                               > self.opts.source_fallback_wait)
                    if stalled and claimer.fallback_to_local():
                        self.recovery.tick("source_mesh_stall_fallbacks")
                        logger.warning(
                            "task %s: mesh stalled %.1fs; claiming "
                            "remaining pieces from origin",
                            self.task_id[:16],
                            now - last_progress)
                        continue
                    if now > deadline:
                        claimer.note_error(
                            "timed out waiting for leased pieces "
                            "from the mesh")
                        return
                    self._done.wait(self.opts.claim_wait_interval)
                    continue
                first, count = claimed[1], claimed[2]
                subruns = claimer.clip(first, count)
                claimer.hold(first, count)
                try:
                    for sub_first, sub_n in subruns:
                        if not fetch_claimed(sub_first, sub_n):
                            return
                finally:
                    claimer.release(first, count)

        threads = [
            threading.Thread(target=worker, daemon=True,
                             name=f"back-source-{i}")
            for i in range(min(self.opts.back_source_concurrency, total) or 1)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    # -- event-loop back-to-source driver ----------------------------------

    def _async_source_target(self) -> "dict | None":
        """Engine-speakable origin descriptor — addr/path/Host plus the
        TLS context, CONNECT tunnel and auth headers the SourceRunOp
        needs — or None when the conductor must use the threaded driver
        (no running engine, or a non-http(s) scheme: file/s3/…). Plain,
        https, proxied and credentialed origins all ride the event loop
        now; there is no per-task source thread left for HTTP."""
        if self.engine is None or not getattr(self.engine, "running", False):
            return None
        import base64
        import urllib.parse

        parsed = urllib.parse.urlsplit(self.url)
        if parsed.scheme not in ("http", "https") or not parsed.hostname:
            return None
        host = parsed.hostname
        port = parsed.port or (443 if parsed.scheme == "https" else 80)
        path = parsed.path or "/"
        if parsed.query:
            path += "?" + parsed.query
        headers: "dict[str, str]" = {}
        if parsed.username:
            # Userinfo rides as Basic auth; the dial target is the bare
            # hostname (the legacy urllib path tried to resolve the
            # userinfo-laden netloc and failed).
            userinfo = urllib.parse.unquote(parsed.username)
            if parsed.password is not None:
                userinfo += ":" + urllib.parse.unquote(parsed.password)
            headers["Authorization"] = "Basic " + base64.b64encode(
                userinfo.encode("latin-1")).decode("ascii")
        from dragonfly2_tpu_torch.client.source import HTTPSourceClient

        try:
            proxy = HTTPSourceClient._proxy_for(self.url)
        except Exception:  # noqa: BLE001 — resolver hiccups → direct
            proxy = None
        addr = f"{host}:{port}"
        host_header = parsed.netloc.rpartition("@")[2]
        tunnel = tunnel_auth = None
        if proxy is not None:
            mode, phost, pport, pauth = proxy
            if mode == "tunnel":
                # https via proxy: CONNECT through the proxy, then TLS
                # to the origin on the same socket.
                tunnel, tunnel_auth = (phost, pport), pauth
            else:
                # plain http via proxy: absolute-URI request AT the
                # proxy, exactly what the legacy urllib transport sent.
                addr = f"{phost}:{pport}"
                netloc = host if port == 80 else f"{host}:{port}"
                path = f"http://{netloc}{path}"
                if pauth:
                    headers["Proxy-Authorization"] = pauth
        tls = (self.engine.source_tls()
               if parsed.scheme == "https" else None)
        return {"addr": addr, "path": path, "host_header": host_header,
                "tls": tls, "server_hostname": host, "tunnel": tunnel,
                "tunnel_auth": tunnel_auth, "headers": headers}

    def _drive_source_async(self, claimer: "_SourceClaimer",
                            length: int) -> None:
        """Claim orchestration for the event-loop driver. Runs on the
        CALLER thread (the one the threaded driver spent join()ing its
        workers): claims runs, keeps ≤ back_source_concurrency
        SourceRunOps streaming on the engine, applies the per-run retry
        budget with jittered backoff, the mesh-stall fallback and the
        lease-wait deadline — claim semantics are the shared
        :class:`_SourceClaimer`, so nothing diverges from the threaded
        driver."""
        from dragonfly2_tpu_torch.client.storage import DiskFullError

        total = claimer.total
        concurrency = min(self.opts.back_source_concurrency, total) or 1
        deadline = self._started_at + self.opts.timeout
        results: "queue.Queue" = queue.Queue()
        active = 0
        # Retry backlog: [ready_at, first, count, attempts] units; a
        # unit's pieces stay HELD in the claimer through its whole retry
        # ladder (the threaded contract).
        pending: List[list] = []

        def submit_unit(unit: list) -> bool:
            """Clip (pieces may have landed via the mesh since) and
            submit one ranged-run op; False when nothing is left to
            fetch (unit complete — hold released)."""
            try:
                submitted = self._submit_source_run_op(
                    claimer, unit, length, results)
            except RuntimeError:  # engine stopped (daemon shutdown)
                claimer.release(unit[1], unit[2])
                claimer.note_error("download engine stopped")
                return False
            if not submitted:
                claimer.release(unit[1], unit[2])
            return submitted

        while not claimer.abort.is_set() and not self._done.is_set():
            now = time.monotonic()
            for unit in [u for u in pending if u[0] <= now]:
                if active >= concurrency:
                    break
                pending.remove(unit)
                if submit_unit(unit):
                    active += 1
            want_wait = False
            while active < concurrency and not claimer.abort.is_set():
                verdict = claimer.claim()
                if verdict is None:
                    break
                if verdict[0] == "retry":
                    continue  # mode flipped; re-claim immediately
                if verdict[0] == "wait":
                    want_wait = True
                    break
                first, count = verdict[1], verdict[2]
                for sub_first, sub_n in claimer.clip(first, count):
                    claimer.hold(sub_first, sub_n)
                    unit = [0.0, sub_first, sub_n, 0]
                    if active < concurrency:
                        if submit_unit(unit):
                            active += 1
                    else:
                        pending.append(unit)
            if active == 0 and not pending:
                if not want_wait:
                    return  # claims exhausted; file locally complete
                # Mesh-wait: other claimants hold the remaining leases
                # and the mesh is delivering them — poll again after a
                # beat; a mesh that stalls past source_fallback_wait
                # degrades ONE WAY to local claims.
                if self._source_complete():
                    return
                with self._sched_lock:
                    last_progress = self._last_progress_at
                now = time.monotonic()
                if (now - last_progress > self.opts.source_fallback_wait
                        and claimer.fallback_to_local()):
                    self.recovery.tick("source_mesh_stall_fallbacks")
                    logger.warning(
                        "task %s: mesh stalled %.1fs; claiming remaining "
                        "pieces from origin", self.task_id[:16],
                        now - last_progress)
                    continue
                if now > deadline:
                    claimer.note_error("timed out waiting for leased "
                                       "pieces from the mesh")
                    return
                self._done.wait(self.opts.claim_wait_interval)
                continue
            # Drain one completion (bounded wait keeps pending retries
            # and the mesh-stall checks live).
            try:
                unit, err = results.get(timeout=0.25)
            except queue.Empty:
                continue
            active -= 1
            first, count, attempts = unit[1], unit[2], unit[3]
            if err is None or self._done.is_set():
                claimer.release(first, count)
                continue
            attempts += 1
            # Pieces still missing from the failed run opened their
            # recovery window now (closed when the retry stores them —
            # the recovery-latency ring).
            now = time.monotonic()
            with self._written_lock:
                for num in range(first, first + count):
                    if not self.store.has_piece(num):
                        self._first_failure_at.setdefault(num, now)
            if isinstance(err, DiskFullError):
                self.recovery.tick("enospc_fail_fast")
                claimer.release(first, count)
                claimer.note_error(
                    f"pieces {first}-{first + count - 1}: {err}")
                return
            if attempts > self.opts.source_retry_limit:
                claimer.release(first, count)
                claimer.note_error(
                    f"pieces {first}-{first + count - 1}: {err}")
                return
            self.recovery.tick("source_run_retries")
            logger.debug("source run %d-%d failed (attempt %d): %s",
                         first, first + count - 1, attempts, err)
            unit[0] = time.monotonic() + full_jitter(
                attempts - 1, self.opts.backoff_base,
                self.opts.backoff_cap, self._rng)
            unit[3] = attempts
            pending.append(unit)

    def _submit_source_run_op(self, claimer: "_SourceClaimer", unit: list,
                              length: int, results: "queue.Queue") -> bool:
        """Build + submit one :class:`SourceRunOp` for a unit's still-
        missing pieces. False = everything already landed (no op)."""
        from dragonfly2_tpu_torch.client.download_async import (
            RunPiece,
            SourceRunOp,
        )

        first, count = unit[1], unit[2]
        pieces: List[RunPiece] = []
        for num in range(first, first + count):
            rng = piece_range(num, self.piece_size, length)
            pieces.append(RunPiece(num, rng.start, rng.length,
                                   skip=self.store.has_piece(num)))
        # Trim landed edges so the ranged GET pays origin bytes only
        # for the span that still contains missing pieces; interior
        # skips (a rare mid-retry mesh race) are consumed and dropped.
        while pieces and pieces[0].skip:
            pieces.pop(0)
        while pieces and pieces[-1].skip:
            pieces.pop()
        if not pieces:
            return False
        target = self._async_source_target()
        addr, path = target["addr"], target["path"]
        host_header = target["host_header"]
        run_start = pieces[0].offset
        run_len = pieces[-1].offset + pieces[-1].length - run_start
        src_rng = (Range(self.url_range.start + run_start, run_len)
                   if self.url_range is not None
                   else Range(run_start, run_len))
        begin_wall = time.time()
        claimed = not claimer.is_local()

        def on_done(completed: int, completed_bytes: int, err) -> None:
            # Counters record what actually LANDED — a run that died
            # mid-body must not claim its unwritten tail, and a GET that
            # never produced a head still counts the request.
            self.stats.source_run(completed, completed_bytes)
            tracer = tracing.default_tracer()
            if tracer.enabled:
                attrs = dict(first=first, count=count, claimed=claimed)
                if err is not None:
                    attrs["error"] = f"{type(err).__name__}: {err}"
                tracer.emit("source.fetch_run", start=begin_wall,
                            duration_s=max(time.time() - begin_wall, 0.0),
                            parent=self._trace_ctx, **attrs)
            with self._async_lock:
                self._async_ops.discard(op)
            results.put((unit, err))

        extra = dict(self.request_header)
        extra.update(target["headers"])
        op = SourceRunOp(
            self.task_id, addr, path, host_header=host_header,
            src_range_header=src_rng.http_header(), url=self.url,
            pieces=pieces, open_fd=self.store.data_write_fd,
            reserve=lambda n: self.shaper.reserve_n(self.task_id, n),
            refund=lambda n: self.shaper.return_n(self.task_id, n),
            piece_cb=self._on_source_piece, done_cb=on_done,
            extra_headers=extra, stats=self.stats,
            tls=target["tls"], server_hostname=target["server_hostname"],
            tunnel=target["tunnel"], tunnel_auth=target["tunnel_auth"],
        )
        if self.traffic_class:
            # Class the engine's admission/dispatch; no header to origin.
            op.qos_class = self.traffic_class
        with self._async_lock:
            self._async_ops.add(op)
        self.engine.submit(op)
        return True

    def _on_source_piece(self, run_piece, md5_hex: str,
                         cost_ns: int) -> None:
        """One origin piece landed on the loop thread (bytes already
        pwritten at the piece offset): record + report with the SAME
        per-piece semantics as the threaded run fetcher (wire md5 as the
        task's truth, journal cadence via record_piece, shaper demand
        sample, batched finished report)."""
        num, offset, nbytes = run_piece.num, run_piece.offset, \
            run_piece.length
        self.store.record_piece(
            PieceMetadata(num=num, md5="", offset=offset, start=offset,
                          length=nbytes),
            nbytes, md5_hex, cost_ns)
        with self._written_lock:
            self._written.add(num)
        self._touch_progress()
        self._observe_piece_recovered(num)
        self._notify_piece_sink(num)
        self.shaper.record(self.task_id, nbytes)
        if self.metrics:
            self.metrics.download_traffic.labels(
                type="back_to_source").inc(nbytes)
        self.reporter.report(PieceFinished(
            peer_id=self.peer_id, piece_number=num, parent_id="",
            offset=offset, length=nbytes, digest=f"md5:{md5_hex}",
            cost_ns=cost_ns, traffic_type=TRAFFIC_BACK_TO_SOURCE,
        ))

    def _source_complete(self) -> bool:
        """Every piece of the (known-shape) task is on disk — origin
        claims AND mesh deliveries both count."""
        store = self.store
        total = self.total_pieces
        return (store is not None and total > 0
                and len(store.meta.pieces) >= total)

    def _download_source_stream(self, request: source_mod.Request) -> tuple[int, int]:
        """Unknown length / no range support: single sequential stream cut
        into pieces as it arrives (piece_manager.go:535)."""
        resp = source_mod.download(request)
        num = 0
        offset = 0
        piece_size = self.piece_size
        while True:
            data = resp.body.read(piece_size)
            if not data:
                break
            # Shaper parity with the ranged path: the stream length is
            # unknown up front, so the wait debits the bytes actually
            # read for this piece (the token bucket enforces the same
            # aggregate rate either way), and record feeds the sampling
            # shaper's demand estimate.
            self.shaper.wait_n(self.task_id, len(data))
            md5 = digestutil.hash_bytes(data, "md5")
            self.store.write_piece(
                WritePieceRequest(
                    self.task_id, self.peer_id,
                    PieceMetadata(num=num, md5=md5, offset=offset,
                                  start=offset, length=len(data)),
                ),
                io.BytesIO(data),
            )
            self.shaper.record(self.task_id, len(data))
            if self.metrics:
                self.metrics.download_traffic.labels(
                    type="back_to_source").inc(len(data))
            self.reporter.report(PieceFinished(
                peer_id=self.peer_id, piece_number=num, parent_id="",
                offset=offset, length=len(data), digest=f"md5:{md5}",
                traffic_type=TRAFFIC_BACK_TO_SOURCE,
            ))
            self._notify_piece_sink(num)
            offset += len(data)
            num += 1
        resp.close()
        self.store.update(content_length=offset, total_pieces=num)
        self.content_length = offset
        self.total_pieces = num
        self.store.mark_done()
        return offset, num
