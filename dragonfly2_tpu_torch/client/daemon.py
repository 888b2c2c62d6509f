"""Daemon assembly — storage + upload server + peer engine + seed role.

Reference counterpart: client/daemon/daemon.go:76-364 (New/Serve wiring) and
peertask_manager.go (task frontends + reuse fast path), plus the seeder
surface (client/daemon/rpcserver/seeder.go:41-332 ObtainSeeds) through which
the scheduler triggers seed-peer back-source downloads.
"""

from __future__ import annotations

import hashlib
import io
import logging
import os
import threading
import time
import uuid
from dataclasses import dataclass, field
from dataclasses import replace as dataclasses_replace
from typing import Dict, Optional

from dragonfly2_tpu_torch.client.peer_task import (
    PeerTaskConductor,
    PeerTaskOptions,
    PeerTaskResult,
    SchedulerAPI,
)
from dragonfly2_tpu_torch.client.piece import parse_url_range
from dragonfly2_tpu_torch.client.storage import StorageManager, StorageOptions
from dragonfly2_tpu_torch.client.traffic_shaper import (
    TrafficShaper,
    new_traffic_shaper,
)
from dragonfly2_tpu_torch.client.upload import UploadServer
from dragonfly2_tpu_torch.scheduler.resource.host import Host
from dragonfly2_tpu_torch.utils import idgen
from dragonfly2_tpu_torch.utils.hosttypes import HostType
from dragonfly2_tpu_torch.utils.ratelimit import INF

logger = logging.getLogger(__name__)


@dataclass
class DaemonConfig:
    """(client/config/peerhost.go:47-77, trimmed to wired options)"""

    storage_root: str = ""
    ip: str = "127.0.0.1"
    hostname: str = "localhost"
    host_type: HostType = HostType.NORMAL
    idc: str = ""
    location: str = ""
    # Geo cluster identity (docs/GEO.md): "" = cluster-blind (the
    # default keeps single-site fleets byte-identical); set, it rides
    # announce/register onto Host/Peer so the scheduler can steer
    # intra-cluster and elect WAN bridges.
    cluster_id: str = ""
    upload_rate_bps: float = INF
    total_download_rate_bps: float = INF
    traffic_shaper_type: str = "plain"
    task_options: PeerTaskOptions = field(default_factory=PeerTaskOptions)
    keep_storage: bool = True
    # Crash-safe download state (ISSUE 8): incremental-journal cadence
    # on the piece write path (see StorageOptions — amortized fsync, a
    # SIGKILL loses at most one window of progress), md5-verification of
    # journaled pieces at reload, and whether start() re-announces
    # completed replicas to the scheduler so a restarted daemon resumes
    # serving as a parent instead of going dark.
    persist_every_pieces: int = 16
    persist_interval_s: float = 2.0
    reload_verify: bool = True
    reseed_on_start: bool = True
    # Probe ticker (client/daemon/networktopology): 0 disables. Each tick
    # asks the scheduler for candidates, TCP-pings them, reports RTTs.
    probe_interval: float = 0.0
    probe_timeout: float = 1.0
    # Re-announce ticker (announcer.go AnnounceHost loop): refreshes the
    # host telemetry snapshot at the scheduler. 0 = announce once only.
    announce_interval: float = 0.0
    # RecoveryStats scope for this daemon's conductors (None = the
    # process-wide /debug/vars "recovery" block); the chaos bench
    # injects a per-rung instance.
    recovery_stats: object = None
    # Upload serving engine (client/upload_async): listen(2) backlog,
    # admission cap on concurrently open peer connections (0 =
    # unlimited; beyond it, arrivals get a best-effort 503), and the
    # fixed event-loop worker count (0 = engine default). Thread cost is
    # upload_workers + 1 regardless of connection count.
    upload_serve_backlog: int = 128
    upload_max_connections: int = 0
    upload_workers: int = 0
    # DataPlaneStats scope for the serving engine (None = the
    # process-wide /debug/vars "data_plane" block); benches inject a
    # per-run instance.
    dataplane_stats: object = None
    # Download engine (client/download_async): "async" runs metadata
    # syncs, piece fetches and coalesced source runs as nonblocking
    # state machines on a fixed daemon-wide pool of dl_workers event
    # loops — download threads become a CONSTANT independent of
    # concurrent task count; "threads" pins the historical
    # thread-per-worker engine (syncer + piece-worker + back-source
    # threads per task).
    download_engine: str = "async"
    dl_workers: int = 0  # 0 = engine default (DEFAULT_DL_WORKERS)
    # Daemon-wide cap on concurrently streaming body ops (piece fetches
    # + source runs); past it, streams queue FIFO in the engine. 0 =
    # engine default (DEFAULT_DL_MAX_STREAMS).
    dl_max_streams: int = 0
    # Data-plane TLS (utils/tlsconf): cert+key turn on TLS serving on
    # the upload engine (kTLS-probed per connection; without offload the
    # server falls down the ladder to mmap writes through the record
    # layer). peer_tls_ca pins the CA the download engine verifies TLS
    # parents against (fetches/syncs dial TLS only when set);
    # source_tls_ca pins https origins (default: system trust).
    upload_tls_cert: str = ""
    upload_tls_key: str = ""
    peer_tls_ca: str = ""
    source_tls_ca: str = ""
    # Multi-tenant QoS (client/qos.py, docs/QOS.md). qos_class_weights
    # ("interactive=8,bulk=3,background=1") turns the policy ON: every
    # admission gate (upload stream gate, download engine, shaper) goes
    # class-aware weighted-fair. Empty = class-blind daemon, zero
    # overhead on every gate (the faultplan ACTIVE-is-None discipline).
    qos_class_weights: str = ""
    # Per-class admission floors ("interactive=2"): slots bulk backlog
    # can never occupy. sum(floors) < the gate capacity is the
    # operator's contract.
    qos_class_floors: str = ""
    # Class unlabeled / unknown-labeled work lands on ("" = bulk).
    qos_default_class: str = ""
    # Per-class park-queue bound on the upload stream gate (overflow →
    # 503 shed so a flooding tenant backs off).
    qos_shed_limit: int = 512
    # Upload stream gate capacity: concurrently SERVING piece bodies
    # (0 = default 64 when a policy is on; gate off when class-blind).
    upload_max_streams: int = 0
    # Per-class slow-SLO overrides for the tail sampler
    # ("interactive=2,bulk=30", seconds). Applies on top of trace_slo.
    qos_class_slos: str = ""


class Daemon:
    """One dfdaemon instance (in-process)."""

    def __init__(self, scheduler: SchedulerAPI, config: DaemonConfig):
        if not config.storage_root:
            raise ValueError("storage_root required")
        from dragonfly2_tpu_torch import __version__
        from dragonfly2_tpu_torch.client.metrics import DaemonMetrics

        self.scheduler = scheduler
        self.config = config
        self.metrics = DaemonMetrics(version=__version__)
        self.storage = StorageManager(StorageOptions(
            root=config.storage_root, keep_storage=config.keep_storage,
            persist_every_pieces=config.persist_every_pieces,
            persist_interval_s=config.persist_interval_s,
            reload_verify=config.reload_verify,
        ), recovery=config.recovery_stats)
        # A task whose LAST local replica was deleted (explicit delete
        # or storage GC) must stop being announced as a seed: drop the
        # balanced client's re-routable record (a membership change
        # would otherwise re-announce the dark seed at a new owner) and
        # the restart re-announce backlog entry.
        self.storage.on_task_deleted = self._on_local_replica_deleted
        upload_ssl = None
        peer_tls = source_tls = None
        if config.upload_tls_cert and config.upload_tls_key:
            from dragonfly2_tpu_torch.utils import tlsconf

            upload_ssl = tlsconf.server_context(
                config.upload_tls_cert, config.upload_tls_key)
        if config.peer_tls_ca:
            from dragonfly2_tpu_torch.utils import tlsconf

            peer_tls = tlsconf.client_context(cafile=config.peer_tls_ca)
        if config.source_tls_ca:
            from dragonfly2_tpu_torch.utils import tlsconf

            source_tls = tlsconf.client_context(cafile=config.source_tls_ca)
        from dragonfly2_tpu_torch.client.qos import QosPolicy

        self.qos_policy = QosPolicy.from_specs(
            weights=config.qos_class_weights,
            floors=config.qos_class_floors,
            default_class=config.qos_default_class,
            shed_limit=config.qos_shed_limit,
        )
        if config.qos_class_slos:
            # Class-tagged slow SLOs: teach the process tail sampler
            # that an interactive task is "slow" long before the
            # fleet-wide bound (utils/tracing.TailSampler.slo_for).
            from dragonfly2_tpu_torch.client.qos import parse_class_map
            from dragonfly2_tpu_torch.utils import tracing as _tracing

            sampler = getattr(_tracing.default_tracer(), "sampler", None)
            if sampler is not None:
                sampler.class_slos.update(parse_class_map(
                    config.qos_class_slos, what="qos class SLO"))
        self.upload = UploadServer(
            self.storage, host=config.ip, rate_limit_bps=config.upload_rate_bps,
            metrics=self.metrics,
            backlog=config.upload_serve_backlog,
            max_connections=config.upload_max_connections,
            max_streams=config.upload_max_streams,
            qos_policy=self.qos_policy,
            workers=config.upload_workers,
            ssl_context=upload_ssl,
            stats=config.dataplane_stats,
        )
        self.shaper: TrafficShaper = new_traffic_shaper(
            config.traffic_shaper_type, config.total_download_rate_bps,
            class_weights=(self.qos_policy.weights
                           if self.qos_policy is not None else None),
        )
        if config.download_engine == "async":
            from dragonfly2_tpu_torch.client.download_async import (
                DownloadLoopEngine,
            )

            self.dl_engine = DownloadLoopEngine(
                workers=config.dl_workers, stats=config.dataplane_stats,
                max_streams=config.dl_max_streams,
                qos_policy=self.qos_policy,
                peer_tls_context=peer_tls, source_tls_context=source_tls)
        else:
            self.dl_engine = None
        self.host_id = idgen.host_id_v1(config.hostname, self.upload.port)
        self.prober = None
        # Constructed eagerly: its per-task in-flight dedup only works as
        # a singleton, and a lazy check-then-set would race concurrent
        # first triggers.
        self._seed_client = SeedPeerDaemonClient(self)
        self._started = False
        self._conductors_lock = threading.Lock()
        self._conductors: Dict[str, PeerTaskConductor] = {}

    def _on_local_replica_deleted(self, task_id: str) -> None:
        backlog = getattr(self, "_reseed_backlog", None)
        if backlog:
            backlog.pop(task_id, None)
        forget = getattr(self.scheduler, "forget_announced_task", None)
        if forget is not None:
            forget(task_id)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._started:
            return
        self.upload.start()
        if self.dl_engine is not None:
            self.dl_engine.start()
        self.shaper.start()
        # host_id depends on the bound port only when port=0 was requested;
        # recompute now that the listener exists.
        self.host_id = idgen.host_id_v1(self.config.hostname, self.upload.port)
        self.announce()
        if self.config.reseed_on_start:
            # Snapshot the reloaded done inventory ONCE: drained here,
            # and re-drained by the announce ticker if schedulers were
            # unreachable mid-drain (runtime-completed tasks never
            # enter — their conductors already reported finished).
            self._reseed_backlog = {
                s.meta.task_id: s for s in self.storage.done_tasks()}
            self._reannounce_done_tasks()
        if self.config.probe_interval > 0:
            self.prober = self._build_prober()
            self.prober.serve()
        if self.config.announce_interval > 0:
            self._announce_stop = threading.Event()
            self._announce_thread = threading.Thread(
                target=self._announce_loop, name="announce-host", daemon=True)
            self._announce_thread.start()
        self._started = True

    def _announce_loop(self) -> None:
        while not self._announce_stop.wait(self.config.announce_interval):
            try:
                self.announce()
                # Task re-announces deferred by an unreachable fleet at
                # start() retry on the same ticker — completed replicas
                # must not stay dark for the daemon's lifetime.
                self._reannounce_done_tasks()
            except Exception:  # noqa: BLE001 — announcing must not die
                logger.exception("host re-announce failed")

    def _build_prober(self):
        """Probe loop against whichever scheduler flavor we hold: the
        in-process service (direct calls) or a remote one (SyncProbes
        stream via the client's probe_sync hook)."""
        from dragonfly2_tpu_torch.client.networktopology import (
            InProcessProbeSync,
            ProbeConfig,
            Prober,
        )

        if hasattr(self.scheduler, "probe_sync"):
            sync = self.scheduler.probe_sync(self.host_id)
        else:
            sync = InProcessProbeSync(self.scheduler)
        return Prober(self.host_id, sync, ProbeConfig(
            interval=self.config.probe_interval,
            probe_timeout=self.config.probe_timeout,
        ), metrics=self.metrics)

    def stop(self) -> None:
        if getattr(self, "_announce_thread", None) is not None:
            self._announce_stop.set()
            self._announce_thread.join(timeout=5)
            self._announce_thread = None
        if self.prober is not None:
            self.prober.stop()
        self.shaper.stop()
        if self.dl_engine is not None:
            self.dl_engine.stop()
        self.upload.stop()
        self.storage.persist_all()
        # Clean-shutdown sentinel: the next start on this root skips
        # the crash-path resident-byte verify (storage._reload).
        self.storage.mark_clean_shutdown()
        self._started = False

    def announce(self) -> None:
        """AnnounceHost (client/daemon/announcer/announcer.go:45-158)."""
        host = self.build_host()
        self.scheduler.announce_host(host)

    def _reannounce_done_tasks(self) -> None:
        """Drain the restart re-announce backlog (AnnounceTask
        semantics): a SIGKILLed-and-restarted seed must resume serving
        as a parent, not go dark until someone re-downloads through
        it. Per-task best effort — a scheduler that predates
        announce_task (or is briefly unreachable) costs a warning,
        never a failed start; tasks deferred by an unreachable fleet
        stay in the backlog and the announce ticker retries them."""
        backlog = getattr(self, "_reseed_backlog", None)
        if not backlog:
            return
        announce = getattr(self.scheduler, "announce_task", None)
        if announce is None:
            return
        from dragonfly2_tpu_torch.client.recovery import RECOVERY
        from dragonfly2_tpu_torch.scheduler.service import AnnounceTaskRequest

        recovery = self.config.recovery_stats or RECOVERY
        for task_id, store in list(backlog.items()):
            meta = store.meta
            if (meta.content_length < 0 or meta.total_pieces <= 0
                    or not store.valid):
                backlog.pop(task_id, None)  # nothing to offer
                continue
            try:
                announce(AnnounceTaskRequest(
                    host_id=self.host_id, task_id=meta.task_id,
                    peer_id=meta.peer_id, url=meta.url,
                    content_length=meta.content_length,
                    total_piece_count=meta.total_pieces,
                    piece_md5_sign=meta.piece_md5_sign,
                ))
            except Exception as exc:  # noqa: BLE001 — best effort per task
                logger.warning("re-announce of task %s failed: %s",
                               meta.task_id[:16], exc)
                if self._scheduler_unreachable(exc):
                    # The walk exhausted every target: later tasks
                    # would pay the same full ring of dial timeouts.
                    # One bounded stall; the ticker retries the rest.
                    logger.warning("schedulers unreachable; deferring "
                                   "%d remaining re-announce(s)",
                                   len(backlog))
                    return
                backlog.pop(task_id, None)  # rejected — retry won't help
                continue
            backlog.pop(task_id, None)
            recovery.tick("seed_tasks_reannounced")

    @staticmethod
    def _scheduler_unreachable(exc: Exception) -> bool:
        """Transport-shaped announce failure (every target down) vs a
        per-task rejection (which must not stop the other replicas)."""
        from dragonfly2_tpu_torch.scheduler.service import ServiceError

        if isinstance(exc, ServiceError):
            return exc.code in ("Unavailable", "DeadlineExceeded")
        return isinstance(exc, (ConnectionError, OSError))

    def build_host(self) -> Host:
        """Identity + live psutil telemetry (announcer.go:45-158), so the
        scheduler's dataset export carries real machine features."""
        from dragonfly2_tpu_torch.client import telemetry

        return Host(
            id=self.host_id,
            hostname=self.config.hostname,
            ip=self.config.ip,
            port=self.upload.port,
            download_port=self.upload.port,
            type=self.config.host_type,
            cluster_id=self.config.cluster_id,
            cpu=telemetry.collect_cpu(),
            memory=telemetry.collect_memory(),
            disk=telemetry.collect_disk(self.config.storage_root),
            network=telemetry.collect_network(
                idc=self.config.idc, location=self.config.location,
                upload_port=self.upload.port,
            ),
            build=telemetry.collect_build(),
            **telemetry.platform_info(),
        )

    # -- task frontends (peertask_manager.go StartFileTask) ----------------

    def download_file(self, url: str, *, output_path: str | None = None,
                      request_header: Dict[str, str] | None = None,
                      tag: str = "", application: str = "",
                      filtered_query_params=None,
                      piece_sink=None, url_range: str = "",
                      priority: int = 0,
                      disable_back_source: bool = False,
                      traffic_class: str = "",
                      tenant: str = "") -> PeerTaskResult:
        # dfget --range a-b (cmd/dfget/cmd/root.go:195): the ranged
        # window is its own task — the range participates in the task id
        # (idgen task_id.go range append), so distinct ranges never share
        # piece stores with each other or with the whole file. The id
        # hashes the CANONICAL form, so '2-9', '02-9' and '2 - 9' are one
        # task (and match what the conductor registers with the scheduler).
        rng = parse_url_range(url_range) if url_range else None
        task_id = idgen.task_id_v1(
            url, tag=tag, application=application,
            url_range=f"{rng.start}-{rng.end}" if rng else "",
            filters="&".join(filtered_query_params or []),
        )
        # Reuse fast path (peertask_reuse.go; FindCompletedTask
        # storage_manager.go:101-106).
        done = self.storage.find_completed_task(task_id)
        if done is not None:
            logger.info("task %s reused from storage", task_id[:16])
            self.metrics.download_traffic.labels(type="reuse").inc(
                max(done.meta.content_length, 0))
            result = PeerTaskResult(
                task_id, done.meta.peer_id, True,
                content_length=done.meta.content_length, storage=done,
                reused=True,
            )
            if output_path:
                result.save_to(output_path)
            return result

        peer_id = (
            idgen.seed_peer_id_v1(self.config.ip)
            if self.config.host_type.is_seed
            else idgen.peer_id_v1(self.config.ip)
        ) + "-" + uuid.uuid4().hex[:8]
        if self.qos_policy is not None:
            traffic_class = self.qos_policy.normalize(traffic_class)
        self.shaper.add_task(task_id, traffic_class=traffic_class)
        self.metrics.download_task_count.inc()
        self.metrics.concurrent_tasks.inc()
        options = self.config.task_options
        if disable_back_source:
            options = dataclasses_replace(options, disable_back_source=True)
        try:
            conductor = PeerTaskConductor(
                self.scheduler, self.storage,
                host_id=self.host_id, task_id=task_id, peer_id=peer_id,
                url=url, request_header=request_header, shaper=self.shaper,
                options=options,
                is_seed=self.config.host_type.is_seed,
                piece_sink=piece_sink,
                metrics=self.metrics,
                url_range=rng,
                priority=priority,
                recovery_stats=self.config.recovery_stats,
                dataplane_stats=self.config.dataplane_stats,
                engine=self.dl_engine,
                traffic_class=traffic_class,
                tenant=tenant,
            )
            with self._conductors_lock:
                self._conductors[peer_id] = conductor
            try:
                result = conductor.run()
            except Exception:
                self.metrics.download_task_failure.inc()
                raise
            if not result.success:
                self.metrics.download_task_failure.inc()
        finally:
            self.metrics.concurrent_tasks.dec()
            self.shaper.remove_task(task_id)
            with self._conductors_lock:
                self._conductors.pop(peer_id, None)
        if result.success and output_path:
            result.save_to(output_path)
        return result

    # -- cache surface (client/dfcache/dfcache.go Stat/Import/Export/Delete)

    @staticmethod
    def cache_task_id(cid: str, tag: str = "") -> str:
        """Cache-key → task id (dfcache uses idgen.TaskIDV1 over the cid)."""
        return idgen.task_id_v1(cid, tag=tag)

    def stat_cache(self, cid: str, tag: str = "") -> Optional[dict]:
        """None when absent (dfcache stat semantics: local completed only)."""
        store = self.storage.find_completed_task(self.cache_task_id(cid, tag))
        if store is None:
            return None
        return {
            "taskId": store.meta.task_id,
            "contentLength": store.meta.content_length,
            "totalPieces": store.meta.total_pieces,
            "pieceMd5Sign": store.meta.piece_md5_sign,
        }

    def import_cache(self, path: str, cid: str, tag: str = "") -> str:
        """Insert a local file as a completed cache task
        (dfcache import → ImportTask, rpcserver.go:401)."""
        from dragonfly2_tpu_torch.client.piece import (
            PieceMetadata,
            compute_piece_count,
            compute_piece_size,
        )
        from dragonfly2_tpu_torch.client.storage import WritePieceRequest

        task_id = self.cache_task_id(cid, tag)
        peer_id = idgen.peer_id_v1(self.config.ip) + "-import"
        store = self.storage.register_task(task_id, peer_id)
        size = os.path.getsize(path)
        piece_size = compute_piece_size(size)
        total = compute_piece_count(size, piece_size)
        with open(path, "rb") as f:
            for num in range(total):
                data = f.read(piece_size)
                store.write_piece(
                    WritePieceRequest(task_id, peer_id, PieceMetadata(
                        num=num, md5=hashlib.md5(data).hexdigest(),
                        offset=num * piece_size, start=num * piece_size,
                        length=len(data),
                    )),
                    io.BytesIO(data),
                )
        store.update(content_length=size, total_pieces=total)
        store.mark_done()
        return task_id

    def export_cache(self, cid: str, output_path: str, tag: str = "") -> bool:
        store = self.storage.find_completed_task(self.cache_task_id(cid, tag))
        if store is None:
            return False
        with open(output_path, "wb") as f:
            for chunk in store.iter_content():
                f.write(chunk)
        return True

    def delete_cache(self, cid: str, tag: str = "") -> int:
        return self.storage.delete_task(self.cache_task_id(cid, tag))

    # -- seeder surface (scheduler → seed daemon) --------------------------

    def seed_client(self) -> "SeedPeerDaemonClient":
        """The daemon's singleton seeder binding — every trigger path
        (in-proc AND the ObtainSeeds wire) shares one in-flight map."""
        return self._seed_client


class SeedBusyError(RuntimeError):
    """All owner trigger slots are in flight; the caller retries later."""


class SeedPeerDaemonClient:
    """The scheduler-side SeedPeerClient protocol bound to a seed daemon —
    ObtainSeeds semantics (seeder.go:53): trigger a back-source download on
    the seed so its pieces become the task's origin in the mesh."""

    # Concurrent back-source downloads are disk+network heavy; cap the
    # OWNERS only (duplicates just wait on an event and must not consume
    # slots — 8 re-triggers of one slow task would otherwise starve every
    # other task, the reverse of what a cap is for).
    MAX_CONCURRENT_TRIGGERS = 8

    class _Run:
        """One trigger attempt: outcome lives ON the run object, so a
        waiter always reads the outcome of the run it waited for — a
        later re-trigger can neither erase nor replace it. Runs die with
        their last reference (no unbounded per-task map)."""

        __slots__ = ("event", "outcome")

        def __init__(self):
            self.event = threading.Event()
            self.outcome = False

    def __init__(self, daemon: Daemon):
        self.daemon = daemon
        self._inflight_lock = threading.Lock()
        self._inflight: Dict[str, "SeedPeerDaemonClient._Run"] = {}
        self._slots = threading.Semaphore(self.MAX_CONCURRENT_TRIGGERS)

    def trigger_task(self, task) -> bool:
        """Returns whether the seed holds the task. A duplicate concurrent
        trigger WAITS for the in-flight one and reports its real outcome —
        preheat's synchronous contract must never claim warm-before-done.
        Raises :class:`SeedBusyError` when all owner slots are taken."""
        with self._inflight_lock:
            existing = self._inflight.get(task.id)
            if existing is None:
                if not self._slots.acquire(blocking=False):
                    raise SeedBusyError(
                        f"{self.MAX_CONCURRENT_TRIGGERS} seed triggers "
                        "already in flight")
                run = self._inflight[task.id] = self._Run()
        if existing is not None:
            existing.event.wait(
                timeout=self.daemon.config.task_options.timeout)
            return existing.outcome if existing.event.is_set() else False
        try:
            return self._run_trigger(task, run)
        finally:
            self._slots.release()

    def _run_trigger(self, task, run: "SeedPeerDaemonClient._Run") -> bool:
        try:
            daemon = self.daemon
            peer_id = (
                idgen.seed_peer_id_v1(daemon.config.ip)
                + "-" + uuid.uuid4().hex[:8]
            )
            seed_range = getattr(task, "url_range", "") or ""
            # Preheat/seed warm-up is scavenger traffic by definition:
            # with a QoS policy on, it rides the background class so a
            # fleet-wide preheat never contends with interactive pulls.
            seed_class = ""
            if daemon.qos_policy is not None:
                from dragonfly2_tpu_torch.client.qos import CLASS_BACKGROUND

                seed_class = daemon.qos_policy.normalize(CLASS_BACKGROUND)
            conductor = PeerTaskConductor(
                daemon.scheduler, daemon.storage,
                host_id=daemon.host_id, task_id=task.id, peer_id=peer_id,
                url=task.url, request_header=dict(task.request_header),
                shaper=daemon.shaper, options=daemon.config.task_options,
                is_seed=True,
                url_range=(parse_url_range(seed_range)
                           if seed_range else None),
                recovery_stats=daemon.config.recovery_stats,
                dataplane_stats=daemon.config.dataplane_stats,
                engine=daemon.dl_engine,
                traffic_class=seed_class,
            )
            # Seeds go straight to source (StartSeedTask → back-source);
            # register first so the peer exists in the scheduler's DAG.
            from dragonfly2_tpu_torch.scheduler.service import RegisterPeerRequest

            daemon.scheduler.register_peer(
                RegisterPeerRequest(
                    host_id=daemon.host_id, task_id=task.id,
                    peer_id=peer_id, url=task.url,
                    request_header=dict(task.request_header),
                    url_range=seed_range,
                    traffic_class=seed_class,
                ),
                channel=conductor.channel,
            )
            conductor._registered = True  # claims eligible (seed warm-up)
            # Adopt a crash-recovered partial store when one exists —
            # a restarted seed resumes its warm-up from the journal
            # instead of re-pulling the whole origin.
            conductor._attach_store()
            conductor._started_at = time.monotonic()
            # Register with the shaper like download_file does — otherwise
            # SamplingTrafficShaper.wait_n is a no-op for the unknown task
            # and seed warm-up traffic (preheat fan-out) runs unthrottled.
            daemon.shaper.add_task(task.id, traffic_class=seed_class)
            try:
                result = conductor._run_back_to_source(report=True)
            finally:
                daemon.shaper.remove_task(task.id)
            if not result.success:
                logger.warning("seed trigger for %s failed: %s",
                               task.id, result.error)
            elif result.storage is not None:
                # Preheat pipeline last leg: the warmed replica is
                # announced task-affinely (PR-8 announce_task path) so
                # EVERY scheduler replica on the task's ring — not just
                # the one that triggered us — offers this seed as a
                # parent, and a preheated fleet never touches origin.
                self._announce_completed(task.id, peer_id, result)
            run.outcome = result.success
            return result.success
        finally:
            with self._inflight_lock:
                self._inflight.pop(task.id, None)
            run.event.set()

    def _announce_completed(self, task_id: str, peer_id: str,
                            result: PeerTaskResult) -> None:
        announce = getattr(self.daemon.scheduler, "announce_task", None)
        if announce is None:
            return  # pre-announce_task scheduler — trigger-side view only
        meta = result.storage.meta
        if meta.content_length < 0 or meta.total_pieces <= 0:
            return
        from dragonfly2_tpu_torch.scheduler.service import AnnounceTaskRequest

        try:
            announce(AnnounceTaskRequest(
                host_id=self.daemon.host_id, task_id=task_id,
                peer_id=peer_id, url=meta.url,
                content_length=meta.content_length,
                total_piece_count=meta.total_pieces,
                piece_md5_sign=meta.piece_md5_sign,
            ))
        except Exception as exc:  # noqa: BLE001 — best effort: the
            # triggering scheduler already has the live peer record.
            logger.warning("post-trigger announce of %s failed: %s",
                           task_id[:16], exc)
