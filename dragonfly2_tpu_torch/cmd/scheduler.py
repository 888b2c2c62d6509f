"""``df2-scheduler`` — run a scheduler instance; port of
``dragonfly2_tpu/cmd/scheduler.py``.

Reference counterpart: cmd/scheduler + scheduler/scheduler.go Server
assembly: resource model + scheduling core + dataset sink + network
topology + the scheduler's RPC surface (``scheduler/rpcserver.py`` over
the port's wire), with optional manager registration/keepalive and
announcer→trainer dataset streaming. Run it as ``python -m
dragonfly2_tpu_torch.cmd.scheduler --port 8002 [--algorithm
default|ml|cost] [--device cuda]``; it prints ``scheduler serving on
host:port`` and serves until SIGTERM.

:func:`connect_manager` is the ``--manager`` branch: it registers the
instance on the manager's internal surface and sends the first keepalive
at once (registration alone leaves the row inactive, and daemons'
dynconfig lists only active instances); it binds the ML evaluator's
quarantine hook (a runtime guard trip escalates the serving version to
``/internal/v1/models/quarantine``, a fleet-wide rollback) and a
``TraceLog`` of its announce feature batches; it runs the keepalive
loop, which uploads the trace corpus every ``TRACE_UPLOAD_TICKS`` ticks
for the validation gate to replay; and it subscribes
``Scheduling.apply_dynconfig`` to a :class:`Dynconfig` on the cluster's
scheduler config, with its on-disk cache under ``data_dir``; it works
on any :class:`~dragonfly2_tpu_torch.scheduler.service.SchedulerService`,
also one a test or a phase builds in its own process.

With ``--manager``, a
:class:`~dragonfly2_tpu_torch.scheduler.jobworker.RemoteJobWorker`
leases the manager's preheat and sync-peers jobs of the queues
``global``, ``schedulers`` and ``scheduler_<id>`` every
``--job-poll-interval`` seconds, where ``<id>`` is the registered row's
id (the queue the manager's preheat posts to), and runs them against the
service. ``--metrics-port`` serves ``SchedulerMetrics`` (live host, task
and peer gauges over the resource model) and the debug-vars bridge on
``/metrics``.

It differs from JAX's on purpose in these ways:

- ``--device`` (default ``cuda``) is where ``--algorithm cost`` loads the
  learned cost model. Without a card and without ``--device cpu`` that
  algorithm exits at start with
  :class:`~dragonfly2_tpu_torch.device.DeviceFault`. A cost model that
  fails to load degrades to the rule evaluator, as in JAX; a fault of the
  card (``device.is_device_fault``) is raised instead.
- JAX's manager threads are daemons that never stop;
  :class:`ManagerLink.stop` ends the keepalive loop and the dynconfig
  ticker, and the job worker is stopped at shutdown.
"""

from __future__ import annotations

import argparse
import logging
import socket
import sys
import threading
import time
from typing import Optional

from dragonfly2_tpu_torch.cmd.common import (
    add_common_flags,
    init_logging,
    init_tracing,
    parse_with_config,
    start_debug_monitor,
    start_metrics_server,
    wait_for_shutdown,
)
from dragonfly2_tpu_torch.manager.client import ManagerHTTPClient
from dragonfly2_tpu_torch.manager.validation import TraceLog
from dragonfly2_tpu_torch.utils.dynconfig import Dynconfig

logger = logging.getLogger(__name__)

#: Keepalive ticks between two trace uploads: about once a minute at
#: the default 5 s interval.
TRACE_UPLOAD_TICKS = 12


class TrainerClient:
    """The announcer's trainer client: ``Train`` on a trainer service
    (``python -m dragonfly2_tpu_torch.cmd.trainer``) over the wire."""

    def __init__(self, target):
        from dragonfly2_tpu_torch.rpc import ServiceClient
        from dragonfly2_tpu_torch.trainer.service import TRAINER_SPEC

        self.cli = ServiceClient(target, TRAINER_SPEC)

    def train(self, requests):
        return self.cli.Train(requests, timeout=3600)


class _ManagerAdapter:
    """Announcer's ManagerAnnounceClient over the HTTP client. Always
    speaks the advertised identity — keepalive must match the registered
    (hostname, ip) row exactly."""

    def __init__(self, client: ManagerHTTPClient, hostname: str, ip: str,
                 cluster_id: int):
        self.client = client
        self.hostname = hostname
        self.ip = ip
        self.cluster_id = cluster_id

    def update_scheduler(self, host_id, ip, hostname_, port):
        self.client.update_scheduler_instance(
            hostname=self.hostname, ip=self.ip, port=port,
            cluster_id=self.cluster_id)

    def keepalive(self, host_id):
        self.client.keepalive_scheduler(hostname=self.hostname, ip=self.ip,
                                        cluster_id=self.cluster_id)


class ManagerLink:
    """What :func:`connect_manager` started: the registered identity, the
    client, the announcer adapter, the trace log (None when the evaluator
    has no quarantine hook), the dynconfig and the keepalive thread."""

    def __init__(self, client: ManagerHTTPClient, adapter: _ManagerAdapter,
                 scheduler_id: int, trace_log: Optional[TraceLog],
                 dynconfig: Dynconfig, keepalive_interval: float):
        self.client = client
        self.adapter = adapter
        self.scheduler_id = scheduler_id
        self.trace_log = trace_log
        self.dynconfig = dynconfig
        self.keepalive_interval = keepalive_interval
        self.keepalives = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._keepalive_loop,
                                        daemon=True, name="manager-keepalive")

    @property
    def cluster_id(self) -> int:
        return self.adapter.cluster_id

    def upload_traces(self) -> bool:
        """Ship the recorded announce traces now; False when there are
        none to ship."""
        if self.trace_log is None or not len(self.trace_log):
            return False
        self.client.upload_announce_traces(self.scheduler_id,
                                           self.trace_log.to_bytes())
        return True

    def keepalive(self) -> None:
        self.adapter.keepalive("")
        self.keepalives += 1

    def start(self) -> None:
        """Start the keepalive loop."""
        self._thread.start()

    def _keepalive_loop(self) -> None:
        ticks = 0
        while not self._stop.wait(self.keepalive_interval):
            ticks += 1
            try:
                self.keepalive()
            except Exception:  # noqa: BLE001 — keepalive must not die
                logger.exception("manager keepalive failed")
            # Failures only cost gate freshness, never the keepalive.
            if ticks % TRACE_UPLOAD_TICKS == 0:
                try:
                    self.upload_traces()
                except Exception:  # noqa: BLE001
                    logger.exception("announce-trace upload failed")

    def stop(self) -> None:
        """End the keepalive loop and the dynconfig ticker."""
        self._stop.set()
        self._thread.join(timeout=5)
        self.dynconfig.stop()


def connect_manager(service, manager_url: str, *, port: int,
                    cluster_id: int = 0, scheduler_id: int = 0,
                    advertise_ip: str = "", hostname: str = "",
                    data_dir: str = ".", keepalive_interval: float = 5.0,
                    dynconfig_interval: float = 60.0) -> ManagerLink:
    """Register ``service`` with the manager at ``manager_url`` (its
    internal surface) and keep it registered; see the module docstring.

    ``advertise_ip`` is the routable address daemons receive through
    dynconfig (default: ``hostname`` resolved, else 127.0.0.1);
    ``hostname`` defaults to this host's name. ``scheduler_id`` 0 takes
    the registered row's id, which keys model uploads, quarantines and
    trace uploads. ``cluster_id`` 0 lets the manager pick its default
    cluster. Returns the :class:`ManagerLink`; call ``stop()`` on it."""
    mgr = ManagerHTTPClient(manager_url)
    hostname = hostname or socket.gethostname()
    if not advertise_ip:
        try:
            advertise_ip = socket.gethostbyname(hostname)
        except OSError:
            advertise_ip = "127.0.0.1"
    row = mgr.update_scheduler_instance(
        hostname=hostname, ip=advertise_ip, port=port, cluster_id=cluster_id)
    scheduler_id = scheduler_id or int(row["id"])
    cluster_id = int(row["scheduler_cluster_id"])
    logger.info("registered with manager as scheduler %s (cluster %s)",
                scheduler_id, cluster_id)
    adapter = _ManagerAdapter(mgr, hostname, advertise_ip, cluster_id)

    # Guarded model lifecycle wiring: an ML evaluator escalates runtime
    # guard trips to a registry quarantine (fleet-wide rollback), and
    # records its announce feature batches so the manager's validation
    # gate replays REAL traffic against future candidates. The evaluator
    # was built before this client existed, hence the late binding.
    trace_log = None
    evaluator = service.scheduling.evaluator
    if hasattr(evaluator, "set_quarantine_hook"):
        trace_log = TraceLog()
        evaluator.set_trace_log(trace_log)

        def quarantine_serving(reason):
            version = getattr(evaluator, "serving_version", "")
            if not version:
                return False  # version unknown yet: retry next trip
            mgr.quarantine_model_version(
                model_type=getattr(evaluator, "model_name", "mlp"),
                version=version, scheduler_id=scheduler_id,
                reason=f"scheduler runtime guard: {reason}")

        evaluator.set_quarantine_hook(quarantine_serving)

    dynconfig = Dynconfig(
        lambda: mgr.scheduler_cluster_config(cluster_id),
        cache_path=f"{data_dir}/dynconfig.json",
        refresh_interval=dynconfig_interval, name="scheduler-dynconfig")
    link = ManagerLink(mgr, adapter, scheduler_id, trace_log, dynconfig,
                       keepalive_interval)
    # First keepalive immediately: registration alone leaves the row
    # inactive, and daemons' dynconfig only lists active instances.
    link.keepalive()
    link.start()
    dynconfig.subscribe(service.scheduling.apply_dynconfig)
    dynconfig.refresh()
    dynconfig.serve()
    return link


def _load_cost_evaluator(registry, current_version, device=None):
    """ACTIVE `cost` version → LearnedCostEvaluator on ``device``, or
    None when no active version exists / it already serves. Shared by
    startup and the reload watcher."""
    from dragonfly2_tpu_torch.inference.sidecar import (
        MODEL_NAME_COST,
        _cost_scorer_from_artifact,
    )
    from dragonfly2_tpu_torch.scheduler.evaluator import new_evaluator

    version = registry.get_active_model_version(MODEL_NAME_COST)
    if version is None or version == current_version:
        return None
    active = registry.get_active_model(MODEL_NAME_COST)
    if active is None:
        return None
    evaluator = new_evaluator(
        "cost", scorer=_cost_scorer_from_artifact(active.artifact,
                                                  version=active.version,
                                                  device=device))
    print(f"learned-cost evaluator serving version {active.version}",
          flush=True)
    return evaluator


def _watch_cost_registry(service, registry, interval_s: float = 60.0,
                         registry_factory=None, device=None):
    """Poll the co-located registry and keep the scheduling core's
    evaluator in sync with the ACTIVE cost version: a newly promoted
    (or rolled-back-to) version hot-swaps in — without this a scheduler
    started before the first promotion would stay on rules until
    restart — and a registry left with NO active version (the serving
    version was quarantined with nothing restorable) DEMOTES a serving
    learned-cost evaluator back to rules, honoring the rollback
    contract's "none -> evaluators rule-fall-back". ``registry`` may be
    None when opening it failed at startup; the watcher then retries
    ``registry_factory`` each tick, so fixing the registry on disk
    never requires a scheduler restart. A tick that fails (a fault of
    the card included) keeps the serving evaluator and tries again on
    the next one."""
    from dragonfly2_tpu_torch.inference.sidecar import MODEL_NAME_COST
    from dragonfly2_tpu_torch.scheduler.evaluator import new_evaluator

    def swap_to(evaluator) -> None:
        old = service.scheduling.evaluator
        service.scheduling.evaluator = evaluator
        close = getattr(old, "close", None)
        if close is not None:
            close()

    def loop():
        nonlocal registry
        while True:
            time.sleep(interval_s)
            try:
                if registry is None:
                    if registry_factory is None:
                        return
                    registry = registry_factory()
                    print("cost registry opened by the reload watcher",
                          flush=True)
                current = getattr(service.scheduling.evaluator,
                                  "serving_version", None)
                version = registry.get_active_model_version(MODEL_NAME_COST)
                if version is None:
                    if current is not None:
                        swap_to(new_evaluator("default"))
                        print("active cost model retired with no "
                              "restorable predecessor; demoted to the "
                              "rule evaluator", flush=True)
                elif version != current:
                    evaluator = _load_cost_evaluator(registry, current,
                                                     device)
                    if evaluator is not None:
                        swap_to(evaluator)
            except Exception:  # noqa: BLE001 — the watcher must not die
                logger.exception("cost model reload check failed")

    threading.Thread(target=loop, daemon=True,
                     name="cost-model-watcher").start()


def build_scheduler(args):
    """(service, server): the scheduler assembled from ``main``'s
    arguments and serving on ``args.host:args.port``."""
    from dragonfly2_tpu_torch import __version__
    from dragonfly2_tpu_torch.rpc import serve
    from dragonfly2_tpu_torch.scheduler.evaluator import new_evaluator
    from dragonfly2_tpu_torch.scheduler.metrics import SchedulerMetrics
    from dragonfly2_tpu_torch.scheduler.networktopology.store import (
        NetworkTopologyConfig,
        NetworkTopologyStore,
    )
    from dragonfly2_tpu_torch.scheduler.resource.resource import (
        Resource,
        ResourceConfig,
    )
    from dragonfly2_tpu_torch.scheduler.rpcserver import (
        SCHEDULER_SPEC,
        SchedulerRpcService,
    )
    from dragonfly2_tpu_torch.scheduler.scheduling.core import Scheduling
    from dragonfly2_tpu_torch.scheduler.service import SchedulerService
    from dragonfly2_tpu_torch.scheduler.storage.storage import Storage

    resource = Resource(ResourceConfig(
        shard_count=args.resource_shards,
        gc_budget_s=args.gc_budget_ms / 1e3))
    storage = Storage(args.data_dir)
    cost_registry = None
    cost_registry_factory = None
    device = None
    if args.algorithm == "cost":
        # Learned piece-cost evaluator (docs/REPLAY.md): the scorer MUST
        # come from a gate-promoted ACTIVE `cost` registry version — the
        # co-located manager db/object-store pair is the only loading
        # path, so an ungated artifact can never reach this seam. No
        # active version (or a load failure) degrades to the rule
        # evaluator; the reload watcher below keeps polling so a later
        # promotion (or rollback to a different version) is picked up
        # without a restart — the sidecar reload-watcher contract.
        from dragonfly2_tpu_torch.device import (
            default_device,
            is_device_fault,
        )

        if not args.cost_model_db:
            raise SystemExit("--algorithm cost needs --cost-model-db "
                             "(co-located manager registry)")
        # No card and no --device cpu: DeviceFault here, before any model.
        device = default_device(args.device)
        evaluator = None

        def cost_registry_factory():
            from dragonfly2_tpu_torch.manager import (
                Database,
                FilesystemObjectStore,
                ManagerService,
            )

            return ManagerService(
                Database(args.cost_model_db),
                FilesystemObjectStore(args.cost_object_dir), device=device)

        try:
            cost_registry = cost_registry_factory()
            evaluator = _load_cost_evaluator(cost_registry, None, device)
            if evaluator is None:
                print("no ACTIVE cost model in the registry; scheduling "
                      "with the rule evaluator until one is promoted "
                      "(reload watcher polling)", flush=True)
        except Exception as exc:
            if is_device_fault(exc):
                raise
            logger.exception(
                "cost registry open failed; degrading to rules "
                "(reload watcher will retry opening it)")
        if evaluator is None:
            evaluator = new_evaluator("default")
    else:
        evaluator = new_evaluator(
            args.algorithm,
            sidecar_target=args.inference_sidecar or None,
        )
    replay_recorder = None
    if args.record_replay:
        from dragonfly2_tpu_torch.scheduler.replaylog import ReplayRecorder

        replay_recorder = ReplayRecorder(storage)
    seed_peer_client = None
    if args.seed_peer:
        # Remote seed daemons over the wire (resource/seed_peer_client.go
        # multi-addr client; cdnsystem.Seeder ObtainSeeds).
        from dragonfly2_tpu_torch.client.rpcserver import GrpcSeedPeerClient

        seed_peer_client = GrpcSeedPeerClient(args.seed_peer)
    service = SchedulerService(
        resource=resource,
        scheduling=Scheduling(evaluator, recorder=replay_recorder),
        storage=storage,
        network_topology=NetworkTopologyStore(
            # persist_path: a restarted replica warm-starts its probe
            # history instead of silently losing it.
            NetworkTopologyConfig(
                persist_path=f"{args.data_dir}/topology_state.json"),
            resource=resource, storage=storage),
        metrics=SchedulerMetrics(resource=resource, version=__version__),
        seed_peer_client=seed_peer_client,
    )
    resource.serve()
    service.network_topology.serve()
    if args.algorithm == "cost":
        _watch_cost_registry(service, cost_registry,
                             registry_factory=cost_registry_factory,
                             device=device)
    if args.replica_peer:
        # Cross-replica probe anti-entropy: symmetric push-pull of
        # probe-window deltas, bounding mid-window loss to one tick —
        # the role Redis plays for the reference (probes.go:115-186).
        from dragonfly2_tpu_torch.scheduler.networktopology import (
            ReplicaSyncer,
        )

        peer_tls = None
        if args.replica_peer_tls_ca:
            from dragonfly2_tpu_torch.rpc.client import ClientTLS

            peer_tls = ClientTLS(
                ca_path=args.replica_peer_tls_ca,
                server_name_override=args.replica_peer_tls_server_name)
        service.replica_syncer = ReplicaSyncer(
            service.network_topology, args.replica_peer,
            interval=args.replica_sync_interval, tls=peer_tls,
            metrics=service.metrics)
        service.replica_syncer.serve()
    tls = None
    if args.tls_cert:
        # pkg/rpc/credential.go's role: server TLS, mutual when a client
        # CA is configured (the reference's mTLS security mode).
        from dragonfly2_tpu_torch.rpc.service import ServerTLS

        tls = ServerTLS(cert_path=args.tls_cert, key_path=args.tls_key,
                        client_ca_path=args.tls_client_ca)
    server = serve([(SCHEDULER_SPEC, SchedulerRpcService(service))],
                   host=args.host, port=args.port, tls=tls)
    return service, server


def _start_announcer(args, service) -> None:
    """``--trainer``: the announcer streams the dataset sink to the
    trainer service every ``--train-interval`` seconds."""
    from dragonfly2_tpu_torch.scheduler.announcer import Announcer
    from dragonfly2_tpu_torch.utils import idgen

    hostname = socket.gethostname()
    announcer = Announcer(
        host_id=idgen.host_id_v1(hostname, args.port),
        ip=args.host, hostname=hostname, port=args.port,
        storage=service.storage,
        trainer_client=TrainerClient(args.trainer),
        scheduler_id=args.scheduler_id,
    )

    def train_loop():
        while True:
            time.sleep(args.train_interval)
            try:
                announcer.train()
            except Exception:  # noqa: BLE001 — the loop must not die
                logger.exception("train upload failed")

    threading.Thread(target=train_loop, daemon=True,
                     name="announce-train").start()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("df2-scheduler")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8002)
    parser.add_argument("--data-dir", default="./scheduler-data",
                        help="dataset sink directory")
    parser.add_argument("--algorithm", default="default",
                        choices=["default", "ml", "cost", "plugin"])
    parser.add_argument("--record-replay", action="store_true",
                        help="record full announce decision events "
                             "(candidates + features + realized costs + "
                             "outcomes) into the data dir's rotating "
                             "replay dataset for offline replay "
                             "evaluation and cost-model training "
                             "(docs/REPLAY.md; zero hot-path work when "
                             "off)")
    parser.add_argument("--cost-model-db", default="",
                        help="manager sqlite path for --algorithm cost "
                             "(co-located registry; only gate-promoted "
                             "ACTIVE cost versions load)")
    parser.add_argument("--cost-object-dir", default="./manager-objects",
                        help="manager object-store dir holding the cost "
                             "model artifacts")
    parser.add_argument("--device", default="cuda",
                        help="where --algorithm cost loads the learned "
                             "cost model: cuda (default; no card → "
                             "DeviceFault at start) or cpu")
    parser.add_argument("--resource-shards", type=int, default=8,
                        help="shards per resource-manager map; announce "
                             "lookups and GC snapshots contend per shard "
                             "(docs/SCHEDULER.md)")
    parser.add_argument("--gc-budget-ms", type=float, default=50.0,
                        help="incremental-GC sweep budget per tick; the "
                             "longest announce-path stall one reclaim "
                             "tick may cause")
    parser.add_argument("--inference-sidecar", default="",
                        help="host:port of the inference sidecar "
                             "(python -m dragonfly2_tpu_torch.cmd."
                             "inference; with --algorithm ml)")
    parser.add_argument("--seed-peer", default=None, action="append",
                        help="host:port of a seed daemon's rpc surface "
                             "(repeatable); first download of a task "
                             "triggers its back-source there")
    parser.add_argument("--trainer", default="",
                        help="host:port of the trainer service; enables "
                             "periodic dataset upload")
    parser.add_argument("--train-interval", type=float, default=600.0)
    parser.add_argument("--scheduler-id", type=int, default=0,
                        help="manager-assigned scheduler instance id; keys "
                             "model uploads per cluster (auto-assigned "
                             "when --manager is set)")
    parser.add_argument("--manager", default="",
                        help="manager internal-surface host:port — "
                             "registers this instance, keeps it alive, "
                             "refreshes cluster dynconfig")
    parser.add_argument("--advertise-ip", default="",
                        help="IP daemons should dial (default: resolved "
                             "hostname; NEVER the 0.0.0.0 bind address)")
    parser.add_argument("--cluster-id", type=int, default=0,
                        help="scheduler cluster id at the manager "
                             "(0 = manager default cluster)")
    parser.add_argument("--geo-cluster", default=None,
                        help="geo cluster (site) this scheduler runs in "
                             "(docs/GEO.md) — a STRING site identity, "
                             "distinct from the manager's integer "
                             "--cluster-id; tags /debug/vars, /metrics "
                             "and traces; omit for cluster-blind")
    parser.add_argument("--job-poll-interval", type=float, default=1.0,
                        help="seconds between job-plane lease polls "
                             "(with --manager)")
    parser.add_argument("--replica-peer", default=None, action="append",
                        help="host:port of a peer scheduler replica "
                             "(repeatable); enables probe anti-entropy")
    parser.add_argument("--replica-sync-interval", type=float, default=60.0,
                        help="seconds between probe anti-entropy ticks")
    parser.add_argument("--replica-peer-tls-ca", default="",
                        help="CA bundle for dialing TLS-serving replica "
                             "peers")
    parser.add_argument("--replica-peer-tls-server-name", default="",
                        help="SNI/SAN override when peers present a "
                             "service-DNS certificate")
    parser.add_argument("--tls-cert", default="",
                        help="serve the scheduler wire over TLS with this "
                             "certificate (PEM)")
    parser.add_argument("--tls-key", default="",
                        help="private key for --tls-cert")
    parser.add_argument("--tls-client-ca", default="",
                        help="require client certs signed by this CA "
                             "(mutual TLS)")
    add_common_flags(parser)
    args = parse_with_config(parser, argv)
    if bool(args.tls_cert) != bool(args.tls_key):
        parser.error("--tls-cert and --tls-key must be given together")
    init_logging(args.verbose, args.log_dir, service="scheduler")
    if args.geo_cluster is not None:
        from dragonfly2_tpu_torch.cmd.common import (
            init_observability_identity,
        )
        from dragonfly2_tpu_torch.utils.geoplan import validate_cluster_id

        try:
            validate_cluster_id(args.geo_cluster, flag="--geo-cluster")
        except ValueError as exc:
            parser.error(str(exc))
        init_observability_identity(args.geo_cluster)
    init_tracing(args, "scheduler", cluster_id=args.geo_cluster or "")

    service, server = build_scheduler(args)
    print(f"scheduler serving on {server.target}", flush=True)
    metrics_server = start_metrics_server(args, service.metrics.registry)
    debug_monitor = start_debug_monitor(args)

    link = job_worker = None
    if args.manager:
        # Advertise a routable address, never the bind address — daemons
        # receive this via dynconfig and 0.0.0.0 would point them at
        # their own loopback.
        link = connect_manager(
            service, args.manager, port=args.port,
            cluster_id=args.cluster_id, scheduler_id=args.scheduler_id,
            advertise_ip=args.advertise_ip or (
                args.host if args.host not in ("0.0.0.0", "::") else ""),
            data_dir=args.data_dir)
        args.scheduler_id = link.scheduler_id
        print(f"registered with manager as scheduler {link.scheduler_id} "
              f"(cluster {link.cluster_id})", flush=True)

        # Consume manager-initiated jobs (preheat, sync-peers) from the
        # durable cross-process plane (scheduler/job/job.go:49 Serve).
        from dragonfly2_tpu_torch.scheduler.jobworker import RemoteJobWorker

        job_worker = RemoteJobWorker(link.client, service, link.scheduler_id,
                                     poll_interval=args.job_poll_interval)
        job_worker.serve()
        print(f"job worker polling queues {job_worker.queues}", flush=True)

    if args.trainer:
        _start_announcer(args, service)

    wait_for_shutdown()
    if job_worker is not None:
        job_worker.stop()
    if link is not None:
        link.stop()
    if metrics_server:
        metrics_server.stop()
    if debug_monitor:
        debug_monitor.stop()
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
