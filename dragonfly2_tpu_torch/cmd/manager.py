"""``df2-manager`` — run the manager (registry control plane), port of
``dragonfly2_tpu/cmd/manager.py``.

Usage::

    python -m dragonfly2_tpu_torch.cmd.manager --port 8080 \\
        --internal-port 65003 --db ./manager.db \\
        --object-store-dir ./manager-objects [--model-gate] [--no-auth]

``--object-store s3|oss|obs`` keeps the model registry in a cloud
object store instead of ``--object-store-dir``; the store reads its
credentials and endpoint from the environment (``AWS_ACCESS_KEY_ID``,
``AWS_SECRET_ACCESS_KEY``, ``AWS_ENDPOINT_URL`` for S3 and
S3-compatibles such as MinIO; ``OSS_*`` and ``OBS_*`` likewise).

Serves the JWT/PAT-authenticated REST API (``manager/rest.py``) over
:class:`~dragonfly2_tpu_torch.manager.ManagerService`: users and RBAC,
cluster, scheduler, seed-peer, application and model CRUD, rollback,
preheat and sync-peers jobs, and, on the separately bound internal
listener, instance registration, keepalive, dynconfig answers,
quarantine escalations, trace uploads and the job plane's lease, renew
and complete. Jobs live in the database (``manager/jobplane.py``):
schedulers started with ``--manager`` lease their queues' jobs over the
internal listener; sync-peers calls each active scheduler's
``ListHosts`` over the wire. ``--metrics-port`` serves ``ManagerMetrics``
and the debug-vars bridge on ``/metrics``.
A sweep thread expires silent instances every half ``keepalive_ttl``.
Auth is on by default (a ``root``/``dragonfly`` account is seeded like
the reference's database seed); ``--no-auth`` runs unauthenticated.
Each listener prints one line with its port (``--port 0`` and
``--internal-port 0`` pick free ones).

The manager computes nothing on a device and loads no torch: its
``--model-gate`` is the gate of the ``create_model`` calls that reach
this database, which run on the trainer's side, on the card.
"""

from __future__ import annotations

import argparse
import sys
import threading

from dragonfly2_tpu_torch.cmd.common import (
    add_common_flags,
    init_logging,
    init_tracing,
    parse_with_config,
    start_debug_monitor,
    start_metrics_server,
    wait_for_shutdown,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("df2-manager")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--internal-port", type=int, default=65003,
                        help="instance surface (registration/keepalive/"
                             "dynconfig; unauthenticated — firewall it); "
                             "-1 disables")
    parser.add_argument("--db", default="./manager.db")
    parser.add_argument("--object-store", default="fs",
                        choices=["fs", "s3", "oss", "obs"],
                        help="artifact backend; s3 reads AWS_* env vars "
                             "(AWS_ENDPOINT_URL for MinIO-compatibles)")
    parser.add_argument("--object-store-dir", default="./manager-objects")
    parser.add_argument("--no-auth", action="store_true",
                        help="disable JWT/RBAC (internal single-box mode)")
    parser.add_argument("--jwt-secret", default="",
                        help="HMAC secret for session tokens (default: "
                             "$DF2_MANAGER_JWT_SECRET or random per boot)")
    parser.add_argument("--model-gate", action="store_true",
                        help="stage ingested models as CANDIDATE and "
                             "promote only through the offline "
                             "validation gate (finite/non-degenerate "
                             "scores, rank correlation vs rules, "
                             "latency budget); rejected versions "
                             "quarantine")
    parser.add_argument("--model-gate-min-correlation", type=float,
                        default=0.2,
                        help="gate floor: mean Spearman rank "
                             "correlation of candidate scores vs the "
                             "rule evaluator over the replayed traces")
    add_common_flags(parser)
    args = parse_with_config(parser, argv)
    init_logging(args.verbose, args.log_dir, service="manager")
    init_tracing(args, "manager")

    from dragonfly2_tpu_torch import __version__
    from dragonfly2_tpu_torch.manager import (
        Database,
        FilesystemObjectStore,
        ManagerService,
    )
    from dragonfly2_tpu_torch.manager.auth import AuthService
    from dragonfly2_tpu_torch.manager.jobplane import DurableJobStore
    from dragonfly2_tpu_torch.manager.jobs import (
        PreheatService,
        SyncPeersService,
    )
    from dragonfly2_tpu_torch.manager.metrics import ManagerMetrics
    from dragonfly2_tpu_torch.manager.rest import ManagerHTTPServer, RestApi

    metrics = ManagerMetrics(version=__version__)
    db = Database(args.db)
    if args.object_store in ("s3", "oss", "obs"):
        from dragonfly2_tpu_torch.manager.objectstore import new_object_store

        object_store = new_object_store(args.object_store)
    else:
        object_store = FilesystemObjectStore(args.object_store_dir)
    validation = None
    if args.model_gate:
        from dragonfly2_tpu_torch.manager.validation import ValidationConfig

        validation = ValidationConfig(
            min_rank_correlation=args.model_gate_min_correlation)
    service = ManagerService(db, object_store, metrics=metrics,
                             validation=validation)
    auth = None if args.no_auth else AuthService(db, secret=args.jwt_secret)
    # Durable cross-process job plane: preheat jobs land in the DB and
    # standalone schedulers lease them over the internal surface
    # (scheduler/jobworker.py RemoteJobWorker) with machinery-style
    # retry/dead-letter semantics.
    jobstore = DurableJobStore(db)
    api = RestApi(service, auth=auth,
                  preheat=PreheatService(jobstore, service),
                  # rpc mode: pulls ListHosts from each registered
                  # scheduler directly — works across processes.
                  sync_peers=SyncPeersService(None, service, mode="rpc"),
                  jobstore=jobstore)
    server = ManagerHTTPServer(api, host=args.host, port=args.port)
    server.start()
    print(f"manager serving on {args.host}:{server.port} "
          f"(auth {'off' if args.no_auth else 'on'})", flush=True)
    internal_server = None
    if args.internal_port >= 0:
        internal_server = ManagerHTTPServer(
            api, host=args.host, port=args.internal_port,
            surface="internal")
        internal_server.start()
        print(f"manager internal surface on "
              f"{args.host}:{internal_server.port}", flush=True)
    metrics_server = start_metrics_server(args, metrics.registry)
    debug_monitor = start_debug_monitor(args)

    stop = threading.Event()

    def sweep():
        while not stop.wait(service.keepalive_ttl / 2):
            service.sweep_keepalive()

    sweeper = threading.Thread(target=sweep, daemon=True,
                               name="keepalive-sweep")
    sweeper.start()
    wait_for_shutdown()
    stop.set()
    sweeper.join(timeout=5)
    if metrics_server:
        metrics_server.stop()
    if debug_monitor:
        debug_monitor.stop()
    if internal_server:
        internal_server.stop()
    server.stop()
    db.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
