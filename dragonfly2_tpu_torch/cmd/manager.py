"""``df2-manager`` — run the manager (registry control plane), port of
``dragonfly2_tpu/cmd/manager.py``.

Usage::

    python -m dragonfly2_tpu_torch.cmd.manager --port 8080 \\
        --internal-port 65003 --db ./manager.db \\
        --object-store-dir ./manager-objects [--model-gate] [--no-auth]

Serves the JWT/PAT-authenticated REST API (``manager/rest.py``) over
:class:`~dragonfly2_tpu_torch.manager.ManagerService`: users and RBAC,
cluster, scheduler, seed-peer, application and model CRUD, rollback,
and, on the separately bound internal listener, instance registration,
keepalive, dynconfig answers, quarantine escalations and trace uploads.
A sweep thread expires silent instances every half ``keepalive_ttl``.
Auth is on by default (a ``root``/``dragonfly`` account is seeded like
the reference's database seed); ``--no-auth`` runs unauthenticated.
Each listener prints one line with its port (``--port 0`` and
``--internal-port 0`` pick free ones).

It differs from JAX's on purpose: no ``ManagerMetrics`` (the card
machine has no ``prometheus_client``), no durable job store, preheat or
sync-peers service (the job plane is not ported: ``/api/v1/jobs`` answers
503 or 400 as JAX's does when they are not wired), and only the
filesystem object store. The manager computes nothing on a device: its
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
    parser.add_argument("--object-store", default="fs", choices=["fs"],
                        help="artifact backend (the S3, OSS and OBS "
                             "stores are not ported)")
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

    from dragonfly2_tpu_torch.manager import (
        Database,
        FilesystemObjectStore,
        ManagerService,
    )
    from dragonfly2_tpu_torch.manager.auth import AuthService
    from dragonfly2_tpu_torch.manager.rest import ManagerHTTPServer, RestApi

    db = Database(args.db)
    object_store = FilesystemObjectStore(args.object_store_dir)
    validation = None
    if args.model_gate:
        from dragonfly2_tpu_torch.manager.validation import ValidationConfig

        validation = ValidationConfig(
            min_rank_correlation=args.model_gate_min_correlation)
    service = ManagerService(db, object_store, validation=validation)
    auth = None if args.no_auth else AuthService(db, secret=args.jwt_secret)
    api = RestApi(service, auth=auth)
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
    metrics_server = start_metrics_server(args)
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
