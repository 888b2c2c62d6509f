"""Minimal daemon process entry for the crash-resume chaos plane.

``python -m dragonfly2_tpu_torch.client.daemon_proc --storage-root R
--scheduler host:port`` runs one REAL dfdaemon process (storage +
upload server + peer engine over ``BalancedSchedulerClient``), prints
one ``DAEMON <host_id> <upload_addr>`` line on stdout, then serves a
tiny line protocol on stdin:

- ``DOWNLOAD <url> [class [tenant]]`` — start the download on a worker
  thread; every verified piece landing prints
  ``PROGRESS <url> <cumulative_bytes>`` (the kill supervisor's
  mid-download trigger), and completion prints ``RESULT <json>``
  carrying success/md5/fresh-vs-resumed accounting. The optional
  trailing tokens tag the task with a QoS traffic class + tenant
  (docs/QOS.md) — the qos bench's mixed-workload fleets issue classed
  pulls through the same protocol the chaos plane uses.
- ``STATS`` — prints ``STATS <json>`` of the process-wide recovery
  counters (reload verify/drop, orphan sweep, resume, re-announce).
- ``EXIT`` — graceful ``daemon.stop()`` (persists every journal), then
  the process exits 0.

The daemon-kill chaos rung (``client/chaosbench.py
run_daemon_kill_rung``) spawns one of these, SIGKILLs it mid-download
— a REAL process death, the failure mode ISSUE 8's durable journal
exists for — and restarts it on the same ``--storage-root`` to prove
the restart is a resume: journaled pieces verified and skipped, only
the missing tail re-downloaded, completed replicas re-announced.

Deliberately lighter than ``cmd/dfdaemon.py`` (same stance as
``scheduler/replica.py``): no config files, no metrics server, no jax
on the import path — the rung needs a daemon that is up in ~1 s.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import threading


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("df2-daemon-proc")
    parser.add_argument("--storage-root", required=True)
    parser.add_argument("--scheduler", required=True, action="append",
                        help="host:port (repeatable)")
    parser.add_argument("--hostname", default="daemon-proc")
    parser.add_argument("--piece-size", type=int, default=0,
                        help="pin the piece size (0 = production sizing) "
                             "so the rung controls pieces-per-task")
    parser.add_argument("--download-rate", type=float, default=0.0,
                        help="bytes/sec throttle so a kill window exists "
                             "on loopback (0 = unlimited)")
    parser.add_argument("--persist-every", type=int, default=2,
                        help="journal cadence in pieces (rung default is "
                             "tight so the kill loses little progress)")
    parser.add_argument("--type", default="normal")
    # Fan-out fleet knobs (client/fanoutbench.py): the dissemination
    # rungs run MANY of these processes, so the chaos-rung defaults
    # (pure-Python plane, fast journal cadence) are overridable.
    parser.add_argument("--native", action="store_true",
                        help="use the C++ piece data plane")
    parser.add_argument("--timeout", type=float, default=60.0,
                        help="per-task conductor deadline (seconds)")
    parser.add_argument("--poll-interval", type=float, default=0.2,
                        help="parent metadata sync interval (seconds)")
    parser.add_argument("--piece-concurrency", type=int, default=0,
                        help="piece/back-source fetcher threads per task "
                             "(0 = PeerTaskOptions defaults)")
    parser.add_argument("--fallback-wait", type=float, default=0.0,
                        help="hybrid back-to-source mesh-stall window "
                             "before claiming leased pieces locally "
                             "(0 = PeerTaskOptions default; fan-out rungs "
                             "raise it — a throttled origin makes slow "
                             "mesh progress NORMAL, and premature "
                             "fallbacks double origin egress)")
    parser.add_argument("--scheduler-grace", type=float, default=5.0,
                        help="scheduler-silence window before degrading "
                             "to back-to-source")
    parser.add_argument("--dl-engine", default="async",
                        choices=("async", "threads"),
                        help="download engine: 'async' = the fixed "
                             "dl-loop event-loop pool (constant thread "
                             "count), 'threads' = the historical "
                             "thread-per-worker engine")
    parser.add_argument("--dl-workers", type=int, default=0,
                        help="event-loop worker count for the async "
                             "download engine (0 = engine default)")
    parser.add_argument("--dl-max-streams", type=int, default=0,
                        help="daemon-wide cap on concurrently streaming "
                             "piece/source-run bodies (0 = engine "
                             "default)")
    # QoS plane (docs/QOS.md): blank weights = class-blind daemon, the
    # zero-overhead default every existing rung keeps.
    parser.add_argument("--qos-class-weights", default="",
                        help="class=weight,... enabling weighted-fair "
                             "admission (blank = class-blind)")
    parser.add_argument("--qos-class-floors", default="",
                        help="class=min_inservice,... reserved slots")
    parser.add_argument("--qos-default-class", default="",
                        help="class assigned to untagged work")
    parser.add_argument("--qos-shed-limit", type=int, default=512,
                        help="per-class parked-queue bound before 503 "
                             "sheds")
    parser.add_argument("--max-streams", type=int, default=0,
                        help="upload-side concurrent response-stream cap "
                             "(0 = QoS default when weights set, else "
                             "uncapped)")
    parser.add_argument("--cluster-id", default=None,
                        help="geo cluster this daemon belongs to "
                             "(docs/GEO.md; omit for cluster-blind)")
    parser.add_argument("--serve-rpc", action="store_true",
                        help="also serve the daemon gRPC surface "
                             "(ObtainSeeds for preheat triggers); the "
                             "DAEMON line gains a third field with the "
                             "rpc target")
    # Observability passthrough (the SAME flag set as cmd/common, via
    # the shared helper, so the fan-out/chaos spawners forward an
    # operator's flags verbatim).
    from dragonfly2_tpu_torch.cmd.common import add_observability_flags

    add_observability_flags(parser)
    args = parser.parse_args(argv)

    if args.cluster_id is not None:
        from dragonfly2_tpu_torch.cmd.common import init_observability_identity
        from dragonfly2_tpu_torch.utils.geoplan import validate_cluster_id

        try:
            validate_cluster_id(args.cluster_id, flag="--cluster-id")
        except ValueError as exc:
            parser.error(str(exc))
        init_observability_identity(args.cluster_id)

    if args.trace_dir or args.otlp_endpoint:
        from dragonfly2_tpu_torch.cmd.common import init_tracing

        init_tracing(args, "daemon-proc")

    if args.piece_size > 0:
        from dragonfly2_tpu_torch.client import peer_task as peer_task_mod

        peer_task_mod.compute_piece_size = (
            lambda content_length, _n=args.piece_size: _n)

    from dragonfly2_tpu_torch.client.daemon import Daemon, DaemonConfig
    from dragonfly2_tpu_torch.client.peer_task import PeerTaskOptions
    from dragonfly2_tpu_torch.client.recovery import RECOVERY
    from dragonfly2_tpu_torch.scheduler.rpcserver import BalancedSchedulerClient
    from dragonfly2_tpu_torch.utils.hosttypes import HostType
    from dragonfly2_tpu_torch.utils.ratelimit import INF

    options = PeerTaskOptions(
        # The kill rung injects through the Python transports and
        # wants deterministic piece accounting; the fan-out rungs flip
        # --native for throughput.
        native_data_plane=args.native,
        timeout=args.timeout,
        scheduler_grace=args.scheduler_grace,
        metadata_poll_interval=args.poll_interval,
    )
    if args.piece_concurrency > 0:
        options.piece_concurrency = args.piece_concurrency
        options.back_source_concurrency = args.piece_concurrency
    if args.fallback_wait > 0:
        options.source_fallback_wait = args.fallback_wait
    scheduler = BalancedSchedulerClient(list(args.scheduler),
                                        cluster_id=args.cluster_id or "")
    daemon = Daemon(scheduler, DaemonConfig(
        storage_root=args.storage_root,
        hostname=args.hostname,
        host_type=HostType.from_name(args.type),
        cluster_id=args.cluster_id or "",
        keep_storage=True,
        total_download_rate_bps=args.download_rate or INF,
        persist_every_pieces=args.persist_every,
        task_options=options,
        download_engine=args.dl_engine,
        dl_workers=args.dl_workers,
        dl_max_streams=args.dl_max_streams,
        qos_class_weights=args.qos_class_weights,
        qos_class_floors=args.qos_class_floors,
        qos_default_class=args.qos_default_class,
        qos_shed_limit=args.qos_shed_limit,
        upload_max_streams=args.max_streams,
    ))
    daemon.start()
    rpc = None
    if args.serve_rpc:
        from dragonfly2_tpu_torch.client.rpcserver import serve_daemon_rpc

        rpc = serve_daemon_rpc(daemon)

    out_lock = threading.Lock()

    def emit(line: str) -> None:
        with out_lock:
            print(line, flush=True)

    suffix = f" {rpc.target}" if rpc is not None else ""
    emit(f"DAEMON {daemon.host_id} {daemon.upload.address}{suffix}")
    if args.metrics_port >= 0:
        # After the DAEMON line (the spawner parses stdout's first
        # line); the bridged registry carries data_plane/recovery/
        # observability for this process.
        from dragonfly2_tpu_torch.cmd.common import start_metrics_server

        start_metrics_server(args)

    def run_download(url: str, traffic_class: str = "",
                     tenant: str = "") -> None:
        fresh = {"bytes": 0, "pieces": 0}

        def sink(store, piece) -> None:
            fresh["bytes"] += piece.length
            fresh["pieces"] += 1
            emit(f"PROGRESS {url} {fresh['bytes']}")

        payload = {"url": url, "ok": False, "error": "", "md5": "",
                   "bytes_fresh": 0, "pieces_fresh": 0,
                   "resumed_pieces": 0, "resumed_bytes": 0,
                   "content_length": -1}
        try:
            result = daemon.download_file(url, piece_sink=sink,
                                          traffic_class=traffic_class,
                                          tenant=tenant)
            digest = hashlib.md5()
            if result.success:
                for chunk in (result.storage.iter_content()
                              if result.storage is not None
                              else [result.direct_bytes or b""]):
                    digest.update(chunk)
            payload.update(
                ok=result.success, error=result.error,
                md5=digest.hexdigest() if result.success else "",
                bytes_fresh=fresh["bytes"], pieces_fresh=fresh["pieces"],
                resumed_pieces=result.resumed_pieces,
                resumed_bytes=result.resumed_bytes,
                content_length=result.content_length,
                reused=result.reused,
            )
        except Exception as exc:  # noqa: BLE001 — reported, not fatal
            payload["error"] = f"{type(exc).__name__}: {exc}"
        emit(f"RESULT {json.dumps(payload)}")

    for raw in sys.stdin:
        line = raw.strip()
        if not line:
            continue
        cmd, _, rest = line.partition(" ")
        if cmd == "DOWNLOAD" and rest:
            # "url [class [tenant]]" — bare url stays the class-blind
            # chaos-plane form; URLs here never contain spaces.
            parts = rest.split()
            url = parts[0]
            klass = parts[1] if len(parts) > 1 else ""
            tenant = parts[2] if len(parts) > 2 else ""
            threading.Thread(target=run_download, args=(url, klass, tenant),
                             name="proc-download", daemon=True).start()
        elif cmd == "GEO" and rest:
            # Install (or replace) the WAN link-emulation plan for THIS
            # process (docs/GEO.md). Sent post-spawn because the bench
            # only learns the fleet's ephemeral addresses from the
            # DAEMON lines; a re-send with partitioned links is the
            # partition chaos trigger. GEO {} uninstalls.
            from dragonfly2_tpu_torch.utils import geoplan

            try:
                spec = json.loads(rest)
                if spec:
                    geoplan.install(geoplan.GeoPlan.from_dict(spec))
                else:
                    geoplan.uninstall()
                emit("GEO-OK")
            except (ValueError, KeyError, TypeError) as exc:
                emit(f"GEO-ERR {type(exc).__name__}: {exc}")
        elif cmd == "STATS":
            from dragonfly2_tpu_torch.client.dataplane import STATS as DP_STATS
            from dragonfly2_tpu_torch.utils import geoplan

            snap = dict(RECOVERY.snapshot())
            # Nested so the flat recovery keys the kill rung reads stay
            # exactly as they were; the fan-out rungs sum these across
            # the fleet for the P2P-share metric.
            snap["data_plane"] = DP_STATS.snapshot()
            if geoplan.ACTIVE is not None:
                snap["geo"] = geoplan.ACTIVE.snapshot()
            emit(f"STATS {json.dumps(snap)}")
        elif cmd == "EXIT":
            break
    if rpc is not None:
        rpc.stop()
    daemon.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
