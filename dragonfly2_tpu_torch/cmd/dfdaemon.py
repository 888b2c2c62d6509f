"""``df2-daemon`` — run a peer daemon (dfdaemon).

Reference counterpart: cmd/dfget daemon mode + client/daemon/daemon.go
Serve: storage + upload server + (optional) proxy + object-storage gateway,
announced to a remote scheduler.
"""

from __future__ import annotations

import argparse
import sys

from dragonfly2_tpu_torch.cmd.common import (
    init_observability_identity,
    init_tracing,
    install_shutdown_handlers,
    parse_with_config,
    add_common_flags,
    init_logging,
    start_debug_monitor,
    start_metrics_server,
    wait_for_shutdown,
)


def build_daemon(args):
    from dragonfly2_tpu_torch.client.daemon import Daemon, DaemonConfig
    from dragonfly2_tpu_torch.scheduler.rpcserver import BalancedSchedulerClient
    from dragonfly2_tpu_torch.utils.hosttypes import HostType
    from dragonfly2_tpu_torch.utils.ratelimit import INF

    import os

    # Extra back-to-source schemes (s3/oss/oras/hdfs), env-configured —
    # secrets never ride argv (pkg/source/clients init registration).
    from dragonfly2_tpu_torch.client.source_signedhttp import register_env_sources

    register_env_sources()

    # Task-affine multi-scheduler routing; a single --scheduler is the
    # one-replica degenerate ring.
    tls = None
    if args.scheduler_tls_ca:
        from dragonfly2_tpu_torch.rpc.client import ClientTLS

        tls = ClientTLS(ca_path=args.scheduler_tls_ca,
                        cert_path=args.tls_cert, key_path=args.tls_key,
                        server_name_override=args.scheduler_tls_server_name)
    scheduler = BalancedSchedulerClient(args.scheduler, tls=tls,
                                        cluster_id=args.cluster_id or "")
    daemon = Daemon(scheduler, DaemonConfig(
        storage_root=args.storage_dir,
        ip=args.ip,
        hostname=args.hostname,
        host_type=HostType.from_name(args.type),
        idc=args.idc,
        location=args.location,
        cluster_id=args.cluster_id or "",
        total_download_rate_bps=args.download_rate or INF,
        upload_rate_bps=args.upload_rate or INF,
        traffic_shaper_type=args.traffic_shaper,
        persist_every_pieces=args.persist_every_pieces,
        persist_interval_s=args.persist_interval,
        reload_verify=not args.no_reload_verify,
        probe_interval=args.probe_interval,
        announce_interval=args.announce_interval,
        upload_serve_backlog=args.serve_backlog,
        upload_max_connections=args.max_connections or 0,
        upload_max_streams=args.max_streams or 0,
        upload_workers=args.upload_workers,
        download_engine=args.dl_engine,
        dl_workers=args.dl_workers,
        dl_max_streams=args.dl_max_streams or 0,
        upload_tls_cert=args.upload_tls_cert,
        upload_tls_key=args.upload_tls_key,
        peer_tls_ca=args.peer_tls_ca,
        source_tls_ca=args.source_tls_ca,
        qos_class_weights=args.qos_class_weights,
        qos_class_floors=args.qos_class_floors,
        qos_default_class=args.qos_default_class,
        qos_shed_limit=args.qos_shed_limit,
        qos_class_slos=args.qos_class_slos,
    ))
    daemon.start()
    return daemon


def _parse_whitelist(spec: str):
    """'host-regex[:port[,port]]' → WhiteListEntry. Ports split off the
    LAST ':' and only when the suffix is digits/commas, so host regexes
    containing ':' (e.g. '(?:a|b)\\.example') survive; the entry's
    eager regex compile turns a malformed pattern into a startup error.
    An empty host part (':8080') is the reference's any-host
    restricted-ports form → WhiteListEntry(host='', ports=[...])."""
    from dragonfly2_tpu_torch.client.proxy import WhiteListEntry

    host, sep, ports = spec.rpartition(":")
    if not sep or not ports or not all(p.isdigit()
                                       for p in ports.split(",")):
        host, ports = spec, ""
    return WhiteListEntry(
        host=host, ports=[p for p in ports.split(",") if p])


def main(argv=None) -> int:
    import socket

    parser = argparse.ArgumentParser("df2-daemon")
    parser.add_argument("--scheduler", default=None, action="append",
                        help="host:port (repeat for replicas; tasks route "
                             "by consistent hash)")
    parser.add_argument("--manager", default="",
                        help="manager host:port — scheduler targets and "
                             "client limits refresh from its dynconfig "
                             "(with local cache fallback)")
    parser.add_argument("--dynconfig-interval", type=float, default=60.0)
    parser.add_argument("--rpc-port", type=int, default=-1,
                        help="serve the dfdaemon.Daemon gRPC surface "
                             "(Download/Stat/Import/Export/Delete) on this "
                             "port (0 = ephemeral, -1 = disabled)")
    parser.add_argument("--storage-dir", default="./daemon-data")
    parser.add_argument("--ip", default="127.0.0.1")
    parser.add_argument("--hostname", default=socket.gethostname())
    parser.add_argument("--type", default="normal",
                        help="normal|super|strong|weak (seed roles)")
    parser.add_argument("--idc", default="")
    parser.add_argument("--location", default="")
    parser.add_argument("--cluster-id", default=None,
                        help="geo cluster this daemon belongs to "
                             "(docs/GEO.md): rides announce/register so "
                             "the scheduler steers piece traffic intra-"
                             "cluster and elects per-cluster WAN bridges; "
                             "omit for a cluster-blind daemon")
    parser.add_argument("--download-rate", type=float, default=0,
                        help="bytes/sec total download limit (0 = unlimited)")
    parser.add_argument("--upload-rate", type=float, default=0)
    parser.add_argument("--reload-interval", type=float, default=10,
                        help="re-read --config every N seconds and hot-"
                             "apply reloadable options (proxy rules, "
                             "registry mirror, upload rate); SIGHUP "
                             "forces an immediate re-read; 0 disables "
                             "(peerhost.go Reload.Interval)")
    parser.add_argument("--traffic-shaper", default="plain",
                        choices=["plain", "sampling"])
    parser.add_argument("--serve-backlog", type=int, default=128,
                        help="upload listener listen(2) backlog")
    parser.add_argument("--max-connections", type=int, default=None,
                        help="admission cap on concurrently open upload "
                             "connections (>= 1; beyond the cap arrivals "
                             "get a best-effort 503; omit for unlimited)")
    parser.add_argument("--max-streams", type=int, default=None,
                        help="cap on concurrently SERVING upload piece "
                             "bodies (>= 1) — the request-time QoS gate; "
                             "excess requests park per class and drain "
                             "weighted-fair (omit: gate off, or 64 when "
                             "--qos-class-weights is set)")
    parser.add_argument("--qos-class-weights", default="",
                        help="'interactive=8,bulk=3,background=1' turns "
                             "multi-tenant QoS ON: every admission gate "
                             "(upload stream gate, download engine, "
                             "traffic shaper) goes class-aware weighted-"
                             "fair (docs/QOS.md); empty = class-blind")
    parser.add_argument("--qos-class-floors", default="",
                        help="per-class admission floors "
                             "('interactive=2'): slots other classes' "
                             "backlog can never occupy; sum(floors) must "
                             "stay below the gate capacity")
    parser.add_argument("--qos-default-class", default="",
                        help="class unlabeled work lands on "
                             "(default: bulk)")
    parser.add_argument("--qos-shed-limit", type=int, default=512,
                        help="per-class park-queue bound on the upload "
                             "stream gate; overflow gets a 503 shed")
    parser.add_argument("--qos-class-slos", default="",
                        help="per-class slow-SLO seconds for the tail "
                             "sampler ('interactive=2,bulk=30')")
    parser.add_argument("--upload-workers", type=int, default=0,
                        help="event-loop worker threads for the upload "
                             "engine (0 = default; total serving threads "
                             "= workers + 1 acceptor, independent of "
                             "connection count)")
    parser.add_argument("--dl-engine", default="async",
                        choices=("async", "threads"),
                        help="download engine: 'async' multiplexes every "
                             "task's metadata syncs, piece fetches and "
                             "source runs over a fixed pool of dl-loop "
                             "event loops (download threads = a constant "
                             "independent of concurrent task count); "
                             "'threads' pins the historical "
                             "thread-per-worker engine")
    parser.add_argument("--dl-workers", type=int, default=0,
                        help="event-loop worker threads for the async "
                             "download engine (0 = default)")
    parser.add_argument("--upload-tls-cert", default="",
                        help="PEM certificate enabling TLS on the upload "
                             "(piece-serving) listener; kTLS offload is "
                             "probed per connection and the serve ladder "
                             "falls back to record-layer writes without it")
    parser.add_argument("--upload-tls-key", default="",
                        help="private key for --upload-tls-cert")
    parser.add_argument("--peer-tls-ca", default="",
                        help="CA bundle (PEM) for TLS to parent peers; "
                             "set it and piece fetches + metadata syncs "
                             "dial TLS on the same event loops (unset = "
                             "plaintext mesh, the default)")
    parser.add_argument("--source-tls-ca", default="",
                        help="CA bundle pinned for https origins "
                             "(unset = system trust)")
    parser.add_argument("--dl-max-streams", type=int, default=None,
                        help="daemon-wide cap on concurrently streaming "
                             "piece/source-run bodies in the async "
                             "engine (>= 1); excess streams queue "
                             "(omit for the engine default)")
    parser.add_argument("--persist-every-pieces", type=int, default=16,
                        help="journal task metadata after this many piece "
                             "landings (0 disables the count trigger); "
                             "with --persist-interval this bounds how much "
                             "download progress a SIGKILL can lose")
    parser.add_argument("--persist-interval", type=float, default=2.0,
                        help="also journal a dirty task after this many "
                             "seconds (0 disables the age trigger; set "
                             "BOTH 0 to journal only at completion/"
                             "shutdown, the pre-journal behavior)")
    parser.add_argument("--no-reload-verify", action="store_true",
                        help="skip md5 re-verification of journaled pieces "
                             "at startup reload (trusted storage medium)")
    parser.add_argument("--probe-interval", type=float, default=0.0,
                        help="network-topology probe ticker seconds "
                             "(0 = disabled)")
    parser.add_argument("--announce-interval", type=float, default=30.0,
                        help="host telemetry re-announce seconds "
                             "(0 = announce once at startup)")
    parser.add_argument("--proxy-port", type=int, default=0,
                        help="enable the HTTP proxy on this port")
    parser.add_argument("--proxy-rule", action="append", default=[],
                        help="regex of URLs routed through the mesh")
    parser.add_argument("--registry-mirror", default="",
                        help="remote registry base for mirror mode")
    parser.add_argument("--proxy-whitelist", action="append", default=[],
                        help="host-regex[:port[,port]] the proxy may "
                             "reach; repeatable. Unset = allow all "
                             "(client/config WhiteList)")
    parser.add_argument("--proxy-hijack-https", action="store_true",
                        help="terminate CONNECT TLS with minted per-host "
                             "certs so HTTPS pulls traverse the mesh "
                             "(clients must trust the CA)")
    parser.add_argument("--proxy-ca-dir", default="",
                        help="CA workdir (ca.pem/ca.key created if absent)")
    parser.add_argument("--sni-port", type=int, default=-1,
                        help="TLS-terminating SNI listener port "
                             "(needs --proxy-hijack-https; -1 = disabled)")
    parser.add_argument("--sni-upstream-port", type=int, default=443,
                        help="origin port SNI-routed requests target")
    parser.add_argument("--object-storage-port", type=int, default=-1,
                        help="enable the object gateway (>=0)")
    parser.add_argument("--object-storage-dir", default="",
                        help="filesystem object-store root for the gateway")
    parser.add_argument("--scheduler-tls-ca", default="",
                        help="trust roots for the scheduler wire (PEM); "
                             "enables TLS to every scheduler target")
    parser.add_argument("--tls-cert", default="",
                        help="client certificate presented to the "
                             "scheduler (mutual TLS)")
    parser.add_argument("--tls-key", default="",
                        help="private key for --tls-cert")
    parser.add_argument("--scheduler-tls-server-name", default="",
                        help="expected server cert hostname when dialing "
                             "by IP (SNI override)")
    add_common_flags(parser)
    args = parse_with_config(parser, argv)
    # SIGTERM/SIGINT must run the graceful stop path from the moment
    # the daemon starts building state (storage reload, announce) —
    # installed only at wait_for_shutdown, a production SIGTERM during
    # startup (or delivered to a handler-less daemon) would kill the
    # process with default disposition and never reach
    # daemon.stop() → storage.persist_all().
    shutdown = install_shutdown_handlers()
    init_logging(args.verbose, args.log_dir, service="dfdaemon")
    if args.cluster_id is not None:
        from dragonfly2_tpu_torch.utils.geoplan import validate_cluster_id

        try:
            validate_cluster_id(args.cluster_id, flag="--cluster-id")
        except ValueError as exc:
            parser.error(str(exc))
        init_observability_identity(args.cluster_id)
    init_tracing(args, "dfdaemon")
    if args.sni_port >= 0 and not args.proxy_hijack_https:
        parser.error("--sni-port requires --proxy-hijack-https "
                     "(the SNI listener terminates TLS with minted certs)")
    if not args.scheduler and not args.manager:
        parser.error("at least one of --scheduler / --manager is required")
    # Admission caps must be >= 1 when given: an explicit 0 wedges the
    # gate permanently (every arrival parks/rejects, no slot ever
    # frees). "Unlimited"/"default" is expressed by OMITTING the flag.
    for flag, value in (("--max-connections", args.max_connections),
                        ("--max-streams", args.max_streams),
                        ("--dl-max-streams", args.dl_max_streams)):
        if value is not None and value < 1:
            parser.error(f"{flag} must be >= 1 (an explicit 0 wedges "
                         f"admission: every request waits for a slot "
                         f"that can never free); omit the flag for the "
                         f"default behavior")
    if args.qos_shed_limit < 1:
        parser.error("--qos-shed-limit must be >= 1")
    from dragonfly2_tpu_torch.client.qos import parse_class_map

    for flag, spec in (("--qos-class-weights", args.qos_class_weights),
                       ("--qos-class-floors", args.qos_class_floors),
                       ("--qos-class-slos", args.qos_class_slos)):
        try:
            parse_class_map(spec, what=flag)
        except ValueError as exc:
            parser.error(str(exc))

    dynconfig = None
    cli_targets = list(args.scheduler or [])
    if args.manager:
        # Scheduler targets come from the manager's dynconfig answer
        # (client/config/dynconfig_manager.go), cached on disk so the
        # daemon still boots when the manager is down — and explicit
        # --scheduler targets are pinned: dynconfig adds/removes only the
        # manager-reported replicas around them.
        from dragonfly2_tpu_torch.manager.client import ManagerHTTPClient
        from dragonfly2_tpu_torch.utils.dynconfig import Dynconfig

        mgr = ManagerHTTPClient(args.manager)
        dynconfig = Dynconfig(
            lambda: mgr.daemon_dynconfig(ip=args.ip,
                                         hostname=args.hostname),
            cache_path=f"{args.storage_dir}/dynconfig.json",
            refresh_interval=args.dynconfig_interval,
            name="daemon-dynconfig")
        try:
            initial = dynconfig.get()
        except ConnectionError as exc:
            if not cli_targets:
                parser.error(f"manager unreachable and no --scheduler "
                             f"fallback: {exc}")
            print(f"manager unreachable ({exc}); starting with "
                  f"--scheduler targets only", flush=True)
            initial = {}
        args.scheduler = cli_targets + [
            t for t in initial.get("schedulers", [])
            if t not in cli_targets]
        if not args.scheduler:
            parser.error(f"manager {args.manager} reports no active "
                         "schedulers and none were given via --scheduler")

    daemon = build_daemon(args)
    if dynconfig is not None:
        def _retarget(cfg):
            reported = cfg.get("schedulers", [])
            if reported or cli_targets:
                daemon.scheduler.update_targets(
                    cli_targets + [t for t in reported
                                   if t not in cli_targets])

        dynconfig.subscribe(_retarget)
        dynconfig.serve()
    print(f"daemon {daemon.host_id} upload on {daemon.upload.address}",
          flush=True)
    metrics_server = start_metrics_server(args, daemon.metrics.registry)
    debug_monitor = start_debug_monitor(args)

    rpc_server = None
    if args.rpc_port >= 0:
        from dragonfly2_tpu_torch.client.rpcserver import serve_daemon_rpc

        rpc_server = serve_daemon_rpc(daemon, host="0.0.0.0",
                                      port=args.rpc_port)
        print(f"daemon rpc on {rpc_server.target}", flush=True)

    proxy = None
    sni = None
    if (args.proxy_port or args.proxy_rule or args.registry_mirror
            or args.proxy_hijack_https):
        from dragonfly2_tpu_torch.client.proxy import (
            ProxyConfig,
            ProxyRule,
            ProxyServer,
            RegistryMirror,
            SNIProxyServer,
        )

        proxy = ProxyServer(daemon, ProxyConfig(
            rules=[ProxyRule(regx=r) for r in args.proxy_rule],
            registry_mirror=(RegistryMirror(remote=args.registry_mirror)
                             if args.registry_mirror else None),
            whitelist=[_parse_whitelist(w) for w in args.proxy_whitelist],
            hijack_https=args.proxy_hijack_https,
            ca_dir=args.proxy_ca_dir,
        ), port=args.proxy_port)
        proxy.start()
        print(f"proxy on {proxy.address}", flush=True)
        if proxy.ca is not None:
            print(f"proxy CA at {proxy.ca.ca_cert_path}", flush=True)
        if args.sni_port >= 0:
            sni = SNIProxyServer(proxy, host="0.0.0.0", port=args.sni_port,
                                 upstream_port=args.sni_upstream_port)
            sni.start()
            print(f"sni listener on 0.0.0.0:{sni.port}", flush=True)

    gateway = None
    if args.object_storage_port >= 0:
        from dragonfly2_tpu_torch.client.objectstorage_gateway import (
            ObjectStorageGateway,
        )
        from dragonfly2_tpu_torch.manager.objectstore import FilesystemObjectStore

        backend = FilesystemObjectStore(
            args.object_storage_dir or "./object-store")
        gateway = ObjectStorageGateway(daemon, backend,
                                       port=args.object_storage_port)
        gateway.start()
        print(f"object gateway on 127.0.0.1:{gateway.port}", flush=True)

    watcher = None
    if args.config and args.reload_interval > 0:
        from dragonfly2_tpu_torch.utils.ratelimit import INF
        from dragonfly2_tpu_torch.utils.reload import ConfigWatcher

        def _apply_reload(cfg: dict) -> None:
            # The reloadable subset (daemon.go:648 watchers): proxy
            # options + rates. Structural options (ports, storage root,
            # hijack mode) still need a restart, as in the reference.
            if "upload_rate" in cfg:
                daemon.upload.limiter.set_rate(
                    float(cfg["upload_rate"]) or INF)
            if proxy is not None and ("proxy_rule" in cfg
                                      or "registry_mirror" in cfg
                                      or "proxy_whitelist" in cfg):
                from dragonfly2_tpu_torch.client.proxy import (
                    ProxyRule,
                    RegistryMirror,
                )

                # Only keys present in the file are touched; an empty
                # value present in the file clears the option.
                kwargs = {}
                if "proxy_rule" in cfg:
                    kwargs["rules"] = [ProxyRule(regx=r)
                                       for r in cfg.get("proxy_rule") or []]
                if "registry_mirror" in cfg:
                    kwargs["registry_mirror"] = (
                        RegistryMirror(remote=cfg["registry_mirror"])
                        if cfg.get("registry_mirror") else None)
                if "proxy_whitelist" in cfg:
                    kwargs["whitelist"] = [
                        _parse_whitelist(w)
                        for w in cfg.get("proxy_whitelist") or []]
                proxy.watch(**kwargs)

        watcher = ConfigWatcher(args.config, _apply_reload,
                                interval=args.reload_interval).start()

    wait_for_shutdown(shutdown)
    if watcher is not None:
        watcher.stop()
    if dynconfig is not None:
        dynconfig.stop()
    if metrics_server:
        metrics_server.stop()
    if rpc_server:
        rpc_server.stop()
    if gateway:
        gateway.stop()
    if sni:
        sni.stop()
    if proxy:
        proxy.stop()
    daemon.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
