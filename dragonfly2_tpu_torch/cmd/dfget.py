"""``df2-get`` — download one URL through the mesh.

Reference counterpart: cmd/dfget + client/dfget/dfget.go:47-397. Ladder:
1. ``--daemon`` (or both flags): drive a long-running daemon over its gRPC
   surface — invocations share that daemon's cache (dfget's daemon-first
   path, root.go:102 runDfget); falls through on daemon failure when a
   scheduler is also configured.
2. ``--scheduler`` (repeatable): spin an ephemeral in-process peer against
   the scheduler replicas (consistent-hash routed).
3. neither: direct back-to-source fetch.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

from dragonfly2_tpu_torch.cmd.common import (
    add_common_flags,
    init_logging,
    init_tracing,
    parse_with_config,
)


def main(argv=None) -> int:
    # The ephemeral-peer fallback fetches origin itself, so it needs the
    # same scheme registry the daemon installs.
    from dragonfly2_tpu_torch.client.source_signedhttp import register_env_sources

    register_env_sources()

    parser = argparse.ArgumentParser("df2-get")
    parser.add_argument("url")
    parser.add_argument("-O", "--output", required=True)
    parser.add_argument("--daemon", default="",
                        help="host:port of a running df2-daemon rpc "
                             "surface; invocations share its cache")
    parser.add_argument("--scheduler", default=[], action="append",
                        help="host:port (repeatable); omit for direct "
                             "back-to-source")
    parser.add_argument("--storage-dir", default="",
                        help="persistent peer storage (default: ephemeral)")
    parser.add_argument("--tag", default="")
    parser.add_argument("--application", default="")
    parser.add_argument("--header", action="append", default=[],
                        metavar="K:V")
    parser.add_argument("--range", dest="url_range", default="",
                        help="download only this byte range, e.g. 0-9 "
                             "(10 bytes); the range is its own task in "
                             "the mesh")
    parser.add_argument("--filter", default="",
                        help="'&'-separated query params excluded from the "
                             "task id")
    parser.add_argument("--recursive", action="store_true",
                        help="URL names a directory on a listable scheme "
                             "(file://, s3://): download every child under "
                             "it into -O as a directory, each through the "
                             "mesh as its own task")
    parser.add_argument("--list", action="store_true",
                        help="with --recursive: print the child URLs and "
                             "exit without downloading (root.go --list)")
    parser.add_argument("--accept-regex", default="",
                        help="with --recursive: only fetch children whose "
                             "URL matches this regex")
    parser.add_argument("--reject-regex", default="",
                        help="with --recursive: skip children whose URL "
                             "matches this regex (applied after "
                             "--accept-regex)")
    parser.add_argument("--digest", default="",
                        help="expected content digest 'md5:<hex>' or "
                             "'sha256:<hex>'; the output is verified and "
                             "deleted on mismatch (root.go --digest)")
    parser.add_argument("--timeout", type=float, default=0.0,
                        help="seconds for the whole download; 0 (default) "
                             "= no deadline (root.go --timeout)")
    parser.add_argument("--traffic-class", default="",
                        help="QoS traffic class for this task "
                             "(interactive/bulk/background, docs/QOS.md); "
                             "rides registration metadata to the scheduler "
                             "and every classed admission gate; blank = "
                             "class-blind")
    parser.add_argument("--tenant", default="",
                        help="tenant id tagged alongside --traffic-class")
    parser.add_argument("--priority", type=int, default=0,
                        help="scheduler priority ladder value 0-6 "
                             "(root.go -P: LEVEL1 forbidden, LEVEL2 "
                             "back-to-source-only, LEVEL3 self "
                             "back-source first)")
    parser.add_argument("--disable-back-source", action="store_true",
                        help="never fetch origin from this client: the "
                             "mesh serves the task or the download "
                             "fails (root.go flag)")
    parser.add_argument("--original-offset", action="store_true",
                        help="with --range: write the window at its "
                             "original byte offset inside -O, so many "
                             "ranged invocations assemble one file "
                             "(root.go --original-offset)")
    parser.add_argument("--scheduler-tls-ca", default="",
                        help="trust roots for the scheduler wire (PEM)")
    parser.add_argument("--tls-cert", default="",
                        help="client certificate for mutual TLS")
    parser.add_argument("--tls-key", default="",
                        help="private key for --tls-cert")
    parser.add_argument("--scheduler-tls-server-name", default="",
                        help="expected server cert hostname when dialing "
                             "by IP")
    add_common_flags(parser)
    args = parse_with_config(parser, argv)
    init_logging(args.verbose, args.log_dir, service="dfget")
    init_tracing(args, "dfget")

    headers = {}
    for item in args.header:
        k, _, v = item.partition(":")
        headers[k.strip()] = v.strip()

    if args.url_range:
        from dragonfly2_tpu_torch.client.piece import parse_url_range

        if args.recursive:
            parser.error("--range cannot be combined with --recursive")
        try:
            parse_url_range(args.url_range)
        except ValueError as exc:
            parser.error(str(exc))
    elif args.original_offset:
        parser.error("--original-offset requires --range")
    if args.digest:
        from dragonfly2_tpu_torch.utils import digest as digestutil

        try:
            digestutil.parse(args.digest)
        except digestutil.InvalidDigestError as exc:
            # Full validation (algorithm, hex charset, exact length) at
            # parse time — a typo'd digest must die HERE, not after the
            # download where the mismatch path deletes the output.
            parser.error(str(exc))
    if (args.list or args.accept_regex or args.reject_regex) \
            and not args.recursive:
        parser.error("--list/--accept-regex/--reject-regex require "
                     "--recursive")
    if not 0 <= args.priority <= 6:
        parser.error("--priority must be in the 0-6 ladder")

    if args.recursive:
        return _recursive_download(args, headers)

    if args.daemon:
        rc = _daemon_download(args, headers)
        if rc is not None:
            return rc
        if not args.scheduler:
            return 1
        print("daemon unreachable; falling back to ephemeral peer",
              file=sys.stderr)

    from dragonfly2_tpu_torch.client.daemon import Daemon, DaemonConfig
    from dragonfly2_tpu_torch.client.peer_task import PeerTaskOptions

    ephemeral = not args.storage_dir
    storage_dir = args.storage_dir or tempfile.mkdtemp(prefix="df2-get-")
    scheduler = _scheduler_client(args)
    options = PeerTaskOptions()
    # 0 = no deadline, like the reference; a week stands in for infinity
    # so internal waits stay finite numbers.
    options.timeout = args.timeout if args.timeout > 0 else 7 * 86400
    daemon = Daemon(scheduler, DaemonConfig(
        storage_root=storage_dir, keep_storage=not ephemeral,
        task_options=options,
    ))
    daemon.start()
    out_path = _download_target(args)
    try:
        result = daemon.download_file(
            args.url, output_path=out_path,
            request_header=headers, tag=args.tag,
            application=args.application,
            filtered_query_params=(args.filter.split("&")
                                   if args.filter else None),
            url_range=args.url_range,
            priority=args.priority,
            disable_back_source=args.disable_back_source,
            traffic_class=args.traffic_class,
            tenant=args.tenant,
        )
    except Exception as exc:  # noqa: BLE001 — mirror _daemon_download:
        # the --original-offset temp window must not leak in the output
        # directory when the download path raises instead of returning a
        # failure result.
        _discard_window(args, out_path)
        print(f"download failed: {exc}", file=sys.stderr)
        return 1
    finally:
        daemon.stop()
        if ephemeral:
            import shutil

            shutil.rmtree(storage_dir, ignore_errors=True)
    if not result.success:
        _discard_window(args, out_path)
        print(f"download failed: {result.error}", file=sys.stderr)
        return 1
    rc = _finalize_output(args, out_path)
    if rc:
        return rc
    print(f"{args.output}: {result.content_length} bytes "
          f"(task {result.task_id[:16]}…)")
    return 0


def _discard_window(args, out_path: str) -> None:
    """Remove a --original-offset temp window after a failed download."""
    if out_path != args.output:
        import contextlib
        import os

        with contextlib.suppress(OSError):
            os.unlink(out_path)


def _download_target(args) -> str:
    """Where the raw download lands: a UNIQUE sibling temp file when
    --original-offset will splice the window into -O afterwards (unique
    so concurrent ranged invocations assembling one file never collide)."""
    if args.original_offset:
        import os
        import tempfile

        out_dir = os.path.dirname(os.path.abspath(args.output)) or "."
        fd, path = tempfile.mkstemp(dir=out_dir, prefix=".df2-window-")
        os.close(fd)
        return path
    return args.output


def _finalize_output(args, out_path: str) -> int:
    """Post-download contract flags: --digest verification (delete on
    mismatch, root.go --digest role) and --original-offset splicing
    (window bytes written at their source offset inside -O, so many
    ranged invocations — possibly concurrent — assemble one file)."""
    import os
    import shutil

    if args.digest:
        from dragonfly2_tpu_torch.utils import digest as digestutil

        want = digestutil.parse(args.digest)
        got = digestutil.hash_file(out_path, want.algorithm)
        if got != want.encoded:
            os.unlink(out_path)
            print(f"digest mismatch: got {want.algorithm}:{got}, "
                  f"want {args.digest}; output removed", file=sys.stderr)
            return 1
    if args.original_offset:
        from dragonfly2_tpu_torch.client.piece import parse_url_range

        start = parse_url_range(args.url_range).start
        # O_CREAT without O_TRUNC: concurrent splicers must never zero
        # each other's already-written windows.
        fd = os.open(args.output, os.O_CREAT | os.O_RDWR, 0o644)
        with open(out_path, "rb") as src, os.fdopen(fd, "r+b") as dst:
            dst.seek(start)
            shutil.copyfileobj(src, dst, 4 << 20)
        os.unlink(out_path)
    return 0


def _recursive_download(args, headers) -> int:
    """Directory download (the reference dfget --recursive /
    rpcserver.go:268 recursive path): list children on a listable scheme,
    then fetch each as its own task into the output DIRECTORY."""
    import os
    import urllib.parse

    from dragonfly2_tpu_torch.client.source import Request, SourceError
    from dragonfly2_tpu_torch.client.source import list_children

    base = args.url if args.url.endswith("/") else args.url + "/"
    try:
        children = list_children(Request(args.url, header=dict(headers)))
    except SourceError as exc:
        print(f"cannot list {args.url}: {exc}", file=sys.stderr)
        return 1
    if not children:
        print(f"{args.url}: no entries", file=sys.stderr)
        return 1
    base_path = urllib.parse.urlparse(base).path
    # --accept-regex / --reject-regex (root.go): accept filters first,
    # reject prunes what survived.
    if args.accept_regex:
        import re

        accept = re.compile(args.accept_regex)
        children = [c for c in children if accept.search(c)]
    if args.reject_regex:
        import re

        reject = re.compile(args.reject_regex)
        children = [c for c in children if not reject.search(c)]
    if args.list:
        for child in children:
            print(child)
        return 0
    if not children:
        print(f"{args.url}: no entries after filters", file=sys.stderr)
        return 1
    entries = []
    for child in children:
        child_path = urllib.parse.urlparse(child).path
        rel = (child_path[len(base_path):] if
               child_path.startswith(base_path)
               else child_path.rsplit("/", 1)[-1])
        entries.append((child, urllib.parse.unquote(rel).lstrip("/")))

    out_root = os.path.abspath(args.output)
    os.makedirs(out_root, exist_ok=True)

    def out_path(rel: str) -> str:
        # Resolve against the ABSOLUTE output root before the containment
        # check; a relative-path compare would flatten every entry.
        path = os.path.normpath(os.path.join(out_root, rel))
        if not path.startswith(out_root + os.sep) and path != out_root:
            path = os.path.join(out_root, os.path.basename(rel))
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        return path

    filtered = args.filter.split("&") if args.filter else None
    use_daemon = bool(args.daemon)
    if use_daemon:
        from dragonfly2_tpu_torch.client.rpcserver import RemoteDaemonClient

        # Preflight so an unreachable daemon degrades like the
        # non-recursive ladder instead of crashing mid-tree.
        probe = None
        try:
            probe = RemoteDaemonClient(args.daemon)
            probe.version()
        except Exception as exc:  # noqa: BLE001 — daemon down is soft
            if probe is not None:
                probe.close()
            print(f"daemon {args.daemon} failed: {exc}", file=sys.stderr)
            if not args.scheduler:
                return 1
            print("daemon unreachable; falling back to ephemeral peer",
                  file=sys.stderr)
            use_daemon = False
        else:
            probe.close()

    failures = 0
    if use_daemon:
        from dragonfly2_tpu_torch.client.rpcserver import RemoteDaemonClient

        client = RemoteDaemonClient(args.daemon)
        try:
            for child, rel in entries:
                try:
                    result = client.download(
                        child, out_path(rel), request_header=headers,
                        tag=args.tag, application=args.application,
                        filtered_query_params=filtered,
                        priority=args.priority,
                        disable_back_source=args.disable_back_source,
                        traffic_class=args.traffic_class,
                        tenant=args.tenant,
                        timeout=(args.timeout if args.timeout > 0
                                 else 7 * 86400))
                except Exception as exc:  # noqa: BLE001 — per-entry
                    failures += 1
                    print(f"{child}: {exc}", file=sys.stderr)
                    continue
                if not result.success:
                    failures += 1
                    print(f"{child}: {result.error}", file=sys.stderr)
        finally:
            client.close()
    else:
        import tempfile

        from dragonfly2_tpu_torch.client.daemon import Daemon, DaemonConfig

        storage_dir = args.storage_dir or tempfile.mkdtemp(prefix="df2-get-")
        scheduler = _scheduler_client(args)
        daemon = Daemon(scheduler, DaemonConfig(
            storage_root=storage_dir, keep_storage=bool(args.storage_dir)))
        daemon.start()
        try:
            for child, rel in entries:
                result = daemon.download_file(
                    child, output_path=out_path(rel),
                    request_header=headers, tag=args.tag,
                    application=args.application,
                    filtered_query_params=filtered,
                    priority=args.priority,
                    disable_back_source=args.disable_back_source,
                    traffic_class=args.traffic_class,
                    tenant=args.tenant)
                if not result.success:
                    failures += 1
                    print(f"{child}: {result.error}", file=sys.stderr)
        finally:
            daemon.stop()
            if not args.storage_dir:
                import shutil

                shutil.rmtree(storage_dir, ignore_errors=True)
    done = len(entries) - failures
    print(f"{args.output}: {done}/{len(entries)} entries downloaded")
    return 0 if failures == 0 else 1


def _daemon_download(args, headers):
    """Remote-daemon path; returns an exit code, or None when the daemon
    is unreachable (caller decides whether a fallback exists)."""
    from dragonfly2_tpu_torch.client.rpcserver import RemoteDaemonClient

    client = RemoteDaemonClient(args.daemon)
    out_path = _download_target(args)
    try:
        result = client.download(
            args.url, output_path=out_path, request_header=headers,
            tag=args.tag, application=args.application,
            filtered_query_params=(args.filter.split("&")
                                   if args.filter else None),
            url_range=args.url_range,
            priority=args.priority,
            disable_back_source=args.disable_back_source,
            traffic_class=args.traffic_class,
            tenant=args.tenant,
            timeout=args.timeout if args.timeout > 0 else 7 * 86400,
        )
    except Exception as exc:  # noqa: BLE001 — daemon down is a soft error
        _discard_window(args, out_path)
        print(f"daemon {args.daemon} failed: {exc}", file=sys.stderr)
        return None
    finally:
        client.close()
    if not result.success:
        _discard_window(args, out_path)
        print(f"download failed: {result.error}", file=sys.stderr)
        return 1
    rc = _finalize_output(args, out_path)
    if rc:
        return rc
    via = "cache" if result.reused else "mesh"
    print(f"{args.output}: {result.content_length} bytes via daemon {via} "
          f"(task {result.task_id[:16]}…)")
    return 0


def _scheduler_client(args):
    """Ephemeral-peer scheduler client honoring the TLS flags; the
    no-scheduler case degrades to the direct back-to-source stub."""
    if not args.scheduler:
        return _DirectScheduler()
    from dragonfly2_tpu_torch.scheduler.rpcserver import BalancedSchedulerClient

    tls = None
    if args.scheduler_tls_ca:
        from dragonfly2_tpu_torch.rpc.client import ClientTLS

        tls = ClientTLS(ca_path=args.scheduler_tls_ca,
                        cert_path=args.tls_cert, key_path=args.tls_key,
                        server_name_override=args.scheduler_tls_server_name)
    return BalancedSchedulerClient(args.scheduler, tls=tls)


class _DirectScheduler:
    """Schedulerless mode: every registration fails, so the conductor's
    fallback drives a pure back-to-source download (dfget's direct path)."""

    def announce_host(self, host) -> None:
        pass

    def __getattr__(self, name):
        def unavailable(*args, **kwargs):
            raise ConnectionError("no scheduler configured")

        return unavailable


if __name__ == "__main__":
    sys.exit(main())
