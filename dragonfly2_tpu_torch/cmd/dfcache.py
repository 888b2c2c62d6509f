"""``df2-cache`` — stat/import/export/delete cache entries.

Reference counterpart: cmd/dfcache + client/dfcache/dfcache.go:46-300.
``--daemon`` drives a running daemon over its gRPC surface (the
reference's unix-socket daemon calls, rpcserver.go:268-698) so repeated
invocations share one live cache; ``--storage-dir`` operates on a daemon
storage directory offline.
"""

from __future__ import annotations

import argparse
import json
import sys

from dragonfly2_tpu_torch.cmd.common import (
    add_common_flags,
    init_logging,
    init_tracing,
    parse_with_config,
)


def _daemon(storage_dir: str):
    from dragonfly2_tpu_torch.client.daemon import Daemon, DaemonConfig
    from dragonfly2_tpu_torch.cmd.dfget import _DirectScheduler

    return Daemon(_DirectScheduler(), DaemonConfig(storage_root=storage_dir))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("df2-cache")
    parser.add_argument("command",
                        choices=["stat", "import", "export", "delete"])
    parser.add_argument("cid", help="cache key")
    parser.add_argument("--daemon", default="",
                        help="host:port of a running df2-daemon rpc surface")
    parser.add_argument("--storage-dir", default="",
                        help="operate directly on a daemon storage dir "
                             "(offline mode)")
    parser.add_argument("--path", default="",
                        help="input file (import) / output file (export)")
    parser.add_argument("--tag", default="")
    add_common_flags(parser)
    args = parse_with_config(parser, argv)
    init_logging(args.verbose, args.log_dir, service="dfcache")
    init_tracing(args, "dfcache")

    if bool(args.daemon) == bool(args.storage_dir):
        parser.error("exactly one of --daemon / --storage-dir is required")
    if args.daemon:
        return _remote_main(args, parser)

    daemon = _daemon(args.storage_dir)
    if args.command == "stat":
        info = daemon.stat_cache(args.cid, args.tag)
        if info is None:
            print("not found", file=sys.stderr)
            return 1
        print(json.dumps(info))
        return 0
    if args.command == "import":
        if not args.path:
            parser.error("import requires --path")
        task_id = daemon.import_cache(args.path, args.cid, args.tag)
        print(task_id)
        return 0
    if args.command == "export":
        if not args.path:
            parser.error("export requires --path")
        if not daemon.export_cache(args.cid, args.path, args.tag):
            print("not found", file=sys.stderr)
            return 1
        return 0
    removed = daemon.delete_cache(args.cid, args.tag)
    return 0 if removed else 1


def _remote_main(args, parser) -> int:
    from dragonfly2_tpu_torch.client.rpcserver import RemoteDaemonClient

    client = RemoteDaemonClient(args.daemon)
    try:
        if args.command == "stat":
            resp = client.stat(cid=args.cid, tag=args.tag)
            if not resp.found:
                print("not found", file=sys.stderr)
                return 1
            print(json.dumps({
                "taskId": resp.task_id,
                "contentLength": resp.content_length,
                "totalPieces": resp.total_pieces,
                "pieceMd5Sign": resp.piece_md5_sign,
            }))
            return 0
        if args.command == "import":
            if not args.path:
                parser.error("import requires --path")
            print(client.import_file(args.path, args.cid, args.tag))
            return 0
        if args.command == "export":
            if not args.path:
                parser.error("export requires --path")
            if not client.export(args.cid, args.path, args.tag):
                print("not found", file=sys.stderr)
                return 1
            return 0
        return 0 if client.delete(args.cid, args.tag) else 1
    finally:
        client.close()


if __name__ == "__main__":
    sys.exit(main())
