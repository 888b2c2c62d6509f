"""``df2-store`` — object-gateway client CLI.

Reference counterpart: cmd/dfstore + client/dfstore (S3-ish verbs against
the daemon's object-storage gateway).
"""

from __future__ import annotations

import argparse
import sys

from dragonfly2_tpu_torch.cmd.common import (
    add_common_flags,
    init_logging,
    init_tracing,
    parse_with_config,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("df2-store")
    parser.add_argument("command",
                        choices=["get", "put", "delete", "exist", "copy"])
    parser.add_argument("bucket")
    parser.add_argument("key")
    parser.add_argument("--endpoint", required=True,
                        help="gateway base URL, e.g. http://127.0.0.1:65004")
    parser.add_argument("--path", default="",
                        help="local file (put source / get destination)")
    parser.add_argument("--dest-key", default="",
                        help="destination key (copy)")
    add_common_flags(parser)
    args = parse_with_config(parser, argv)
    init_logging(args.verbose, args.log_dir, service="dfstore")
    init_tracing(args, "dfstore")

    from dragonfly2_tpu_torch.client.objectstorage_gateway import DfstoreClient

    client = DfstoreClient(args.endpoint)
    if args.command == "put":
        if not args.path:
            parser.error("put requires --path")
        with open(args.path, "rb") as f:
            client.put_object(args.bucket, args.key, f.read())
        return 0
    if args.command == "get":
        data = client.get_object(args.bucket, args.key)
        if args.path:
            with open(args.path, "wb") as f:
                f.write(data)
        else:
            sys.stdout.buffer.write(data)
        return 0
    if args.command == "exist":
        exists = client.is_object_exist(args.bucket, args.key)
        print("true" if exists else "false")
        return 0 if exists else 1
    if args.command == "copy":
        if not args.dest_key:
            parser.error("copy requires --dest-key")
        client.copy_object(args.bucket, args.key, args.dest_key)
        return 0
    client.delete_object(args.bucket, args.key)
    return 0


if __name__ == "__main__":
    sys.exit(main())
