"""``df2-replay`` — columnar replay corpus tooling, port of
``dragonfly2_tpu/cmd/replaytool.py``.

Usage::

    python -m dragonfly2_tpu_torch.cmd.replaytool pack SRC [SRC...] -o OUT.npc
    python -m dragonfly2_tpu_torch.cmd.replaytool check PATH [PATH...]
    python -m dragonfly2_tpu_torch.cmd.replaytool stat PATH [PATH...]

``pack`` migrates rotating ``replay*.csv`` corpora (files or storage
directories) into one footer-indexed columnar ``.npc`` segment and
re-opens the result through the structural validator, so the converter
doubles as a round-trip check — a red check deletes nothing and exits
non-zero. ``check`` runs the same validator on existing ``.npc`` files
(truncated files, dirty padding, mask/ordering breaks). ``stat`` prints
decision/candidate counts, the K bucket, and byte sizes. ``check`` and
``stat`` take ``--json``. The files are the JAX package's format: either
package reads what the other wrote.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def _expand_csv_sources(sources) -> list:
    """CSV files from a mix of file paths and storage directories
    (directories contribute their rotated ``replay*.csv`` set, oldest
    backup first so packed seq order matches write order)."""
    paths = []
    for src in sources:
        if os.path.isdir(src):
            rotated = sorted(
                glob.glob(os.path.join(src, "replay*.csv*")),
                reverse=True)
            if not rotated:
                raise SystemExit(f"no replay*.csv files under {src!r}")
            paths.extend(rotated)
        else:
            paths.append(src)
    return paths


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("df2-replay")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("pack", help="CSV corpus -> columnar .npc")
    p.add_argument("sources", nargs="+",
                   help="replay CSV files or storage dirs holding them")
    p.add_argument("-o", "--out", required=True,
                   help="output .npc path")

    for name in ("check", "stat"):
        p = sub.add_parser(name)
        p.add_argument("paths", nargs="+", help="columnar .npc files")
        p.add_argument("--json", action="store_true",
                       help="machine-readable output")
    args = parser.parse_args(argv)

    from dragonfly2_tpu_torch.scheduler.replaystore import (
        ReplayStoreError, check_corpus, open_corpus, pack_csv)

    if args.command == "pack":
        try:
            stats = pack_csv(_expand_csv_sources(args.sources), args.out)
        except (ReplayStoreError, OSError, ValueError) as exc:
            print(f"pack failed: {exc}", file=sys.stderr)
            return 1
        print(json.dumps(stats, indent=2, default=str))
        return 0

    failed = False
    reports = []
    for path in args.paths:
        report = check_corpus(path)
        reports.append(report)
        if args.command == "check":
            if not report["ok"]:
                failed = True
            if not args.json:
                verdict = "ok" if report["ok"] else "CORRUPT"
                line = (f"{path}  {verdict}  "
                        f"decisions={report['decisions']}  "
                        f"candidates={report['candidates']}")
                for err in report["errors"]:
                    line += f"\n  error: {err}"
                for warning in report["warnings"]:
                    line += f"\n  warning: {warning}"
                print(line)
        else:  # stat
            if report["ok"]:
                cc = open_corpus(path)
                report["bytes"] = os.path.getsize(path)
                report["tasks"] = int(len(set(cc.task_id.tolist())))
            if not args.json:
                if report["ok"]:
                    print(f"{path}  decisions={report['decisions']}  "
                          f"candidates={report['candidates']}  "
                          f"k={report['k']}  "
                          f"back_to_source={report['back_to_source']}  "
                          f"outcomes={report['outcomes']}  "
                          f"tasks={report['tasks']}  "
                          f"bytes={report['bytes']}")
                else:
                    failed = True
                    print(f"{path}  UNREADABLE: {report['errors']}")
    if args.json:
        print(json.dumps(reports, indent=2, default=str))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
