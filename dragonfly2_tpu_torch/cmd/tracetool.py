"""``df2-trace-tool`` — critical-path analysis of swarm span traces.

Usage::

    df2-trace-tool analyze TRACE_DIR [TRACE_DIR...]   # slowest first
    df2-trace-tool analyze --task-id T --json DIR     # one task, JSON
    df2-trace-tool list DIR                           # one line per task

Reads the rotated ``trace-*.jsonl`` files every service writes under
``--trace-dir`` (tail-sampled: SLO-breaching tasks are always present),
stitches spans by trace id, and names each task's dominant critical-path
contributor (docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("df2-trace-tool")
    sub = parser.add_subparsers(dest="command", required=True)
    for name in ("analyze", "list"):
        p = sub.add_parser(name)
        p.add_argument("paths", nargs="+",
                       help="trace dirs (or span JSONL files)")
        p.add_argument("--task-id", default="",
                       help="only traces of this task id (prefix ok)")
        p.add_argument("--json", action="store_true",
                       help="machine-readable output")
        p.add_argument("--limit", type=int, default=0,
                       help="at most N traces (0 = all)")
    args = parser.parse_args(argv)

    from dragonfly2_tpu_torch.tracetool import analyze_dirs, format_report

    reports = analyze_dirs(args.paths)
    if args.task_id:
        reports = [r for r in reports
                   if r["task_id"].startswith(args.task_id)]
    if args.limit > 0:
        reports = reports[:args.limit]
    if args.command == "list":
        if args.json:
            print(json.dumps([{k: r[k] for k in (
                "trace_id", "task_id", "peer_id", "ttlb_s", "success",
                "tail_reason")} for r in reports], indent=2))
        else:
            for r in reports:
                print(f"{r['trace_id']}  ttlb={r['ttlb_s']:8.3f}s  "
                      f"success={r['success']!s:5}  "
                      f"dominant={r['dominant']['kind']:13}  "
                      f"task={r['task_id'][:32]}")
        return 0
    if args.json:
        print(json.dumps(reports, indent=2))
    else:
        for r in reports:
            print(format_report(r))
            print()
    if not reports:
        print("no task traces found", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
