"""Critical-path analysis over task trace spans (``df2-trace-tool``).

Answers the question the raw counters cannot: *why was THIS task slow?*
Feed it the span JSONL directories a swarm's tracers wrote (every
service may write its own file; spans share one trace id per task via
the ``df2-trace`` propagation) and it reconstructs each task's
timeline — registration, schedule wait, piece fetches with
parent-vs-source and claim attribution, failovers, stalls — and names
the dominant critical-path contributor.

Model: the root span is ``peer_task.run`` (one per task attempt). Its
wall-clock decomposes into

- ``register``      — registration round-trips,
- ``schedule_wait`` — registration → first scheduler decision,
- ``download``      — time ≥1 piece/source fetch was in flight, minus
  stall excess,
- ``fetch_stall``   — per-fetch excess over the trace's typical fetch
  (a mid-stream stall, a dying parent, an injected fault…), attributed
  to the worst span's parent/piece,
- ``failover``      — scheduler re-home windows,
- ``idle``          — root wall-clock covered by none of the above
  (dispatcher starvation, deadline waits, reporter barriers).

The dominant contributor is simply the largest bucket; ``bench.py obs``
asserts an injected mid-download stall is named correctly before any
operator trusts the tool on a real swarm.
"""

from __future__ import annotations

import glob
import json
import os
import statistics
from typing import Dict, Iterable, List, Optional, Tuple

#: Span names that represent bytes actually moving for the task.
FETCH_SPANS = ("piece.fetch", "source.fetch_run")
#: A fetch this much slower than the trace's median counts as stalled…
STALL_FACTOR = 3.0
#: …provided the excess is at least this big (seconds) — median noise
#: on sub-ms fetches must not read as a stall.
STALL_MIN_EXCESS_S = 0.05


def load_spans(paths: Iterable[str]) -> List[dict]:
    """Every span record under the given files/directories (rotated
    ``.1``/``.2`` backups included; malformed lines skipped)."""
    files: List[str] = []
    for path in paths:
        if os.path.isdir(path):
            files.extend(sorted(glob.glob(
                os.path.join(path, "trace-*.jsonl*"))))
        else:
            files.append(path)
    spans: List[dict] = []
    for fname in files:
        try:
            with open(fname) as f:
                for line in f:
                    try:
                        record = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(record, dict) and "trace_id" in record:
                        spans.append(record)
        except OSError:
            continue
    return spans


def group_traces(spans: List[dict]) -> Dict[str, List[dict]]:
    out: Dict[str, List[dict]] = {}
    for span in spans:
        out.setdefault(span["trace_id"], []).append(span)
    for buf in out.values():
        buf.sort(key=lambda s: s.get("start", 0.0))
    return out


def _interval(span: dict) -> Tuple[float, float]:
    start = span.get("start", 0.0)
    return start, start + span.get("duration_ms", 0.0) / 1e3


def _union_seconds(intervals: List[Tuple[float, float]]) -> float:
    if not intervals:
        return 0.0
    intervals = sorted(intervals)
    total = 0.0
    cur_lo, cur_hi = intervals[0]
    for lo, hi in intervals[1:]:
        if lo > cur_hi:
            total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    total += cur_hi - cur_lo
    return total


def _fetch_detail(span: dict) -> str:
    attrs = span.get("attrs") or {}
    if span.get("name") == "piece.fetch":
        return (f"piece {attrs.get('piece')} from parent "
                f"{attrs.get('parent_id') or '?'}")
    return (f"source run [{attrs.get('first')}, "
            f"+{attrs.get('count')}) "
            f"({'claimed' if attrs.get('claimed') else 'local'})")


def analyze_trace(spans: List[dict]) -> Optional[dict]:
    """Timeline + dominant contributor for ONE trace; None when the
    trace has no ``peer_task.run`` root (not a task trace)."""
    roots = [s for s in spans if s.get("name") == "peer_task.run"]
    if not roots:
        return None
    root = roots[0]
    root_lo, root_hi = _interval(root)
    ttlb = max(root_hi - root_lo, 0.0)
    attrs = root.get("attrs") or {}

    def in_root(span: dict) -> bool:
        lo, hi = _interval(span)
        return hi >= root_lo and lo <= root_hi

    by_name: Dict[str, List[dict]] = {}
    for span in spans:
        by_name.setdefault(span.get("name", ""), []).append(span)

    register_s = sum(
        span.get("duration_ms", 0.0) / 1e3
        for span in by_name.get("peer_task.register", ()))
    schedule_wait_s = sum(
        span.get("duration_ms", 0.0) / 1e3
        for span in by_name.get("peer_task.schedule_wait", ()))
    failover_s = sum(
        span.get("duration_ms", 0.0) / 1e3
        for span in by_name.get("sched_client.failover", ()))
    failovers = len(by_name.get("sched_client.failover", ()))

    fetches = [s for name in FETCH_SPANS for s in by_name.get(name, ())
               if in_root(s)]
    durations = [s.get("duration_ms", 0.0) / 1e3 for s in fetches]
    union_fetch = _union_seconds([_interval(s) for s in fetches])
    stalls: List[dict] = []
    stall_s = 0.0
    if len(durations) >= 3:
        median = statistics.median(durations)
        for span, dur in zip(fetches, durations):
            excess = dur - median
            if dur > STALL_FACTOR * median and excess > STALL_MIN_EXCESS_S:
                stall_s += excess
                stalls.append({
                    "span": span.get("name"),
                    "detail": _fetch_detail(span),
                    "seconds": round(excess, 3),
                    "duration_s": round(dur, 3),
                })
    stalls.sort(key=lambda s: -s["seconds"])

    download_s = max(union_fetch - stall_s, 0.0)
    active = [_interval(s) for s in fetches]
    active += [_interval(s) for s in by_name.get("peer_task.register", ())]
    active += [_interval(s)
               for s in by_name.get("peer_task.schedule_wait", ())]
    active += [_interval(s)
               for s in by_name.get("sched_client.failover", ())]
    idle_s = max(ttlb - _union_seconds(
        [(max(lo, root_lo), min(hi, root_hi)) for lo, hi in active
         if hi > root_lo and lo < root_hi]), 0.0)

    contributors = {
        "register": round(register_s, 3),
        "schedule_wait": round(schedule_wait_s, 3),
        "download": round(download_s, 3),
        "fetch_stall": round(stall_s, 3),
        "failover": round(failover_s, 3),
        "idle": round(idle_s, 3),
    }
    dominant_kind = max(contributors, key=lambda k: contributors[k])
    dominant = {
        "kind": dominant_kind,
        "seconds": contributors[dominant_kind],
        "detail": (stalls[0]["detail"]
                   if dominant_kind == "fetch_stall" and stalls else ""),
    }
    services = sorted({s.get("service", "") for s in spans} - {""})
    events = [
        {"name": s.get("name"), "start_offset_s": round(
            _interval(s)[0] - root_lo, 3),
         "attrs": s.get("attrs") or {}}
        for s in spans
        if s.get("name") in ("peer_task.resume", "peer_task.back_to_source",
                             "sched_client.failover")
    ]
    return {
        "trace_id": root["trace_id"],
        "task_id": attrs.get("task_id", ""),
        "peer_id": attrs.get("peer_id", ""),
        "success": attrs.get("success"),
        "degraded": attrs.get("degraded", ""),
        "tail_reason": root.get("tail", ""),
        "ttlb_s": round(ttlb, 3),
        "spans": len(spans),
        "services": services,
        "failovers": failovers,
        "contributors": contributors,
        "dominant": dominant,
        "stalls": stalls[:8],
        "events": events,
    }


def analyze_dirs(paths: Iterable[str]) -> List[dict]:
    """Every task trace found under ``paths``, slowest first."""
    out = []
    for trace_spans in group_traces(load_spans(paths)).values():
        report = analyze_trace(trace_spans)
        if report is not None:
            out.append(report)
    out.sort(key=lambda r: -r["ttlb_s"])
    return out


def format_report(report: dict) -> str:
    lines = [
        f"trace {report['trace_id']}  task {report['task_id'][:24]}  "
        f"peer {report['peer_id'][:24]}",
        f"  ttlb {report['ttlb_s']:.3f}s  success={report['success']}"
        + (f"  degraded={report['degraded']}" if report["degraded"] else "")
        + (f"  tail={report['tail_reason']}" if report["tail_reason"]
           else "")
        + f"  services={','.join(report['services'])}",
        "  contributors: " + "  ".join(
            f"{k}={v:.3f}s" for k, v in report["contributors"].items()),
        f"  dominant: {report['dominant']['kind']} "
        f"({report['dominant']['seconds']:.3f}s)"
        + (f" — {report['dominant']['detail']}"
           if report["dominant"]["detail"] else ""),
    ]
    for stall in report["stalls"][:3]:
        lines.append(f"  stall: +{stall['seconds']:.3f}s {stall['detail']}")
    return "\n".join(lines)
