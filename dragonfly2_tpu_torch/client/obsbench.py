"""Observability-plane bench — the ``bench.py obs`` stage.

Proves the fleet observability plane (docs/OBSERVABILITY.md) does its
three jobs on a REAL swarm before any operator trusts it on one:

1. **Tail capture** (``run_obs_rung``): a live loopback swarm — an
   in-process scheduler + 2 daemons + an origin — downloads under a
   tail-sampling tracer with a ZERO head fraction. The clean warm-up
   task's trace must be DISCARDED (that is the sampler earning its
   memory bound); a second task disrupted mid-download by a seeded
   ``piece.body`` STALL breaches the task SLO and its FULL trace —
   daemon spans and scheduler spans, ONE trace id — must be promoted
   to disk, and the critical-path analyzer must name the injected
   stall as the dominant contributor.
2. **Prometheus bridge**: every stats block registered on
   ``/debug/vars`` must be scrapeable at ``/metrics`` in parseable
   Prometheus text format.
3. **Overhead contract** (``run_tracing_overhead_guard`` /
   ``run_loopback_overhead_guard``): tracing ON vs OFF must stay
   within ``OBS_OVERHEAD_BOUND`` (1.05×) on the scheduler announce p99
   and on loopback back-to-source MB/s — the PR-13 recorder-guard
   methodology (interleaved arms, best-of-reps statistic, one retry
   with more reps on a first failure).

``check_obs_regression`` re-runs all three against their ABSOLUTE
bounds for the one-command ``bench.py obs --check-regression`` gate.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

from dragonfly2_tpu_torch.utils import faultplan
from dragonfly2_tpu_torch.utils.faultplan import FaultKind, FaultPlan

#: On-vs-off ratio every guarded statistic must hold (announce p99,
#: loopback MB/s).
OBS_OVERHEAD_BOUND = 1.05
#: The rung's task-duration SLO; the injected stall is sized past it.
OBS_SLO_S = 1.0
#: Injected mid-download stall (seconds) — well past the SLO margin,
#: far above any honest loopback fetch.
OBS_STALL_S = 1.6


def _swarm_tracer(trace_dir: str, *, head_fraction: float,
                  slo_s: float = OBS_SLO_S):
    """(tracer, obs_stats) — a tail-sampling tracer scoped to one run."""
    from dragonfly2_tpu_torch.utils.obsstats import ObservabilityStats
    from dragonfly2_tpu_torch.utils.tracing import TailSampler, Tracer

    stats = ObservabilityStats()
    sampler = TailSampler(head_fraction=head_fraction, slow_slo_s=slo_s,
                          stats=stats)
    return Tracer("obs-swarm", out_dir=trace_dir, sampler=sampler,
                  stats=stats), stats


def run_obs_rung(*, size_bytes: int = 2 << 20, piece_size: int = 128 << 10,
                 stall_s: float = OBS_STALL_S, slo_s: float = OBS_SLO_S,
                 seed: int = 0, root: "str | None" = None) -> dict:
    """The tail-capture + analyzer rung (see module docstring)."""
    tmp = root or tempfile.mkdtemp(prefix="df2-obs-")
    try:
        return _obs_rung_in(tmp, size_bytes=size_bytes,
                            piece_size=piece_size, stall_s=stall_s,
                            slo_s=slo_s, seed=seed)
    finally:
        # Owns the workspace end to end: every early-failure return
        # inside the body still cleans up.
        if root is None:
            shutil.rmtree(tmp, ignore_errors=True)


def _obs_rung_in(tmp: str, *, size_bytes: int, piece_size: int,
                 stall_s: float, slo_s: float, seed: int) -> dict:
    from dragonfly2_tpu_torch.client import peer_task as peer_task_mod
    from dragonfly2_tpu_torch.client.chaosbench import MultiBlobServer
    from dragonfly2_tpu_torch.client.daemon import Daemon, DaemonConfig
    from dragonfly2_tpu_torch.client.dataplane import DataPlaneStats
    from dragonfly2_tpu_torch.client.peer_task import PeerTaskOptions
    from dragonfly2_tpu_torch.client.recovery import RecoveryStats
    from dragonfly2_tpu_torch.scheduler.evaluator.base import BaseEvaluator
    from dragonfly2_tpu_torch.scheduler.resource.resource import Resource
    from dragonfly2_tpu_torch.scheduler.scheduling.core import (
        Scheduling,
        SchedulingConfig,
    )
    from dragonfly2_tpu_torch.scheduler.service import SchedulerService
    from dragonfly2_tpu_torch.tracetool import analyze_dirs
    from dragonfly2_tpu_torch.utils import tracing

    import numpy as np

    trace_dir = os.path.join(tmp, "traces")
    blob = np.random.default_rng(seed).bytes(size_bytes)
    want_md5 = hashlib.md5(blob).hexdigest()
    out: dict = {
        "size_bytes": size_bytes, "piece_size": piece_size,
        "stall_s": stall_s, "slo_s": slo_s,
        "failures": [], "verdict_pass": False,
        "warm_trace_dropped": None, "disrupted_trace": {},
        "analyzer": {}, "obs_counters": {}, "metrics_scrape": {},
    }
    tracer, obs_stats = _swarm_tracer(trace_dir, head_fraction=0.0,
                                      slo_s=slo_s)
    prev_tracer = tracing.default_tracer()
    prev_piece_size = peer_task_mod.compute_piece_size
    recovery = RecoveryStats()
    dataplane = DataPlaneStats()
    service = SchedulerService(
        resource=Resource(),
        scheduling=Scheduling(
            BaseEvaluator(),
            SchedulingConfig(retry_interval=0.01,
                             retry_back_to_source_limit=2)))
    options = PeerTaskOptions(native_data_plane=False, timeout=30.0,
                              metadata_poll_interval=0.05)
    daemons = [
        Daemon(service, DaemonConfig(
            storage_root=os.path.join(tmp, name), hostname=name,
            keep_storage=False, task_options=options,
            recovery_stats=recovery, dataplane_stats=dataplane))
        for name in ("obs-a", "obs-b")
    ]
    try:
        tracing.set_default_tracer(tracer)
        # Pin the piece size so the 2 MiB task has enough pieces for a
        # meaningful fetch-duration median (the stall detector's
        # baseline) — the daemon_proc precedent.
        peer_task_mod.compute_piece_size = lambda _len: piece_size
        for d in daemons:
            d.start()
        with MultiBlobServer({"/obs/blob": blob}) as origin:
            url = origin.url("/obs/blob")
            # Warm task: daemon A back-to-sources, becomes the seed.
            # Clean + fast ⇒ its trace must be tail-DROPPED.
            result = daemons[0].download_file(url)
            if not result.success:
                out["failures"].append(f"warm download: {result.error}")
                return out
            if hashlib.md5(result.read_all()).hexdigest() != want_md5:
                out["failures"].append("warm download md5 mismatch")
                return out
            spans_on_disk = _read_spans(trace_dir)
            out["warm_trace_dropped"] = (
                len(spans_on_disk) == 0
                and obs_stats.get("traces_dropped") >= 1)
            if not out["warm_trace_dropped"]:
                out["failures"].append(
                    f"warm trace not dropped ({len(spans_on_disk)} spans "
                    f"on disk, dropped={obs_stats.get('traces_dropped')})")

            # Disrupted task: daemon B pulls P2P from A with ONE seeded
            # mid-download stall on the piece body — past the SLO.
            plan = FaultPlan(seed=seed)
            plan.add("piece.body", FaultKind.STALL, every_nth=1,
                     max_fires=1, delay_s=stall_s)
            faultplan.install(plan)
            t0 = time.perf_counter()
            try:
                result = daemons[1].download_file(url)
            finally:
                faultplan.uninstall()
            ttlb = time.perf_counter() - t0
            out["disrupted_ttlb_s"] = round(ttlb, 3)
            if not result.success:
                out["failures"].append(
                    f"disrupted download: {result.error}")
                return out
            if hashlib.md5(result.read_all()).hexdigest() != want_md5:
                out["failures"].append("disrupted download md5 mismatch")
                return out
            if ttlb <= slo_s:
                out["failures"].append(
                    f"disruption did not breach the SLO "
                    f"({ttlb:.3f}s <= {slo_s}s); stall too small")
    finally:
        peer_task_mod.compute_piece_size = prev_piece_size
        tracing.set_default_tracer(prev_tracer)
        for d in daemons:
            try:
                d.stop()
            except Exception:  # noqa: BLE001 — teardown best effort
                pass
        out["obs_counters"] = obs_stats.snapshot()
    # --- assertions over the captured trace --------------------------
    spans = _read_spans(trace_dir)
    trace_ids = {s["trace_id"] for s in spans}
    names = {s["name"] for s in spans}
    disrupted = {
        "spans": len(spans),
        "trace_ids": len(trace_ids),
        "daemon_spans": sorted(n for n in names
                               if n.startswith(("peer_task.",
                                                "piece."))),
        "scheduler_spans": sorted(n for n in names
                                  if n.startswith("sched.")),
    }
    out["disrupted_trace"] = disrupted
    if len(trace_ids) != 1:
        out["failures"].append(
            f"expected exactly the disrupted task's trace on disk, "
            f"got {len(trace_ids)} trace ids")
    if not disrupted["daemon_spans"] or not disrupted["scheduler_spans"]:
        out["failures"].append(
            "tail-captured trace missing daemon or scheduler spans: "
            f"{sorted(names)}")
    tails = {s.get("tail") for s in spans if s.get("tail")}
    out["tail_reasons"] = sorted(tails)
    if "slow" not in tails:
        out["failures"].append(
            f"disrupted trace not promoted as slow (reasons: {tails})")

    reports = analyze_dirs([trace_dir])
    if not reports:
        out["failures"].append("analyzer found no task trace")
    else:
        report = reports[0]
        out["analyzer"] = {
            "ttlb_s": report["ttlb_s"],
            "contributors": report["contributors"],
            "dominant": report["dominant"],
            "stalls": report["stalls"][:2],
        }
        if report["dominant"]["kind"] != "fetch_stall":
            out["failures"].append(
                "analyzer blamed "
                f"{report['dominant']['kind']} "
                f"({report['contributors']}), expected fetch_stall")
        elif report["dominant"]["seconds"] < 0.5 * stall_s:
            out["failures"].append(
                f"analyzer stall attribution "
                f"{report['dominant']['seconds']}s < half the "
                f"injected {stall_s}s")

    out["metrics_scrape"] = scrape_all_blocks()
    if not out["metrics_scrape"]["all_blocks_exported"]:
        out["failures"].append(
            "blocks missing from /metrics: "
            f"{out['metrics_scrape']['missing_blocks']}")
    out["verdict_pass"] = not out["failures"]
    return out


def _read_spans(trace_dir: str) -> List[dict]:
    from dragonfly2_tpu_torch.tracetool import load_spans

    return load_spans([trace_dir])


def scrape_all_blocks() -> dict:
    """Serve the bridged registry on an ephemeral port, scrape it over
    HTTP, parse the Prometheus text format, and check EVERY registered
    debug-vars block surfaced at least one ``df2_<block>_`` metric."""
    import urllib.request

    from dragonfly2_tpu_torch.utils.prom import text_string_to_metric_families

    from dragonfly2_tpu_torch.utils import prombridge
    from dragonfly2_tpu_torch.utils.debugmon import registered_debug_vars
    from dragonfly2_tpu_torch.utils.metricsserver import MetricsServer

    server = MetricsServer(prombridge.bridge_registry(),
                           host="127.0.0.1", port=0)
    server.start()
    try:
        with urllib.request.urlopen(
                f"http://{server.address}/metrics", timeout=10) as resp:
            text = resp.read().decode()
    finally:
        server.stop()
    families = {f.name for f in text_string_to_metric_families(text)}
    blocks, broken = [], []
    for name, fn in sorted(registered_debug_vars().items()):
        try:
            fn()
        except Exception:  # noqa: BLE001 — the bridge skips these too
            # A raising block is skipped by /debug/vars AND the bridge
            # by design (one bad var must not take down either page);
            # it is "broken", not "missing from /metrics".
            broken.append(name)
        else:
            blocks.append(name)
    missing = [b for b in blocks
               if not any(name.startswith(f"df2_{b}_") or name == f"df2_{b}"
                          for name in families)]
    return {
        "blocks": blocks,
        "broken_blocks": broken,
        "metric_families": len(families),
        "missing_blocks": missing,
        "all_blocks_exported": not missing,
        "text_bytes": len(text),
    }


# ----------------------------------------------------------------------
# Overhead guards (PR-13 recorder-guard methodology)
# ----------------------------------------------------------------------


def run_tracing_overhead_guard(
    *, n_peers: int = 300, workers: int = 2, reps: int = 5,
    bound: float = OBS_OVERHEAD_BOUND, retry_reps: int = 8,
) -> Dict[str, object]:
    """Announce-latency on-vs-off guard: the scheduler ladder's smallest
    rung shape, arms interleaved, statistic = best-of-reps p99 per arm
    (see loadbench.run_recorder_overhead_guard for why the minimum).
    The ON arm runs the production shape: tail sampler, default head
    fraction, JSONL out dir."""
    from dragonfly2_tpu_torch.scheduler.loadbench import run_swarm_bench
    from dragonfly2_tpu_torch.utils import tracing

    tmp = tempfile.mkdtemp(prefix="df2-obs-guard-")
    prev = tracing.default_tracer()
    try:
        # Warmup rung (discarded): first-call numpy/evaluator costs.
        run_swarm_bench(32, workers=2, gc_churn=False)
        rep_p99: Dict[str, List[float]] = {"off": [], "on": []}
        rep_p50: Dict[str, List[float]] = {"off": [], "on": []}
        for rep in range(reps):
            for arm in ("off", "on"):
                if arm == "on":
                    tracer, _stats = _swarm_tracer(
                        os.path.join(tmp, f"on-{rep}"), head_fraction=0.05,
                        slo_s=30.0)
                    tracing.set_default_tracer(tracer)
                else:
                    tracing.set_default_tracer(prev)
                try:
                    rung = run_swarm_bench(n_peers, workers=workers,
                                           gc_churn=False)
                finally:
                    tracing.set_default_tracer(prev)
                rep_p99[arm].append(rung["announce_p99_ms"])
                rep_p50[arm].append(rung["announce_p50_ms"])
        p99_off = min(rep_p99["off"])
        p99_on = min(rep_p99["on"])
        ratio = p99_on / max(p99_off, 1e-9)
        out = {
            "peers": n_peers,
            "reps": reps,
            "workers": workers,
            "statistic": "best_of_reps_p99",
            "announce_p99_off_ms": round(p99_off, 4),
            "announce_p99_on_ms": round(p99_on, 4),
            "announce_p50_off_ms": round(min(rep_p50["off"]), 4),
            "announce_p50_on_ms": round(min(rep_p50["on"]), 4),
            "rep_p99_off_ms": [round(v, 4) for v in rep_p99["off"]],
            "rep_p99_on_ms": [round(v, 4) for v in rep_p99["on"]],
            "p99_ratio": round(ratio, 4),
            "bound": bound,
            "within_bound": ratio <= bound,
        }
        if not out["within_bound"] and retry_reps > reps:
            retried = run_tracing_overhead_guard(
                n_peers=n_peers, workers=workers, reps=retry_reps,
                bound=bound, retry_reps=0)
            retried["first_attempt"] = out
            return retried
        return out
    finally:
        tracing.set_default_tracer(prev)
        shutil.rmtree(tmp, ignore_errors=True)


def run_loopback_overhead_guard(
    *, size_bytes: int = 16 << 20, reps: int = 3,
    bound: float = OBS_OVERHEAD_BOUND, retry_reps: int = 5,
) -> Dict[str, object]:
    """Loopback back-to-source MB/s on-vs-off guard (the daemon-side
    per-run/per-piece span cost), best-of-reps, arms interleaved. The
    ON arm uses head fraction 0.0 — the pure buffering cost, with no
    luck-of-the-trace-id disk writes perturbing a rep."""
    from dragonfly2_tpu_torch.client.dataplane import run_loopback_bench
    from dragonfly2_tpu_torch.utils import tracing

    tmp = tempfile.mkdtemp(prefix="df2-obs-lb-")
    prev = tracing.default_tracer()
    try:
        run_loopback_bench(4 << 20)  # warmup (connection pools, numpy)
        mbps: Dict[str, List[float]] = {"off": [], "on": []}
        for rep in range(reps):
            for arm in ("off", "on"):
                if arm == "on":
                    tracer, _stats = _swarm_tracer(
                        os.path.join(tmp, f"on-{rep}"), head_fraction=0.0,
                        slo_s=30.0)
                    tracing.set_default_tracer(tracer)
                else:
                    tracing.set_default_tracer(prev)
                try:
                    run = run_loopback_bench(size_bytes, seed=rep)
                finally:
                    tracing.set_default_tracer(prev)
                mbps[arm].append(run["mb_per_s"])
        best_off = max(mbps["off"])
        best_on = max(mbps["on"])
        ratio = best_off / max(best_on, 1e-9)
        out = {
            "size_bytes": size_bytes,
            "reps": reps,
            "statistic": "best_of_reps_mb_per_s",
            "mb_per_s_off": round(best_off, 1),
            "mb_per_s_on": round(best_on, 1),
            "rep_mb_per_s_off": [round(v, 1) for v in mbps["off"]],
            "rep_mb_per_s_on": [round(v, 1) for v in mbps["on"]],
            "throughput_ratio": round(ratio, 4),
            "bound": bound,
            "within_bound": ratio <= bound,
        }
        if not out["within_bound"] and retry_reps > reps:
            retried = run_loopback_overhead_guard(
                size_bytes=size_bytes, reps=retry_reps, bound=bound,
                retry_reps=0)
            retried["first_attempt"] = out
            return retried
        return out
    finally:
        tracing.set_default_tracer(prev)
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# Stage assembly + regression gate
# ----------------------------------------------------------------------


def run_obs_stage(*, seed: int = 0) -> dict:
    """Rung + both overhead guards, one combined verdict."""
    rung = run_obs_rung(seed=seed)
    announce = run_tracing_overhead_guard()
    loopback = run_loopback_overhead_guard()
    return {
        "rung": rung,
        "announce_guard": announce,
        "loopback_guard": loopback,
        "verdict_pass": bool(rung["verdict_pass"]
                             and announce["within_bound"]
                             and loopback["within_bound"]),
    }


def best_recorded_obs(state_dir: str) -> Optional[dict]:
    best = None
    for path in glob.glob(os.path.join(state_dir, "obs_run_*.json")):
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        if data.get("skipped") or not data.get("verdict_pass"):
            continue
        ratio = (data.get("announce_guard") or {}).get("p99_ratio")
        if ratio is None:
            continue
        if best is None or ratio < best["announce_p99_ratio"]:
            best = {
                "file": os.path.basename(path),
                "announce_p99_ratio": ratio,
                "loopback_ratio": (data.get("loopback_guard") or {}).get(
                    "throughput_ratio"),
            }
    return best


def check_obs_regression(state_dir: str) -> Dict[str, object]:
    """``bench.py obs --check-regression``: a fresh full stage must hold
    its ABSOLUTE bounds — tail capture + analyzer attribution green,
    every stats block scrapeable, both overhead ratios ≤ 1.05. The best
    record rides along for trend reading (the mlguard gate shape)."""
    fresh = run_obs_stage()
    failures: List[str] = list(fresh["rung"]["failures"])
    if not fresh["announce_guard"]["within_bound"]:
        failures.append(
            f"announce overhead ratio "
            f"{fresh['announce_guard']['p99_ratio']} > "
            f"{OBS_OVERHEAD_BOUND}")
    if not fresh["loopback_guard"]["within_bound"]:
        failures.append(
            f"loopback overhead ratio "
            f"{fresh['loopback_guard']['throughput_ratio']} > "
            f"{OBS_OVERHEAD_BOUND}")
    return {
        "passed": not failures,
        "failures": failures,
        "fresh": {
            "rung_verdict": fresh["rung"]["verdict_pass"],
            "announce_p99_ratio": fresh["announce_guard"]["p99_ratio"],
            "loopback_ratio": fresh["loopback_guard"]["throughput_ratio"],
            "dominant": (fresh["rung"].get("analyzer") or {}).get(
                "dominant"),
        },
        "best_recorded": best_recorded_obs(state_dir),
    }
