"""In-process swarm load benchmark for the scheduler control plane.

Drives the REAL :class:`~dragonfly2_tpu_torch.scheduler.service.SchedulerService`
— sharded resource managers, scheduling core, rule evaluator — with N
hosts × M concurrent worker threads, each peer walking the full announce
ladder (register → download_started → schedule_candidate_parents →
batched piece reports, PR-3 form → finished), while an optional GC-churn
thread hammers the incremental sweeps. This is the control-plane sibling
of the serving ladder (``measure_colocated``) and the data plane's
loopback bench (``run_loopback_bench``): ``bench.py``'s ``scheduler``
stage runs it over a swarm-size ladder, and the tier-1 smoke test runs a
tiny swarm asserting counters only.

What a rung reports (all measured, no synthetic sleeps):

- ``announce_p50_ms`` / ``announce_p99_ms`` — register→first-decision
  latency per peer (the announce→decision number the ladder bounds).
- ``decisions_per_sec`` / ``piece_reports_per_sec`` — control-plane
  throughput over the driven phase.
- ``gc_pause_p50_ms`` / ``gc_pause_p99_ms`` / ``gc_budget_overruns`` —
  incremental-GC tick pauses under announce load.
- the hermetic :class:`~dragonfly2_tpu_torch.scheduler.controlstats.
  ControlPlaneStats` snapshot (filter/evaluate timings, bad-node
  fast/slow split, back-to-source verdicts).

Swarm shape: peers are spread over tasks at ``peers_per_task`` so the
per-announce candidate work (a filter over one task's DAG) stays
constant across rungs — the ladder measures control-plane CONTENTION
(locks, GC interference, shared state) at growing swarm sizes, not
growing per-task DAGs. Each task is pre-seeded with ``seeds_per_task``
seed peers via the real back-to-source path so candidates exist from the
first announce. A ``leave_fraction`` of peers drops without a leave RPC
(FSM → Leave, the same state a stale host cascade produces) so the GC
sweeps have real reclaim work, not just scan work.
"""

from __future__ import annotations

import threading
from time import perf_counter
from typing import Dict, List, Optional

import numpy as np

from dragonfly2_tpu_torch.scheduler.controlstats import ControlPlaneStats
from dragonfly2_tpu_torch.scheduler.evaluator import BaseEvaluator
from dragonfly2_tpu_torch.scheduler.resource.host import Host
from dragonfly2_tpu_torch.scheduler.resource.resource import Resource, ResourceConfig
from dragonfly2_tpu_torch.scheduler.scheduling.core import Scheduling, SchedulingConfig
from dragonfly2_tpu_torch.scheduler.service import (
    PieceFinished,
    RegisterPeerRequest,
    SchedulerService,
)
from dragonfly2_tpu_torch.utils.hosttypes import HostType
from dragonfly2_tpu_torch.utils.meminfo import peak_rss_mb, reset_peak_rss, rss_mb
from dragonfly2_tpu_torch.utils.percentile import percentile

DEFAULT_PEERS_PER_TASK = 500

# Pre-slimming resident cost of one registered peer, measured with the
# same tracemalloc probe tests/test_scheduler_cluster.py runs (10k
# registrations against a live SchedulerService, before __slots__ /
# shared FSM tables / lazy cost windows landed). Recorded in every
# rung's JSON next to the measured bytes_per_peer gauge so "measurably
# below the pre-slimming baseline" is a number in the artifact, not a
# claim in a doc.
PRE_SLIM_BYTES_PER_PEER = 7883.0


class _DecisionRecorder:
    """Announce channel double: stamps each peer's FIRST decision."""

    def __init__(self) -> None:
        self.decided_at: Dict[str, float] = {}
        self.parents: Dict[str, List[str]] = {}
        self.back_to_source: set[str] = set()

    def send_candidate_parents(self, peer, parents) -> bool:
        self.decided_at.setdefault(peer.id, perf_counter())
        self.parents[peer.id] = [p.id for p in parents]
        return True

    def send_need_back_to_source(self, peer, description) -> bool:
        self.decided_at.setdefault(peer.id, perf_counter())
        self.back_to_source.add(peer.id)
        return True


#: Per-piece base cost in the synthetic swarm (constant profile).
BASE_PIECE_COST_NS = 20_000_000

#: Fraction of hosts the "profiled" cost model makes pathologically slow
#: (8-20x base cost) — the realized-cost outliers the replay plane's
#: bad-node metrics and the learned cost model need to exist at all.
PROFILED_BAD_HOST_FRACTION = 0.15


def _host_cost_factors(n_hosts: int, seed: int) -> np.ndarray:
    """Seeded per-host piece-cost multipliers for the "profiled" cost
    model: most hosts 0.7-1.6x base, a slice pathologically slow."""
    rng = np.random.default_rng(seed)
    return np.where(rng.random(n_hosts) < PROFILED_BAD_HOST_FRACTION,
                    rng.uniform(8.0, 20.0, n_hosts),
                    rng.uniform(0.7, 1.6, n_hosts))


def run_swarm_bench(
    n_peers: int = 1000,
    *,
    workers: int = 8,
    n_hosts: Optional[int] = None,
    peers_per_task: int = DEFAULT_PEERS_PER_TASK,
    pieces_per_peer: int = 4,
    piece_length: int = 4 << 20,
    seeds_per_task: int = 3,
    leave_fraction: float = 0.25,
    shard_count: int = 8,
    gc_budget_s: float = 0.005,
    gc_churn: bool = True,
    recorder=None,
    cost_profile: str = "constant",
    profile_seed: int = 0,
    return_latencies: bool = False,
) -> Dict[str, object]:
    """One swarm rung against a fresh SchedulerService; returns metrics.

    ``recorder`` installs a replay-plane :class:`~dragonfly2_tpu_torch.
    scheduler.replaylog.ReplayRecorder` on the scheduling core (decision
    events + outcomes captured; None = the default zero-work path).
    ``cost_profile="profiled"`` replaces the constant per-piece cost
    with seeded per-host multipliers — fast seeds, ordinary peers, and a
    slice of pathologically slow hosts — and embeds the slowness signal
    into the host's upload-failure counters so it is LEARNABLE from the
    canonical features (the corpus the learned cost model trains on).
    """
    if n_hosts is None:
        n_hosts = n_peers  # one dfdaemon per peer, the common shape
    n_tasks = max(1, n_peers // peers_per_task)
    profiled = cost_profile == "profiled"
    factors = _host_cost_factors(n_hosts, profile_seed) if profiled else None

    stats = ControlPlaneStats()  # hermetic: not the process-global block
    if recorder is not None:
        # Rung-scoped counters, same as every other component here; the
        # recorder has not captured anything yet (the contract on
        # rebind_stats).
        recorder.rebind_stats(stats)
    resource = Resource(
        ResourceConfig(shard_count=shard_count, gc_budget_s=gc_budget_s),
        stats=stats)
    scheduling = Scheduling(
        BaseEvaluator(stats=stats),
        SchedulingConfig(retry_interval=0.002), stats=stats,
        recorder=recorder)
    svc = SchedulerService(resource, scheduling, stats=stats)
    recorder_chan = _DecisionRecorder()

    hosts = []
    for i in range(n_hosts):
        host = Host(id=f"bench-host-{i:06d}", hostname=f"bh{i}",
                    ip="10.1.0.1", port=65001, download_port=65002)
        if profiled:
            # The slowness signal must be visible in the canonical
            # features or no model could learn it: slow hosts fail
            # uploads proportionally more.
            host.upload_count = 200
            host.upload_failed_count = int(
                200 * min(float(factors[i]) / 25.0, 0.9))
        hosts.append(host)

    # -- pre-seed every task through the real back-to-source path ----------
    content_length = pieces_per_peer * piece_length
    for t in range(n_tasks):
        task_id = f"bench-task-{t:04d}"
        for s in range(seeds_per_task):
            host = Host(id=f"bench-seed-host-{t:04d}-{s}", hostname="seed",
                        ip="10.2.0.1", port=65001, download_port=65002,
                        type=HostType.SUPER_SEED)
            svc.announce_host(host)
            seed_id = f"bench-seed-{t:04d}-{s}"
            svc.register_peer(
                RegisterPeerRequest(host_id=host.id, task_id=task_id,
                                    peer_id=seed_id,
                                    url=f"https://bench/{task_id}",
                                    piece_length=piece_length),
                channel=recorder_chan)
            svc.download_peer_back_to_source_started(seed_id)
            # Profiled seeds are FAST (half base cost) — the realized
            # corpus should reward them like the real swarm does.
            seed_cost_ns = (int(BASE_PIECE_COST_NS * 0.5) if profiled
                            else BASE_PIECE_COST_NS)
            svc.download_pieces_finished([
                PieceFinished(peer_id=seed_id, piece_number=k,
                              offset=k * piece_length, length=piece_length,
                              cost_ns=seed_cost_ns,
                              traffic_type="back_to_source")
                for k in range(pieces_per_peer)
            ])
            svc.download_peer_back_to_source_finished(
                seed_id, content_length, pieces_per_peer)

    # -- concurrent announce workers ---------------------------------------
    latencies: List[float] = []
    latencies_lock = threading.Lock()
    next_peer = [0]
    claim_lock = threading.Lock()
    errors: List[str] = []

    def drive_one(i: int) -> None:
        task_id = f"bench-task-{i % n_tasks:04d}"
        host = hosts[i % n_hosts]
        peer_id = f"bench-peer-{i:06d}"
        t0 = perf_counter()
        svc.announce_host(host)
        svc.register_peer(
            RegisterPeerRequest(host_id=host.id, task_id=task_id,
                                peer_id=peer_id,
                                url=f"https://bench/{task_id}",
                                piece_length=piece_length),
            channel=recorder_chan)
        svc.download_peer_started(peer_id)
        decided = recorder_chan.decided_at.get(peer_id)
        if decided is not None:
            with latencies_lock:
                latencies.append((decided - t0) * 1e3)
        if peer_id in recorder_chan.back_to_source:
            svc.download_peer_back_to_source_started(peer_id)
            parent_id = ""
        else:
            parents = recorder_chan.parents.get(peer_id) or []
            parent_id = parents[0] if parents else ""
        factor = float(factors[i % n_hosts]) if profiled else 1.0
        svc.download_pieces_finished([
            PieceFinished(peer_id=peer_id, piece_number=k,
                          parent_id=parent_id, offset=k * piece_length,
                          length=piece_length,
                          # Deterministic per-piece jitter keeps the
                          # Welford spread nonzero without an RNG on
                          # the driven path.
                          cost_ns=int(BASE_PIECE_COST_NS * factor
                                      * (1.0 + 0.03 * (k % 3 - 1))))
            for k in range(pieces_per_peer)
        ])
        if peer_id in recorder_chan.back_to_source:
            svc.download_peer_back_to_source_finished(
                peer_id, content_length, pieces_per_peer)
        else:
            svc.download_peer_finished(peer_id, cost_seconds=0.1)
        if leave_fraction > 0 and i % max(int(1 / leave_fraction), 1) == 0:
            # Drop without a leave RPC — the FSM state a stale-host
            # cascade produces — so the GC sweep has reclaim work.
            peer = resource.peer_manager.load(peer_id)
            if peer is not None:
                peer.leave()

    def worker() -> None:
        while True:
            with claim_lock:
                i = next_peer[0]
                if i >= n_peers:
                    return
                next_peer[0] += 1
            try:
                drive_one(i)
            except Exception as exc:  # noqa: BLE001 — bench must report
                if len(errors) < 8:
                    errors.append(f"peer {i}: {type(exc).__name__}: {exc}")

    stop_gc = threading.Event()

    def gc_loop() -> None:
        managers = (resource.host_manager, resource.task_manager,
                    resource.peer_manager)
        while not stop_gc.is_set():
            for manager in managers:
                manager.run_gc()
            stop_gc.wait(0.002)

    gc_thread = None
    if gc_churn:
        gc_thread = threading.Thread(target=gc_loop, name="bench-gc",
                                     daemon=True)
        gc_thread.start()

    # Resident-bytes gauge: RSS delta across the driven phase / peers.
    # A gauge, not an exact accounting — allocator slack and freed-but-
    # retained arenas ride along — but it is the number that actually
    # bounds how many peers one replica can hold, which is the point.
    # The kernel peak-RSS watermark is reset so peak_rss_mb covers THIS
    # rung, not whatever an earlier bench stage drove the process to;
    # when the kernel refuses, the scope is labeled process-lifetime.
    peak_is_rung_scoped = reset_peak_rss()
    rss_before_mb = rss_mb()

    t_start = perf_counter()
    threads = [threading.Thread(target=worker, name=f"bench-announce-{w}")
               for w in range(min(workers, n_peers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = perf_counter() - t_start

    if gc_thread is not None:
        stop_gc.set()
        gc_thread.join(timeout=5)

    if recorder is not None:
        # Finalize stragglers (error'd peers) and flush the durable log
        # so the rung's corpus is complete the moment this returns.
        recorder.finalize_all()
        recorder.flush()
    rss_after_mb = rss_mb()
    snap = stats.snapshot()
    lat = sorted(latencies)
    out = {
        "peers": n_peers,
        "hosts": n_hosts,
        "tasks": n_tasks,
        "peers_per_task": peers_per_task,
        "workers": len(threads),
        "seconds": round(wall, 3),
        "announce_p50_ms": round(percentile(lat, 0.50), 4),
        "announce_p99_ms": round(percentile(lat, 0.99), 4),
        "decisions": snap["decisions"],
        "decisions_per_sec": round(snap["decisions"] / max(wall, 1e-9), 1),
        "piece_reports": snap["piece_reports"],
        "piece_reports_per_sec": round(
            snap["piece_reports"] / max(wall, 1e-9), 1),
        "back_to_source": snap["back_to_source"],
        "schedules": snap["schedules"],
        "filter_ms_p99": snap["filter_ms_p99"],
        "evaluate_ms_p99": snap["evaluate_ms_p99"],
        "bad_node_fast": snap["bad_node_fast"],
        "bad_node_slow": snap["bad_node_slow"],
        "gc_ticks": snap["gc_ticks"],
        "gc_budget_overruns": snap["gc_budget_overruns"],
        "gc_reclaimed": snap["gc_reclaimed"],
        "gc_pause_p50_ms": snap["gc_pause_ms_p50"],
        "gc_pause_p99_ms": snap["gc_pause_ms_p99"],
        "peak_rss_mb": round(peak_rss_mb(), 1),
        "peak_rss_scope": "rung" if peak_is_rung_scoped else "process",
        "rss_delta_mb": round(rss_after_mb - rss_before_mb, 1),
        "bytes_per_peer": round(
            max(rss_after_mb - rss_before_mb, 0.0) * (1 << 20)
            / max(n_peers, 1), 1),
        # Methodologies differ and the artifact says so: the gauge is a
        # whole-process RSS delta (allocator slack rides along), the
        # baseline was tracemalloc over pure registrations — the
        # apples-to-apples pre/post-slimming comparison is the
        # tracemalloc regression test, this pair is the operator-facing
        # density signal.
        "bytes_per_peer_method": "rss_delta",
        "bytes_per_peer_pre_slim_baseline": PRE_SLIM_BYTES_PER_PEER,
        "bytes_per_peer_pre_slim_method": "tracemalloc_registration",
        "replay_decisions": snap["replay_decisions"],
        "replay_finalized": snap["replay_finalized"],
        "replay_evicted": snap["replay_evicted"],
        "replay_appends_batched": snap["replay_appends_batched"],
        "errors": errors,
    }
    if return_latencies:
        out["latencies_ms"] = lat
    return out


# The documented ladder bound (docs/SCHEDULER.md): the largest rung's
# announce→decision p99 must stay within this factor of the smallest
# rung's. Per-task DAGs are capped (peers_per_task), so growth past the
# bound means control-plane contention — shard locks, GC pauses — is
# scaling with swarm size, which is exactly the regression this ladder
# exists to catch.
LADDER_P99_BOUND = 4.0

# Default single-replica ladder. The 25k rung (ISSUE 11) exists so one
# replica's density is proven before the 4-replica cluster rung claims
# 100k; bench.py trims the ladder under budget pressure and `--rungs`
# overrides it from the CLI.
DEFAULT_LADDER_SIZES = (100, 1000, 5000, 25000)

# `bench.py scheduler --check-regression` bounds (vs the best persisted
# scheduler_run_*.json record): a fresh top-rung run may not fall below
# half the recorded decision throughput, nor double the recorded
# announce p99. Wide enough to absorb box noise; a real control-plane
# regression (a lock re-serialized, an O(n) filter) blows straight
# through either.
REGRESSION_DECISIONS_FRACTION = 0.5
REGRESSION_P99_FACTOR = 2.0


def run_swarm_ladder(sizes=DEFAULT_LADDER_SIZES, **kwargs) -> Dict[str, object]:
    """The bench stage's ladder: one rung per swarm size + the p99 bound
    verdict comparing the largest rung against the smallest."""
    # Per-task DAG size must be EQUAL across rungs or the ratio compares
    # per-announce work, not contention: cap peers_per_task at the
    # smallest rung so every rung runs tasks of identical size.
    kwargs.setdefault("peers_per_task",
                      min(DEFAULT_PEERS_PER_TASK, min(sizes)))
    # Warmup rung (discarded): first-call numpy/evaluator costs would
    # otherwise land entirely in the smallest rung's p99 and flatter the
    # ladder ratio.
    run_swarm_bench(32, workers=2, gc_churn=False)
    ladder = {}
    for n in sizes:
        ladder[str(n)] = run_swarm_bench(n, **kwargs)
    smallest, largest = str(sizes[0]), str(sizes[-1])
    p99_small = ladder[smallest]["announce_p99_ms"]
    p99_large = ladder[largest]["announce_p99_ms"]
    ratio = round(p99_large / max(p99_small, 1e-9), 3)
    return {
        "ladder": ladder,
        "decision_p99_ratio": ratio,
        "ladder_p99_bound": LADDER_P99_BOUND,
        "p99_within_bound": ratio <= LADDER_P99_BOUND,
    }


# Recorder overhead guard (docs/REPLAY.md): announce p99 with the
# replay recorder installed may exceed the recorder-off p99 by at most
# this factor. Off = recorder None = the zero-work path (one `is not
# None` check per decision, the faultplan ACTIVE-is-None discipline).
RECORDER_OVERHEAD_BOUND = 1.05


def run_recorder_overhead_guard(
    *, n_peers: int = 300, workers: int = 2, reps: int = 5,
    bound: float = RECORDER_OVERHEAD_BOUND, retry_reps: int = 8,
) -> Dict[str, object]:
    """Recorder on-vs-off announce-latency comparison on the scheduler
    ladder's smallest-rung shape.

    Statistic: per arm, the BEST (minimum) of ``reps`` interleaved
    repetitions' announce p99s — the PR-7 upload-bench best-of-N
    discipline. On a small box the tail is periodically contaminated by
    multi-ms scheduler stalls that hit either arm at random (measured
    off-vs-off: medians flap past 5%, pooled p99s past 60%, per-arm
    minima stay within ~2%); the minimum is each arm's cleanest
    observation and still carries any REAL per-announce overhead, which
    is a constant addition no lucky rep can hide. Arms alternate so box
    drift lands on both equally; GC churn is off so the measurement
    isolates the recorder, not GC-vs-capture-thread interference.

    A first measurement over the bound reruns ONCE with ``retry_reps``
    repetitions and takes that verdict — min-of-N tightens with N, so
    the retry only filters tail contamination; a real regression shows
    in both passes, and both are recorded in the result
    (``first_attempt``)."""
    from dragonfly2_tpu_torch.scheduler.replaylog import ReplayRecorder

    # Warmup rung (discarded): first-call numpy/evaluator costs must
    # not land in either arm.
    run_swarm_bench(32, workers=2, gc_churn=False)
    rep_p99: Dict[str, List[float]] = {"off": [], "on": []}
    rep_p50: Dict[str, List[float]] = {"off": [], "on": []}
    for _ in range(reps):
        for arm in ("off", "on"):
            rec = ReplayRecorder() if arm == "on" else None
            rung = run_swarm_bench(n_peers, workers=workers,
                                   gc_churn=False, recorder=rec)
            rep_p99[arm].append(rung["announce_p99_ms"])
            rep_p50[arm].append(rung["announce_p50_ms"])
            if rec is not None:
                rec.close()
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
        retried = run_recorder_overhead_guard(
            n_peers=n_peers, workers=workers, reps=retry_reps,
            bound=bound, retry_reps=0)
        retried["first_attempt"] = out
        return retried
    return out


def best_recorded_scheduler_run(state_dir: str):
    """Best persisted ``scheduler_run_*.json`` (written by bench.py on
    green ladder runs): the record with the LARGEST top rung, tiebroken
    by decisions/sec — a trimmed dev-box record (``--rungs 100,400``)
    posts higher decisions/sec on its tiny rung than the real 25k
    record and must not displace it as the gate's reference."""
    import glob
    import json
    import os

    best = None
    for path in glob.glob(os.path.join(state_dir, "scheduler_run_*.json")):
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        ladder = (data.get("ladder") or {}).get("ladder") or {}
        if not ladder:
            continue
        size = max(ladder, key=lambda k: int(k))
        rung = ladder[size]
        dps = rung.get("decisions_per_sec", 0)
        if dps and (best is None
                    or (int(size), dps)
                    > (best["rung"], best["decisions_per_sec"])):
            best = {
                "file": os.path.basename(path),
                "rung": int(size),
                "decisions_per_sec": dps,
                "announce_p99_ms": rung.get("announce_p99_ms"),
                "bytes_per_peer": rung.get("bytes_per_peer"),
                "peers_per_task": rung.get("peers_per_task"),
            }
    return best


def check_scheduler_regression(
    state_dir: str, *,
    decisions_fraction: float = REGRESSION_DECISIONS_FRACTION,
    p99_factor: float = REGRESSION_P99_FACTOR,
) -> Dict[str, object]:
    """``bench.py scheduler --check-regression``: a fresh run of the
    best record's TOP RUNG vs that record. Fails (CLI exit 1) when the
    fresh run delivers under ``decisions_fraction`` of the recorded
    decisions/sec or over ``p99_factor``× the recorded announce p99 —
    the same gate shape the dataplane/chaos/fanout stages already
    carry."""
    best = best_recorded_scheduler_run(state_dir)
    if best is None:
        # Nothing recorded yet: check the ladder's own documented bound.
        fresh = run_swarm_ladder((100, 1000, 5000), workers=8)
        return {
            "fresh_decision_p99_ratio": fresh["decision_p99_ratio"],
            "best_recorded": None,
            "passed": bool(fresh["p99_within_bound"]),
            "note": "no persisted record; checked the 4x ladder bound only",
        }
    # Same shape the ladder ran the record with: warmup discarded, and
    # per-task DAGs matching the RECORD's (a record from a custom
    # --rungs ladder may have run bigger tasks — comparing against a
    # different per-announce workload would gate on the mismatch, not
    # on a regression).
    run_swarm_bench(32, workers=2, gc_churn=False)
    fresh = run_swarm_bench(
        best["rung"], workers=8,
        peers_per_task=(best.get("peers_per_task")
                        or min(DEFAULT_PEERS_PER_TASK,
                               DEFAULT_LADDER_SIZES[0])))
    out = {
        "rung": best["rung"],
        "fresh_decisions_per_sec": fresh["decisions_per_sec"],
        "fresh_announce_p99_ms": fresh["announce_p99_ms"],
        "fresh_bytes_per_peer": fresh["bytes_per_peer"],
        "best_recorded": best,
        "decisions_fraction": decisions_fraction,
        "p99_factor": p99_factor,
    }
    out["passed"] = bool(
        not fresh["errors"]
        and fresh["decisions_per_sec"]
        >= decisions_fraction * best["decisions_per_sec"]
        and fresh["announce_p99_ms"]
        <= p99_factor * max(best["announce_p99_ms"] or 0.0, 1e-9))
    return out
