"""Multi-process scheduler-CLUSTER load bench — the 100k-peer rung.

Where :mod:`~dragonfly2_tpu_torch.scheduler.loadbench` drives one in-process
``SchedulerService`` (single-replica density), this driver speaks REAL
gRPC to N ``scheduler/replica.py`` subprocesses through the
:class:`~dragonfly2_tpu_torch.scheduler.rpcserver.BalancedSchedulerClient` —
the exact task-affine ring + failover machinery daemons run — so a rung
measures the CLUSTER: ring routing, per-replica contention, cross-
process announce latency, and (on the kill variant) live re-routes.

Rung shape (``run_cluster_rung``):

- ``replicas`` scheduler subprocesses, each with a worker pool sized to
  the driver's concurrency (one open AnnouncePeer stream holds one gRPC
  worker — the fan-out bench lesson) and the interval GC running.
- Tasks pre-seeded over the wire via the real back-to-source path, so
  candidates exist from the first announce; each task's whole peer set
  lands on ONE replica (ring affinity), spreading ``n_tasks`` tasks
  across the cluster.
- ``workers`` driver threads walk peers through the full announce
  ladder over gRPC: register → started → FIRST DECISION (the
  announce-latency stamp) → batched piece reports → finished.
- The handoff-aware chaos variant (``kill_replica=True``) SIGKILLs the
  busiest session-owning replica once ``kill_after_fraction`` of the
  swarm has been driven; the PR-6 failover machinery re-homes in-flight
  peers and the rung bounds the re-route p99 by ``reroute_bound_s``
  (the chaos plane's ``scheduler_grace``).
- Per-replica gauges come from each surviving replica's ``Stats``
  unary: decisions, schedule p99, piece reports, GC pauses, RSS — plus
  a cluster-wide bytes/peer gauge from the per-replica RSS deltas.

``run_cluster_ladder`` wraps a small baseline rung and the big rung and
asserts the documented :data:`~dragonfly2_tpu_torch.scheduler.loadbench.
LADDER_P99_BOUND` ACROSS THE CLUSTER: big-rung announce p99 ≤ 4× the
baseline rung's — including whatever disruption the mid-swarm kill
caused, because a bounded tail under replica loss is the contract.
"""

from __future__ import annotations

import logging
import os
import queue as queue_mod
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional

from dragonfly2_tpu_torch.utils.percentile import percentile

logger = logging.getLogger(__name__)

#: Default cluster shape (ISSUE 11): 4 replicas comfortably own a
#: 100k-peer swarm.
DEFAULT_REPLICAS = 4
#: Re-route bound for the kill variant — the same scheduler_grace the
#: ``bench.py chaos`` scheduler-kill rung bounds (a re-route slower than
#: the grace would have degraded a real conductor to back-to-source).
REROUTE_BOUND_S = 2.0
#: Drive peers of one task at this many so per-announce DAG work stays
#: constant between the baseline and 100k rungs (the loadbench rule).
CLUSTER_PEERS_PER_TASK = 100


class _DecisionChannel:
    """Driver-side announce channel: the GrpcSchedulerClient read loop
    pushes decisions here; one instance per driven peer."""

    __slots__ = ("decisions",)

    def __init__(self) -> None:
        self.decisions: "queue_mod.Queue" = queue_mod.Queue()


def _spawn_cluster(tmp: str, replicas: int, pool_workers: int):
    """Spawn the replica subprocesses; on partial failure kill the ones
    already running (the chaos-rung contract)."""
    from dragonfly2_tpu_torch.client.chaosbench import spawn_scheduler_replica

    procs, targets = [], []
    # GC at a production-shaped cadence (a long rung sees several full
    # passes, so the pause gauges carry real data) but with FINE slices:
    # at 25k peers/replica a 50 ms default slice plus GIL wait is a
    # visible announce-path stall on a small box — 10 ms slices keep
    # each contiguous pause short while total reclaim work is unchanged.
    extra = ["--max-workers", str(pool_workers), "--serve-gc",
             "--gc-interval", "30.0", "--gc-budget-ms", "10"]
    try:
        for i in range(replicas):
            proc, target = spawn_scheduler_replica(
                os.path.join(tmp, f"replica-{i}"), extra_args=extra)
            procs.append(proc)
            targets.append(target)
    except BaseException:
        for proc in procs:
            proc.kill()
            proc.wait()
        raise
    return procs, targets


def _replica_stats(balanced, target: str) -> Optional[dict]:
    try:
        s = balanced.stats_at(target)
    except Exception:  # noqa: BLE001 — dead/killed replica
        return None
    return {
        "hosts": s.hosts, "tasks": s.tasks, "peers": s.peers,
        "rss_mb": s.rss_mb, "peak_rss_mb": s.peak_rss_mb,
        "decisions": s.stats.get("decisions"),
        "schedules": s.stats.get("schedules"),
        "schedule_ms_p99": s.stats.get("schedule_ms_p99"),
        "piece_reports": s.stats.get("piece_reports"),
        "peer_reregistrations": s.stats.get("peer_reregistrations"),
        "gc_ticks": s.stats.get("gc_ticks"),
        "gc_pause_ms_p50": s.stats.get("gc_pause_ms_p50"),
        "gc_pause_ms_p99": s.stats.get("gc_pause_ms_p99"),
        "gc_budget_overruns": s.stats.get("gc_budget_overruns"),
    }


def run_cluster_rung(
    n_peers: int,
    *,
    replicas: int = DEFAULT_REPLICAS,
    # 8 concurrent announce chains: past that the driver saturates a
    # small box's core and the rung measures queueing delay, not the
    # cluster (16 workers measured 4.5× the announce p99 of 8 at the
    # same throughput — CPU-bound either way).
    workers: int = 8,
    peers_per_task: int = CLUSTER_PEERS_PER_TASK,
    pieces_per_peer: int = 2,
    piece_length: int = 4 << 20,
    seeds_per_task: int = 1,
    n_hosts: int = 256,
    kill_replica: bool = False,
    kill_after_fraction: float = 0.5,
    reroute_bound_s: float = REROUTE_BOUND_S,
    decision_timeout_s: float = 30.0,
    warmup_peers: int = 32,
    host_refresh_s: float = 120.0,
    repeats: int = 1,
    deadline_s: float = 0.0,
    root: str | None = None,
) -> Dict[str, object]:
    """One cluster rung; returns metrics + (for the kill variant) the
    re-route verdict inputs. ``deadline_s`` > 0 aborts the drive loop
    when exceeded — the rung then reports ``aborted_budget`` and
    withholds any verdict instead of persisting a starved run.

    ``repeats`` pools that many repetitions of the rung (fresh task
    namespaces, identical per-task DAG size and concurrency) into one
    latency population: the p99 of a single 100-peer rung is literally
    its one unluckiest sample, far too noisy to anchor a 4× bound —
    measured across runs it swung 42–92 ms on an idle box."""
    from dragonfly2_tpu_torch.client.peer_task import (
        CandidateParents,
        NeedBackToSource,
    )
    from dragonfly2_tpu_torch.client.recovery import RecoveryStats
    from dragonfly2_tpu_torch.scheduler.resource.host import Host
    from dragonfly2_tpu_torch.scheduler.rpcserver import BalancedSchedulerClient
    from dragonfly2_tpu_torch.scheduler.service import (
        AnnounceTaskRequest,
        PieceFinished,
        RegisterPeerRequest,
    )
    from dragonfly2_tpu_torch.utils.hosttypes import HostType

    total_peers = n_peers * max(repeats, 1)
    n_tasks = max(1, total_peers // peers_per_task)
    n_hosts = min(n_hosts, total_peers)
    content_length = pieces_per_peer * piece_length
    # Each open announce stream occupies one server worker; the driver
    # can have every worker's stream on one replica in the worst case,
    # plus unary headroom (claims/stats/health never starve — the
    # fan-out bench lesson).
    pool_workers = max(32, workers + 16)

    tmp = root or tempfile.mkdtemp(prefix="df2-cluster-")
    try:
        procs, targets = _spawn_cluster(tmp, replicas, pool_workers)
    except BaseException:
        # The big try/finally below owns the workspace only once the
        # cluster is up — a spawn failure must not leak the tmp tree.
        if root is None:
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    recovery = RecoveryStats()
    balanced = None
    t_begin = time.perf_counter()

    latencies: List[float] = []
    latencies_lock = threading.Lock()
    failures: List[str] = []
    completed = [0]
    decided = [0]
    aborted = [False]
    killed: dict = {}
    kill_stop = threading.Event()

    def drive_warmup(i: int) -> None:
        # Warm the whole path — gRPC channels, server-side numpy
        # scoring, evaluator staging — against a throwaway seeded task
        # so first-call costs never land in a measured rung (the
        # loadbench warmup-rung discipline; cold costs in the SMALL
        # baseline rung would flatter the cluster p99 ratio).
        drive_one(i, task_id=f"cluster-task-{n_tasks:05d}",
                  peer_id=f"cluster-warmup-{i:04d}", record=False)

    def seed_task(t: int) -> None:
        task_id = f"cluster-task-{t:05d}"
        for s in range(seeds_per_task):
            seed_id = f"cluster-seed-{t:05d}-{s}"
            chan = _DecisionChannel()
            balanced.register_peer(
                RegisterPeerRequest(
                    host_id=f"cluster-host-{t % n_hosts:05d}",
                    task_id=task_id, peer_id=seed_id,
                    url=f"https://cluster/{task_id}",
                    piece_length=piece_length),
                channel=chan)
            balanced.download_peer_back_to_source_started(seed_id)
            balanced.download_pieces_finished([
                PieceFinished(peer_id=seed_id, piece_number=k,
                              offset=k * piece_length, length=piece_length,
                              cost_ns=20_000_000,
                              traffic_type="back_to_source")
                for k in range(pieces_per_peer)
            ])
            balanced.download_peer_back_to_source_finished(
                seed_id, content_length, pieces_per_peer)
            # The PR-8/9 daemon contract: a completed replica is
            # announced task-affinely. At the owner this is a counted
            # idempotent upsert — the point is the CLIENT-SIDE record,
            # which lets a membership change re-route this seed to the
            # task's new ring owner (cross-replica seed visibility).
            # Without it, every task orphaned by the replica kill pays
            # the full scheduling retry ladder per remaining peer — the
            # exact tail the cluster p99 bound exists to catch.
            balanced.announce_task(AnnounceTaskRequest(
                host_id=f"cluster-host-{t % n_hosts:05d}",
                task_id=task_id, peer_id=seed_id,
                url=f"https://cluster/{task_id}",
                content_length=content_length,
                total_piece_count=pieces_per_peer))

    def drive_one(i: int, *, task_id: str | None = None,
                  peer_id: str | None = None, record: bool = True) -> None:
        task_id = task_id or f"cluster-task-{i % n_tasks:05d}"
        peer_id = peer_id or f"cluster-peer-{i:06d}"
        chan = _DecisionChannel()
        t0 = time.perf_counter()
        balanced.register_peer(
            RegisterPeerRequest(host_id=f"cluster-host-{i % n_hosts:05d}",
                                task_id=task_id, peer_id=peer_id,
                                url=f"https://cluster/{task_id}",
                                piece_length=piece_length),
            channel=chan)
        balanced.download_peer_started(peer_id)
        try:
            decision = chan.decisions.get(timeout=decision_timeout_s)
        except queue_mod.Empty:
            # The terminal report below still finalizes the session;
            # a decision that never came is the failure we report.
            balanced.download_peer_failed(peer_id)
            raise RuntimeError(f"no decision within {decision_timeout_s}s")
        if record:
            with latencies_lock:
                latencies.append((time.perf_counter() - t0) * 1e3)
                decided[0] += 1
        parent_id = ""
        back_to_source = isinstance(decision, NeedBackToSource)
        if isinstance(decision, CandidateParents) and decision.parents:
            parent_id = decision.parents[0].peer_id
        if back_to_source:
            balanced.download_peer_back_to_source_started(peer_id)
        balanced.download_pieces_finished([
            PieceFinished(peer_id=peer_id, piece_number=k,
                          parent_id=parent_id, offset=k * piece_length,
                          length=piece_length, cost_ns=20_000_000)
            for k in range(pieces_per_peer)
        ])
        if back_to_source:
            balanced.download_peer_back_to_source_finished(
                peer_id, content_length, pieces_per_peer)
        else:
            balanced.download_peer_finished(peer_id, cost_seconds=0.05)

    next_item = [0]
    claim_lock = threading.Lock()

    def worker(drive, total: int) -> None:
        while True:
            with claim_lock:
                i = next_item[0]
                if i >= total or aborted[0]:
                    return
                next_item[0] += 1
            if deadline_s and time.perf_counter() - t_begin > deadline_s:
                aborted[0] = True
                return
            try:
                drive(i)
            except Exception as exc:  # noqa: BLE001 — bench must report
                with latencies_lock:
                    if len(failures) < 8:
                        failures.append(
                            f"{drive.__name__} {i}: "
                            f"{type(exc).__name__}: {exc}")
            else:
                if drive is drive_one:
                    with latencies_lock:
                        completed[0] += 1

    def run_pool(drive, total: int) -> None:
        next_item[0] = 0
        pool = [threading.Thread(target=worker, args=(drive, total),
                                 name=f"cluster-drive-{w}", daemon=True)
                for w in range(min(workers, total))]
        for t in pool:
            t.start()
        for t in pool:
            t.join()

    def killer() -> None:
        """SIGKILL a session-owning replica once the swarm crosses the
        kill fraction — the PR-6 chaos-rung victim rule: PREFER a
        victim whose session count just GREW (a session sampled at the
        tail of its flow can deliver its final report between the count
        and the SIGKILL landing — a no-op kill with zero re-homes that
        voids the verdict — while a fresh register has its whole flow
        ahead); fall back to the busiest owner after a beat without
        growth."""
        threshold = int(total_peers * kill_after_fraction)
        prev = {t: 0 for t in targets}
        last_grown = time.perf_counter()
        while not kill_stop.is_set() and not killed:
            with latencies_lock:
                done = completed[0]
            if done >= threshold:
                counts = {t: 0 for t in targets}
                for tgt in balanced.peer_session_targets():
                    if tgt in counts:
                        counts[tgt] += 1
                alive = [t for t in targets
                         if procs[targets.index(t)].poll() is None]
                grown = [t for t in alive if counts[t] > prev[t]]
                prev = counts
                victim = None
                if grown:
                    last_grown = time.perf_counter()
                    victim = max(grown, key=lambda t: counts[t])
                elif time.perf_counter() - last_grown > 0.5:
                    busiest = max(alive, key=lambda t: counts[t],
                                  default=None)
                    if busiest is not None and counts[busiest] > 0:
                        victim = busiest
                # Otherwise keep polling — the drive loop is mid-swarm,
                # so sessions reappear within a claim cycle.
                if victim is not None and counts[victim] > 0:
                    orphaned = sum(
                        1 for t in range(n_tasks)
                        if balanced.ring.pick(f"cluster-task-{t:05d}")
                        == victim)
                    proc = procs[targets.index(victim)]
                    proc.kill()
                    proc.wait()
                    killed["target"] = victim
                    killed["at_peers"] = done
                    killed["owned_sessions"] = counts[victim]
                    killed["orphaned_tasks"] = orphaned
                    # Handoff-aware driver: a real deployment's
                    # dynconfig observes the death and removes the
                    # target — which is what triggers the cooperative
                    # re-home of in-flight peers AND the seed re-route
                    # of the victim's announced tasks to their new ring
                    # owners. Without this, post-kill registrations of
                    # orphaned tasks land on a replica that has never
                    # heard of them.
                    survivors = [t for t in targets if t != victim]
                    try:
                        balanced.update_targets(survivors)
                        killed["membership_updated"] = True
                    except Exception as exc:  # noqa: BLE001 — reactive
                        # failover still covers the swarm
                        logger.warning("post-kill membership update "
                                       "failed: %s", exc)
                    return
            kill_stop.wait(0.02)

    refresh_stop = threading.Event()

    def make_hosts():
        return [Host(id=f"cluster-host-{h:05d}", hostname=f"ch{h}",
                     ip="10.3.0.1", port=65001, download_port=65002,
                     type=HostType.SUPER_SEED,
                     concurrent_upload_limit=10_000)
                for h in range(n_hosts)]

    def host_refresher() -> None:
        """Real daemons re-announce their host on an interval; without
        the refresh a rung longer than the 6-minute host TTL watches
        the GC declare every fabricated host stale and LEAVE-cascade
        the live swarm mid-measurement (observed: a 100k rung's p99
        blown by its own reclaim flood, not by contention). Staggered:
        a real fleet's announces arrive spread out, and a tight burst
        of n_hosts fan-out RPCs from one thread measurably stalls the
        in-flight announces sharing the box."""
        while not refresh_stop.wait(host_refresh_s):
            for host in make_hosts():
                try:
                    balanced.announce_host(host)
                except Exception:  # noqa: BLE001 — next cycle retries
                    pass
                if refresh_stop.wait(0.02):
                    return

    try:
        balanced = BalancedSchedulerClient(targets, recovery=recovery)
        # Hosts are SHARED across many peers (the driver fabricates
        # n_hosts, not one per peer, to keep the 4-replica host fan-out
        # off the measured path); they get upload-slot headroom so the
        # rung measures control-plane contention, not slot exhaustion
        # on a fabricated host shape.
        for host in make_hosts():
            balanced.announce_host(host)
        refresher = threading.Thread(target=host_refresher, daemon=True,
                                     name="cluster-host-refresh")
        refresher.start()
        run_pool(seed_task, n_tasks + (1 if warmup_peers else 0))
        if warmup_peers:
            run_pool(drive_warmup, warmup_peers)
        seeded_wall = time.perf_counter() - t_begin
        # RSS snapshot AFTER seeding/warmup/host announce — the same
        # discipline as loadbench — so the bytes/peer gauge bills the
        # DRIVEN peers, not the fixture state.
        stats_before = {t: _replica_stats(balanced, t) for t in targets}

        kill_thread = None
        if kill_replica:
            kill_thread = threading.Thread(target=killer, daemon=True,
                                           name="cluster-replica-killer")
            kill_thread.start()

        t_drive = time.perf_counter()
        run_pool(drive_one, total_peers)
        drive_wall = time.perf_counter() - t_drive
        kill_stop.set()
        if kill_thread is not None:
            kill_thread.join(timeout=1.0)
        stale_seed_records: List[str] = []
        if killed:
            victim = killed["target"]

            def stale():
                return [t for t, tgt
                        in balanced.announced_task_targets().items()
                        if tgt == victim]

            if stale():
                # A transiently failed re-route defers to a 30s retry
                # timer the rung won't wait out — sweep the stragglers
                # inline so the verdict judges the machinery, not the
                # timer's phase. Structural check (records still at the
                # victim), not counter arithmetic: an extra tick from
                # the warmup task must not mask one failed move.
                balanced.sweep_seed_reroutes()
            stale_seed_records = stale()

        per_replica = {}
        for t in targets:
            if killed.get("target") == t:
                per_replica[t] = {"killed": True}
                continue
            per_replica[t] = _replica_stats(balanced, t) or {
                "unreachable": True}
    finally:
        kill_stop.set()
        refresh_stop.set()
        if balanced is not None:
            try:
                balanced.close()
            except Exception:  # noqa: BLE001 — teardown best effort
                pass
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if root is None:
            shutil.rmtree(tmp, ignore_errors=True)

    lat = sorted(latencies)
    reroutes = sorted(recovery.reroute_samples())
    reroute_p99_s = percentile(reroutes, 0.99)
    success_rate = round(completed[0] / max(total_peers, 1), 4)
    # Cluster-wide resident gauge: per-replica RSS growth over the
    # driven phase, summed, per peer. A gauge (allocator slack rides
    # along), but measured on the REAL replica processes.
    rss_deltas = {
        t: round(after["rss_mb"] - stats_before[t]["rss_mb"], 1)
        for t, after in per_replica.items()
        if after.get("rss_mb") is not None
        and (stats_before.get(t) or {}).get("rss_mb") is not None
    }
    total_delta_mb = sum(rss_deltas.values())
    out: Dict[str, object] = {
        "peers": n_peers,
        "repeats": max(repeats, 1),
        "samples": total_peers,
        "replicas": replicas,
        "workers": workers,
        "tasks": n_tasks,
        "hosts": n_hosts,
        "pieces_per_peer": pieces_per_peer,
        "seconds": round(drive_wall, 3),
        "seed_seconds": round(seeded_wall, 3),
        "announce_p50_ms": round(percentile(lat, 0.50), 4),
        "announce_p99_ms": round(percentile(lat, 0.99), 4),
        "decided": decided[0],
        "decisions_per_sec": round(decided[0] / max(drive_wall, 1e-9), 1),
        "peers_per_sec": round(completed[0] / max(drive_wall, 1e-9), 1),
        "completed": completed[0],
        "success_rate": success_rate,
        "failures": failures[:8],
        "aborted_budget": aborted[0],
        "per_replica": per_replica,
        "replica_rss_delta_mb": rss_deltas,
        "bytes_per_peer_cluster": round(
            max(total_delta_mb, 0.0) * (1 << 20) / max(completed[0], 1), 1),
        "recovery_counters": {
            k: recovery.get(k)
            for k in ("scheduler_failovers", "scheduler_reregisters",
                      "scheduler_failover_pieces_replayed",
                      "scheduler_handoff_rehomed",
                      "scheduler_handoff_stranded",
                      "seed_tasks_rerouted")
        },
    }
    if kill_replica:
        out["killed"] = killed or None
        out["stale_seed_records"] = stale_seed_records
        out["reroutes"] = len(reroutes)
        out["reroute_p50_ms"] = round(percentile(reroutes, 0.50) * 1e3, 1)
        out["reroute_p99_ms"] = round(reroute_p99_s * 1e3, 1)
        out["reroute_bound_s"] = reroute_bound_s
        # Replica loss surfaces as a REACTIVE/PROACTIVE failover (the
        # victim's in-flight sessions re-homed on failure or stream
        # loss) or as a COOPERATIVE handoff (the driver's membership
        # update re-homed them while draining) — whichever won the
        # race, at least one session must have MOVED.
        rehomed = (recovery.get("scheduler_failovers")
                   + recovery.get("scheduler_handoff_rehomed"))
        out["sessions_rehomed"] = rehomed
        out["kill_verdict_pass"] = bool(
            not aborted[0]
            and killed
            # Exact count, not the rounded rate: round(99998/1e5, 4)
            # is 1.0 — a "100% success" verdict must mean zero failed
            # peers, literally.
            and completed[0] == total_peers
            and rehomed > 0
            and (not reroutes or reroute_p99_s <= reroute_bound_s)
            # Cross-replica seed visibility, proven STRUCTURALLY at
            # rung scale: no announced record may still point at the
            # dead replica (a counter comparison could let an extra
            # warmup-task tick mask one permanently failed move).
            and not stale_seed_records)
    return out


def run_cluster_ladder(
    *,
    baseline_peers: int = 100,
    baseline_repeats: int = 3,
    cluster_peers: int = 100_000,
    replicas: int = DEFAULT_REPLICAS,
    workers: int = 8,
    kill_replica: bool = True,
    deadline_s: float = 0.0,
    **kwargs,
) -> Dict[str, object]:
    """Baseline rung + the big cluster rung (with the mid-swarm replica
    kill), bound by ``LADDER_P99_BOUND`` across the cluster: the big
    rung's announce p99 — INCLUDING kill disruption — must stay within
    4× the baseline rung's. Same-transport comparison: both rungs run
    over real gRPC against the same replica count; the baseline pools
    ``baseline_repeats`` repetitions of the 100-peer rung so its p99 is
    a percentile, not one unlucky sample (see run_cluster_rung)."""
    from dragonfly2_tpu_torch.scheduler.loadbench import LADDER_P99_BOUND

    # ONE budget clock for the whole ladder: each rung resets its own
    # t_begin, so passing deadline_s through verbatim would let the
    # ladder consume up to 2× the budget.
    t0 = time.perf_counter()

    def left() -> float:
        return deadline_s - (time.perf_counter() - t0)

    baseline = run_cluster_rung(
        baseline_peers, replicas=replicas, workers=workers,
        kill_replica=False, repeats=baseline_repeats,
        deadline_s=deadline_s, **kwargs)
    if baseline["aborted_budget"] or (deadline_s and left() < 30.0):
        # The verdict is already unreachable — don't burn minutes of
        # subprocess drive on a big rung whose result cannot be used.
        return {
            "baseline": baseline,
            "cluster": None,
            "ladder_p99_bound": LADDER_P99_BOUND,
            "verdict_skipped_budget": True,
        }
    big = run_cluster_rung(
        cluster_peers, replicas=replicas, workers=workers,
        kill_replica=kill_replica,
        deadline_s=left() if deadline_s else 0.0, **kwargs)
    ratio = round(
        big["announce_p99_ms"] / max(baseline["announce_p99_ms"], 1e-9), 3)
    out = {
        "baseline": baseline,
        "cluster": big,
        "cluster_p99_ratio": ratio,
        "ladder_p99_bound": LADDER_P99_BOUND,
    }
    if big["aborted_budget"]:
        # A starved rung's p99 covers only part of the swarm — an
        # explicit skip, never a verdict (the chaos-rung contract).
        out["verdict_skipped_budget"] = True
        return out
    out["p99_within_bound"] = ratio <= LADDER_P99_BOUND
    out["verdict_pass"] = bool(
        out["p99_within_bound"]
        and big["completed"] == big["samples"]
        and baseline["completed"] == baseline["samples"]
        and (not kill_replica or big.get("kill_verdict_pass")))
    return out
