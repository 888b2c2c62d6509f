"""Geo-hierarchical multi-site swarm bench — ``bench.py``'s ``geo`` stage.

The workload is ROADMAP open item 3's traffic shape: the ISSUE-9
checkpoint fan-out, but spread across 2–3 *sites* joined by emulated
WAN links (utils/geoplan.py) instead of one flat loopback mesh. Every
daemon process carries a ``--cluster-id``, the scheduler elects ONE
bridge peer per (task, cluster) that is allowed to cross the WAN, and
everyone else is steered to same-cluster parents — so the stage proves
the ISSUE-18 claim directly:

- **WAN amplification** — cross-cluster bytes ÷ checkpoint size, summed
  from every process's geoplan snapshot. A flat mesh pays ≈ one WAN
  crossing per *peer*; bridge election bounds it near one per
  *cluster*. The verdict bound is the ISSUE contract,
  ``1 + #clusters`` (:func:`wan_amplification_bound`).
- **per-site TTLB** — wall time until the LAST daemon in each site
  holds the last byte (from the same PROGRESS byte clock the fan-out
  ladder uses).
- **bridge-election counts** — scheduler-side grants (a cross-cluster
  candidate kept because it held/won the bridge lease) vs denials
  (steered back to the local mesh).
- **cross-site preheat** (largest rung): per-cluster seed daemons
  registered via ``SchedulerService.register_seed_client`` and warmed
  with ``preheat(url, cluster=...)`` — a warm fleet's swarm phase
  must then stay essentially WAN-silent AND origin-silent.
- **site-partition chaos rung**: one site is cut mid-swarm (its links
  flip to ``partitioned`` via a GEO re-send). The surviving sites
  finish 100%; the victim's downloads fail with real refusals/resets,
  then — after heal — resume over the crash-safe persisted-piece path
  within :data:`RESUME_BOUND_S`.

A green run persists to ``artifacts/bench_state/geo_run_*.json`` and
``bench.py geo --check-regression`` gates future PRs against the best
record (parity with the dataplane/fanout gates). Design details in
docs/GEO.md.
"""

from __future__ import annotations

import hashlib
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Sequence

from dragonfly2_tpu_torch.client.fanoutbench import (
    ThrottledCheckpointOrigin,
    make_checkpoint,
)
from dragonfly2_tpu_torch.utils.geoplan import LinkSpec

MiB = 1 << 20

#: Emulated sites. Three (the acceptance shape): one will usually hold
#: the origin's back-to-source claimant, the other two cross the WAN
#: through their elected bridges.
DEFAULT_SITES = ("site-a", "site-b", "site-c")
#: Ladder rungs as daemons PER SITE (total = per_site × len(sites)).
DEFAULT_PER_SITE_RUNGS = (2, 4)
#: Checkpoint shape — smaller than the fan-out ladder's: the measured
#: quantity here is WAN crossings, not raw mesh throughput.
DEFAULT_SHARDS = 2
DEFAULT_SHARD_BYTES = 12 * MiB
DEFAULT_PIECE_SIZE = 2 * MiB
DEFAULT_ORIGIN_RATE_BPS = 10 * MiB
#: Emulated WAN link shape (every directed cross-site pair).
WAN_LATENCY_S = 0.01
WAN_JITTER_S = 0.002
WAN_BANDWIDTH_BPS = 12 * MiB
#: Preheated rung: swarm-phase WAN bytes ÷ checkpoint must stay below
#: this (every site already holds the bytes), and origin bytes below
#: the fraction bound.
PREHEAT_WAN_FRACTION_BOUND = 0.5
PREHEAT_ORIGIN_FRACTION_BOUND = 0.05
#: Partition rung: seconds from heal to the LAST victim-site success.
RESUME_BOUND_S = 90.0
#: Regression gate (parity with fanout): fresh largest-rung TTLB and
#: WAN amplification must stay within 1/fraction of the best record.
GEO_REGRESSION_FRACTION = 0.5


def wan_amplification_bound(n_sites: int) -> float:
    """The ISSUE-18 contract: WAN bytes ÷ checkpoint bytes must stay
    ≤ ``1 + #clusters`` — one bounded crossing per cluster plus slack,
    instead of one per peer."""
    return 1.0 + n_sites


def build_site_plans(site_addrs: Dict[str, Sequence[str]], *, seed: int = 0,
                     latency_s: float = WAN_LATENCY_S,
                     jitter_s: float = WAN_JITTER_S,
                     bandwidth_bps: float = WAN_BANDWIDTH_BPS,
                     partitioned_sites: Sequence[str] = ()) -> Dict[str, dict]:
    """One GEO wire-form plan per site, sharing the same address map,
    link shapes and seed (so per-link decision streams agree across the
    fleet — the GeoPlan contract). ``partitioned_sites`` flips every
    link touching those sites, both directions — the partition rung's
    trigger is re-installing the result."""
    links: Dict[str, dict] = {}
    for src in site_addrs:
        for dst in site_addrs:
            if src == dst:
                continue
            links[f"{src}|{dst}"] = LinkSpec(
                latency_s=latency_s, jitter_s=jitter_s,
                bandwidth_bps=bandwidth_bps,
                partitioned=(src in partitioned_sites
                             or dst in partitioned_sites)).to_dict()
    clusters = {site: sorted(addrs) for site, addrs in site_addrs.items()}
    return {site: {"cluster": site, "seed": seed, "clusters": clusters,
                   "links": links}
            for site in site_addrs}


def _geo_scheduler(total_procs: int):
    """Scheduler service + gRPC server for a geo fleet; returns
    ``(service, sched_stats, server)``. Same retry/pool sizing lessons
    as the fan-out ladder (fanoutbench.py)."""
    from dragonfly2_tpu_torch.rpc import serve
    from dragonfly2_tpu_torch.scheduler import controlstats
    from dragonfly2_tpu_torch.scheduler.evaluator.base import BaseEvaluator
    from dragonfly2_tpu_torch.scheduler.resource.resource import Resource
    from dragonfly2_tpu_torch.scheduler.rpcserver import (
        SCHEDULER_SPEC,
        SchedulerRpcService,
    )
    from dragonfly2_tpu_torch.scheduler.scheduling.core import (
        Scheduling,
        SchedulingConfig,
    )
    from dragonfly2_tpu_torch.scheduler.service import SchedulerService

    sched_stats = controlstats.ControlPlaneStats()
    service = SchedulerService(
        resource=Resource(),
        scheduling=Scheduling(
            BaseEvaluator(),
            SchedulingConfig(retry_interval=0.05, retry_limit=60,
                             retry_back_to_source_limit=8),
            stats=sched_stats,
        ),
        stats=sched_stats,
    )
    server = serve([(SCHEDULER_SPEC, SchedulerRpcService(service))],
                   max_workers=4 * total_procs + 64)
    return service, sched_stats, server


def _geo_proc_kwargs(piece_size: int, *, timeout: float = 300.0,
                     fallback_wait: float = 120.0) -> dict:
    """DaemonProc kwargs shared by every geo fleet — the fan-out
    ladder's tuning (slow shared origin, cold multi-proc spawn wave)
    with the rung-appropriate conductor timeout."""
    return dict(
        piece_size=piece_size, native=True, timeout=timeout,
        poll_interval=0.03, piece_concurrency=2,
        fallback_wait=fallback_wait, scheduler_grace=30.0,
        startup_timeout=240.0,
    )


def _spawn_site_fleet(tmp: str, target: str, sites: Sequence[str],
                      per_site: int, proc_kwargs: dict):
    """Spawn ``per_site`` daemon_proc children per site, each carrying
    its site as ``--cluster-id``. Returns ``(procs_by_site, errors)``;
    spawn runs threaded because a cold multi-proc wave on a small box
    serializes multi-second interpreter startups."""
    import os

    from dragonfly2_tpu_torch.client.chaosbench import DaemonProc

    procs_by_site: Dict[str, List] = {site: [] for site in sites}
    errors: List[str] = []
    lock = threading.Lock()

    def spawn(site: str, idx: int) -> None:
        try:
            proc = DaemonProc(
                os.path.join(tmp, f"{site}-d{idx}"), [target],
                hostname=f"geo-{site}-{idx}",
                extra_args=("--cluster-id", site), **proc_kwargs)
        except Exception as exc:  # noqa: BLE001 — surfaced by caller
            with lock:
                errors.append(f"{site}/d{idx}: {exc}")
            return
        with lock:
            procs_by_site[site].append(proc)

    threads = [threading.Thread(target=spawn, args=(site, i))
               for site in sites for i in range(per_site)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return procs_by_site, errors


def _retire(procs: Sequence) -> None:
    stoppers = [threading.Thread(target=lambda p=p: _exit_or_kill(p))
                for p in procs]
    for t in stoppers:
        t.start()
    for t in stoppers:
        t.join()


def _exit_or_kill(proc) -> None:
    try:
        proc.exit(timeout=10.0)
    except Exception:  # noqa: BLE001 — teardown best effort
        proc.kill()


def _sum_geo_stats(procs: Sequence) -> Dict[str, int]:
    """Fleet-wide WAN accounting + data-plane byte split, summed from
    each process's STATS reply (receiver-side geoplan snapshots)."""
    totals = {"wan_bytes": 0, "wan_dials": 0, "wan_refused": 0,
              "wan_resets": 0, "p2p_bytes": 0, "source_bytes": 0}
    for proc in procs:
        try:
            stats = proc.stats(timeout=10.0)
        except Exception:  # noqa: BLE001 — stats are best effort
            continue
        geo = stats.get("geo", {})
        for key in ("wan_bytes", "wan_dials", "wan_refused", "wan_resets"):
            totals[key] += geo.get(key, 0)
        snap = stats.get("data_plane", {})
        totals["p2p_bytes"] += snap.get("parent_bytes", 0)
        totals["source_bytes"] += snap.get("source_bytes", 0)
    return totals


def run_geo_rung(per_site: int, blobs: Dict[str, bytes], *,
                 sites: Sequence[str] = DEFAULT_SITES,
                 preheated: bool = False, seed: int = 0,
                 md5_sample: int = 1,
                 piece_size: int = DEFAULT_PIECE_SIZE,
                 origin_rate_bps: float = DEFAULT_ORIGIN_RATE_BPS,
                 wan_bandwidth_bps: float = WAN_BANDWIDTH_BPS,
                 root: str | None = None) -> dict:
    """One geo rung: ``per_site`` daemon_proc children per site, every
    cross-site byte shaped + counted by each process's installed
    GeoPlan, every daemon pulling every shard. The origin and the
    scheduler live in THIS process and stay outside the plan — origin
    egress is accounted separately (same split the ISSUE bound draws:
    origin ≈ 1×, WAN ≤ #clusters×). ``preheated`` first warms one seed
    daemon per site through the per-cluster preheat path, then
    measures the swarm phase only."""
    import os
    import random

    n_sites = len(sites)
    n_daemons = per_site * n_sites
    checkpoint_bytes = sum(len(b) for b in blobs.values())
    tmp = root or tempfile.mkdtemp(prefix="df2-geo-")
    service, sched_stats, server = _geo_scheduler(
        n_daemons + (n_sites if preheated else 0))
    proc_kwargs = _geo_proc_kwargs(piece_size)
    out: dict = {
        "sites": list(sites),
        "per_site": per_site,
        "daemons": n_daemons,
        "shards": len(blobs),
        "checkpoint_bytes": checkpoint_bytes,
        "preheated": preheated,
        "failures": [],
        # Complete-on-failure shape (the PR-8 chaos-rung lesson): every
        # key a consumer reads exists before the first early return.
        "downloads": 0,
        "success_rate": 0.0,
        "ttlb_s": None,
        "site_ttlb_s": {},
        "wan_bytes": None,
        "wan_dials": None,
        "wan_refused": None,
        "wan_amplification": None,
        "wan_amplification_bound": wan_amplification_bound(n_sites),
        "origin_bytes": None,
        "origin_amplification": None,
        "p2p_bytes": None,
        "source_bytes": None,
        "bridge_grants": None,
        "bridge_denials": None,
    }
    procs_by_site: Dict[str, List] = {}
    seed_procs: Dict[str, object] = {}
    try:
        with ThrottledCheckpointOrigin(
                blobs, rate_bps=origin_rate_bps) as origin:
            if preheated:
                from dragonfly2_tpu_torch.client.chaosbench import DaemonProc
                from dragonfly2_tpu_torch.client.rpcserver import (
                    GrpcSeedPeerClient,
                )

                for site in sites:
                    sp = DaemonProc(
                        os.path.join(tmp, f"seed-{site}"), [server.target],
                        hostname=f"geo-seed-{site}", serve_rpc=True,
                        host_type="super",
                        extra_args=("--cluster-id", site), **proc_kwargs)
                    seed_procs[site] = sp
                    service.register_seed_client(
                        site, GrpcSeedPeerClient([sp.rpc_target]))
                warm0 = time.perf_counter()
                for path in blobs:
                    for site in sites:
                        service.preheat(origin.url(path), cluster=site)
                out["preheat_seconds"] = round(
                    time.perf_counter() - warm0, 3)
                out["preheat_origin_bytes"] = origin.counters()[
                    "bytes_served"]
                # The swarm phase below measures ONLY post-warm egress.
                origin.reset_counters()

            procs_by_site, spawn_errs = _spawn_site_fleet(
                tmp, server.target, sites, per_site, proc_kwargs)
            if spawn_errs:
                out["failures"] = spawn_errs[:8]
                return out

            site_addrs = {
                site: [p.address for p in procs_by_site[site]]
                for site in sites}
            for site, sp in seed_procs.items():
                site_addrs[site].append(sp.address)
            plans = build_site_plans(site_addrs, seed=seed,
                                     bandwidth_bps=wan_bandwidth_bps)
            for site in sites:
                for proc in procs_by_site[site]:
                    proc.geo_install(plans[site])
            for site, sp in seed_procs.items():
                sp.geo_install(plans[site])

            failures: List[str] = []
            fail_lock = threading.Lock()
            want_md5 = {path: hashlib.md5(blob).hexdigest()
                        for path, blob in blobs.items()}
            finish_at: Dict[str, List[float]] = {
                site: [0.0] * per_site for site in sites}
            t0 = time.perf_counter()

            def drive(site: str, site_idx: int, idx: int) -> None:
                proc = procs_by_site[site][idx]
                rng = random.Random(seed * 1009 + site_idx * 101 + idx)
                order = list(blobs)
                rng.shuffle(order)
                for path in order:
                    proc.download(origin.url(path))
                    try:
                        result = proc.result(timeout=proc_kwargs["timeout"])
                    except Exception:  # noqa: BLE001 — queue timeout
                        with fail_lock:
                            failures.append(
                                f"{site}/d{idx} {path}: no result")
                        continue
                    if not result.get("ok"):
                        with fail_lock:
                            failures.append(f"{site}/d{idx} {path}: "
                                            f"{result.get('error')}")
                    elif idx < md5_sample:
                        if result.get("md5") != want_md5[path]:
                            with fail_lock:
                                failures.append(
                                    f"{site}/d{idx} {path}: md5 mismatch")
                stamps = list(proc.progress_at.values())
                finish_at[site][idx] = ((max(stamps) - t0) if stamps
                                        else time.perf_counter() - t0)

            drivers = [threading.Thread(
                target=drive, args=(site, si, i),
                name=f"geo-{site}-{i}")
                for si, site in enumerate(sites)
                for i in range(per_site)]
            for t in drivers:
                t.start()
                time.sleep(0.02)  # rollout stagger (fanout lesson)
            for t in drivers:
                t.join()
            origin_counters = origin.counters()
            all_procs = ([p for plist in procs_by_site.values()
                          for p in plist] + list(seed_procs.values()))
            totals = _sum_geo_stats(all_procs)
    finally:
        _retire([p for plist in procs_by_site.values() for p in plist]
                + list(seed_procs.values()))
        server.stop()
        if root is None:
            shutil.rmtree(tmp, ignore_errors=True)

    sched_snap = sched_stats.snapshot()
    site_ttlb = {site: round(max(stamps), 3)
                 for site, stamps in finish_at.items()}
    out.update({
        "downloads": n_daemons * len(blobs),
        "failures": failures[:8],
        "success_rate": round(
            1.0 - len(failures) / max(n_daemons * len(blobs), 1), 4),
        "ttlb_s": round(max(site_ttlb.values()), 3),
        "site_ttlb_s": site_ttlb,
        "wan_bytes": totals["wan_bytes"],
        "wan_dials": totals["wan_dials"],
        "wan_refused": totals["wan_refused"],
        "wan_amplification": round(
            totals["wan_bytes"] / checkpoint_bytes, 3),
        "origin_bytes": origin_counters["bytes_served"],
        "origin_amplification": round(
            origin_counters["bytes_served"] / checkpoint_bytes, 3),
        "p2p_bytes": totals["p2p_bytes"],
        "source_bytes": totals["source_bytes"],
        "bridge_grants": sched_snap.get("bridge_grants", 0),
        "bridge_denials": sched_snap.get("bridge_denials", 0),
    })
    return out


def run_geo_partition_rung(*, per_site: int = 2,
                           sites: Sequence[str] = DEFAULT_SITES,
                           seed: int = 0,
                           shard_bytes: int = 16 * MiB,
                           piece_size: int = 1 * MiB,
                           origin_rate_bps: float = 20 * MiB,
                           wan_bandwidth_bps: float = 6 * MiB,
                           resume_bound_s: float = RESUME_BOUND_S,
                           root: str | None = None) -> dict:
    """Site-partition chaos rung. The origin is pinned into the FIRST
    site's cluster (so a partitioned site cannot quietly fall back to
    source — exactly what a real WAN cut does), the LAST site is the
    victim. Mid-swarm, every plan is re-installed with the victim's
    links partitioned: surviving sites must finish 100% while the
    victim's downloads fail with real refusals/resets. After heal, the
    victim re-issues the same downloads and must finish — resuming
    from its crash-safe persisted pieces — within ``resume_bound_s``
    of the heal."""
    victim = sites[-1]
    survivors = [s for s in sites if s != victim]
    blobs = make_checkpoint(1, shard_bytes, seed)
    checkpoint_bytes = sum(len(b) for b in blobs.values())
    tmp = root or tempfile.mkdtemp(prefix="df2-geo-part-")
    n_daemons = per_site * len(sites)
    _service, sched_stats, server = _geo_scheduler(n_daemons)
    # Short conductor timeout: a partitioned victim must FAIL (and
    # surface its RESULT) quickly, not sit out a 5-minute deadline.
    proc_kwargs = _geo_proc_kwargs(piece_size, timeout=40.0,
                                   fallback_wait=8.0)
    out: dict = {
        "sites": list(sites),
        "victim": victim,
        "per_site": per_site,
        "checkpoint_bytes": checkpoint_bytes,
        "resume_bound_s": resume_bound_s,
        "failures": [],
        "partition_after_s": None,
        "survivor_success_rate": 0.0,
        "victim_failed_during_partition": 0,
        "victim_prepartition_ok": 0,
        "victim_partial_bytes": [],
        "victim_resume_seconds": None,
        "victim_wan_refused": None,
        "verdict_pass": False,
    }
    procs_by_site: Dict[str, List] = {}
    try:
        with ThrottledCheckpointOrigin(
                blobs, rate_bps=origin_rate_bps) as origin:
            procs_by_site, spawn_errs = _spawn_site_fleet(
                tmp, server.target, sites, per_site, proc_kwargs)
            if spawn_errs:
                out["failures"] = spawn_errs[:8]
                return out
            path = next(iter(blobs))
            url = origin.url(path)
            origin_addr = f"127.0.0.1:{origin.port}"
            site_addrs: Dict[str, List[str]] = {
                site: [p.address for p in procs_by_site[site]]
                for site in sites}
            # Pin the origin into the first site: victim back-to-source
            # now rides (and is cut with) the WAN like everything else.
            site_addrs[sites[0]].append(origin_addr)
            healthy = build_site_plans(site_addrs, seed=seed,
                                       bandwidth_bps=wan_bandwidth_bps)
            cut = build_site_plans(site_addrs, seed=seed,
                                   bandwidth_bps=wan_bandwidth_bps,
                                   partitioned_sites=(victim,))
            all_procs = [p for plist in procs_by_site.values()
                         for p in plist]
            for site in sites:
                for proc in procs_by_site[site]:
                    proc.geo_install(healthy[site])

            t0 = time.perf_counter()
            for proc in all_procs:
                proc.download(url)

            # Cut once the victim is mid-flight (first landed bytes).
            victim_procs = procs_by_site[victim]
            deadline = time.perf_counter() + 30.0
            while time.perf_counter() < deadline:
                if any(p.progress_of(url) > 0 for p in victim_procs):
                    break
                time.sleep(0.05)
            for site in sites:
                for proc in procs_by_site[site]:
                    proc.geo_install(cut[site])
            out["partition_after_s"] = round(time.perf_counter() - t0, 3)

            survivor_failures: List[str] = []
            for site in survivors:
                for i, proc in enumerate(procs_by_site[site]):
                    try:
                        result = proc.result(timeout=120.0)
                    except Exception:  # noqa: BLE001 — queue timeout
                        survivor_failures.append(f"{site}/d{i}: no result")
                        continue
                    if not result.get("ok"):
                        survivor_failures.append(
                            f"{site}/d{i}: {result.get('error')}")
            n_survivors = per_site * len(survivors)
            out["survivor_success_rate"] = round(
                1.0 - len(survivor_failures) / max(n_survivors, 1), 4)
            out["failures"] += survivor_failures[:8]

            # Victim verdicts during the cut: ok only if it finished
            # before the partition landed; otherwise a failed RESULT.
            need_resume: List[int] = []
            for i, proc in enumerate(victim_procs):
                try:
                    result = proc.result(
                        timeout=proc_kwargs["timeout"] + 45.0)
                except Exception:  # noqa: BLE001 — queue timeout
                    out["failures"].append(
                        f"{victim}/d{i}: no partition-phase result")
                    continue
                if result.get("ok"):
                    out["victim_prepartition_ok"] += 1
                else:
                    out["victim_failed_during_partition"] += 1
                    need_resume.append(i)
            out["victim_partial_bytes"] = [
                victim_procs[i].progress_of(url) for i in need_resume]

            # Heal, then re-issue: the conductor restart must find the
            # persisted pieces (PR-8 crash-safe path) and finish within
            # the documented bound.
            for site in sites:
                for proc in procs_by_site[site]:
                    proc.geo_install(healthy[site])
            heal_t0 = time.perf_counter()
            for i in need_resume:
                victim_procs[i].download(url)
            resume_failures: List[str] = []
            want_md5 = hashlib.md5(blobs[path]).hexdigest()
            for i in need_resume:
                try:
                    result = victim_procs[i].result(
                        timeout=resume_bound_s + 45.0)
                except Exception:  # noqa: BLE001 — queue timeout
                    resume_failures.append(f"{victim}/d{i}: no resume")
                    continue
                if not result.get("ok"):
                    resume_failures.append(
                        f"{victim}/d{i}: {result.get('error')}")
                elif result.get("md5") != want_md5:
                    resume_failures.append(f"{victim}/d{i}: md5 mismatch")
            out["victim_resume_seconds"] = round(
                time.perf_counter() - heal_t0, 3)
            out["failures"] += resume_failures[:8]

            totals = _sum_geo_stats(victim_procs)
            out["victim_wan_refused"] = totals["wan_refused"]
            out["verdict_pass"] = bool(
                not survivor_failures
                and not resume_failures
                and out["victim_failed_during_partition"] >= 1
                and out["victim_resume_seconds"] <= resume_bound_s)
            if out["victim_failed_during_partition"] == 0:
                out["failures"].append(
                    "partition landed after every victim finished — "
                    "no resume path exercised")
    finally:
        _retire([p for plist in procs_by_site.values() for p in plist])
        server.stop()
        if root is None:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


def run_geo_ladder(per_site_rungs: Sequence[int] = DEFAULT_PER_SITE_RUNGS,
                   *, sites: Sequence[str] = DEFAULT_SITES,
                   shards: int = DEFAULT_SHARDS,
                   shard_bytes: int = DEFAULT_SHARD_BYTES,
                   piece_size: int = DEFAULT_PIECE_SIZE,
                   origin_rate_bps: float = DEFAULT_ORIGIN_RATE_BPS,
                   seed: int = 0, time_left=None) -> dict:
    """Cold rungs smallest→largest, a preheated variant at the largest
    rung, then the site-partition chaos rung. ``time_left`` (callable
    returning remaining seconds) lets the bench stage skip later rungs
    EXPLICITLY — a skipped rung records ``skipped`` and withholds the
    verdict, never a silent pass."""
    blobs = make_checkpoint(shards, shard_bytes, seed)
    checkpoint_bytes = sum(len(b) for b in blobs.values())
    n_sites = len(sites)
    ladder: Dict[str, dict] = {}
    preheated: dict | None = None
    partition: dict | None = None
    skipped: List[str] = []

    # Budget heuristic per rung: one origin pass + the WAN crossings at
    # link rate + fleet bytes at a conservative aggregate mesh rate +
    # spawn/teardown slack.
    def rung_budget(per_site: int) -> float:
        total = per_site * n_sites
        return (checkpoint_bytes / origin_rate_bps
                + n_sites * checkpoint_bytes / WAN_BANDWIDTH_BPS
                + total * checkpoint_bytes / (40 * MiB) + 60.0)

    for per_site in sorted(per_site_rungs):
        if time_left is not None and time_left() < rung_budget(per_site):
            skipped.append(f"cold-{per_site}")
            continue
        ladder[str(per_site)] = run_geo_rung(
            per_site, blobs, sites=sites, seed=seed,
            piece_size=piece_size, origin_rate_bps=origin_rate_bps)
    top_rung = max(per_site_rungs)
    if time_left is not None and time_left() < rung_budget(top_rung) + 30.0:
        skipped.append(f"preheated-{top_rung}")
    else:
        preheated = run_geo_rung(
            top_rung, blobs, sites=sites, preheated=True, seed=seed,
            piece_size=piece_size, origin_rate_bps=origin_rate_bps)
    if time_left is not None and time_left() < 240.0:
        skipped.append("partition")
    else:
        partition = run_geo_partition_rung(sites=sites, seed=seed)

    out = {
        "sites": list(sites),
        "rungs": sorted(per_site_rungs),
        "shards": shards,
        "checkpoint_bytes": checkpoint_bytes,
        "piece_size": piece_size,
        "origin_rate_mb_per_s": round(origin_rate_bps / MiB, 1),
        "wan_bandwidth_mb_per_s": round(WAN_BANDWIDTH_BPS / MiB, 1),
        "ladder": ladder,
        "preheated": preheated,
        "partition": partition,
        "skipped_rungs": skipped,
        "wan_amplification_bound": wan_amplification_bound(n_sites),
        "preheat_wan_fraction_bound": PREHEAT_WAN_FRACTION_BOUND,
        "preheat_origin_fraction_bound": PREHEAT_ORIGIN_FRACTION_BOUND,
        "resume_bound_s": RESUME_BOUND_S,
    }
    largest = str(top_rung)
    cold_complete = all(str(r) in ladder for r in per_site_rungs)
    if cold_complete:
        top = ladder[largest]
        out["cold_wan_amplification_at_max"] = top["wan_amplification"]
        out["cold_verdict_pass"] = bool(
            all(r["success_rate"] >= 1.0 for r in ladder.values())
            and top["wan_amplification"]
            <= wan_amplification_bound(n_sites)
            # Zero grants means zero sanctioned WAN parents — the
            # bridge machinery never engaged and the bound is vacuous.
            and top["bridge_grants"] >= 1)
    if preheated is not None:
        wan_fraction = preheated["wan_bytes"] / checkpoint_bytes
        origin_fraction = preheated["origin_bytes"] / checkpoint_bytes
        out["preheat_wan_fraction"] = round(wan_fraction, 5)
        out["preheat_origin_fraction"] = round(origin_fraction, 5)
        out["preheat_verdict_pass"] = bool(
            preheated["success_rate"] >= 1.0
            and wan_fraction <= PREHEAT_WAN_FRACTION_BOUND
            and origin_fraction <= PREHEAT_ORIGIN_FRACTION_BOUND)
    # The combined verdict exists ONLY when nothing was skipped — a
    # budget-starved run must never persist as green.
    if (cold_complete and preheated is not None and partition is not None
            and not skipped):
        out["verdict_pass"] = bool(
            out["cold_verdict_pass"] and out["preheat_verdict_pass"]
            and partition["verdict_pass"])
    return out


def best_recorded_geo(state_dir: str) -> "dict | None":
    """Best persisted green geo run (lowest largest-rung cold TTLB)
    from artifacts/bench_state/geo_run_*.json."""
    import glob
    import json as json_mod
    import os

    best = None
    for path in glob.glob(os.path.join(state_dir, "geo_run_*.json")):
        try:
            with open(path) as f:
                run = json_mod.load(f)
        except (OSError, ValueError):
            continue
        if not run.get("verdict_pass"):
            continue
        largest = str(max(run.get("rungs", [0])))
        top = (run.get("ladder") or {}).get(largest)
        if not top:
            continue
        record = {
            "path": path,
            "ttlb_s": top["ttlb_s"],
            "wan_amplification": top["wan_amplification"],
        }
        if best is None or record["ttlb_s"] < best["ttlb_s"]:
            best = record
    return best


def check_geo_regression(
        state_dir: str, *,
        fraction: float = GEO_REGRESSION_FRACTION) -> dict:
    """``bench.py geo --check-regression`` — fresh ladder vs the best
    persisted record. Fails when the fresh run loses its verdict
    (including the partition rung), or the largest cold rung's TTLB /
    WAN amplification degrade past ``1/fraction``× the record (the
    absolute ``1 + #clusters`` bound still applies via the verdict)."""
    best = best_recorded_geo(state_dir)
    fresh = run_geo_ladder(seed=0)
    largest = str(max(fresh["rungs"]))
    top = fresh["ladder"].get(largest, {})
    out = {
        "fresh_verdict_pass": fresh.get("verdict_pass", False),
        "fresh_ttlb_s": top.get("ttlb_s"),
        "fresh_wan_amplification": top.get("wan_amplification"),
        "fresh_partition_pass": (fresh.get("partition") or {}).get(
            "verdict_pass"),
        "best_recorded": best,
        "fraction": fraction,
    }
    passed = bool(fresh.get("verdict_pass"))
    if best is None:
        out["note"] = ("no persisted record; gate covers the absolute "
                       "ladder bounds only")
    else:
        passed = passed and (
            top.get("ttlb_s", float("inf")) <= best["ttlb_s"] / fraction
            and top.get("wan_amplification", float("inf"))
            <= best["wan_amplification"] / fraction)
    out["passed"] = passed
    return out
