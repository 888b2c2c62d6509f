"""Fleet-scale checkpoint fan-out ladder — ``bench.py``'s ``fanout`` stage.

The workload is ROADMAP item 4's traffic shape: ONE throttled origin
holding a multi-file sharded model checkpoint, and a fleet of N daemons
that all need every shard — exactly what pushing LLM weights to an
inference fleet looks like. The stage proves the ISSUE-9 dissemination
engine (scheduler-coordinated disjoint source claims + partial peers
serving while they download + rarest-first piece dispatch) makes the
fan-out scale SUBLINEARLY in fleet size:

- **time-to-last-byte (TTLB)** per fleet rung (4 / 16 / 32 daemons) —
  the wall time until the LAST daemon holds the LAST byte,
- **origin-egress amplification** — origin bytes served ÷ checkpoint
  size (a stampede would be ≈N×; the dissemination pipeline holds it
  near 1×),
- **P2P share** — fraction of delivered bytes that came peer-to-peer,
- **per-daemon MB/s** over each daemon's own completion time.

Documented bounds (the stage verdict in the bench JSON):

- cold: amplification ≤ :data:`AMPLIFICATION_BOUND` (2.0) at the
  largest rung AND TTLB(32) ≤ :data:`TTLB_RATIO_BOUND` (3×) TTLB(4) —
  the fleet grew 8× but the cold-start time budget grew ≤3×,
- preheated (manager preheat → seed trigger → re-announce): origin
  bytes ≤ :data:`PREHEAT_ORIGIN_FRACTION_BOUND` of the checkpoint
  (~zero — a preheated fleet never touches origin).

A green run persists to ``artifacts/bench_state/fanout_run_*.json`` and
``bench.py fanout --check-regression`` gates future PRs against the
best record (parity with the dataplane/chaos gates). Design details in
docs/FANOUT.md.
"""

from __future__ import annotations

import hashlib
import shutil
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler
from typing import Dict, List, Sequence

from dragonfly2_tpu_torch.utils.httpserver import ThreadedHTTPService
from dragonfly2_tpu_torch.utils.percentile import percentile
from dragonfly2_tpu_torch.utils.ratelimit import Limiter

MiB = 1 << 20

#: Cold-rung origin-egress bound at the largest fleet rung.
AMPLIFICATION_BOUND = 2.0
#: TTLB(largest rung) must stay within this multiple of TTLB(smallest).
TTLB_RATIO_BOUND = 3.0
#: Preheated rung: origin bytes ÷ checkpoint size must stay below this.
PREHEAT_ORIGIN_FRACTION_BOUND = 0.01
#: Fleet rungs (daemon counts), smallest first.
DEFAULT_RUNGS = (4, 16, 32)
#: Checkpoint shape: ``DEFAULT_SHARDS`` files of ``DEFAULT_SHARD_BYTES``
#: each — ≥256 MiB total, range-request heavy at 2 MiB pieces.
DEFAULT_SHARDS = 4
DEFAULT_SHARD_BYTES = 64 * MiB
DEFAULT_PIECE_SIZE = 4 * MiB
#: Origin uplink throttle. The checkpoint takes ≥ size/rate seconds to
#: leave the origin ONCE — the dissemination pipeline's job is to make
#: that single pass feed the whole fleet. 5 MiB/s models a deliberately
#: modest origin (a cloud bucket egress cap / a WAN link): the
#: interesting regime is the one where a stampede would hurt.
DEFAULT_ORIGIN_RATE_BPS = 5 * MiB
#: Regression gate (parity with dataplane/chaos): fresh TTLB and
#: amplification must stay within 1/fraction of the best record.
FANOUT_REGRESSION_FRACTION = 0.5


class ThrottledCheckpointOrigin(ThreadedHTTPService):
    """Range-capable loopback origin for a sharded checkpoint with a
    GLOBAL uplink throttle and egress counters — the measured side of
    the amplification metric. One token bucket is shared by every
    concurrent response, so total origin egress is rate-bound the way a
    real origin's uplink is."""

    CHUNK = 256 * 1024

    def __init__(self, blobs: Dict[str, bytes], *, rate_bps: float,
                 host: str = "127.0.0.1", port: int = 0):
        self.blobs = dict(blobs)
        self.limiter = Limiter(rate_bps, burst=int(self.CHUNK * 4))
        self._counter_lock = threading.Lock()
        self.bytes_served = 0
        self.requests = 0
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_HEAD(self):  # noqa: N802
                blob = server.blobs.get(self.path.split("?", 1)[0])
                if blob is None:
                    self.send_error(404)
                    return
                with server._counter_lock:
                    server.requests += 1
                self.send_response(200)
                self.send_header("Content-Length", str(len(blob)))
                self.send_header("Accept-Ranges", "bytes")
                self.end_headers()

            def do_GET(self):  # noqa: N802
                from dragonfly2_tpu_torch.client.piece import parse_http_range

                blob = server.blobs.get(self.path.split("?", 1)[0])
                if blob is None:
                    self.send_error(404)
                    return
                rng_header = self.headers.get("Range")
                if rng_header:
                    rng = parse_http_range(rng_header, len(blob))
                    data = memoryview(blob)[rng.start:rng.start + rng.length]
                    self.send_response(206)
                    self.send_header(
                        "Content-Range",
                        f"bytes {rng.start}-{rng.end}/{len(blob)}")
                else:
                    data = memoryview(blob)
                    self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                with server._counter_lock:
                    server.requests += 1
                off = 0
                while off < len(data):
                    chunk = data[off:off + server.CHUNK]
                    server.limiter.wait_n(len(chunk))
                    self.wfile.write(chunk)
                    with server._counter_lock:
                        server.bytes_served += len(chunk)
                    off += len(chunk)

        super().__init__(Handler, host=host, port=port, name="fanout-origin")

    def url(self, path: str) -> str:
        return f"http://127.0.0.1:{self.port}{path}"

    def reset_counters(self) -> None:
        with self._counter_lock:
            self.bytes_served = 0
            self.requests = 0

    def counters(self) -> Dict[str, int]:
        with self._counter_lock:
            return {"bytes_served": self.bytes_served,
                    "requests": self.requests}

    def __enter__(self) -> "ThrottledCheckpointOrigin":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def make_checkpoint(shards: int = DEFAULT_SHARDS,
                    shard_bytes: int = DEFAULT_SHARD_BYTES,
                    seed: int = 0) -> Dict[str, bytes]:
    """Sharded-checkpoint blobs keyed by origin path."""
    import numpy as np

    return {
        f"/ckpt/model-{i:05d}-of-{shards:05d}.bin":
            np.random.default_rng(seed * 101 + i).bytes(shard_bytes)
        for i in range(shards)
    }


def _fanout_task_options():
    from dragonfly2_tpu_torch.client.peer_task import PeerTaskOptions

    return PeerTaskOptions(
        timeout=600.0,
        # Dissemination latency is poll-bound × chain depth (a cold
        # burst forms peer chains before anyone holds pieces): a tight
        # poll keeps the cascade lag small. 0.01 measured WORSE on the
        # 2-core dev box (poll storm), 0.03 is the knee; the
        # idle-adaptive backoff (metadata_idle_poll_cap) keeps the
        # fleet-wide poll load bounded at the 32-daemon rung.
        metadata_poll_interval=0.03,
        # 2 fetchers per conductor: 32 daemons × defaults (4+4) is a
        # thread-thrash regime on the 2-core dev box; the native data
        # plane keeps 2 streams per child plenty to track its parents.
        piece_concurrency=2,
        back_source_concurrency=2,
        claim_wait_interval=0.3,
        source_fallback_wait=20.0,
    )


def run_fanout_rung(n_daemons: int, blobs: Dict[str, bytes], *,
                    origin_rate_bps: float = DEFAULT_ORIGIN_RATE_BPS,
                    preheated: bool = False, seed: int = 0,
                    md5_sample: int = 2, mode: str = "threads",
                    piece_size: int = DEFAULT_PIECE_SIZE,
                    root: str | None = None,
                    daemon_extra_args: Sequence[str] = ()) -> dict:
    """One fleet rung. ``mode="threads"`` runs the daemons in-process
    (hermetic, what the tier-1 smoke uses); ``mode="procs"`` runs each
    daemon as a REAL ``daemon_proc`` subprocess against a gRPC
    scheduler served from this process — the ladder's mode, because 32
    in-process daemons measure the GIL, not the dissemination engine.
    Each daemon pulls every shard (seeded-shuffled order). Returns
    TTLB, per-daemon completion stats, origin egress / amplification,
    and the P2P share."""
    if mode == "procs":
        return _run_fanout_rung_procs(
            n_daemons, blobs, origin_rate_bps=origin_rate_bps,
            preheated=preheated, seed=seed, md5_sample=md5_sample,
            piece_size=piece_size, root=root,
            daemon_extra_args=daemon_extra_args)
    import os
    import random

    from dragonfly2_tpu_torch.client.daemon import Daemon, DaemonConfig
    from dragonfly2_tpu_torch.client.dataplane import DataPlaneStats
    from dragonfly2_tpu_torch.client.recovery import RecoveryStats
    from dragonfly2_tpu_torch.scheduler.evaluator.base import BaseEvaluator
    from dragonfly2_tpu_torch.scheduler.resource.resource import Resource
    from dragonfly2_tpu_torch.scheduler.scheduling.core import (
        Scheduling,
        SchedulingConfig,
    )
    from dragonfly2_tpu_torch.scheduler import controlstats
    from dragonfly2_tpu_torch.scheduler.service import SchedulerService
    from dragonfly2_tpu_torch.utils.hosttypes import HostType

    checkpoint_bytes = sum(len(b) for b in blobs.values())
    tmp = root or tempfile.mkdtemp(prefix="df2-fanout-")
    dataplane = DataPlaneStats()
    recovery = RecoveryStats()
    sched_stats = controlstats.ControlPlaneStats()
    service = SchedulerService(
        resource=Resource(),
        scheduling=Scheduling(
            BaseEvaluator(),
            # A cold 32-daemon burst registers every peer inside one
            # piece-land interval: give the candidate search a longer
            # retry runway than the 0.5 s default so late registrants
            # find the (by then piece-holding) early ones instead of
            # degrading to unreported full origin pulls.
            SchedulingConfig(retry_interval=0.05, retry_limit=60,
                             retry_back_to_source_limit=8),
            stats=sched_stats,
        ),
        stats=sched_stats,
    )
    options = _fanout_task_options()
    daemons: List[Daemon] = []
    seed_daemon = None
    out: dict = {
        "daemons": n_daemons,
        "shards": len(blobs),
        "checkpoint_bytes": checkpoint_bytes,
        "preheated": preheated,
        "failures": [],
    }
    try:
        with ThrottledCheckpointOrigin(
                blobs, rate_bps=origin_rate_bps) as origin:
            if preheated:
                seed_daemon = Daemon(service, DaemonConfig(
                    storage_root=os.path.join(tmp, "seed"),
                    hostname="fanout-seed", host_type=HostType.SUPER_SEED,
                    keep_storage=False, task_options=options,
                    recovery_stats=recovery, dataplane_stats=dataplane))
                seed_daemon.start()
                service.seed_peer_client = seed_daemon.seed_client()
                warm0 = time.perf_counter()
                for path in blobs:
                    service.preheat(origin.url(path))
                out["preheat_seconds"] = round(
                    time.perf_counter() - warm0, 3)
                out["preheat_origin_bytes"] = origin.counters()[
                    "bytes_served"]
                # The fleet phase below measures ONLY post-warm egress.
                origin.reset_counters()
            for i in range(n_daemons):
                daemons.append(Daemon(service, DaemonConfig(
                    storage_root=os.path.join(tmp, f"d{i}"),
                    hostname=f"fanout-{i}", keep_storage=False,
                    task_options=options, recovery_stats=recovery,
                    dataplane_stats=dataplane)))
            for d in daemons:
                d.start()

            finish_at: List[float] = [0.0] * n_daemons
            failures: List[str] = []
            fail_lock = threading.Lock()
            want_md5 = {path: hashlib.md5(blob).hexdigest()
                        for path, blob in blobs.items()}
            t0 = time.perf_counter()

            def fleet_worker(idx: int) -> None:
                rng = random.Random(seed * 1009 + idx)
                order = list(blobs)
                rng.shuffle(order)
                for path in order:
                    try:
                        result = daemons[idx].download_file(origin.url(path))
                    except Exception as exc:  # noqa: BLE001 — counted
                        with fail_lock:
                            failures.append(f"d{idx} {path}: raised {exc}")
                        continue
                    if not result.success:
                        with fail_lock:
                            failures.append(
                                f"d{idx} {path}: {result.error}")
                    elif idx < md5_sample:
                        got = hashlib.md5(result.read_all()).hexdigest()
                        if got != want_md5[path]:
                            with fail_lock:
                                failures.append(
                                    f"d{idx} {path}: md5 mismatch")
                finish_at[idx] = time.perf_counter() - t0

            threads = [
                threading.Thread(target=fleet_worker, args=(i,),
                                 name=f"fanout-d{i}", daemon=True)
                for i in range(n_daemons)
            ]
            for i, t in enumerate(threads):
                t.start()
                # Tiny stagger: a real fleet's rollout is never a
                # same-microsecond thundering herd, and the scheduler's
                # candidate search deserves at least one piece-land
                # interval of spread.
                time.sleep(0.02)
            for t in threads:
                t.join()
            ttlb = max(finish_at)
            origin_counters = origin.counters()
    finally:
        for d in daemons:
            try:
                d.stop()
            except Exception:  # noqa: BLE001 — teardown best effort
                pass
        if seed_daemon is not None:
            try:
                seed_daemon.stop()
            except Exception:  # noqa: BLE001
                pass
        if root is None:
            shutil.rmtree(tmp, ignore_errors=True)

    snap = dataplane.snapshot()
    p2p_bytes = snap["parent_bytes"]
    source_bytes = snap["source_bytes"]
    delivered = p2p_bytes + source_bytes
    per_daemon_mbps = sorted(
        checkpoint_bytes / MiB / max(fin, 1e-9) for fin in finish_at)
    out.update({
        "downloads": n_daemons * len(blobs),
        "failures": failures[:8],
        "success_rate": round(
            1.0 - len(failures) / max(n_daemons * len(blobs), 1), 4),
        "ttlb_s": round(ttlb, 3),
        "daemon_finish_p50_s": round(percentile(sorted(finish_at), 0.50), 3),
        "daemon_finish_p99_s": round(percentile(sorted(finish_at), 0.99), 3),
        "per_daemon_mb_per_s_p50": round(
            percentile(per_daemon_mbps, 0.50), 2),
        "per_daemon_mb_per_s_min": round(per_daemon_mbps[0], 2),
        "origin_bytes": origin_counters["bytes_served"],
        "origin_requests": origin_counters["requests"],
        "origin_amplification": round(
            origin_counters["bytes_served"] / checkpoint_bytes, 3),
        "p2p_bytes": p2p_bytes,
        "source_bytes": source_bytes,
        "p2p_share": round(p2p_bytes / max(delivered, 1), 4),
        "claims": {k: v for k, v in sched_stats.snapshot().items()
                   if k.startswith("source_claims")
                   or k in ("back_to_source",)},
        "recovery": {k: v for k, v in recovery.snapshot().items() if v},
    })
    return out


def _run_fanout_rung_procs(n_daemons: int, blobs: Dict[str, bytes], *,
                           origin_rate_bps: float, preheated: bool,
                           seed: int, md5_sample: int, piece_size: int,
                           root: str | None,
                           daemon_extra_args: Sequence[str] = ()) -> dict:
    """Process-fleet rung: one gRPC scheduler served from THIS process
    (so the claim/decision counters stay readable), N ``daemon_proc``
    children on the native data plane, and — for the preheated variant
    — a seed daemon process serving ObtainSeeds behind the scheduler's
    ``GrpcSeedPeerClient``. TTLB is read from each daemon's LAST
    piece-landing PROGRESS event, so the md5 verification pass each
    RESULT pays never inflates the byte clock."""
    import os
    import random

    from dragonfly2_tpu_torch.client.chaosbench import DaemonProc
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

    checkpoint_bytes = sum(len(b) for b in blobs.values())
    tmp = root or tempfile.mkdtemp(prefix="df2-fanout-")
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
    # Every live AnnouncePeer stream pins one gRPC worker thread for
    # the peer's whole download — the default 16-worker pool deadlocks
    # a 32-daemon fleet's UNARY calls (claims time out, every claimant
    # falls back to a full local origin pull, and amplification
    # explodes). Size the pool to the fleet.
    server = serve([(SCHEDULER_SPEC, SchedulerRpcService(service))],
                   max_workers=4 * n_daemons + 64)
    opts = _fanout_task_options()
    proc_kwargs = dict(
        piece_size=piece_size, native=True, timeout=opts.timeout,
        poll_interval=opts.metadata_poll_interval,
        piece_concurrency=opts.piece_concurrency,
        # The origin is deliberately slow: waiting minutes on leased
        # pieces arriving through the mesh is the NORMAL shape here,
        # and a short stall window would flip waiting claimants to
        # local origin pulls — doubling egress exactly where the
        # amplification bound watches. Liveness stays bounded by the
        # conductor timeout.
        fallback_wait=120.0,
        # Cold-start decision latency under a 32-proc spawn wave can
        # exceed the chaos-rung 5 s grace; a mass silent-scheduler
        # degrade would pull the whole fleet off the decision path.
        scheduler_grace=30.0,
        # Fleet spawn shares two cores: a cold 32-proc wave can take
        # >30 s to all reach their DAEMON line.
        startup_timeout=240.0,
        # Observability flags (--trace-dir/--metrics-port/...) forward
        # verbatim to every spawned daemon_proc.
        extra_args=tuple(daemon_extra_args),
    )
    procs: List[DaemonProc] = []
    seed_proc = None
    out: dict = {
        "daemons": n_daemons,
        "shards": len(blobs),
        "checkpoint_bytes": checkpoint_bytes,
        "preheated": preheated,
        "mode": "procs",
        "failures": [],
        # Every key a consumer reads is present from the start, so an
        # early-return failure (spawn error) still yields a complete
        # (failed) report instead of a KeyError that eats it — the
        # PR-8 chaos-rung lesson.
        "downloads": 0,
        "success_rate": 0.0,
        "ttlb_s": None,
        "daemon_finish_p50_s": None,
        "daemon_finish_p99_s": None,
        "per_daemon_mb_per_s_p50": None,
        "per_daemon_mb_per_s_min": None,
        "origin_bytes": None,
        "origin_requests": None,
        "origin_amplification": None,
        "p2p_bytes": None,
        "source_bytes": None,
        "p2p_share": None,
        "claims": {},
        "recovery": {},
    }
    try:
        with ThrottledCheckpointOrigin(
                blobs, rate_bps=origin_rate_bps) as origin:
            if preheated:
                from dragonfly2_tpu_torch.client.rpcserver import GrpcSeedPeerClient

                seed_proc = DaemonProc(
                    os.path.join(tmp, "seed"), [server.target],
                    hostname="fanout-seed", serve_rpc=True,
                    host_type="super", **proc_kwargs)
                service.seed_peer_client = GrpcSeedPeerClient(
                    [seed_proc.rpc_target])
                warm0 = time.perf_counter()
                for path in blobs:
                    service.preheat(origin.url(path))
                out["preheat_seconds"] = round(
                    time.perf_counter() - warm0, 3)
                out["preheat_origin_bytes"] = origin.counters()[
                    "bytes_served"]
                origin.reset_counters()

            spawn_errs: List[str] = []
            spawn_lock = threading.Lock()

            def spawn(idx: int) -> None:
                try:
                    proc = DaemonProc(
                        os.path.join(tmp, f"d{idx}"), [server.target],
                        hostname=f"fanout-{idx}", **proc_kwargs)
                except Exception as exc:  # noqa: BLE001 — surfaced below
                    with spawn_lock:
                        spawn_errs.append(f"d{idx}: {exc}")
                    return
                with spawn_lock:
                    procs.append(proc)

            spawners = [threading.Thread(target=spawn, args=(i,))
                        for i in range(n_daemons)]
            for t in spawners:
                t.start()
            for t in spawners:
                t.join()
            if spawn_errs:
                out["failures"] = spawn_errs[:8]
                return out

            failures: List[str] = []
            fail_lock = threading.Lock()
            want_md5 = {path: hashlib.md5(blob).hexdigest()
                        for path, blob in blobs.items()}
            finish_at: List[float] = [0.0] * n_daemons
            t0 = time.perf_counter()

            def drive(idx: int) -> None:
                proc = procs[idx]
                rng = random.Random(seed * 1009 + idx)
                order = list(blobs)
                rng.shuffle(order)
                for path in order:
                    url = origin.url(path)
                    proc.download(url)
                    try:
                        result = proc.result(timeout=opts.timeout)
                    except Exception:  # noqa: BLE001 — queue timeout
                        with fail_lock:
                            failures.append(f"d{idx} {path}: no result")
                        continue
                    if not result.get("ok"):
                        with fail_lock:
                            failures.append(
                                f"d{idx} {path}: {result.get('error')}")
                    elif result.get("md5") != want_md5[path]:
                        with fail_lock:
                            failures.append(f"d{idx} {path}: md5 mismatch")
                # Byte clock: the last verified piece landing; RESULT
                # arrival (md5 re-read included) is the fallback for a
                # fully-reused edge case with no fresh pieces.
                stamps = list(proc.progress_at.values())
                finish_at[idx] = ((max(stamps) - t0) if stamps
                                  else time.perf_counter() - t0)

            drivers = [threading.Thread(target=drive, args=(i,),
                                        name=f"fanout-drive-{i}")
                       for i in range(n_daemons)]
            for i, t in enumerate(drivers):
                t.start()
                time.sleep(0.02)  # rollout stagger (see threads mode)
            for t in drivers:
                t.join()
            ttlb = max(finish_at) if finish_at else 0.0
            origin_counters = origin.counters()

            p2p_bytes = source_bytes = 0
            fleet_recovery: Dict[str, int] = {}
            for proc in procs:
                try:
                    stats = proc.stats(timeout=10.0)
                except Exception:  # noqa: BLE001 — stats are best effort
                    continue
                snap = stats.get("data_plane", {})
                p2p_bytes += snap.get("parent_bytes", 0)
                source_bytes += snap.get("source_bytes", 0)
                for key, value in stats.items():
                    if isinstance(value, (int, float)) and value:
                        fleet_recovery[key] = (
                            fleet_recovery.get(key, 0) + value)
    finally:
        def retire(proc) -> None:
            try:
                proc.exit(timeout=10.0)
            except Exception:  # noqa: BLE001 — teardown best effort
                proc.kill()

        stoppers = [threading.Thread(target=retire, args=(p,))
                    for p in procs + ([seed_proc] if seed_proc else [])]
        for t in stoppers:
            t.start()
        for t in stoppers:
            t.join()
        server.stop()
        if root is None:
            shutil.rmtree(tmp, ignore_errors=True)

    delivered = p2p_bytes + source_bytes
    per_daemon_mbps = sorted(
        checkpoint_bytes / MiB / max(fin, 1e-9) for fin in finish_at)
    out.update({
        "downloads": n_daemons * len(blobs),
        "failures": failures[:8],
        "success_rate": round(
            1.0 - len(failures) / max(n_daemons * len(blobs), 1), 4),
        "ttlb_s": round(ttlb, 3),
        "daemon_finish_p50_s": round(percentile(sorted(finish_at), 0.50), 3),
        "daemon_finish_p99_s": round(percentile(sorted(finish_at), 0.99), 3),
        "per_daemon_mb_per_s_p50": round(
            percentile(per_daemon_mbps, 0.50), 2),
        "per_daemon_mb_per_s_min": round(per_daemon_mbps[0], 2),
        "origin_bytes": origin_counters["bytes_served"],
        "origin_requests": origin_counters["requests"],
        "origin_amplification": round(
            origin_counters["bytes_served"] / checkpoint_bytes, 3),
        "p2p_bytes": p2p_bytes,
        "source_bytes": source_bytes,
        "p2p_share": round(p2p_bytes / max(delivered, 1), 4),
        "claims": {k: v for k, v in sched_stats.snapshot().items()
                   if k.startswith("source_claims")
                   or k in ("back_to_source",)},
        "recovery": fleet_recovery,
    })
    return out


def run_fanout_ladder(rungs: Sequence[int] = DEFAULT_RUNGS, *,
                      shards: int = DEFAULT_SHARDS,
                      shard_bytes: int = DEFAULT_SHARD_BYTES,
                      piece_size: int = DEFAULT_PIECE_SIZE,
                      origin_rate_bps: float = DEFAULT_ORIGIN_RATE_BPS,
                      preheat_rung: int | None = None,
                      seed: int = 0,
                      time_left=None) -> dict:
    """Cold rungs smallest→largest, then the preheated variant at
    ``preheat_rung`` (default: the largest rung). Every rung runs the
    PROCESS fleet (``mode="procs"``) — on a small dev box an in-process
    32-daemon swarm measures interpreter contention, not the
    dissemination engine. ``time_left`` (a callable returning remaining
    seconds) lets the bench stage skip later rungs EXPLICITLY — a
    skipped rung records ``skipped`` and withholds the verdict, never a
    silent pass."""
    blobs = make_checkpoint(shards, shard_bytes, seed)
    checkpoint_bytes = sum(len(b) for b in blobs.values())
    preheat_rung = preheat_rung or max(rungs)
    ladder: Dict[str, dict] = {}
    preheated: dict | None = None
    skipped: List[str] = []

    # Budget heuristic per rung: one origin pass + fleet bytes at a
    # conservative 60 MiB/s aggregate mesh rate + spawn/teardown slack.
    def rung_budget(n: int) -> float:
        return (checkpoint_bytes / origin_rate_bps
                + n * checkpoint_bytes / (60 * MiB) + 30.0)

    for n in sorted(rungs):
        if time_left is not None and time_left() < rung_budget(n):
            skipped.append(f"cold-{n}")
            continue
        ladder[str(n)] = run_fanout_rung(
            n, blobs, origin_rate_bps=origin_rate_bps, seed=seed,
            mode="procs", piece_size=piece_size)
    if time_left is not None and time_left() < rung_budget(preheat_rung):
        skipped.append(f"preheated-{preheat_rung}")
    else:
        preheated = run_fanout_rung(
            preheat_rung, blobs, origin_rate_bps=origin_rate_bps,
            preheated=True, seed=seed, mode="procs",
            piece_size=piece_size)

    out = {
        "rungs": sorted(rungs),
        "shards": shards,
        "checkpoint_bytes": checkpoint_bytes,
        "piece_size": piece_size,
        "origin_rate_mb_per_s": round(origin_rate_bps / MiB, 1),
        "ladder": ladder,
        "preheated": preheated,
        "skipped_rungs": skipped,
        "amplification_bound": AMPLIFICATION_BOUND,
        "ttlb_ratio_bound": TTLB_RATIO_BOUND,
        "preheat_origin_fraction_bound": PREHEAT_ORIGIN_FRACTION_BOUND,
    }
    smallest, largest = str(min(rungs)), str(max(rungs))
    cold_complete = smallest in ladder and largest in ladder
    if cold_complete:
        top = ladder[largest]
        ttlb_ratio = round(
            top["ttlb_s"] / max(ladder[smallest]["ttlb_s"], 1e-9), 3)
        out["ttlb_ratio"] = ttlb_ratio
        out["cold_amplification_at_max"] = top["origin_amplification"]
        out["cold_verdict_pass"] = bool(
            all(r["success_rate"] >= 1.0 for r in ladder.values())
            and top["origin_amplification"] <= AMPLIFICATION_BOUND
            and ttlb_ratio <= TTLB_RATIO_BOUND)
    if preheated is not None:
        fraction = preheated["origin_bytes"] / checkpoint_bytes
        out["preheat_origin_fraction"] = round(fraction, 5)
        out["preheat_verdict_pass"] = bool(
            preheated["success_rate"] >= 1.0
            and fraction <= PREHEAT_ORIGIN_FRACTION_BOUND)
    # The combined verdict exists ONLY when nothing was skipped — a
    # budget-starved run must never persist as green.
    if cold_complete and preheated is not None and not skipped:
        out["verdict_pass"] = bool(
            out["cold_verdict_pass"] and out["preheat_verdict_pass"])
    return out


def best_recorded_fanout(state_dir: str) -> "dict | None":
    """Best persisted green fanout run (lowest largest-rung cold TTLB)
    from artifacts/bench_state/fanout_run_*.json."""
    import glob
    import json as json_mod
    import os

    best = None
    for path in glob.glob(os.path.join(state_dir, "fanout_run_*.json")):
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
            "origin_amplification": top["origin_amplification"],
        }
        if best is None or record["ttlb_s"] < best["ttlb_s"]:
            best = record
    return best


def check_fanout_regression(
        state_dir: str, *,
        fraction: float = FANOUT_REGRESSION_FRACTION) -> dict:
    """``bench.py fanout --check-regression`` — fresh ladder vs the best
    persisted record. Fails when the fresh run loses its verdict, or
    the largest cold rung's TTLB / amplification degrade past
    ``1/fraction``× the record (0.5 → a 2× collapse fails the gate;
    the absolute bounds still apply through the verdict)."""
    best = best_recorded_fanout(state_dir)
    fresh = run_fanout_ladder(seed=0)
    largest = str(max(fresh["rungs"]))
    top = fresh["ladder"].get(largest, {})
    out = {
        "fresh_verdict_pass": fresh.get("verdict_pass", False),
        "fresh_ttlb_s": top.get("ttlb_s"),
        "fresh_amplification": top.get("origin_amplification"),
        "fresh_ttlb_ratio": fresh.get("ttlb_ratio"),
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
            and top.get("origin_amplification", float("inf"))
            <= best["origin_amplification"] / fraction)
    out["passed"] = passed
    return out
