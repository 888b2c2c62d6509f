"""Chaos ladder: a loopback swarm under seeded fault injection.

``bench.py``'s ``chaos`` stage (and the ``slow``+``chaos``-marked e2e
test) drive a REAL in-process swarm — scheduler service + two peer
daemons + an HTTP origin on 127.0.0.1 — through a fault-rate ladder
(default 0 % / 1 % / 5 %). At each rung a seeded :class:`FaultPlan`
injects byte corruption, mid-stream resets, connect-refused dials,
truncated source bodies, and scheduler ``UNAVAILABLE`` across the
compiled-in sites (docs/CHAOS.md), and the rung reports:

- **task success rate** — every download must finish md5-exact,
- **goodput retention** — rung MB/s over the 0 % rung's MB/s,
- **recovery p50/p99** — piece-recovery latency (first failed attempt →
  successful store) from the rung's injected ``RecoveryStats``,
- the recovery counters and per-site fault fire counts.

The documented bound (the stage's verdict in the bench JSON): **100 %
task success at every rung and ≥ 70 % goodput retention at the highest
rung**. ``ENOSPC`` is deliberately absent from the ladder — it is a
fail-FAST contract (tests/test_chaos_recovery.py), not a recover-and-
retain one.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
import time
from http.server import BaseHTTPRequestHandler
from typing import Dict, Sequence

from dragonfly2_tpu_torch.utils import faultplan
from dragonfly2_tpu_torch.utils.faultplan import FaultKind, FaultPlan
from dragonfly2_tpu_torch.utils.httpserver import ThreadedHTTPService
from dragonfly2_tpu_torch.utils.percentile import percentile

#: The documented ladder bound (ISSUE 5 acceptance).
SUCCESS_BOUND = 1.0
GOODPUT_RETENTION_BOUND = 0.70
DEFAULT_RATES = (0.0, 0.01, 0.05)

#: Scheduler-kill rung bound (ISSUE 6 acceptance): with ≥1 replica
#: surviving a hard kill, every task succeeds, NONE degrade to
#: back-to-source for scheduler loss, and the p99 re-route (first failed
#: peer-keyed call → session re-established on a live replica) stays
#: within the conductor's scheduler_grace — the window that would
#: otherwise have been burned degrading.
KILL_RUNG_REPLICAS = 3

#: Daemon-kill rung bounds (ISSUE 8 acceptance): a daemon SIGKILLed at
#: ~this fraction of a download and restarted on the same storage root
#: must finish every task md5-exact, re-download no more than the
#: missing bytes plus one piece per worker (the journal made restart a
#: RESUME), and re-announce its completed replicas (a child served off
#: the restarted seed proves it).
DAEMON_KILL_FRACTION = 0.5
#: Chaos regression gate (`bench.py chaos --check-regression`): fresh
#: goodput retention must stay within this fraction of the best
#: persisted record — parity with the PR 7 dataplane gate.
CHAOS_REGRESSION_FRACTION = 0.5


class MultiBlobServer(ThreadedHTTPService):
    """Range-capable loopback origin serving one blob per path — the
    chaos swarm needs DISTINCT tasks (distinct URLs), which the
    single-blob bench server can't provide. Rides the shared
    ThreadedHTTPService shell (quiet per-request errors: injected
    resets make clients vanish mid-request by design)."""

    def __init__(self, blobs: Dict[str, bytes], host: str = "127.0.0.1",
                 port: int = 0):
        self.blobs = dict(blobs)
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):  # noqa: N802
                from dragonfly2_tpu_torch.client.piece import parse_http_range

                blob = server.blobs.get(self.path.split("?", 1)[0])
                if blob is None:
                    self.send_error(404)
                    return
                rng_header = self.headers.get("Range")
                if rng_header:
                    rng = parse_http_range(rng_header, len(blob))
                    data = blob[rng.start:rng.start + rng.length]
                    self.send_response(206)
                    self.send_header(
                        "Content-Range",
                        f"bytes {rng.start}-{rng.end}/{len(blob)}")
                else:
                    data = blob
                    self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        super().__init__(Handler, host=host, port=port, name="chaos-origin")

    def url(self, path: str) -> str:
        return f"http://127.0.0.1:{self.port}{path}"

    def __enter__(self) -> "MultiBlobServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def build_fault_plan(rate: float, seed: int,
                     tls: bool = False) -> FaultPlan:
    """The ladder's fault mix at one rung: every RECOVERABLE kind on
    every data/control site, probabilities scaled off the rung rate.
    ``tls`` adds mid-HANDSHAKE resets on the peer leg — the connection
    dies before the TLS session is up, the failure mode plain-TCP
    ladders never exercise."""
    plan = FaultPlan(seed=seed)
    plan.add("piece.body", FaultKind.CORRUPT, probability=rate)
    plan.add("piece.body", FaultKind.RESET, probability=rate / 2)
    plan.add("source.body", FaultKind.TRUNCATE, probability=rate / 2)
    plan.add("source.body", FaultKind.RESET, probability=rate / 2)
    plan.add("pool.connect", FaultKind.CONNECT_REFUSED, probability=rate)
    plan.add("scheduler.rpc", FaultKind.UNAVAILABLE, probability=rate)
    if tls:
        plan.add("tls.handshake", FaultKind.RESET, probability=rate)
    return plan


def _chaos_task_options():
    from dragonfly2_tpu_torch.client.peer_task import PeerTaskOptions

    return PeerTaskOptions(
        # The injection sites live on the pure-Python data plane; the
        # native C++ loop has no chunk hook to corrupt through.
        native_data_plane=False,
        timeout=60.0,
        scheduler_grace=2.0,
        metadata_timeout=2.0,
        backoff_base=0.01,
        backoff_cap=0.2,
        piece_retry_limit=12,
        source_retry_limit=4,
        corrupt_blacklist_threshold=4,
    )


def _run_rung(rate: float, *, blobs: Dict[str, bytes], seed: int,
              tmp: str, tls_conf: "tuple | None" = None) -> dict:
    import os

    from dragonfly2_tpu_torch.client.daemon import Daemon, DaemonConfig
    from dragonfly2_tpu_torch.client.recovery import RecoveryStats
    from dragonfly2_tpu_torch.scheduler.evaluator.base import BaseEvaluator
    from dragonfly2_tpu_torch.scheduler.resource.resource import Resource
    from dragonfly2_tpu_torch.scheduler.scheduling.core import (
        Scheduling,
        SchedulingConfig,
    )
    from dragonfly2_tpu_torch.scheduler.service import SchedulerService
    from dragonfly2_tpu_torch.scheduler.storage.storage import Storage

    from dragonfly2_tpu_torch.client.dataplane import DataPlaneStats

    recovery = RecoveryStats()
    dataplane = DataPlaneStats()
    service = SchedulerService(
        resource=Resource(),
        scheduling=Scheduling(
            BaseEvaluator(),
            SchedulingConfig(retry_interval=0.01,
                             retry_back_to_source_limit=2),
        ),
        storage=Storage(os.path.join(tmp, "datasets")),
    )
    # The conductors hold the scheduler by direct reference; the proxy
    # compiles the SAME "scheduler.rpc" site the gRPC adapters carry.
    scheduler = faultplan.RpcFaultProxy(service)
    options = _chaos_task_options()
    cert, key, ca = tls_conf if tls_conf is not None else ("", "", "")
    daemons = [
        Daemon(scheduler, DaemonConfig(
            storage_root=os.path.join(tmp, name), hostname=name,
            keep_storage=False, task_options=options,
            recovery_stats=recovery,
            # Per-rung serving-engine counters: the p2p legs of the swarm
            # ride the event-loop upload server, and the rung report
            # carries its serve-path split as evidence.
            dataplane_stats=dataplane,
            # TLS ladder: every p2p leg handshakes — serving AND piece
            # fetch — so mid-handshake/mid-stream resets hit real TLS
            # state machines, not plaintext sockets.
            upload_tls_cert=cert, upload_tls_key=key, peer_tls_ca=ca,
        ))
        for name in ("chaos-a", "chaos-b")
    ]
    plan = (build_fault_plan(rate, seed, tls=tls_conf is not None)
            if rate > 0 else None)
    downloads = 0
    failures = []
    bytes_ok = 0
    durations = []
    wall0 = time.perf_counter()
    try:
        for d in daemons:
            d.start()
        if plan is not None:
            faultplan.install(plan)
        with MultiBlobServer(blobs) as origin:
            for path, blob in blobs.items():
                want = hashlib.md5(blob).hexdigest()
                for daemon in daemons:
                    begin = time.perf_counter()
                    result = daemon.download_file(origin.url(path))
                    durations.append(time.perf_counter() - begin)
                    downloads += 1
                    if not result.success:
                        failures.append(f"{path}: {result.error}")
                        continue
                    got = hashlib.md5(result.read_all()).hexdigest()
                    if got != want:
                        failures.append(f"{path}: md5 {got} != {want}")
                        continue
                    bytes_ok += len(blob)
    finally:
        faultplan.uninstall()
        for d in daemons:
            try:
                d.stop()
            except Exception:  # noqa: BLE001 — teardown best effort
                pass
    wall = time.perf_counter() - wall0
    recoveries = sorted(recovery.recovery_samples())
    out = {
        "fault_rate": rate,
        "downloads": downloads,
        "failures": failures[:5],
        "success_rate": round(
            (downloads - len(failures)) / max(downloads, 1), 4),
        "bytes_ok": bytes_ok,
        "seconds": round(wall, 3),
        "mb_per_s": round(bytes_ok / (1 << 20) / max(wall, 1e-9), 2),
        "download_p50_s": round(percentile(sorted(durations), 0.50), 3),
        "download_p99_s": round(percentile(sorted(durations), 0.99), 3),
        "recovery_events": len(recoveries),
        "recovery_p50_ms": round(percentile(recoveries, 0.50) * 1e3, 1),
        "recovery_p99_ms": round(percentile(recoveries, 0.99) * 1e3, 1),
        "recovery_counters": recovery.snapshot(),
        "tls": tls_conf is not None,
        "upload_engine": {
            k: v for k, v in dataplane.snapshot().items()
            if k.startswith(("upload_", "sendfile", "mmap_bytes",
                             "buffered_bytes", "connections_open",
                             "tls_", "ktls_"))
        },
    }
    if plan is not None:
        out["faults"] = plan.snapshot()
    return out


def spawn_scheduler_replica(data_dir: str, startup_timeout: float = 30.0,
                            extra_args: Sequence[str] = ()):
    """One scheduler replica as a REAL child process (``scheduler/
    replica.py``); returns (Popen, target). Killing it is the one
    failure an in-process server can't reproduce. ``extra_args`` pass
    replica CLI knobs through (the cluster bench sizes the worker pool
    and GC to its swarm)."""
    import os
    import queue as queue_mod
    import subprocess
    import sys
    import threading

    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cpu")  # never probe a device
    proc = subprocess.Popen(
        [sys.executable, "-m", "dragonfly2_tpu_torch.scheduler.replica",
         "--data-dir", data_dir, *extra_args],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env)
    # A bare readline() hangs the whole bench if the child stalls
    # before printing (slow import, bind wedged) — bound the wait.
    line_q: "queue_mod.Queue" = queue_mod.Queue()
    threading.Thread(target=lambda: line_q.put(proc.stdout.readline()),
                     name="replica-startup-read", daemon=True).start()
    try:
        line = line_q.get(timeout=startup_timeout).strip()
    except queue_mod.Empty:
        proc.kill()
        proc.wait()
        raise RuntimeError(
            f"replica did not start within {startup_timeout}s") from None
    if not line.startswith("REPLICA "):
        proc.kill()
        proc.wait()
        raise RuntimeError(f"replica failed to start: {line!r}")
    return proc, line.split(" ", 1)[1]


def run_scheduler_kill_rung(*, replicas: int = KILL_RUNG_REPLICAS,
                            tasks: int = 8, size_bytes: int = 2 << 20,
                            piece_size: int = 128 << 10, seed: int = 0,
                            kill_after: float = 0.6, workers: int = 4,
                            root: str | None = None) -> dict:
    """The ISSUE-6 chaos rung: a loopback swarm against ``replicas``
    scheduler processes, one hard-killed mid-swarm by a seeded
    ``scheduler.process`` KILL rule. Reports re-route p50/p99 (from the
    rung's injected RecoveryStats), failover/re-registration counters,
    and tasks degraded to source; the verdict is 100 % task success,
    p99 re-route ≤ ``scheduler_grace``, and 0 degrades while the other
    replicas survive."""
    import os
    import queue as queue_mod
    import threading

    import numpy as np

    from dragonfly2_tpu_torch.client import peer_task as peer_task_mod
    from dragonfly2_tpu_torch.client.daemon import Daemon, DaemonConfig
    from dragonfly2_tpu_torch.client.recovery import RecoveryStats
    from dragonfly2_tpu_torch.scheduler.rpcserver import BalancedSchedulerClient

    tmp = root or tempfile.mkdtemp(prefix="df2-ha-")
    blobs = {
        f"/ha/blob-{i}": np.random.default_rng(seed * 7 + i).bytes(size_bytes)
        for i in range(tasks)
    }
    procs = []
    targets = []
    try:
        for i in range(replicas):
            proc, target = spawn_scheduler_replica(
                os.path.join(tmp, f"replica-{i}"))
            procs.append(proc)
            targets.append(target)
    except BaseException:
        # The finally below only guards the swarm; a partial spawn
        # failure must not orphan the replicas already running.
        for proc in procs:
            proc.kill()
            proc.wait()
        raise

    balanced = None
    daemons = []
    try:
        recovery = RecoveryStats()
        options = _chaos_task_options()
        balanced = BalancedSchedulerClient(targets, recovery=recovery)
        for name in ("ha-a", "ha-b"):
            daemons.append(Daemon(balanced, DaemonConfig(
                storage_root=os.path.join(tmp, name), hostname=name,
                keep_storage=False, task_options=options,
                recovery_stats=recovery,
                # Throttle so the swarm SPANS the kill window:
                # unthrottled loopback can drain every task before
                # kill_after and the rung would measure a no-op kill.
                total_download_rate_bps=4 * (1 << 20),
            )))
    except BaseException:
        # Same contract as the spawn guard: the big finally below only
        # starts once the swarm is running — a client/daemon ctor
        # failure here must not orphan three replica processes (or the
        # tmp tree) for the life of the machine.
        for d in daemons:
            try:
                d.stop()
            except Exception:  # noqa: BLE001 — teardown best effort
                pass
        if balanced is not None:
            try:
                balanced.close()
            except Exception:  # noqa: BLE001
                pass
        for proc in procs:
            proc.kill()
            proc.wait()
        if root is None:
            shutil.rmtree(tmp, ignore_errors=True)
        raise

    prev_piece_size = peer_task_mod.compute_piece_size
    peer_task_mod.compute_piece_size = lambda content_length: piece_size

    results: "queue_mod.Queue" = queue_mod.Queue()
    failures = []
    killed: dict = {}
    supervisor_stop = threading.Event()
    wall0 = time.perf_counter()
    try:
        for d in daemons:
            d.start()
        with MultiBlobServer(blobs) as origin:
            plan = FaultPlan(seed=seed)
            plan.add("scheduler.process", FaultKind.KILL, every_nth=1,
                     after=kill_after, max_fires=1)
            faultplan.install(plan)

            def live_owner_counts():
                counts = {t: 0 for t in targets}
                for tgt in balanced.peer_session_targets():
                    if tgt in counts:
                        counts[tgt] += 1
                return counts

            def supervisor() -> None:
                """Kill a session-owning replica when the (seeded,
                time-windowed) KILL rule fires. Prefer a victim whose
                session count just GREW: a session observed at the tail
                of its download can deliver its final report between
                the count and the SIGKILL landing (a no-op kill that
                measures no re-routes and voids the verdict), while a
                freshly registered session has its whole throttled
                download ahead. Only after no growth for a beat does it
                fall back to the busiest owner (a static count means
                the swarm is mid-download — also safe)."""
                fallback_wait_s = 0.5

                def alive(t):
                    return procs[targets.index(t)].poll() is None

                prev = {t: 0 for t in targets}
                last_grown = time.perf_counter()
                while not supervisor_stop.is_set() and not killed:
                    counts = live_owner_counts()
                    grown = [t for t in targets
                             if counts[t] > prev[t] and alive(t)]
                    prev = counts
                    victim = None
                    if grown:
                        last_grown = time.perf_counter()
                        victim = max(grown, key=lambda t: counts[t])
                    elif (time.perf_counter() - last_grown
                          > fallback_wait_s):
                        busiest = max(targets, key=lambda t: counts[t])
                        if counts[busiest] > 0 and alive(busiest):
                            victim = busiest
                    # The site is visited only while an eligible victim
                    # exists, so the one seeded fire always lands on it.
                    if victim is not None and faultplan.should_kill(
                            plan, "scheduler.process", context=victim):
                        proc = procs[targets.index(victim)]
                        proc.kill()
                        proc.wait()
                        killed["target"] = victim
                        killed["at_s"] = round(
                            time.perf_counter() - wall0, 3)
                        killed["owned_sessions"] = counts[victim]
                        return
                    supervisor_stop.wait(0.02)

            sup = threading.Thread(target=supervisor, daemon=True,
                                   name="replica-killer")
            sup.start()

            work: "queue_mod.Queue" = queue_mod.Queue()
            for path, blob in blobs.items():
                for daemon in daemons:
                    work.put((daemon, path, blob))

            def downloader() -> None:
                while True:
                    try:
                        daemon, path, blob = work.get_nowait()
                    except queue_mod.Empty:
                        return
                    want = hashlib.md5(blob).hexdigest()
                    begin = time.perf_counter()
                    try:
                        result = daemon.download_file(origin.url(path))
                    except Exception as exc:  # noqa: BLE001 — counted
                        results.put((path, time.perf_counter() - begin,
                                     f"raised: {exc}"))
                        continue
                    err = ""
                    if not result.success:
                        err = f"failed: {result.error}"
                    elif (hashlib.md5(result.read_all()).hexdigest()
                          != want):
                        err = "md5 mismatch"
                    results.put((path, time.perf_counter() - begin, err))

            pool = [threading.Thread(target=downloader, daemon=True,
                                     name=f"ha-dl-{i}")
                    for i in range(workers)]
            for t in pool:
                t.start()
            for t in pool:
                t.join()
            supervisor_stop.set()  # a no-kill run must not stall the join
            sup.join(timeout=1.0)
    finally:
        supervisor_stop.set()
        faultplan.uninstall()
        peer_task_mod.compute_piece_size = prev_piece_size
        for d in daemons:
            try:
                d.stop()
            except Exception:  # noqa: BLE001 — teardown best effort
                pass
        try:
            balanced.close()
        except Exception:  # noqa: BLE001
            pass
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if root is None:
            shutil.rmtree(tmp, ignore_errors=True)

    wall = time.perf_counter() - wall0
    downloads = 0
    durations = []
    while True:
        try:
            path, dur, err = results.get_nowait()
        except queue_mod.Empty:
            break
        downloads += 1
        durations.append(dur)
        if err:
            failures.append(f"{path}: {err}")
    reroutes = sorted(recovery.reroute_samples())
    grace = options.scheduler_grace
    degraded = recovery.get("scheduler_degraded_to_source")
    success_rate = round((downloads - len(failures)) / max(downloads, 1), 4)
    reroute_p99_s = percentile(reroutes, 0.99)
    verdict = bool(
        killed
        and success_rate >= SUCCESS_BOUND
        and degraded == 0
        and (not reroutes or reroute_p99_s <= grace)
        and recovery.get("scheduler_failovers") > 0
    )
    return {
        "replicas": replicas,
        "targets": targets,
        "tasks": tasks,
        "downloads": downloads,
        "pieces_per_task": size_bytes // piece_size,
        "failures": failures[:5],
        "success_rate": success_rate,
        "seconds": round(wall, 3),
        "killed": killed or None,
        "reroutes": len(reroutes),
        "reroute_p50_ms": round(percentile(reroutes, 0.50) * 1e3, 1),
        "reroute_p99_ms": round(reroute_p99_s * 1e3, 1),
        "reroute_bound_s": grace,
        "failovers": recovery.get("scheduler_failovers"),
        "reregisters": recovery.get("scheduler_reregisters"),
        "pieces_replayed": recovery.get("scheduler_failover_pieces_replayed"),
        "degraded_to_source": degraded,
        "download_p99_s": round(percentile(sorted(durations), 0.99), 3),
        "recovery_counters": recovery.snapshot(),
        "verdict_pass": verdict,
    }


class DaemonProc:
    """Supervisor handle for one ``client/daemon_proc.py`` child: spawn,
    parse its line protocol (DAEMON / PROGRESS / RESULT / STATS), and
    hard-kill or gracefully exit it. The stdout reader runs on its own
    thread so a SIGKILLed child just EOFs the pipe."""

    def __init__(self, storage_root: str, scheduler_targets, *,
                 hostname: str, piece_size: int = 0,
                 download_rate: float = 0.0, persist_every: int = 2,
                 startup_timeout: float = 30.0, native: bool = False,
                 timeout: float = 0.0, poll_interval: float = 0.0,
                 piece_concurrency: int = 0, serve_rpc: bool = False,
                 host_type: str = "", fallback_wait: float = 0.0,
                 scheduler_grace: float = 0.0,
                 extra_args: "Sequence[str]" = ()):
        import os
        import queue as queue_mod
        import subprocess
        import sys
        import threading

        env = dict(os.environ)
        env.setdefault("JAX_PLATFORMS", "cpu")  # never probe a device
        cmd = [sys.executable, "-m", "dragonfly2_tpu_torch.client.daemon_proc",
               "--storage-root", storage_root, "--hostname", hostname,
               "--persist-every", str(persist_every)]
        for target in scheduler_targets:
            cmd += ["--scheduler", target]
        if piece_size > 0:
            cmd += ["--piece-size", str(piece_size)]
        if download_rate > 0:
            cmd += ["--download-rate", str(download_rate)]
        if native:
            cmd += ["--native"]
        if timeout > 0:
            cmd += ["--timeout", str(timeout)]
        if poll_interval > 0:
            cmd += ["--poll-interval", str(poll_interval)]
        if piece_concurrency > 0:
            cmd += ["--piece-concurrency", str(piece_concurrency)]
        if serve_rpc:
            cmd += ["--serve-rpc"]
        if host_type:
            cmd += ["--type", host_type]
        if fallback_wait > 0:
            cmd += ["--fallback-wait", str(fallback_wait)]
        if scheduler_grace > 0:
            cmd += ["--scheduler-grace", str(scheduler_grace)]
        # Observability (and future) daemon_proc knobs pass through
        # verbatim — e.g. ("--trace-dir", d, "--metrics-port", "0").
        cmd += list(extra_args)
        self.proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, env=env)
        self._progress_lock = threading.Lock()
        self.progress: Dict[str, int] = {}  # url → cumulative fresh bytes
        # url → perf_counter stamp of the LAST progress event — the
        # fan-out rungs read time-to-last-byte from these instead of
        # RESULT arrival (which also pays the md5 verification pass).
        self.progress_at: Dict[str, float] = {}
        self.results: "queue_mod.Queue" = queue_mod.Queue()
        self.stats_q: "queue_mod.Queue" = queue_mod.Queue()
        self.geo_q: "queue_mod.Queue" = queue_mod.Queue()
        self._ready: "queue_mod.Queue" = queue_mod.Queue()
        threading.Thread(target=self._read_loop, name=f"proc-read-{hostname}",
                         daemon=True).start()
        try:
            first = self._ready.get(timeout=startup_timeout)
        except queue_mod.Empty:
            self.kill()
            raise RuntimeError(
                f"daemon proc did not start within {startup_timeout}s"
            ) from None
        if not isinstance(first, tuple):
            self.kill()
            raise RuntimeError(f"daemon proc failed to start: {first!r}")
        self.host_id, self.address, self.rpc_target = first

    def _read_loop(self) -> None:
        import json as json_mod

        announced = False
        for raw in self.proc.stdout:
            line = raw.strip()
            kind, _, rest = line.partition(" ")
            if kind == "DAEMON" and not announced:
                announced = True
                parts = rest.split(" ")
                self._ready.put((parts[0],
                                 parts[1] if len(parts) > 1 else "",
                                 parts[2] if len(parts) > 2 else ""))
            elif kind == "PROGRESS":
                url, _, total = rest.rpartition(" ")
                try:
                    with self._progress_lock:
                        self.progress[url] = int(total)
                        self.progress_at[url] = time.perf_counter()
                except ValueError:
                    pass
            elif kind == "RESULT":
                self.results.put(json_mod.loads(rest))
            elif kind == "STATS":
                self.stats_q.put(json_mod.loads(rest))
            elif kind in ("GEO-OK", "GEO-ERR"):
                self.geo_q.put((kind == "GEO-OK", rest))
            elif not announced:
                announced = True
                self._ready.put(line)  # startup failure text

    def progress_of(self, url: str) -> int:
        with self._progress_lock:
            return self.progress.get(url, 0)

    def _send(self, line: str) -> None:
        try:
            self.proc.stdin.write(line + "\n")
            self.proc.stdin.flush()
        except (BrokenPipeError, OSError, ValueError):
            pass  # child already dead — callers time out on the queue

    def download(self, url: str) -> None:
        self._send(f"DOWNLOAD {url}")

    def result(self, timeout: float) -> dict:
        return self.results.get(timeout=timeout)

    def stats(self, timeout: float = 10.0) -> dict:
        self._send("STATS")
        return self.stats_q.get(timeout=timeout)

    def geo_install(self, plan_dict: dict, timeout: float = 10.0) -> None:
        """Install/replace the child's WAN link-emulation plan
        (docs/GEO.md) — sent post-spawn because the fleet's ephemeral
        addresses are only known from the DAEMON lines; re-sending with
        partitioned links is the geo bench's partition trigger."""
        import json as json_mod

        self._send("GEO " + json_mod.dumps(plan_dict))
        ok, err = self.geo_q.get(timeout=timeout)
        if not ok:
            raise RuntimeError(f"geo plan install failed: {err}")

    def kill(self) -> None:
        self.proc.kill()
        self.proc.wait()

    def exit(self, timeout: float = 10.0) -> None:
        self._send("EXIT")
        try:
            self.proc.wait(timeout=timeout)
        except Exception:  # noqa: BLE001 — teardown best effort
            self.kill()


def run_daemon_kill_rung(*, size_bytes: int = 4 << 20,
                         warm_bytes: int = 512 << 10,
                         piece_size: int = 64 << 10, seed: int = 0,
                         kill_fraction: float = DAEMON_KILL_FRACTION,
                         download_rate: float = 2 * (1 << 20),
                         timeout_s: float = 60.0,
                         root: str | None = None,
                         daemon_extra_args: Sequence[str] = ()) -> dict:
    """The ISSUE-8 chaos rung: SIGKILL a daemon PROCESS mid-download,
    restart it on the same storage root, and bound the damage.

    Script: a victim daemon (throttled so the kill window exists on
    loopback) completes a warm task, then starts a big one; when its
    fresh-byte progress crosses ``kill_fraction`` the seeded
    ``daemon.process`` KILL site fires and the supervisor SIGKILLs it.
    The restart (same root, unthrottled) must (a) resume the big task
    — journaled pieces verified and skipped, re-downloaded bytes ≤
    missing bytes + one piece per worker — and (b) re-announce the
    warm replica, proven by an in-process child downloading it with
    back-to-source DISABLED (every byte must come off the restarted
    seed). Verdict: 100 % task success, both md5s exact, the
    re-download bound holds, ≥ 1 piece resumed, ≥ 1 piece served."""
    import os
    import time as time_mod

    import numpy as np

    from dragonfly2_tpu_torch.client.daemon import Daemon, DaemonConfig
    from dragonfly2_tpu_torch.client.recovery import RecoveryStats
    from dragonfly2_tpu_torch.scheduler.rpcserver import BalancedSchedulerClient

    tmp = root or tempfile.mkdtemp(prefix="df2-dk-")
    victim_root = os.path.join(tmp, "victim")
    rng = np.random.default_rng(seed * 31 + 7)
    warm_blob = rng.bytes(warm_bytes)
    big_blob = rng.bytes(size_bytes)
    warm_md5 = hashlib.md5(warm_blob).hexdigest()
    big_md5 = hashlib.md5(big_blob).hexdigest()
    deadline = time_mod.monotonic() + timeout_s

    def left() -> float:
        return max(deadline - time_mod.monotonic(), 0.1)

    sched_proc = victim = restarted = child = None
    child_client = None
    # Every key the bench stage records is present from the start, so
    # an early-return failure path still produces a complete (failed)
    # report instead of a KeyError that eats the stage verdict.
    out: dict = {
        "size_bytes": size_bytes, "warm_bytes": warm_bytes,
        "piece_size": piece_size, "kill_fraction": kill_fraction,
        "failures": [], "verdict_pass": False, "killed": None,
        "resume": {}, "reseed": {}, "recovery_counters": {},
        "missing_bytes": None, "refetch_bound_bytes": None,
        "downloads": 0, "success_rate": 0.0,
    }
    # Piece sizing: the daemon processes pin it via --piece-size; the
    # in-process child never computes one (its piece shapes come from
    # the register response and the parent's metadata inventory), so
    # nothing is patched in THIS process.
    try:
        sched_proc, target = spawn_scheduler_replica(
            os.path.join(tmp, "sched"))
        with MultiBlobServer({"/dk/warm": warm_blob,
                              "/dk/big": big_blob}) as origin:
            warm_url = origin.url("/dk/warm")
            big_url = origin.url("/dk/big")
            victim = DaemonProc(
                victim_root, [target], hostname="dk-victim",
                piece_size=piece_size, download_rate=download_rate,
                extra_args=daemon_extra_args)
            victim.download(warm_url)
            warm1 = victim.result(timeout=left())
            if not warm1.get("ok"):
                out["failures"].append(f"warm: {warm1.get('error')}")
                return out

            # The kill decision rides the fault plane like the
            # scheduler-kill precedent: the site is visited once the
            # progress threshold is reached, and the seeded rule fires.
            plan = FaultPlan(seed=seed)
            plan.add("daemon.process", FaultKind.KILL, every_nth=1,
                     max_fires=1)
            faultplan.install(plan)
            victim.download(big_url)
            killed = None
            finished_early = False
            threshold = int(size_bytes * kill_fraction)
            while time_mod.monotonic() < deadline:
                done = victim.progress_of(big_url)
                if done >= threshold and faultplan.should_kill(
                        plan, "daemon.process", context="dk-victim"):
                    victim.kill()
                    killed = {"at_bytes": done,
                              "fraction": round(done / size_bytes, 3)}
                    break
                if not victim.results.empty():
                    finished_early = True  # beat the threshold — no-op
                    break
                time_mod.sleep(0.02)
            out["killed"] = killed
            if killed is None:
                # Distinguish the two red causes: a too-fast download
                # (raise the throttle/size) vs a stalled one that never
                # reached the threshold before the rung deadline.
                out["failures"].append(
                    "kill window missed (download finished before the "
                    f"{kill_fraction:.0%} threshold)" if finished_early
                    else "kill window missed (download stalled at "
                    f"{victim.progress_of(big_url)}/{size_bytes} bytes "
                    "until the rung deadline)")
                return out

            # Restart on the SAME storage root, unthrottled: restart
            # must be a RESUME end to end.
            restarted = DaemonProc(
                victim_root, [target], hostname="dk-victim",
                piece_size=piece_size, extra_args=daemon_extra_args)
            restarted.download(big_url)
            big2 = restarted.result(timeout=left())
            stats = restarted.stats(timeout=left())
            out["resume"] = {
                k: big2.get(k) for k in (
                    "ok", "error", "md5", "bytes_fresh", "pieces_fresh",
                    "resumed_pieces", "resumed_bytes")}
            out["recovery_counters"] = {
                k: stats.get(k) for k in (
                    "reload_pieces_verified", "reload_pieces_dropped",
                    "reload_orphans_swept", "tasks_resumed",
                    "resume_pieces_reused", "seed_tasks_reannounced")}
            missing = size_bytes - big2.get("resumed_bytes", 0)
            # "One piece per worker" tracks the engine it constrains:
            # the victim runs default fetch concurrency (daemon_proc
            # leaves piece/back-source concurrency at the
            # PeerTaskOptions defaults).
            from dragonfly2_tpu_torch.client.peer_task import PeerTaskOptions

            defaults = PeerTaskOptions()
            workers = max(defaults.piece_concurrency,
                          defaults.back_source_concurrency)
            refetch_bound = missing + workers * piece_size
            out["missing_bytes"] = missing
            out["refetch_bound_bytes"] = refetch_bound
            if not big2.get("ok"):
                out["failures"].append(f"resume: {big2.get('error')}")
            elif big2.get("md5") != big_md5:
                out["failures"].append("resume: md5 mismatch")
            if big2.get("resumed_pieces", 0) <= 0:
                out["failures"].append(
                    "restart resumed nothing (journal lost?)")
            if big2.get("bytes_fresh", 0) > refetch_bound:
                out["failures"].append(
                    f"re-downloaded {big2.get('bytes_fresh')} bytes > "
                    f"bound {refetch_bound}")
            if stats.get("seed_tasks_reannounced", 0) < 1:
                out["failures"].append("restarted seed did not re-announce")

            # Re-seed proof: an in-process child pulls the WARM task
            # with back-to-source disabled — every piece must be served
            # by the restarted daemon.
            child_recovery = RecoveryStats()
            child_client = BalancedSchedulerClient(
                [target], recovery=child_recovery)
            child = Daemon(child_client, DaemonConfig(
                storage_root=os.path.join(tmp, "child"),
                hostname="dk-child", keep_storage=False,
                recovery_stats=child_recovery,
                task_options=_chaos_task_options()))
            child.start()
            served_pieces = [0]
            child_result = child.download_file(
                warm_url, disable_back_source=True,
                piece_sink=lambda s, p: served_pieces.__setitem__(
                    0, served_pieces[0] + 1))
            out["reseed"] = {
                "child_ok": bool(child_result.success),
                "child_error": child_result.error,
                "served_pieces": served_pieces[0],
            }
            if not child_result.success:
                out["failures"].append(
                    f"reseed child: {child_result.error}")
            else:
                got = hashlib.md5(child_result.read_all()).hexdigest()
                if got != warm_md5:
                    out["failures"].append("reseed child: md5 mismatch")
            if served_pieces[0] < 1:
                out["failures"].append("restarted seed served no pieces")
            out["downloads"] = 3  # warm + resumed big + child warm
            failed_downloads = sum(
                1 for ok in (warm1.get("ok"), big2.get("ok"),
                             child_result.success) if not ok)
            out["success_rate"] = round(1.0 - failed_downloads / 3.0, 4)
            out["verdict_pass"] = not out["failures"]
            return out
    except Exception as exc:  # noqa: BLE001 — the rung reports, not raises
        out["failures"].append(f"rung error: {type(exc).__name__}: {exc}")
        return out
    finally:
        faultplan.uninstall()
        if child is not None:
            try:
                child.stop()
            except Exception:  # noqa: BLE001 — teardown best effort
                pass
        if child_client is not None:
            try:
                child_client.close()
            except Exception:  # noqa: BLE001
                pass
        for proc in (victim, restarted):
            if proc is not None:
                proc.exit(timeout=5.0)
        if sched_proc is not None:
            sched_proc.kill()
            sched_proc.wait()
        if root is None:
            shutil.rmtree(tmp, ignore_errors=True)


def best_recorded_chaos(state_dir: str) -> "dict | None":
    """Best persisted green chaos ladder (highest goodput retention)
    from artifacts/bench_state/chaos_run_*.json."""
    import glob
    import json as json_mod
    import os

    best = None
    for path in glob.glob(os.path.join(state_dir, "chaos_run_*.json")):
        try:
            with open(path) as f:
                run = json_mod.load(f)
        except (OSError, ValueError):
            continue
        ladder = run.get("ladder") or {}
        if not ladder.get("verdict_pass"):
            continue
        retention = ladder.get("goodput_retention_at_max", 0.0)
        if best is None or retention > best["goodput_retention_at_max"]:
            best = {"path": path,
                    "goodput_retention_at_max": retention}
    return best


def check_chaos_regression(
        state_dir: str, *,
        fraction: float = CHAOS_REGRESSION_FRACTION) -> dict:
    """``bench.py chaos --check-regression`` — the one-command chaos
    gate (parity with the PR 7 dataplane gate): a FRESH ladder + the
    daemon-kill rung vs the best persisted record. Fails when any rung
    loses its verdict or fresh retention drops below ``fraction`` of
    the record (the fraction absorbs machine noise; a real recovery
    regression fails the 100 %-success bound outright)."""
    best = best_recorded_chaos(state_dir)
    ladder = run_chaos_ladder(seed=0)
    daemon_kill = run_daemon_kill_rung(seed=0)
    out = {
        "fresh_retention": ladder["goodput_retention_at_max"],
        "fresh_ladder_pass": ladder["verdict_pass"],
        "fresh_daemon_kill_pass": daemon_kill["verdict_pass"],
        "daemon_kill_failures": daemon_kill["failures"][:5],
        "best_recorded": best,
        "fraction": fraction,
    }
    passed = bool(ladder["verdict_pass"] and daemon_kill["verdict_pass"])
    if best is None:
        out["note"] = ("no persisted record; gate covers the absolute "
                       "ladder + daemon-kill bounds only")
    else:
        # Retention > 1.0 is a loopback artifact (docs/CHAOS.md: an
        # injected register fault short-circuits to back-to-source,
        # which is FASTER than mesh scheduling there) — gating against
        # a lucky >1.0 record would fail every honest run, so the
        # record is clamped to 1.0 and the comparison measures only
        # real recovery-throughput collapse.
        reference = min(best["goodput_retention_at_max"], 1.0)
        out["reference_retention"] = reference
        passed = passed and (
            ladder["goodput_retention_at_max"] >= fraction * reference)
    out["passed"] = passed
    return out


def run_chaos_ladder(rates: Sequence[float] = DEFAULT_RATES, *,
                     tasks: int = 3, size_bytes: int = 3 << 20,
                     piece_size: int = 256 << 10, seed: int = 0,
                     tls: bool = False,
                     root: str | None = None) -> dict:
    """Run the ladder; returns per-rung results + the verdict.

    The piece size is shrunk (module-level patch of the conductor's
    ``compute_piece_size`` binding, same technique as the data-plane
    test fixtures) so each task spans many pieces without multi-GB
    blobs — fault/recovery behavior is per-piece, so piece COUNT is
    what the ladder needs.

    ``tls=True`` runs every p2p leg over TLS (throwaway openssl-CLI CA)
    and adds mid-handshake resets to the fault mix; the result carries
    ``{"skipped": True}`` when the CLI can't mint certs.
    """
    import numpy as np

    from dragonfly2_tpu_torch.client import peer_task as peer_task_mod

    blobs = {
        f"/chaos/blob-{i}": np.random.default_rng(seed + i).bytes(size_bytes)
        for i in range(tasks)
    }
    tmp = root or tempfile.mkdtemp(prefix="df2-chaos-")
    tls_conf = None
    if tls:
        from dragonfly2_tpu_torch.utils import tlsconf

        if not tlsconf.openssl_available():
            if root is None:
                shutil.rmtree(tmp, ignore_errors=True)
            return {"skipped": True,
                    "reason": "openssl CLI unavailable for TLS certs"}
        ca_cert, ca_key = tlsconf.mint_ca(os.path.join(tmp, "tls"),
                                          "df2-chaos-ca")
        cert, key = tlsconf.mint_leaf(os.path.join(tmp, "tls"),
                                      "127.0.0.1", ca_cert, ca_key)
        tls_conf = (cert, key, ca_cert)
    prev_piece_size = peer_task_mod.compute_piece_size
    peer_task_mod.compute_piece_size = lambda content_length: piece_size
    ladder: Dict[str, dict] = {}
    try:
        for idx, rate in enumerate(rates):
            rung_tmp = tempfile.mkdtemp(prefix=f"rung{idx}-", dir=tmp)
            ladder[str(rate)] = _run_rung(
                rate, blobs=blobs, seed=seed * 1000 + idx, tmp=rung_tmp,
                tls_conf=tls_conf)
    finally:
        peer_task_mod.compute_piece_size = prev_piece_size
        if root is None:
            shutil.rmtree(tmp, ignore_errors=True)
    base = ladder[str(rates[0])]["mb_per_s"] or 1e-9
    top = ladder[str(max(rates))]
    retention = round(top["mb_per_s"] / base, 3)
    all_success = all(r["success_rate"] >= SUCCESS_BOUND
                      for r in ladder.values())
    verdict = all_success and retention >= GOODPUT_RETENTION_BOUND
    return {
        "rates": list(rates),
        "ladder": ladder,
        "tls": tls,
        "pieces_per_task": size_bytes // piece_size,
        "goodput_retention_at_max": retention,
        "goodput_retention_bound": GOODPUT_RETENTION_BOUND,
        "success_bound": SUCCESS_BOUND,
        "all_rungs_full_success": all_success,
        "verdict_pass": verdict,
    }
