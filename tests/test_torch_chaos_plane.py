"""The in-process chaos plane and the modules the port's data plane and
tracing reach for, held against the JAX package on the CPU.

- data-plane TLS: two port daemons whose upload servers and peer
  fetches use certificates minted by the port's ``utils/tlsconf``
  download a blob byte for byte over a TLS peer leg;
- the upload benches (``client/uploadbench``): the seed task equals the
  JAX package's, and ``dataplane.run_splice_loopback_bench`` runs;
- OTLP export (``utils/otlp``): ``cmd.common.init_tracing`` with
  ``--otlp-endpoint`` delivers to a loopback collector the request the
  JAX package's ``spans_to_request`` builds from the same records;
- the chaos ladder (``client/chaosbench``): ``build_fault_plan`` fires
  as JAX's does, one fault rung at small blobs ends byte-exact, and the
  two kill rungs — a scheduler replica process (``scheduler.replica``)
  and a daemon process (``client.daemon_proc``) killed mid-swarm — end
  green with JAX's report keys, their seeded KILL rules firing as JAX's;
- probe anti-entropy between two ``cmd.scheduler`` processes
  (``--replica-peer``): a probe fed into one shows on the other;
- ``utils/reload.ConfigWatcher``: the same callbacks as JAX's for a
  change, a bad edit and another change.
"""

from __future__ import annotations

import argparse
import hashlib
import http.server
import json
import os
import threading
import time

import numpy as np
import pytest

from dragonfly2_tpu.client import chaosbench as jax_chaos
from dragonfly2_tpu.client import uploadbench as jax_uploadbench
from dragonfly2_tpu.utils import otlp as jax_otlp
from dragonfly2_tpu.utils import reload as jax_reload
from dragonfly2_tpu.utils.tlsconf import openssl_available

# The port's modules under test are imported inside each test, so that a
# missing one fails that test alone.
needs_openssl = pytest.mark.skipif(
    not openssl_available(), reason="openssl CLI unavailable for certs")


def _scheduler(root: str):
    from dragonfly2_tpu_torch.scheduler.evaluator.base import BaseEvaluator
    from dragonfly2_tpu_torch.scheduler.resource.resource import Resource
    from dragonfly2_tpu_torch.scheduler.scheduling.core import (
        Scheduling,
        SchedulingConfig,
    )
    from dragonfly2_tpu_torch.scheduler.service import SchedulerService
    from dragonfly2_tpu_torch.scheduler.storage.storage import Storage

    return SchedulerService(
        resource=Resource(),
        scheduling=Scheduling(BaseEvaluator(),
                              SchedulingConfig(retry_interval=0.01)),
        storage=Storage(os.path.join(root, "datasets")))


# ----------------------------------------------------------------------
# Data-plane TLS
# ----------------------------------------------------------------------


@needs_openssl
def test_tls_daemons_download_byte_for_byte(tmp_path):
    """A seeds the blob from the origin; B pulls it from A's TLS upload
    server, checking A's certificate against the minted CA."""
    from dragonfly2_tpu_torch.client.chaosbench import MultiBlobServer
    from dragonfly2_tpu_torch.client.daemon import Daemon, DaemonConfig
    from dragonfly2_tpu_torch.client.dataplane import DataPlaneStats
    from dragonfly2_tpu_torch.utils import tlsconf

    work = str(tmp_path / "tls")
    ca_cert, ca_key = tlsconf.mint_ca(work, "df2-test-ca")
    cert, key = tlsconf.mint_leaf(work, "127.0.0.1", ca_cert, ca_key)
    stats = DataPlaneStats()
    service = _scheduler(str(tmp_path))
    daemons = [Daemon(service, DaemonConfig(
        storage_root=str(tmp_path / name), hostname=name,
        keep_storage=False, dataplane_stats=stats,
        upload_tls_cert=cert, upload_tls_key=key, peer_tls_ca=ca_cert))
        for name in ("tls-a", "tls-b")]
    blob = np.random.default_rng(5).bytes(3 << 20)
    try:
        for d in daemons:
            d.start()
        with MultiBlobServer({"/tls/blob": blob}) as origin:
            for d in daemons:
                result = d.download_file(origin.url("/tls/blob"))
                assert result.success, result.error
                assert hashlib.md5(result.read_all()).digest() == \
                    hashlib.md5(blob).digest()
    finally:
        for d in daemons:
            d.stop()
    snap = stats.snapshot()
    assert snap["tls_handshakes"] >= 1, snap
    assert snap["tls_client_handshakes"] >= 1, snap
    parents = {p.host.hostname for r in service.storage.list_download()
               if r.host.hostname == "tls-b" for p in r.parents}
    assert parents == {"tls-a"}


# ----------------------------------------------------------------------
# Upload benches
# ----------------------------------------------------------------------


def test_seed_task_equals_jax(tmp_path):
    from dragonfly2_tpu_torch.client import uploadbench as port_uploadbench

    kw = dict(size_bytes=(1 << 20) + 12345, piece_size=256 << 10, seed=4)
    _, jax_pieces = jax_uploadbench.build_seed_task(str(tmp_path / "j"),
                                                    **kw)
    _, port_pieces = port_uploadbench.build_seed_task(str(tmp_path / "p"),
                                                      **kw)
    assert [(p.num, p.md5, p.offset, p.length) for p in port_pieces] == \
        [(p.num, p.md5, p.offset, p.length) for p in jax_pieces]


def test_splice_loopback_bench_runs(tmp_path):
    from dragonfly2_tpu_torch import native
    from dragonfly2_tpu_torch.client.dataplane import (
        run_splice_loopback_bench,
    )

    out = run_splice_loopback_bench(size_bytes=4 << 20,
                                    piece_size=256 << 10, attempts=1,
                                    root=str(tmp_path))
    if not native.available():
        assert out["skipped"] is True
        return
    assert out["clean"], out["attempts"]
    assert out["verified_pieces"] == out["pieces"] == 16
    assert out["splice_bytes"] > 0


def test_upload_loopback_bench_verifies_every_body(tmp_path):
    from dragonfly2_tpu_torch.client import uploadbench as port_uploadbench

    out = port_uploadbench.run_upload_loopback_bench(
        size_bytes=2 << 20, piece_size=256 << 10, streams=2,
        verify_every=1, attempts=1, root=str(tmp_path))
    assert out["md5_ok"], out["failures"]
    assert out["pieces"] == out["pieces_md5_verified"] == 8
    assert out["bytes"] == 2 << 20


# ----------------------------------------------------------------------
# OTLP export
# ----------------------------------------------------------------------


class _Collector:
    """A loopback OTLP/HTTP collector: records each POST's decoded body."""

    def __init__(self):
        collector = self
        self.requests = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802
                body = self.rfile.read(int(self.headers["Content-Length"]))
                collector.requests.append({
                    "path": self.path,
                    "content_type": self.headers["Content-Type"],
                    "body": json.loads(body)})
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(b"{}")

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.endpoint = f"http://127.0.0.1:{self.server.server_port}"
        threading.Thread(target=self.server.serve_forever,
                         daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def test_init_tracing_exports_jax_request_over_otlp():
    from dragonfly2_tpu_torch.cmd.common import init_tracing
    from dragonfly2_tpu_torch.utils import tracing

    collector = _Collector()
    before = tracing.default_tracer()
    try:
        init_tracing(argparse.Namespace(
            trace_dir="", otlp_endpoint=collector.endpoint,
            trace_sample=1.0), "manager")
        tracer = tracing.default_tracer()
        assert tracer is not before and tracer.enabled
        records = []
        enqueue = tracer._otlp.enqueue

        def capture(record):
            records.append(json.loads(json.dumps(record)))
            enqueue(record)

        tracer._otlp.enqueue = capture
        with tracer.span("create_model", model_id="m1", retries=2):
            with tracer.span("validate", rows=12, ratio=0.5, ok=True):
                pass
        try:
            with tracer.span("boom"):
                raise ValueError("x")
        except ValueError:
            pass
        tracer.flush()
        tracer.close()
    finally:
        tracing.set_default_tracer(before)
        collector.close()
    assert len(records) == 3
    assert [r["path"] for r in collector.requests] == ["/v1/traces"]
    assert collector.requests[0]["content_type"] == "application/json"
    want = json.loads(json.dumps(jax_otlp.spans_to_request(
        "manager", [jax_otlp.record_to_otlp_span(r) for r in records])))
    # The instrumentation scope names the package that made the spans.
    scope = want["resourceSpans"][0]["scopeSpans"][0]["scope"]
    assert scope == {"name": "dragonfly2_tpu.utils.tracing"}
    scope["name"] = "dragonfly2_tpu_torch.utils.tracing"
    assert collector.requests[0]["body"] == want


# ----------------------------------------------------------------------
# The chaos ladder
# ----------------------------------------------------------------------


@pytest.mark.parametrize("tls", [False, True])
@pytest.mark.parametrize("rate,seed", [(0.01, 0), (0.05, 3), (0.3, 7)])
def test_fault_plan_fires_as_jax(rate, seed, tls):
    from dragonfly2_tpu_torch.client import chaosbench as port_chaos

    plans = [mod.build_fault_plan(rate, seed, tls=tls)
             for mod in (jax_chaos, port_chaos)]
    rules = [{site: [(r.kind.value, r.probability) for r in rs]
              for site, rs in plan._rules.items()} for plan in plans]
    assert rules[0] == rules[1]
    for plan in plans:
        for visit in range(400):
            for site in sorted(plan._rules):
                plan.check(site, f"ctx-{visit}")
    assert plans[1].history == plans[0].history
    assert plans[1].snapshot() == plans[0].snapshot()
    assert plans[1].history  # the rate fires at these visit counts


def test_fault_rung_small_blobs_byte_exact(tmp_path):
    """The ladder's top rate, every download md5-exact. Which visits a
    fault hits depends only on the seed and on how often each site was
    visited, so the rung's fires must be the fresh plan's after as many
    visits; at seed 24 the ``scheduler.rpc`` coin comes up on its 5th
    visit, and a rung makes several times that many."""
    from dragonfly2_tpu_torch.client import chaosbench as port_chaos

    out = port_chaos.run_chaos_ladder(
        rates=(0.05,), tasks=2, size_bytes=512 << 10,
        piece_size=64 << 10, seed=24, root=str(tmp_path))
    rung = out["ladder"]["0.05"]
    assert rung["success_rate"] == 1.0, rung["failures"]
    assert rung["bytes_ok"] == 2 * 2 * (512 << 10)
    assert out["pieces_per_task"] == 8
    replay = jax_chaos.build_fault_plan(0.05, 24 * 1000)
    for site, seen in rung["faults"].items():
        for _ in range(seen["visits"]):
            replay.check(site)
    assert replay.snapshot() == rung["faults"]
    assert rung["faults"]["scheduler.rpc"]["total_fires"] >= 1
    assert out["all_rungs_full_success"]


#: The kill rungs at test size (each about 6 and 13 s on the CPU).
KILL_RUNGS = {
    "run_scheduler_kill_rung": dict(tasks=6, size_bytes=1 << 20,
                                    piece_size=64 << 10, seed=3),
    "run_daemon_kill_rung": dict(seed=0),
}


@pytest.fixture(scope="module")
def kill_rung_reports(tmp_path_factory):
    """rung → {"port": report, "jax": report}. The two packages' rungs
    run side by side (their fault planes and counters are separate
    module globals); each rung's processes are its own package's."""
    from dragonfly2_tpu_torch.client import chaosbench as port_chaos

    reports = {rung: {} for rung in KILL_RUNGS}

    def run(pkg, chaos, rung):
        root = tmp_path_factory.mktemp(f"{rung}-{pkg}")
        try:
            reports[rung][pkg] = getattr(chaos, rung)(
                root=str(root), **KILL_RUNGS[rung])
        except Exception as exc:  # noqa: BLE001 — reported by the test
            reports[rung][pkg] = {"error": repr(exc)}

    for rung in KILL_RUNGS:
        threads = [threading.Thread(target=run, args=(pkg, chaos, rung))
                   for pkg, chaos in (("port", port_chaos),
                                      ("jax", jax_chaos))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
    return reports


@pytest.mark.parametrize("rung", sorted(KILL_RUNGS))
def test_kill_rung_green_with_jax_report_keys(kill_rung_reports, rung):
    """``run_scheduler_kill_rung`` SIGKILLs a ``scheduler.replica``
    process mid-swarm; ``run_daemon_kill_rung`` SIGKILLs a
    ``client.daemon_proc`` process mid-download and restarts it. Both run
    through the port's processes to a green verdict, with the report JAX's
    rung gives."""
    port, ref = kill_rung_reports[rung]["port"], kill_rung_reports[rung]["jax"]
    assert "error" not in port, port
    assert "error" not in ref, ref
    assert sorted(port) == sorted(ref)
    assert port["verdict_pass"], json.dumps(port, indent=1, default=str)
    assert port["success_rate"] == 1.0 and port["killed"]
    if rung == "run_scheduler_kill_rung":
        assert port["degraded_to_source"] == 0 and port["failovers"] >= 1
        assert port["reroute_p99_ms"] <= port["reroute_bound_s"] * 1e3
    else:
        assert 0.3 <= port["killed"]["fraction"] <= 0.9
        assert port["resume"]["ok"] and port["resume"]["resumed_pieces"] > 0
        assert port["resume"]["bytes_fresh"] <= port["refetch_bound_bytes"]
        assert port["reseed"]["child_ok"]
        assert port["recovery_counters"]["seed_tasks_reannounced"] >= 1


@pytest.mark.parametrize("site,rule", [
    ("scheduler.process", dict(every_nth=1, after=0.0, max_fires=1)),
    ("daemon.process", dict(every_nth=1, max_fires=1)),
])
@pytest.mark.parametrize("seed", [0, 3])
def test_kill_rule_fires_as_jax(site, rule, seed):
    """The rungs' seeded KILL rules: the same seed fires on the same
    visit, once, in both packages."""
    from dragonfly2_tpu.utils import faultplan as jax_faultplan
    from dragonfly2_tpu_torch.utils import faultplan

    fired = []
    for fp in (faultplan, jax_faultplan):
        plan = fp.FaultPlan(seed=seed)
        plan.add(site, fp.FaultKind.KILL, **rule)
        fired.append([fp.should_kill(plan, site, context=f"v{i}")
                      for i in range(20)])
        fired[-1].append(plan.snapshot())
    assert fired[0] == fired[1]
    assert fired[0][:20].count(True) == 1


# ----------------------------------------------------------------------
# Probe anti-entropy across scheduler processes
# ----------------------------------------------------------------------


def test_probes_replicate_between_scheduler_processes(tmp_path):
    """Two ``python -m dragonfly2_tpu_torch.cmd.scheduler`` processes
    peered with ``--replica-peer``: a probe fed into A over its
    ``SyncProbes`` stream shows on B within a sync tick, read through B's
    ``SyncReplicaProbes``."""
    import signal
    import socket
    import subprocess
    import sys

    from dragonfly2_tpu_torch.scheduler.resource import Host
    from dragonfly2_tpu_torch.scheduler.rpcserver import GrpcSchedulerClient
    from dragonfly2_tpu_torch.scheduler.service import ProbeResult
    from dragonfly2_tpu_torch.schema.records import Network

    def free_port() -> int:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    ports = [free_port(), free_port()]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dragonfly2_tpu_torch.cmd.scheduler",
         "--host", "127.0.0.1", "--port", str(ports[i]),
         "--data-dir", str(tmp_path / f"data-{i}"),
         "--replica-peer", f"127.0.0.1:{ports[1 - i]}",
         "--replica-sync-interval", "0.5"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env, cwd=repo) for i in (0, 1)]
    a = b = None
    try:
        for proc in procs:
            watchdog = threading.Timer(120, proc.kill)
            watchdog.start()
            line = proc.stdout.readline()
            watchdog.cancel()
            assert line.startswith("scheduler serving on "), line
        a = GrpcSchedulerClient(f"127.0.0.1:{ports[0]}")
        b = GrpcSchedulerClient(f"127.0.0.1:{ports[1]}")
        for client in (a, b):
            for h in ("h-src", "h-dst"):
                client.announce_host(Host(id=h, hostname=h, ip="127.0.0.1",
                                          network=Network(idc="x")))
        sync = a.probe_sync("h-src")
        reported = sync.sync("h-src", lambda targets: (
            [ProbeResult(t.host_id, 0.017) for t in targets], []))
        sync.close()
        assert reported >= 1
        deadline = time.monotonic() + 20.0
        rtts = []
        while time.monotonic() < deadline and not rtts:
            delta = b.sync_replica_probes({}, since=0.0)
            rtts = [edge["probes"][0]["rtt"]
                    for edge in delta.get("edges", [])
                    if (edge["src"], edge["dst"]) == ("h-src", "h-dst")]
            time.sleep(0.25)
        assert rtts == [pytest.approx(0.017)]
    finally:
        for client in (a, b):
            if client is not None:
                client.close()
        for proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        codes = []
        for proc in procs:
            try:
                codes.append(proc.wait(timeout=20))
            except subprocess.TimeoutExpired:
                proc.kill()
                codes.append(proc.wait())
            proc.stdout.close()
    assert codes == [0, 0]


# ----------------------------------------------------------------------
# Config hot reload
# ----------------------------------------------------------------------


def _reload_callbacks(mod, path) -> list:
    """Write, start, then change / corrupt / change the file, poking
    the watcher after each edit; returns what the callback saw."""
    import yaml

    with open(path, "w") as f:
        f.write(yaml.safe_dump({"upload_rate": 100}))
    seen = []
    watcher = mod.ConfigWatcher(str(path), seen.append, interval=0,
                                install_sighup=False).start()
    try:
        for text in (yaml.safe_dump({"upload_rate": 250}),
                     "]]]] not yaml {{{{",
                     yaml.safe_dump({"upload_rate": 300, "tag": "x"})):
            with open(path, "w") as f:
                f.write(text)
            n = len(seen)
            watcher.poke()
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and len(seen) == n \
                    and "not yaml" not in text:
                time.sleep(0.02)
            time.sleep(0.1)
    finally:
        watcher.stop()
    return seen


def test_config_watcher_sequence_equals_jax(tmp_path):
    from dragonfly2_tpu_torch.utils import reload as port_reload

    want = _reload_callbacks(jax_reload, tmp_path / "jax.yaml")
    got = _reload_callbacks(port_reload, tmp_path / "port.yaml")
    assert want == [{"upload_rate": 250}, {"upload_rate": 300, "tag": "x"}]
    assert got == want
