"""Port parity for the ML loop's probe half: the TCP-connect RTT
(``utils/netping.py``), the daemon's probe ticker
(``client/networktopology.py``) and a port ``Daemon`` probing live
through an in-process ``SchedulerService`` into its
``NetworkTopologyStore``.

RTTs are wall-clock measurements, so the two packages are held to the
same keys, the same reachable/unreachable pattern and the same reported
(destination, ok/failed) sets, never to RTT values.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time

import pytest

from dragonfly2_tpu.client import networktopology as jax_nt
from dragonfly2_tpu.utils import netping as jax_netping
from dragonfly2_tpu_torch.client import networktopology as port_nt
from dragonfly2_tpu_torch.client.daemon import Daemon, DaemonConfig
from dragonfly2_tpu_torch.scheduler.evaluator.base import BaseEvaluator
from dragonfly2_tpu_torch.scheduler.networktopology.store import (
    NetworkTopologyConfig,
    NetworkTopologyStore,
)
from dragonfly2_tpu_torch.scheduler.resource.resource import Resource
from dragonfly2_tpu_torch.scheduler.scheduling.core import (
    Scheduling,
    SchedulingConfig,
)
from dragonfly2_tpu_torch.scheduler.service import SchedulerService
from dragonfly2_tpu_torch.scheduler.storage.storage import Storage
from dragonfly2_tpu_torch.utils import netping as port_netping

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETPING = {"jax": jax_netping, "port": port_netping}
NT = {"jax": jax_nt, "port": port_nt}
# Port 1 on the loopback: nothing listens there, the connect is refused
# at once.
CLOSED_PORT = 1
PROBE_DEADLINE_S = 10.0


@pytest.fixture
def listener():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    s.listen(8)
    yield s.getsockname()[1]
    s.close()


# -- netping -----------------------------------------------------------------


def test_netping_constants_equal():
    assert port_netping.DEFAULT_TIMEOUT == jax_netping.DEFAULT_TIMEOUT


@pytest.mark.parametrize("pkg", sorted(NETPING))
def test_tcp_rtt_live_and_closed(pkg, listener):
    netping = NETPING[pkg]
    rtt = netping.tcp_rtt("127.0.0.1", listener, timeout=2)
    assert rtt is not None and 0 < rtt < 2
    assert netping.tcp_rtt("127.0.0.1", CLOSED_PORT, timeout=0.5) is None


def test_ping_hosts_same_keys_and_none_pattern(listener):
    targets = [("up-a", "127.0.0.1", listener),
               ("down", "127.0.0.1", CLOSED_PORT),
               ("up-b", "127.0.0.1", listener)]
    got = port_netping.ping_hosts(targets, timeout=0.5)
    want = jax_netping.ping_hosts(targets, timeout=0.5)
    assert list(got) == list(want) == ["up-a", "down", "up-b"]
    assert {k: v is None for k, v in got.items()} == {
        k: v is None for k, v in want.items()} == {
        "up-a": False, "down": True, "up-b": False}
    assert port_netping.ping_hosts([]) == jax_netping.ping_hosts([]) == {}


# -- the prober ----------------------------------------------------------------


class FakeService:
    """The ``SchedulerService`` probe surface of
    ``tests/test_probe_sender.py``: hands out fixed targets and keeps
    what is reported."""

    def __init__(self, targets):
        self.targets = targets
        self.finished = []
        self.failed = []

    def probe_started(self, host_id):
        class H:  # duck Host
            def __init__(self, t):
                self.id, self.ip, self.port = t

        return [H(t) for t in self.targets]

    def probe_finished(self, host_id, results):
        self.finished.extend(results)

    def probe_failed(self, host_id, results):
        self.failed.extend(results)


def _probe_once(pkg, targets):
    nt = NT[pkg]
    service = FakeService(targets)
    prober = nt.Prober("me", nt.InProcessProbeSync(service),
                       nt.ProbeConfig(probe_timeout=0.5))
    n = prober.probe_once()
    assert all(r.rtt_seconds > 0 for r in service.finished)
    assert all(r.rtt_seconds == 0.0 for r in service.failed)
    return n, ({(r.dest_host_id, "ok") for r in service.finished}
               | {(r.dest_host_id, "failed") for r in service.failed})


def test_probe_once_reports_as_jax(listener):
    targets = [("host-up", "127.0.0.1", listener),
               ("host-down", "127.0.0.1", CLOSED_PORT),
               ("host-up-2", "127.0.0.1", listener)]
    got, want = _probe_once("port", targets), _probe_once("jax", targets)
    assert got == want
    assert got == (3, {("host-up", "ok"), ("host-up-2", "ok"),
                       ("host-down", "failed")})


def test_probe_config_defaults_equal():
    assert vars(port_nt.ProbeConfig()) == vars(jax_nt.ProbeConfig())


@pytest.mark.parametrize("pkg", sorted(NT))
def test_ticker_survives_sync_errors(pkg):
    nt = NT[pkg]
    calls = []
    done = threading.Event()

    class Exploding:
        def probe_started(self, host_id):
            calls.append(host_id)
            raise RuntimeError("scheduler down")

    class CountingProber(nt.Prober):
        def probe_once(self):
            try:
                return super().probe_once()
            finally:
                if len(calls) >= 2:
                    done.set()

    prober = CountingProber("me", Exploding(), nt.ProbeConfig(interval=0.01))
    prober.serve()
    try:
        assert done.wait(timeout=5)
    finally:
        prober.stop()
    assert prober._thread is not None and not prober._thread.is_alive()


def test_probe_metrics_counted(listener):
    """The daemon's in-process ``probe_count`` family takes the prober's
    outcomes, as the JAX package's prometheus counter does."""
    from dragonfly2_tpu_torch.client.metrics import DaemonMetrics

    metrics = DaemonMetrics()
    service = FakeService([("up", "127.0.0.1", listener),
                           ("down", "127.0.0.1", CLOSED_PORT)])
    prober = port_nt.Prober("me", port_nt.InProcessProbeSync(service),
                            port_nt.ProbeConfig(probe_timeout=0.5),
                            metrics=metrics)
    assert prober.probe_once() == 2
    assert metrics.probe_count.labels(outcome="ok").get() == 1
    assert metrics.probe_count.labels(outcome="failed").get() == 1


_GRPC_PROBE = """
import json, sys
from dragonfly2_tpu_torch.client.networktopology import GrpcProbeSync
sync = GrpcProbeSync("127.0.0.1:1")
sync.close()
print(json.dumps({"built": type(sync).__name__, "grpc": sorted(
    m for m in sys.modules if m.split(".")[0] == "grpc")}))
"""


def test_grpc_probe_sync_builds_without_grpc():
    """``GrpcProbeSync`` imports its transport when built — the port's
    RPC client and ``scheduler/rpcserver.py`` — and none of it loads
    grpc. (The probe cycle over the wire is
    ``tests/test_torch_scheduler_wire.py``'s.)"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _GRPC_PROBE], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"built": "GrpcProbeSync", "grpc": []}


# -- a port daemon probing live ------------------------------------------------


def probing_scheduler(root) -> SchedulerService:
    """A scheduler service whose topology store writes into its dataset
    storage, as ``tests/test_ml_loop_e2e.py`` wires the JAX one."""
    resource = Resource()
    storage = Storage(str(root / "datasets"))
    return SchedulerService(
        resource=resource,
        scheduling=Scheduling(BaseEvaluator(),
                              SchedulingConfig(retry_interval=0.01)),
        storage=storage,
        network_topology=NetworkTopologyStore(
            NetworkTopologyConfig(), resource=resource, storage=storage))


def test_daemon_probes_live(tmp_path):
    """A port ``Daemon`` with ``probe_interval > 0`` builds its prober at
    ``start()`` (the copied daemon imports ``client/networktopology``),
    and its probes reach the scheduler's store."""
    scheduler = probing_scheduler(tmp_path)
    daemons = []
    try:
        for i in range(3):
            daemon = Daemon(scheduler, DaemonConfig(
                storage_root=str(tmp_path / f"peer{i}"), hostname=f"peer{i}",
                idc="idc-a" if i % 2 == 0 else "idc-b",
                probe_interval=0.05, probe_timeout=0.5))
            daemon.start()
            daemons.append(daemon)
        assert all(isinstance(d.prober, port_nt.Prober) for d in daemons)
        store = scheduler.network_topology
        ids = {d.host_id for d in daemons}
        deadline = time.monotonic() + PROBE_DEADLINE_S
        while time.monotonic() < deadline:
            sources = {src for src, _ in store._edges}
            if sources >= ids:
                break
            time.sleep(0.05)
        edges = dict(store._edges)
        assert {src for src, _ in edges} == ids
        # Every probe went to another live daemon, and none failed.
        assert all(src != dst and dst in ids for src, dst in edges)
        assert all(e.average_rtt > 0 for e in edges.values())
        assert sum(store.probed_count(h) for h in ids) >= len(ids)
    finally:
        for daemon in reversed(daemons):
            daemon.stop()
    assert all(not d.prober._thread.is_alive() for d in daemons)
    # The snapshot writes one topology record a probing host.
    assert scheduler.network_topology.snapshot() == len(daemons)
    assert scheduler.storage.network_topology_count() == len(daemons)
