"""The port's metrics plane held to JAX's: ``utils/prom.py`` in place of
``prometheus_client``, under the same metrics classes.

The same numpy-seeded sequence of ``inc``, ``dec``, ``set``, ``observe``
and ``labels`` goes into each JAX class (on ``prometheus_client``) and
into the port's copy (on ``utils/prom.py``); the port's
``generate_latest`` text, parsed with ``prometheus_client``'s own parser,
gives the same families, types, help texts, label sets and sample values
as JAX's, ``_created`` series aside (the port does not write them).
Counts are held exactly, sums to 1e-12 relative. Then label escaping,
``MetricsServer``'s routes, ``cmd/common.start_metrics_server``, the
debug monitor's routes and profiler (JAX's ``tests/test_debugmon.py``
on both packages), and a fresh interpreter that refuses
``prometheus_client`` importing the plane.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
from prometheus_client import generate_latest as jax_generate_latest
from prometheus_client.parser import text_string_to_metric_families

from dragonfly2_tpu_torch.utils import prom

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("dragonfly2_tpu", "dragonfly2_tpu_torch")
SUM_RTOL = 1e-12
#: Label values a sequence draws from, the escaped characters among them.
LABEL_VALUES = ("p2p", "back_to_source", "gnn", 'quo"te', "back\\slash",
                "new\nline")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def families(text: str) -> list:
    """Parsed families as comparable tuples, ``_created`` left out."""
    fams = list(text_string_to_metric_families(text))
    names = {f.name for f in fams}
    out = []
    for f in fams:
        if f.name.endswith("_created") and f.name[:-len("_created")] in names:
            continue
        samples = sorted(
            (s.name, tuple(sorted(s.labels.items())), s.value)
            for s in f.samples if not s.name.endswith("_created"))
        out.append((f.name, f.type, f.documentation, samples))
    return out


def assert_same_families(got: list, want: list) -> None:
    assert [g[:3] for g in got] == [w[:3] for w in want]
    for g, w in zip(got, want):
        assert [s[:2] for s in g[3]] == [s[:2] for s in w[3]], g[0]
        for (name, _, a), (_, _, b) in zip(g[3], w[3]):
            if name.endswith("_sum"):
                assert math.isclose(a, b, rel_tol=SUM_RTOL), (name, a, b)
            else:
                assert a == b, (name, a, b)


def metric_attrs(obj) -> dict:
    """name → metric of a metrics class instance (JAX's: prometheus
    collectors), in attribute order."""
    return {k: v for k, v in vars(obj).items()
            if hasattr(v, "_type") and hasattr(v, "_labelnames")}


def drive(objs: list, seed: int, steps: int = 300) -> None:
    """The same seeded operations on every instance in ``objs``: the
    metric, its label values and the amounts come from the generator;
    the operation from the metric's type in the JAX instance."""
    rng = np.random.default_rng(seed)
    attrs = [metric_attrs(o) for o in objs]
    names = list(attrs[0])
    for _ in range(steps):
        name = names[rng.integers(len(names))]
        ref = attrs[0][name]
        values = {label: LABEL_VALUES[rng.integers(len(LABEL_VALUES))]
                  for label in ref._labelnames}
        amount = float(rng.gamma(2.0, 50.0))
        op = int(rng.integers(3))
        for per in attrs:
            metric = per[name]
            if values:
                metric = metric.labels(**values)
            if ref._type == "counter":
                metric.inc(amount)
            elif ref._type == "histogram":
                metric.observe(amount / 1e3 if op else amount)
            elif op == 0:
                metric.set(amount)
            elif op == 1:
                metric.inc(amount)
            else:
                metric.dec(amount)


def resource_of(pkg: str, hosts: int, tasks: int):
    """A live resource model of ``pkg`` holding ``hosts`` hosts and
    ``tasks`` tasks."""
    resource = mod(pkg, "scheduler.resource.resource").Resource()
    host_cls = mod(pkg, "scheduler.resource.host").Host
    task_cls = mod(pkg, "scheduler.resource.task").Task
    for i in range(hosts):
        resource.host_manager.store(host_cls(id=f"host-{i}",
                                             hostname=f"h{i}"))
    for i in range(tasks):
        resource.task_manager.store(task_cls(id=f"task-{i}",
                                             url=f"http://o/{i}"))
    return resource


MAKERS = {
    "scheduler": lambda pkg: mod(pkg, "scheduler.metrics").SchedulerMetrics(
        resource=resource_of(pkg, 3, 2), version="1.2.3"),
    "scheduler_no_version": lambda pkg: mod(
        pkg, "scheduler.metrics").SchedulerMetrics(),
    "trainer": lambda pkg: mod(pkg, "trainer.metrics").TrainerMetrics(
        version="1.2.3"),
    "manager": lambda pkg: mod(pkg, "manager.metrics").ManagerMetrics(
        version="1.2.3"),
    "daemon": lambda pkg: mod(pkg, "client.metrics").DaemonMetrics(
        version="1.2.3"),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", list(MAKERS))
def test_exposition_parses_to_jax_samples(kind, seed):
    jax_obj = MAKERS[kind]("dragonfly2_tpu")
    port_obj = MAKERS[kind]("dragonfly2_tpu_torch")
    drive([jax_obj, port_obj], seed)
    want = families(jax_generate_latest(jax_obj.registry).decode())
    got = families(prom.generate_latest(port_obj.registry).decode())
    assert got
    assert_same_families(got, want)


def test_counter_sample_names_end_in_total():
    """A counter declared without ``_total`` (``traffic_bytes``) is
    exposed as ``..._total`` in both packages."""
    port = MAKERS["scheduler"]("dragonfly2_tpu_torch")
    port.traffic.labels(type="p2p").inc(7)
    text = prom.generate_latest(port.registry).decode()
    assert 'dragonfly_scheduler_traffic_bytes_total{type="p2p"} 7.0' in text
    assert "# TYPE dragonfly_scheduler_traffic_bytes_total counter" in text
    assert "dragonfly_scheduler_resource_hosts 3.0" in text


@pytest.mark.parametrize("value", ['a"b', "c\\d", "e\nf", '\\"\n'])
def test_escaped_label_values_as_prometheus_client(value):
    import prometheus_client

    jreg, preg = prometheus_client.CollectorRegistry(), \
        prom.CollectorRegistry()
    j = prometheus_client.Counter("esc_total", "Help with \\ and\nnewline.",
                                  labelnames=("v",), registry=jreg)
    p = prom.Counter("esc_total", "Help with \\ and\nnewline.",
                     labelnames=("v",), registry=preg)
    j.labels(v=value).inc(2)
    p.labels(v=value).inc(2)
    jtext = jax_generate_latest(jreg).decode()
    ptext = prom.generate_latest(preg).decode()
    assert [ln for ln in ptext.splitlines() if "_created" not in ln] == \
        [ln for ln in jtext.splitlines() if "_created" not in ln]
    ((_, _, _, samples),) = families(ptext)
    assert samples == [("esc_total", (("v", value),), 2.0)]


def test_registry_refuses_duplicates_and_unregisters():
    reg = prom.CollectorRegistry()
    counter = prom.Counter("dup_total", "d", registry=reg)
    with pytest.raises(ValueError):
        prom.Counter("dup", "d", registry=reg)
    reg.unregister(counter)
    prom.Counter("dup", "d", registry=reg).inc()
    assert "dup_total 1.0" in prom.generate_latest(reg).decode()
    with pytest.raises(ValueError):
        prom.Counter("neg", "n").inc(-1)
    with pytest.raises(ValueError):
        prom.Counter("lab", "l", labelnames=("a",)).inc()


def test_histogram_buckets_and_go_floats_as_prometheus_client():
    import prometheus_client

    buckets = (1e-4, 0.5, 1.0, 2.5e6, 1e7)
    jreg, preg = prometheus_client.CollectorRegistry(), \
        prom.CollectorRegistry()
    j = prometheus_client.Histogram("h_seconds", "h", buckets=buckets,
                                    registry=jreg)
    p = prom.Histogram("h_seconds", "h", buckets=buckets, registry=preg)
    for x in (5e-5, 0.5, 0.7, 3e6, 2e7, 1.0):
        j.observe(x)
        p.observe(x)
    jlines = [ln for ln in jax_generate_latest(jreg).decode().splitlines()
              if "_created" not in ln]
    assert prom.generate_latest(preg).decode().splitlines() == jlines
    assert 'h_seconds_bucket{le="2.5e+06"} 4.0' in jlines
    assert 'h_seconds_bucket{le="+Inf"} 6.0' in jlines


# -- the debug-vars bridge --------------------------------------------------

BLOCK = {"requests": 12, "ratio": 0.25, "ok": True, "name": "skipped",
         "nested": {"p50_ms": 1.5, "9lives": 3},
         "per_lane": [{"lane": 0, "sheds": 2}, {"lane": 1, "sheds": 5}],
         "gc_counts": (4, 5, 6), "mixed": [1, "x"]}


@pytest.mark.parametrize("cluster", ["", "site-a"])
def test_bridge_exports_a_registered_block_as_jax(cluster, monkeypatch):
    want, got = None, None
    for pkg in PKGS:
        debugmon = mod(pkg, "utils.debugmon")
        prombridge = mod(pkg, "utils.prombridge")
        monkeypatch.setitem(debugmon._VARS, "test_bridge_block",
                            lambda: BLOCK)
        monkeypatch.setitem(debugmon._VARS, "test_bridge_broken",
                            lambda: 1 / 0)
        monkeypatch.setattr(debugmon, "_CLUSTER_ID", cluster)
        if pkg == "dragonfly2_tpu":
            text = jax_generate_latest(prombridge.bridge_registry()).decode()
        else:
            registry = prombridge.bridge_registry()
            assert prombridge.attach(registry) is registry
            text = prom.generate_latest(registry).decode()
        # This process's other blocks and its process vars differ between
        # two scrapes; the test's block and the tracing block do not.
        fams = [f for f in families(text)
                if f[0].startswith(("df2_test_bridge", "df2_observability"))]
        names = {f[0] for f in families(text)}
        assert "df2_process_threads" in names
        if pkg == "dragonfly2_tpu":
            want = fams
        else:
            got = fams
    assert any(f[0] == "df2_test_bridge_block_per_lane_sheds" for f in got)
    assert_same_families(got, want)


# -- the endpoint -----------------------------------------------------------

def http_get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers.get("Content-Type"), exc.read()


def test_metrics_server_routes():
    from dragonfly2_tpu_torch.utils.metricsserver import MetricsServer

    metrics = MAKERS["manager"]("dragonfly2_tpu_torch")
    metrics.keepalive_count.inc(3)
    server = MetricsServer(metrics.registry, port=0)
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        code, ctype, body = http_get(base + "/metrics?x=1")
        assert code == 200 and ctype == prom.CONTENT_TYPE_LATEST
        assert b"dragonfly_manager_keepalive_total 3.0" in body
        assert http_get(base + "/healthy")[::2] == (200, b"ok")
        assert http_get(base + "/nope")[::2] == (404, b"not found")
    finally:
        server.stop()


def test_start_metrics_server_off_and_on(capsys):
    from dragonfly2_tpu_torch.cmd.common import start_metrics_server

    assert start_metrics_server(argparse.Namespace(metrics_port=-1)) is None
    assert start_metrics_server(argparse.Namespace()) is None
    metrics = MAKERS["trainer"]("dragonfly2_tpu_torch")
    metrics.train_cycles.inc()
    server = start_metrics_server(argparse.Namespace(metrics_port=0),
                                  metrics.registry)
    bridge_only = start_metrics_server(argparse.Namespace(metrics_port=0))
    try:
        assert f"metrics on {server.address}/metrics" in \
            capsys.readouterr().out
        _, _, body = http_get(f"http://127.0.0.1:{server.port}/metrics")
        assert b"dragonfly_trainer_train_cycles_total 1.0" in body
        assert b"df2_process_threads" in body
        _, _, body = http_get(
            f"http://127.0.0.1:{bridge_only.port}/metrics")
        assert b"df2_process_threads" in body
        assert b"dragonfly_" not in body
    finally:
        server.stop()
        bridge_only.stop()


# -- the debug monitor (JAX's tests/test_debugmon.py on both packages) ------

def get(url: str) -> tuple:
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.status, resp.read()


@pytest.mark.parametrize("pkg", PKGS)
def test_debugmon_endpoints(pkg):
    debugmon = mod(pkg, "utils.debugmon")
    mon = debugmon.DebugMonitor(port=0)
    mon.start()
    base = f"http://{mon.address}"
    try:
        assert get(base + "/healthy") == (200, b"OK")
        marker = threading.current_thread().name
        code, body = get(base + "/debug/threads")
        assert code == 200 and marker.encode() in body
        assert b"test_torch_metrics.py" in body
        vars_ = json.loads(get(base + "/debug/vars")[1])
        assert vars_["threads"] >= 2 and vars_["uptime_seconds"] >= 0
        assert "gc_objects" not in vars_
        full = json.loads(get(base + "/debug/vars?full=1")[1])
        assert full["gc_objects"] > 1000
        with pytest.raises(urllib.error.HTTPError) as exc:
            get(base + "/debug/nope")
        assert exc.value.code == 404
    finally:
        mon.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_debugmon_registered_vars_served_and_isolated(pkg, monkeypatch):
    debugmon = mod(pkg, "utils.debugmon")
    monkeypatch.setitem(debugmon._VARS, "test_batcher_stats", lambda: {
        "mlp": {"sheds": 3, "per_lane": [{"lane": 0}]}})
    monkeypatch.setitem(debugmon._VARS, "test_broken_var", lambda: 1 / 0)
    mon = debugmon.DebugMonitor(port=0)
    mon.start()
    try:
        vars_ = json.loads(get(f"http://{mon.address}/debug/vars")[1])
        assert vars_["test_batcher_stats"]["mlp"]["sheds"] == 3
        assert "error" in vars_["test_broken_var"]
        assert set(debugmon.registered_debug_vars()) >= {
            "test_batcher_stats", "test_broken_var"}
    finally:
        mon.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_sampling_profiler_catches_hot_thread(pkg):
    debugmon = mod(pkg, "utils.debugmon")
    stop = threading.Event()

    def hot_loop():
        while not stop.is_set():
            sum(i * i for i in range(500))

    t = threading.Thread(target=hot_loop, name="hot-loop", daemon=True)
    t.start()
    try:
        report = debugmon.sample_profile(0.4, hz=200)
    finally:
        stop.set()
        t.join(timeout=2)
    assert "hot_loop" in report and "sampling rounds" in report
    lines = report.splitlines()
    assert lines[1] == "# count  stack (root;...;leaf)"
    assert all(int(ln.split()[0]) >= 1 for ln in lines[2:])


@pytest.mark.parametrize("pkg", PKGS)
def test_debug_profile_endpoint(pkg):
    debugmon = mod(pkg, "utils.debugmon")
    mon = debugmon.DebugMonitor(port=0)
    mon.start()
    try:
        code, body = get(f"http://{mon.address}/debug/profile?seconds=0.2")
        assert code == 200 and b"sampling rounds" in body
    finally:
        mon.stop()


# -- without prometheus_client ----------------------------------------------

_NO_PROM = r"""
import importlib.abc, json, sys

REFUSED = {"prometheus_client", "jax", "grpc", "psutil", "dragonfly2_tpu"}


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ModuleNotFoundError(f"{name} is refused here", name=name)
        return None


sys.meta_path.insert(0, Refuse())
import argparse, urllib.request
from dragonfly2_tpu_torch.cmd import common
from dragonfly2_tpu_torch.manager import jobs, jobplane
from dragonfly2_tpu_torch.scheduler import jobworker
from dragonfly2_tpu_torch.scheduler.metrics import SchedulerMetrics
from dragonfly2_tpu_torch.utils import prombridge

metrics = SchedulerMetrics(version="x")
metrics.traffic.labels(type="p2p").inc(3)
server = common.start_metrics_server(argparse.Namespace(metrics_port=0),
                                     metrics.registry)
with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/metrics",
                            timeout=10) as resp:
    text = resp.read().decode()
server.stop()
print(json.dumps({"text": text, "loaded": sorted(
    m for m in sys.modules if m.split(".")[0] in REFUSED)}))
"""


def test_plane_runs_where_prometheus_client_is_refused():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _NO_PROM], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    assert 'dragonfly_scheduler_traffic_bytes_total{type="p2p"} 3.0' in \
        result["text"]
    assert "df2_process_threads" in result["text"]
