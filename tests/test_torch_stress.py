"""``df2-stress`` in the port (``cmd/stress.py``), against the JAX
package's: JAX's ``TestStressHarness`` cases over both packages, and one
run through a port daemon's RPC surface in process with JAX's report
keys."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from dragonfly2_tpu.cmd import stress as jax_stress
from dragonfly2_tpu_torch.client.daemon import Daemon, DaemonConfig
from dragonfly2_tpu_torch.client.rpcserver import serve_daemon_rpc
from dragonfly2_tpu_torch.cmd import stress as port_stress
from dragonfly2_tpu_torch.scheduler.evaluator import BaseEvaluator
from dragonfly2_tpu_torch.scheduler.resource.resource import Resource
from dragonfly2_tpu_torch.scheduler.scheduling import (
    Scheduling,
    SchedulingConfig,
)
from dragonfly2_tpu_torch.scheduler.service import SchedulerService
from dragonfly2_tpu_torch.scheduler.storage.storage import Storage
from tests.fileserver import FileServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRESS = {"jax": jax_stress, "port": port_stress}


@pytest.mark.parametrize("pkg", sorted(STRESS))
class TestStressHarness:
    def test_distribution_over_fileserver(self, tmp_path, pkg):
        root = tmp_path / "www"
        root.mkdir()
        (root / "f.bin").write_bytes(os.urandom(100_000))
        with FileServer(str(root)) as fs:
            out = STRESS[pkg].run_stress(fs.url("f.bin"), concurrency=4,
                                         requests=20)
        assert out["succeeded"] == 20 and out["failed"] == 0
        assert out["latency_ms"]["p50"] > 0
        assert out["latency_ms"]["p99"] >= out["latency_ms"]["p50"]
        assert out["throughput_mbps"] > 0

    def test_error_taxonomy(self, tmp_path, pkg):
        root = tmp_path / "www"
        root.mkdir()
        with FileServer(str(root)) as fs:
            out = STRESS[pkg].run_stress(fs.url("missing.bin"),
                                         concurrency=2, requests=6)
        assert out["failed"] == 6
        assert out["errors"] == {"HTTP 404": 6}

    def test_cli_prints_one_json_line(self, tmp_path, capsys, pkg):
        root = tmp_path / "www"
        root.mkdir()
        (root / "f.bin").write_bytes(b"x" * 1000)
        with FileServer(str(root)) as fs:
            rc = STRESS[pkg].main([fs.url("f.bin"), "-c", "2", "-n", "4"])
        assert rc == 0
        line = capsys.readouterr().out.strip()
        assert json.loads(line)["succeeded"] == 4


def test_keys_equal_jax_over_a_file_server(tmp_path):
    root = tmp_path / "www"
    root.mkdir()
    (root / "f.bin").write_bytes(os.urandom(50_000))
    with FileServer(str(root)) as fs:
        port = port_stress.run_stress(fs.url("f.bin"), concurrency=2,
                                      requests=6)
        ref = jax_stress.run_stress(fs.url("f.bin"), concurrency=2,
                                    requests=6)
    assert sorted(port) == sorted(ref)
    assert sorted(port["latency_ms"]) == sorted(ref["latency_ms"])


def test_through_a_port_daemon_rpc(tmp_path, capsys):
    scheduler = SchedulerService(
        resource=Resource(),
        scheduling=Scheduling(BaseEvaluator(), SchedulingConfig(
            retry_interval=0.01, retry_back_to_source_limit=2)),
        storage=Storage(str(tmp_path / "datasets")))
    daemon = Daemon(scheduler, DaemonConfig(
        storage_root=str(tmp_path / "d"), hostname="stress"))
    daemon.start()
    rpc = serve_daemon_rpc(daemon)
    root = tmp_path / "www"
    root.mkdir()
    (root / "s.bin").write_bytes(os.urandom(256 * 1024))
    try:
        with FileServer(str(root)) as fs:
            out = port_stress.run_stress(fs.url("s.bin"), daemon=rpc.target,
                                         concurrency=3, requests=9,
                                         timeout=60)
            ref_keys = sorted(jax_stress.run_stress(
                fs.url("missing"), concurrency=1, requests=1))
            rc = port_stress.main([fs.url("s.bin"), "--daemon", rpc.target,
                                   "-c", "2", "-n", "4"])
    finally:
        rpc.stop()
        daemon.stop()
    assert out["succeeded"] == 9 and out["failed"] == 0, out
    assert sorted(out) == ref_keys
    assert rc == 0
    assert json.loads(capsys.readouterr().out.strip())["succeeded"] == 4


def test_runs_as_a_module(tmp_path):
    root = tmp_path / "www"
    root.mkdir()
    (root / "f.bin").write_bytes(b"y" * 5000)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    with FileServer(str(root)) as fs:
        out = subprocess.run(
            [sys.executable, "-m", "dragonfly2_tpu_torch.cmd.stress",
             fs.url("f.bin"), "-c", "2", "-n", "4"], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip())["succeeded"] == 4
