"""The port's scheduler-cluster bench (``scheduler/clusterbench.py``),
held against the JAX package's: a small rung (2 ``scheduler.replica``
children, 300 peers, one replica SIGKILLed mid-swarm) in both packages
side by side on threads, with JAX's report keys and verdicts; and the
ladder's verdict over the same faked rungs. JAX marks its own rung test
slow (about 4 s here); this one is not: both rungs run at once in
about as long."""

from __future__ import annotations

import threading

import pytest

from dragonfly2_tpu.scheduler import clusterbench as jax_cluster
from dragonfly2_tpu_torch.scheduler import clusterbench as port_cluster

BENCH = {"jax": jax_cluster, "port": port_cluster}


@pytest.fixture(scope="module")
def rungs():
    out = {}

    def run(pkg):
        try:
            out[pkg] = BENCH[pkg].run_cluster_rung(
                300, replicas=2, workers=8, kill_replica=True,
                kill_after_fraction=0.3, reroute_bound_s=10.0)
        except Exception as exc:  # noqa: BLE001 — reported by the tests
            out[pkg] = {"error": repr(exc)}

    threads = [threading.Thread(target=run, args=(pkg,)) for pkg in BENCH]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    return out


def test_report_keys_equal_jax(rungs):
    port, ref = rungs["port"], rungs["jax"]
    assert "error" not in port, port
    assert "error" not in ref, ref
    assert sorted(port) == sorted(ref)
    assert sorted(port["per_replica"]) != [] and len(port["per_replica"]) == 2


@pytest.mark.parametrize("pkg", sorted(BENCH))
def test_small_rung_with_replica_kill_is_green(rungs, pkg):
    """JAX's ``TestClusterRungSubprocess`` case over each package."""
    r = rungs[pkg]
    assert r["success_rate"] == 1.0, r["failures"]
    assert r["killed"], "the kill never fired"
    assert r["completed"] == r["samples"] == 300
    assert r["sessions_rehomed"] > 0
    assert r["kill_verdict_pass"] is True
    survivors = [s for s in r["per_replica"].values()
                 if not s.get("killed")]
    assert survivors and all(s.get("peers", 0) > 0 for s in survivors)
    assert all(s.get("rss_mb", 0) > 0 for s in survivors)


@pytest.mark.parametrize("big_p99,kill_ok,aborted", [
    (40.0, True, False), (400.0, True, False), (40.0, False, False),
    (40.0, True, True)])
def test_ladder_verdict_equals_jax(monkeypatch, big_p99, kill_ok, aborted):
    def fake(n_peers, *, kill_replica=False, **kw):
        return {"announce_p99_ms": big_p99 if n_peers > 100 else 20.0,
                "completed": n_peers, "samples": n_peers,
                "aborted_budget": aborted and n_peers > 100,
                "kill_verdict_pass": kill_ok}

    outs = {}
    for pkg, bench in BENCH.items():
        monkeypatch.setattr(bench, "run_cluster_rung", fake)
        outs[pkg] = bench.run_cluster_ladder(cluster_peers=1000)
    assert outs["port"] == outs["jax"]
    assert outs["port"].get("verdict_pass") is (
        None if aborted else (big_p99 == 40.0 and kill_ok))
