"""The port's fan-out bench (``client/fanoutbench.py``), held against the
JAX package's: JAX's ``TestFanoutBench`` cases (``tests/test_fanout.py``)
over both packages — the tiny rung in threads, the regression gate on
monkeypatched ladders with equal verdicts, the skipped rung — the
checkpoint's bytes, the state-directory reader, and one process-fleet
rung at 2 daemons. Where both packages' fleets run, they run side by
side on threads; each fleet is its own package's."""

from __future__ import annotations

import json
import threading

import pytest

from dragonfly2_tpu.client import fanoutbench as jax_fanout
from dragonfly2_tpu.client import peer_task as jax_peer_task
from dragonfly2_tpu_torch.client import fanoutbench as port_fanout
from dragonfly2_tpu_torch.client import peer_task as port_peer_task

BENCH = {"jax": jax_fanout, "port": port_fanout}
PEER_TASK = {"jax": jax_peer_task, "port": port_peer_task}


def side_by_side(run) -> dict:
    """pkg → ``run(pkg)``, both packages on threads at once."""
    out = {}

    def one(pkg):
        try:
            out[pkg] = run(pkg)
        except Exception as exc:  # noqa: BLE001 — reported by the test
            out[pkg] = {"error": repr(exc)}

    threads = [threading.Thread(target=one, args=(pkg,)) for pkg in BENCH]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert not any(t.is_alive() for t in threads)
    return out


def test_checkpoint_bytes_equal_jax():
    for shards, size, seed in ((2, 1 << 20, 5), (3, 100_003, 0)):
        assert (port_fanout.make_checkpoint(shards, size, seed=seed)
                == jax_fanout.make_checkpoint(shards, size, seed=seed))


@pytest.fixture(scope="module")
def tiny_rungs(tmp_path_factory):
    """JAX's tiny rung (2 daemons in threads, 2 × 1 MiB, 256 KiB pieces)
    in each package, side by side."""
    def run(pkg):
        mod = PEER_TASK[pkg]
        prev = mod.compute_piece_size
        mod.compute_piece_size = lambda n: 256 * 1024
        try:
            blobs = BENCH[pkg].make_checkpoint(2, 1 << 20, seed=5)
            return BENCH[pkg].run_fanout_rung(
                2, blobs, origin_rate_bps=1 << 30, seed=5,
                root=str(tmp_path_factory.mktemp(f"rung-{pkg}")))
        finally:
            mod.compute_piece_size = prev
    return side_by_side(run)


@pytest.mark.parametrize("pkg", sorted(BENCH))
def test_tiny_rung_reports_all_metrics(tiny_rungs, pkg):
    out = tiny_rungs[pkg]
    assert out["success_rate"] == 1.0, out.get("failures", out)
    assert out["ttlb_s"] > 0
    assert out["origin_amplification"] <= 2.0
    assert out["p2p_share"] > 0
    for key in ("per_daemon_mb_per_s_p50", "origin_requests",
                "claims", "p2p_bytes", "source_bytes"):
        assert key in out


def test_tiny_rung_report_keys_equal_jax(tiny_rungs):
    assert sorted(tiny_rungs["port"]) == sorted(tiny_rungs["jax"])


def test_process_fleet_rung_at_two_daemons(tmp_path):
    """Two ``client.daemon_proc`` children against the scheduler served
    from this process, in each package."""
    def run(pkg):
        blobs = BENCH[pkg].make_checkpoint(2, 1 << 20, seed=5)
        return BENCH[pkg].run_fanout_rung(
            2, blobs, origin_rate_bps=1 << 30, seed=5, mode="procs",
            piece_size=256 * 1024, root=str(tmp_path / pkg))
    out = side_by_side(run)
    port, ref = out["port"], out["jax"]
    assert "error" not in port, port
    assert "error" not in ref, ref
    assert sorted(port) == sorted(ref)
    assert port["mode"] == "procs" and port["success_rate"] == 1.0, port
    assert port["downloads"] == ref["downloads"] == 4
    assert port["origin_amplification"] <= port_fanout.AMPLIFICATION_BOUND


def _fresh(result, verdict=True):
    return {"rungs": [4, 16, 32], "verdict_pass": verdict, "ttlb_ratio": 2.0,
            "ladder": {"32": result}}


GATE_CASES = {
    "healthy": _fresh({"ttlb_s": 60.0, "origin_amplification": 1.2}),
    "ttlb_collapsed": _fresh({"ttlb_s": 150.0, "origin_amplification": 1.2}),
    "amplification_collapsed": _fresh({"ttlb_s": 60.0,
                                       "origin_amplification": 2.5}),
    "lost_verdict": _fresh({"ttlb_s": 60.0, "origin_amplification": 1.2},
                           verdict=False),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_regression_gate_verdicts_equal_jax(tmp_path, monkeypatch, case):
    state_dir = tmp_path / "state"
    state_dir.mkdir()
    record = {"verdict_pass": True, "rungs": [4, 16, 32],
              "ladder": {"32": {"ttlb_s": 50.0,
                                "origin_amplification": 1.1}}}
    (state_dir / "fanout_run_best.json").write_text(json.dumps(record))
    outs = {}
    for pkg, bench in BENCH.items():
        monkeypatch.setattr(bench, "run_fanout_ladder",
                            lambda **kw: GATE_CASES[case])
        outs[pkg] = bench.check_fanout_regression(str(state_dir))
    assert outs["port"] == outs["jax"]
    assert outs["port"]["passed"] is (case == "healthy")


def test_regression_gate_without_a_record_equals_jax(tmp_path, monkeypatch):
    outs = {}
    for pkg, bench in BENCH.items():
        monkeypatch.setattr(bench, "run_fanout_ladder",
                            lambda **kw: GATE_CASES["healthy"])
        outs[pkg] = bench.check_fanout_regression(str(tmp_path))
    assert outs["port"] == outs["jax"] and outs["port"]["passed"]
    assert "note" in outs["port"]


def test_best_recorded_equals_jax(tmp_path):
    for i, (ttlb, verdict) in enumerate(((50.0, True), (40.0, False),
                                         (45.0, True), (30.0, True))):
        run = {"verdict_pass": verdict, "rungs": [4, 16] if i < 3 else [4],
               "ladder": {"16": {"ttlb_s": ttlb,
                                 "origin_amplification": 1.0 + i}}}
        (tmp_path / f"fanout_run_{i}.json").write_text(json.dumps(run))
    (tmp_path / "fanout_run_bad.json").write_text("{")
    got = port_fanout.best_recorded_fanout(str(tmp_path))
    assert got == jax_fanout.best_recorded_fanout(str(tmp_path))
    assert got["ttlb_s"] == 45.0


@pytest.mark.parametrize("pkg", sorted(BENCH))
def test_skipped_rung_withholds_verdict(monkeypatch, pkg):
    bench = BENCH[pkg]
    calls = []

    def fake_rung(n, blobs, **kw):
        calls.append(n)
        return {"success_rate": 1.0, "ttlb_s": 1.0,
                "origin_amplification": 1.0, "origin_bytes": 0,
                "p2p_share": 1.0, "failures": []}

    monkeypatch.setattr(bench, "run_fanout_rung", fake_rung)
    out = bench.run_fanout_ladder(rungs=(2, 4), shards=1,
                                  shard_bytes=1 << 20, time_left=lambda: 0.0)
    assert calls == []
    assert out["skipped_rungs"]
    assert "verdict_pass" not in out


def test_ladder_verdicts_equal_jax_on_faked_rungs(monkeypatch):
    """The ladder's bookkeeping (rung order, the preheated rung, the
    ratios and the verdict) over the same faked rung results."""
    def fake(pkg):
        def rung(n, blobs, *, preheated=False, **kw):
            total = sum(len(b) for b in blobs.values())
            return {"success_rate": 1.0, "ttlb_s": 1.0 + n / 10,
                    "origin_amplification": 1.0,
                    "origin_bytes": 0 if preheated else total,
                    "p2p_share": 0.9, "failures": []}
        return rung

    outs = {}
    for pkg, bench in BENCH.items():
        monkeypatch.setattr(bench, "run_fanout_rung", fake(pkg))
        outs[pkg] = bench.run_fanout_ladder(rungs=(4, 16), shards=2,
                                            shard_bytes=1 << 16)
    assert outs["port"] == outs["jax"]
    assert outs["port"]["verdict_pass"] is True
