"""The port's geo bench (``client/geobench.py``), held against the JAX
package's: the WAN bound, the per-site plans, the regression gate and the
state-directory reader give equal answers, and one small process rung (a
``daemon_proc`` child a site, 2 sites) runs in both packages side by side
on threads."""

from __future__ import annotations

import json
import threading

import pytest

from dragonfly2_tpu.client import geobench as jax_geo
from dragonfly2_tpu_torch.client import geobench as port_geo
from dragonfly2_tpu_torch.client.fanoutbench import make_checkpoint

BENCH = {"jax": jax_geo, "port": port_geo}


@pytest.mark.parametrize("n_sites", [1, 2, 3, 5])
def test_wan_bound_equals_jax(n_sites):
    assert (port_geo.wan_amplification_bound(n_sites)
            == jax_geo.wan_amplification_bound(n_sites))


@pytest.mark.parametrize("partitioned", [(), ("site-b",),
                                         ("site-a", "site-c")])
def test_site_plans_equal_jax(partitioned):
    addrs = {"site-a": ["127.0.0.1:2", "127.0.0.1:1"],
             "site-b": ["127.0.0.1:3"], "site-c": ["127.0.0.1:9"]}
    got = port_geo.build_site_plans(addrs, seed=4,
                                    partitioned_sites=partitioned)
    assert got == jax_geo.build_site_plans(addrs, seed=4,
                                           partitioned_sites=partitioned)
    assert json.loads(json.dumps(got)) == got  # wire form


def _fresh(ttlb, wan, verdict=True):
    return {"rungs": [2, 4], "verdict_pass": verdict,
            "partition": {"verdict_pass": verdict},
            "ladder": {"4": {"ttlb_s": ttlb, "wan_amplification": wan}}}


GATE_CASES = {"healthy": _fresh(10.0, 2.0), "slow": _fresh(30.0, 2.0),
              "wan": _fresh(10.0, 5.0), "lost": _fresh(10.0, 2.0, False)}


@pytest.mark.parametrize("record", [True, False])
@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_regression_gate_equals_jax(tmp_path, monkeypatch, case, record):
    if record:
        (tmp_path / "geo_run_1.json").write_text(json.dumps(
            _fresh(8.0, 1.8)))
        (tmp_path / "geo_run_2.json").write_text(json.dumps(
            _fresh(6.0, 1.9, verdict=False)))
    outs = {}
    for pkg, bench in BENCH.items():
        monkeypatch.setattr(bench, "run_geo_ladder",
                            lambda **kw: GATE_CASES[case])
        outs[pkg] = bench.check_geo_regression(str(tmp_path))
    assert outs["port"] == outs["jax"]
    assert outs["port"]["passed"] is (case == "healthy"
                                      or (not record and case != "lost"))


def test_best_recorded_equals_jax(tmp_path):
    for i, ttlb in enumerate((9.0, 7.0, 8.0)):
        (tmp_path / f"geo_run_{i}.json").write_text(json.dumps(
            _fresh(ttlb, 1.5, verdict=i != 1)))
    got = port_geo.best_recorded_geo(str(tmp_path))
    assert got == jax_geo.best_recorded_geo(str(tmp_path))
    assert got["ttlb_s"] == 8.0


def test_small_process_rung_in_both_packages(tmp_path):
    """One daemon_proc child a site, 2 sites, one 2 MiB shard, 512 KiB
    pieces: every download succeeds and the WAN bytes stay within the
    bound in both packages."""
    out = {}

    def run(pkg):
        try:
            out[pkg] = BENCH[pkg].run_geo_rung(
                1, make_checkpoint(1, 2 << 20, 0),
                sites=("site-a", "site-b"), piece_size=512 * 1024,
                root=str(tmp_path / pkg))
        except Exception as exc:  # noqa: BLE001 — reported below
            out[pkg] = {"error": repr(exc)}

    threads = [threading.Thread(target=run, args=(pkg,)) for pkg in BENCH]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    port, ref = out["port"], out["jax"]
    assert "error" not in port, port
    assert "error" not in ref, ref
    assert sorted(port) == sorted(ref)
    assert port["success_rate"] == ref["success_rate"] == 1.0
    assert port["downloads"] == ref["downloads"] == 2
    assert port["wan_amplification"] <= port["wan_amplification_bound"]
    assert port["wan_amplification_bound"] == ref["wan_amplification_bound"]
