"""The port's observability bench (``client/obsbench.py``), held against
the JAX package's: ``scrape_all_blocks`` over the debug-vars bridge gives
the same blocks, families and sample keys in both packages; the port's
text-format parser (``utils/prom.py``, which the copy imports where JAX's
imports ``prometheus_client.parser``) reads every exposition as
``prometheus_client`` does; the port's tail-capture rung is green; and
the regression gate and the state-directory reader give equal answers."""

from __future__ import annotations

import importlib
import json

import pytest
from prometheus_client.parser import text_string_to_metric_families as ref_parse

from dragonfly2_tpu.client import obsbench as jax_obs
from dragonfly2_tpu_torch.client import obsbench as port_obs
from dragonfly2_tpu_torch.utils.prom import text_string_to_metric_families

PACKAGES = {"jax": "dragonfly2_tpu", "port": "dragonfly2_tpu_torch"}
BENCH = {"jax": jax_obs, "port": port_obs}
#: Modules that register debug-vars blocks when imported.
REGISTERING = ("client.daemon", "scheduler.service", "client.dataplane",
               "scheduler.rpcserver", "client.rpcserver")


def _exposition(pkg: str) -> str:
    for name in REGISTERING:
        importlib.import_module(f"{PACKAGES[pkg]}.{name}")
    bridge = importlib.import_module(f"{PACKAGES[pkg]}.utils.prombridge")
    if pkg == "jax":
        from prometheus_client import generate_latest
    else:
        from dragonfly2_tpu_torch.utils.prom import generate_latest
    return generate_latest(bridge.bridge_registry()).decode()


def _shape(families) -> dict:
    """family → (type, sorted (sample name, label keys))."""
    return {f.name: (f.type, sorted({(s.name, tuple(sorted(s.labels)))
                                     for s in f.samples}))
            for f in families}


def test_scrape_all_blocks_equals_jax():
    for name in REGISTERING:
        for pkg in PACKAGES.values():
            importlib.import_module(f"{pkg}.{name}")
    got, want = port_obs.scrape_all_blocks(), jax_obs.scrape_all_blocks()
    assert sorted(got) == sorted(want)
    assert got["blocks"] == want["blocks"]
    assert got["metric_families"] == want["metric_families"]
    assert got["all_blocks_exported"] and want["all_blocks_exported"]
    assert got["missing_blocks"] == want["missing_blocks"] == []


def test_families_and_sample_keys_equal_jax():
    port_text, jax_text = _exposition("port"), _exposition("jax")
    got = _shape(ref_parse(port_text))
    want = _shape(ref_parse(jax_text))
    assert got.keys() == want.keys()
    assert got == want


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_port_parser_reads_each_exposition_as_prometheus_client(pkg):
    text = _exposition(pkg)

    def flat(families):
        return [(f.name, f.documentation, f.type,
                 [(s.name, s.labels, s.value) for s in f.samples])
                for f in families]

    got = flat(text_string_to_metric_families(text))
    want = flat(ref_parse(text))
    assert got == want and len(got) > 10


def test_port_parser_on_hand_written_text():
    text = "\n".join([
        "# HELP a_total help \\\\ x\\n y",
        "# TYPE a_total counter",
        'a_total{x="1",y="q\\"z\\n\\\\"} 3',
        'a_total{x="2"} 4.5',
        "# TYPE h histogram",
        'h_bucket{le="0.1"} 1', 'h_bucket{le="+Inf"} 2', "h_count 2",
        "h_sum 0.3", "stray 7", "# TYPE g gauge", 'g{a="b",} 1e+07 123',
        "# HELP c2 counter without total", "# TYPE c2 counter", "c2 5",
        "# a comment", ""])

    def flat(families):
        return [(f.name, f.documentation, f.type,
                 [(s.name, s.labels, s.value) for s in f.samples])
                for f in families]

    assert (flat(text_string_to_metric_families(text))
            == flat(ref_parse(text)))


def test_port_obs_rung_is_green(tmp_path):
    """JAX's ``TestObsRungE2E`` case (slow there) on the port: the
    disrupted task's trace is captured whole and attributed to its
    stalled fetch, the warm task's dropped."""
    out = port_obs.run_obs_rung(seed=0, root=str(tmp_path))
    assert out["verdict_pass"], out["failures"]
    assert out["warm_trace_dropped"] is True
    assert out["disrupted_trace"]["trace_ids"] == 1
    assert out["analyzer"]["dominant"]["kind"] == "fetch_stall"
    assert out["metrics_scrape"]["all_blocks_exported"]


def _stage(rung_ok=True, announce=1.01, loopback=1.0):
    return {"rung": {"verdict_pass": rung_ok,
                     "failures": [] if rung_ok else ["stall missed"],
                     "analyzer": {"dominant": {"kind": "fetch_stall"}}},
            "announce_guard": {"within_bound": announce <= 1.05,
                               "p99_ratio": announce},
            "loopback_guard": {"within_bound": loopback <= 1.05,
                               "throughput_ratio": loopback},
            "verdict_pass": rung_ok and announce <= 1.05 and loopback <= 1.05}


@pytest.mark.parametrize("fresh", [_stage(), _stage(rung_ok=False),
                                   _stage(announce=1.3),
                                   _stage(loopback=1.2)])
def test_regression_gate_equals_jax(tmp_path, monkeypatch, fresh):
    for i, ratio in enumerate((1.02, 0.98, 0.9)):
        data = _stage(announce=ratio)
        data["verdict_pass"] = i != 2
        (tmp_path / f"obs_run_{i}.json").write_text(json.dumps(data))
    outs = {}
    for pkg, bench in BENCH.items():
        monkeypatch.setattr(bench, "run_obs_stage", lambda **kw: fresh)
        outs[pkg] = bench.check_obs_regression(str(tmp_path))
    assert outs["port"] == outs["jax"]
    assert outs["port"]["passed"] is fresh["verdict_pass"]
    assert outs["port"]["best_recorded"]["announce_p99_ratio"] == 0.98
