"""Port parity for the replay tooling: the ``df2-replay`` CLI
(``cmd/replaytool.py``: ``pack``, ``check``, ``stat``) and the bench
helpers (``scheduler/replaybench.py``: ``synth_replay_corpus``, the
throughput ladder, the persisted-record readers, the ladder half of the
regression check), against the JAX package, on the CPU.

Outputs are compared exactly, apart from the ladder's timings (host
clock readings, different in every run); no speedup is asserted.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from dragonfly2_tpu.cmd import replaytool as jax_tool
from dragonfly2_tpu.scheduler import replaybench as jax_bench
from dragonfly2_tpu.scheduler import replaystore as jax_store
from dragonfly2_tpu_torch import schema
from dragonfly2_tpu_torch.cmd import replaytool
from dragonfly2_tpu_torch.scheduler import replaybench, replaystore
from dragonfly2_tpu_torch.schema.io import CsvRecordWriter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMING_KEYS = ("seq_elapsed_s", "seq_decisions_per_s", "vec_elapsed_s",
               "vec_decisions_per_s", "sharded_elapsed_s",
               "sharded_decisions_per_s", "speedup", "sharded_speedup")


def run_both(capsys, argv):
    """(port's (rc, stdout, stderr), JAX's) for one argv."""
    out = []
    for tool in (replaytool, jax_tool):
        try:
            rc = tool.main(list(argv))
        except SystemExit as exc:  # argparse and the source expansion
            rc = exc.code
        captured = capsys.readouterr()
        out.append((rc, captured.out, captured.err))
    return out


@pytest.fixture
def corpus_files(tmp_path):
    """A storage-like directory of two replay CSVs written by the port's
    CSV writer, and a good and a truncated ``.npc``."""
    events = replaybench.synth_replay_corpus(240, seed=31).to_events()
    src = tmp_path / "sched"
    src.mkdir()
    for name, part in (("replay-2024.csv", events[:100]),
                       ("replay.csv", events[100:])):
        with CsvRecordWriter(schema.ReplayDecision, str(src / name)) as w:
            for e in part:
                w.write(e)
    good = str(tmp_path / "good.npc")
    replaystore.write_columns(good, replaybench.synth_replay_corpus(
        300, seed=32).columns())
    bad = str(tmp_path / "bad.npc")
    with open(good, "rb") as f, open(bad, "wb") as g:
        g.write(f.read()[:-4])
    return {"dir": str(src), "good": good, "bad": bad, "tmp": tmp_path}


def test_pack_output_equal_to_jax(capsys, corpus_files):
    tmp = corpus_files["tmp"]
    outs = []
    for tool, name in ((replaytool, "port.npc"), (jax_tool, "jax.npc")):
        rc = tool.main(["pack", corpus_files["dir"], "-o", str(tmp / name)])
        captured = capsys.readouterr()
        assert rc == 0, captured.err
        report = json.loads(captured.out)
        report.pop("path")
        report["check"].pop("path")
        outs.append(report)
    assert outs[0] == outs[1]
    assert outs[0]["decisions"] == 240 and outs[0]["check"]["ok"]
    assert len(outs[0]["sources"]) == 2
    with open(tmp / "port.npc", "rb") as a, open(tmp / "jax.npc", "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("command", ["check", "stat"])
@pytest.mark.parametrize("as_json", [True, False])
def test_check_and_stat_output_equal_to_jax(capsys, corpus_files, command,
                                            as_json):
    argv = [command, corpus_files["good"], corpus_files["bad"]]
    if as_json:
        argv.append("--json")
    got, want = run_both(capsys, argv)
    assert got == want
    # The truncated file is red: a nonzero exit, except from ``stat
    # --json``, which reports it in the JSON only (as JAX's does).
    assert got[0] == (0 if (command, as_json) == ("stat", True) else 1)
    if as_json:
        reports = json.loads(got[1])
        assert [r["ok"] for r in reports] == [True, False]
    good_only = [command, corpus_files["good"]] + (["--json"] if as_json
                                                   else [])
    got, want = run_both(capsys, good_only)
    assert got == want and got[0] == 0


@pytest.mark.parametrize("case", ["empty_dir", "missing_file", "bad_args"])
def test_refusals_equal_to_jax(capsys, tmp_path, case):
    if case == "empty_dir":
        argv = ["pack", str(tmp_path), "-o", str(tmp_path / "o.npc")]
    elif case == "missing_file":
        argv = ["pack", str(tmp_path / "absent.csv"), "-o",
                str(tmp_path / "o.npc")]
    else:
        argv = ["pack", str(tmp_path)]
    got, want = run_both(capsys, argv)
    assert got[0] == want[0] and got[0] not in (0, None)
    if case != "bad_args":  # argparse prints the program's own usage
        assert got == want
    assert not os.path.exists(tmp_path / "o.npc")


def test_runs_as_a_module(corpus_files):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "dragonfly2_tpu_torch.cmd.replaytool", "stat",
         corpus_files["good"], "--json"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout)[0]
    assert report == json.loads(json.dumps(jax_store.check_corpus(
        corpus_files["good"]) | {"bytes": os.path.getsize(
            corpus_files["good"]), "tasks": 50}))


# -- the bench helpers --------------------------------------------------------


@pytest.mark.parametrize("n,seed,b2s", [(0, 0, 0.05), (1, 4, 0.05),
                                        (257, 1, 0.05), (3000, 7, 0.05),
                                        (500, 2, 0.5), (100, 3, 0.0)])
def test_synth_replay_corpus_equal_to_jax(n, seed, b2s):
    got = replaybench.synth_replay_corpus(n, seed=seed, b2s_fraction=b2s)
    want = jax_bench.synth_replay_corpus(n, seed=seed, b2s_fraction=b2s)
    assert (got.n, got.k) == (want.n, want.k)
    for name in replaystore.ALL_COLUMNS:
        a, b = got.columns()[name], want.columns()[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def strip_timings(report: dict) -> dict:
    return {k: v for k, v in report.items() if k not in TIMING_KEYS}


def test_rung_report_keys_present_from_birth():
    got = replaybench._ladder_rung_report(10)
    assert got == jax_bench._ladder_rung_report(10)
    assert got["decisions"] == 10 and got["error"] is None


def test_ladder_rungs_equal_to_jax():
    got = replaybench.run_replay_throughput_ladder(rungs=(500, 2000),
                                                   bound=0.0)
    want = jax_bench.run_replay_throughput_ladder(rungs=(500, 2000),
                                                  bound=0.0)
    assert got.keys() == want.keys()
    assert {k: v for k, v in got.items() if k != "rungs"} == \
        {k: v for k, v in want.items() if k != "rungs"}
    assert got["error"] is None and got["verdict_pass"] is True
    assert [strip_timings(r) for r in got["rungs"]] == \
        [strip_timings(r) for r in want["rungs"]]
    for rung in got["rungs"]:
        assert rung.keys() == replaybench._ladder_rung_report(0).keys()
        assert rung["error"] is None and rung["digests_equal"] is True
        assert all(rung[k] is not None and rung[k] > 0 for k in TIMING_KEYS)
    assert [r["corpus_k"] for r in got["rungs"]] == [16, 16]


def test_ladder_reports_a_rung_that_fails(monkeypatch):
    def boom(n, seed=0, b2s_fraction=0.05):
        if n == 64:
            return real(n, seed=seed)
        raise RuntimeError("no corpus")

    real = replaybench.synth_replay_corpus
    monkeypatch.setattr(replaybench, "synth_replay_corpus", boom)
    got = replaybench.run_replay_throughput_ladder(rungs=(100,))
    assert got["verdict_pass"] is False and got["error"] is None
    assert got["rungs"][0]["error"] == "RuntimeError: no corpus"
    assert got["rungs"][0]["digest"] is None


def write_json(path, data) -> None:
    with open(path, "w") as f:
        json.dump(data, f)


@pytest.fixture
def state_dir(tmp_path):
    """Persisted bench records as the bench writes them: replay A/B runs
    (green, red, skipped, unreadable) and ladder runs."""
    def ab(corpus, cost_regret, verdict=True, **extra):
        return {"verdict_pass": verdict, "record": {
            "corpus_decisions": corpus}, "ab": {"evaluators": {
                "rule": {"regret_mean_s": 0.01},
                "cost": {"regret_mean_s": cost_regret}}}, **extra}

    def ladder(rungs, verdict=True, **extra):
        return {"verdict_pass": verdict, "bound": 20.0, "rungs": [
            dict(replaybench._ladder_rung_report(n), vec_decisions_per_s=v,
                 digests_equal=True) for n, v in rungs], **extra}

    write_json(tmp_path / "replay_run_a.json", ab(400, 0.004))
    write_json(tmp_path / "replay_run_b.json", ab(600, 0.009))
    write_json(tmp_path / "replay_run_c.json", ab(600, 0.003))
    write_json(tmp_path / "replay_run_d.json", ab(900, 0.001, False))
    write_json(tmp_path / "replay_run_e.json", ab(950, 0.001, skipped=True))
    (tmp_path / "replay_run_f.json").write_text("{not json")
    write_json(tmp_path / "replay_ladder_run_a.json",
               ladder([(500, 2e5), (2000, 3e5)]))
    write_json(tmp_path / "replay_ladder_run_b.json",
               ladder([(500, 1e5), (2000, 4e5)]))
    write_json(tmp_path / "replay_ladder_run_c.json",
               ladder([(500, 9e9), (2000, 9e9)], False))
    write_json(tmp_path / "replay_ladder_run_d.json", ladder([]))
    return str(tmp_path)


def test_best_recorded_runs_equal_to_jax(state_dir, tmp_path_factory):
    got = replaybench.best_recorded_replay_run(state_dir)
    assert got == jax_bench.best_recorded_replay_run(state_dir)
    assert got["file"] == "replay_run_c.json"
    got = replaybench.best_recorded_replay_ladder(state_dir)
    assert got == jax_bench.best_recorded_replay_ladder(state_dir)
    assert got["file"] == "replay_ladder_run_b.json"
    empty = str(tmp_path_factory.mktemp("empty"))
    assert replaybench.best_recorded_replay_run(empty) is None
    assert replaybench.best_recorded_replay_ladder(empty) is None


@pytest.mark.parametrize("record", ["unreachable", "reachable", "none"])
def test_ladder_regression_equals_jax_check(monkeypatch, tmp_path, record):
    """The ladder keys of JAX's ``check_replay_regression`` (its fresh
    A/B swapped for a canned report: only the ladder half is compared
    here)."""
    if record != "none":
        rate = 1e12 if record == "unreachable" else 1.0
        write_json(tmp_path / "replay_ladder_run_x.json", {
            "verdict_pass": True, "bound": 20.0, "rungs": [dict(
                replaybench._ladder_rung_report(700),
                vec_decisions_per_s=rate, digests_equal=True)]})
    monkeypatch.setattr(jax_bench, "run_replay_ab",
                        lambda **kw: {"verdict_pass": True, "ab": {}})
    monkeypatch.setattr(jax_bench, "LADDER_RUNGS", (600,))
    monkeypatch.setattr(replaybench, "LADDER_RUNGS", (600,))
    got = replaybench.ladder_regression(str(tmp_path))
    want = jax_bench.check_replay_regression(str(tmp_path))
    for key in got:
        if key == "ladder_rung":
            assert strip_timings(got[key]) == strip_timings(want[key])
        else:
            assert got[key] == want[key], key
    assert got["ladder_rung"]["decisions"] == (600 if record == "none"
                                               else 700)
    assert got["ladder_digests_ok"] is True
    assert got["ladder_throughput_ok"] is (record != "unreachable")


@pytest.mark.parametrize("candidate,baseline", [
    (None, 0.01), (0.01, None), (0.0105, 0.01), (0.0111, 0.01),
    (0.003, 0.0005), (0.0026, 0.0005), (-0.02, -0.01)])
def test_regret_bound_equal_to_jax(candidate, baseline):
    assert replaybench._regret_within_bound(candidate, baseline) == \
        jax_bench._regret_within_bound(candidate, baseline)
    assert (replaybench.REGRET_REL_BOUND, replaybench.REGRET_ABS_BOUND_S,
            replaybench.MIN_CORPUS_DECISIONS, replaybench.LADDER_RUNGS,
            replaybench.VECTORIZED_SPEEDUP_BOUND, replaybench.LADDER_SHARDS,
            replaybench.LADDER_REGRESSION_FACTOR) == (
        jax_bench.REGRET_REL_BOUND, jax_bench.REGRET_ABS_BOUND_S,
        jax_bench.MIN_CORPUS_DECISIONS, jax_bench.LADDER_RUNGS,
        jax_bench.VECTORIZED_SPEEDUP_BOUND, jax_bench.LADDER_SHARDS,
        jax_bench.LADDER_REGRESSION_FACTOR)
