"""Port parity for the replay plane's recording half on the CPU:
``scheduler/replaylog.py`` (the announce-stream recorder) and
``scheduler/loadbench.py`` (the in-process swarm driver and the
scheduler ladder's record readers), against the JAX package.

Tolerances: none. A single announce worker with the GC-churn thread off
makes a swarm deterministic under ``random.seed`` (the scheduling core
samples candidates with the ``random`` module; the GC thread's timing is
the one input a seed does not fix). Under that seeding the two packages'
recorded events are equal field for field, floats bit for bit, apart
from the two wall-clock stamps ``decided_at`` and ``finalized_at``; the
rung's counters are equal, its timings and memory gauges are not
compared.
"""

from __future__ import annotations

import dataclasses
import json
import random

import pytest

from dragonfly2_tpu.scheduler import controlstats as jax_controlstats
from dragonfly2_tpu.scheduler import loadbench as jax_loadbench
from dragonfly2_tpu.scheduler import replaylog as jax_replaylog
from dragonfly2_tpu.schema import ReplayDecision as JaxReplayDecision
from dragonfly2_tpu_torch.scheduler import controlstats, loadbench, replaylog
from dragonfly2_tpu_torch.scheduler import replay
from dragonfly2_tpu_torch.scheduler.storage.storage import (
    Storage,
    StorageConfig,
)
from dragonfly2_tpu_torch.schema import ReplayDecision

PACKAGES = {
    "jax": (jax_replaylog, jax_loadbench, jax_controlstats,
            JaxReplayDecision),
    "port": (replaylog, loadbench, controlstats, ReplayDecision),
}

#: Rung keys that are wall-clock timings or process memory gauges.
TIMINGS = {"seconds", "announce_p50_ms", "announce_p99_ms",
           "decisions_per_sec", "piece_reports_per_sec", "filter_ms_p99",
           "evaluate_ms_p99", "gc_pause_p50_ms", "gc_pause_p99_ms",
           "peak_rss_mb", "peak_rss_scope", "rss_delta_mb",
           "bytes_per_peer"}
STAMPS = ("decided_at", "finalized_at")
SWARM_PEERS = 150


def recorded_swarm(package: str, seed: int, storage=None):
    """One profiled swarm of SWARM_PEERS peers through ``package``'s
    scheduler with its recorder: (rung, the recorder's ring)."""
    log, bench, stats, _ = PACKAGES[package]
    random.seed(seed)
    recorder = log.ReplayRecorder(storage, stats=stats.ControlPlaneStats())
    rung = bench.run_swarm_bench(SWARM_PEERS, workers=1, gc_churn=False,
                                 recorder=recorder, cost_profile="profiled",
                                 profile_seed=seed)
    events = recorder.events()
    recorder.close()
    return rung, events


def without_stamps(events) -> list:
    out = []
    for event in events:
        fields = dataclasses.asdict(event)
        for name in STAMPS:
            fields.pop(name)
        out.append(fields)
    return out


@pytest.fixture(scope="module")
def swarms(tmp_path_factory):
    """Seeds 0-2 through both packages; the port's seed-0 run also
    records into a rotating scheduler storage."""
    runs = {}
    for seed in range(3):
        runs["jax", seed] = recorded_swarm("jax", seed)
        storage = None
        if seed == 0:
            storage = Storage(
                str(tmp_path_factory.mktemp("replaylog") / "sched"),
                StorageConfig(max_size=64 * 1024, buffer_size=10))
        runs["port", seed] = recorded_swarm("port", seed, storage)
        runs["storage", seed] = storage
    return runs


@pytest.mark.parametrize("seed", range(3))
def test_recorded_events_equal_jax(swarms, seed):
    got, want = swarms["port", seed][1], swarms["jax", seed][1]
    assert len(got) == len(want) == SWARM_PEERS
    assert without_stamps(got) == without_stamps(want)
    assert all(e.decided_at > 0 and e.finalized_at >= e.decided_at
               for e in got)


@pytest.mark.parametrize("seed", range(3))
def test_rung_counters_equal_jax(swarms, seed):
    got, want = swarms["port", seed][0], swarms["jax", seed][0]
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in TIMINGS} == \
        {k: v for k, v in want.items() if k not in TIMINGS}
    assert got["errors"] == [] and got["decisions"] == SWARM_PEERS
    assert got["replay_finalized"] == got["replay_decisions"] \
        == got["decisions"] + got["back_to_source"]
    assert got["replay_evicted"] == 0


def test_rotating_dataset_reads_back_the_ring(swarms):
    storage = swarms["storage", 0]
    ring = swarms["port", 0][1]
    assert len(storage.replay.all_files()) > 1  # it rotated
    assert storage.list_replay() == ring
    assert replay.corpus_from_storage(storage) == \
        replay.corpus_from_events(ring)


# -- the JAX recorder's cases, on both packages -------------------------------


class _Task:
    id = "t"
    total_piece_count = 4


class _Host:
    type = type("T", (), {"is_seed": False})()
    upload_count = 0
    upload_failed_count = 0
    concurrent_upload_limit = 10
    idc = ""
    location = ""

    def free_upload_count(self):
        return 10


class _Peer:
    def __init__(self, pid):
        self.id = pid
        self.task = _Task()
        self.host = _Host()

    def state(self):
        return "Running"

    def finished_piece_count(self):
        return 1

    def piece_costs(self):
        return [0.01]


@pytest.mark.parametrize("package", PACKAGES)
def test_eviction_bounds_pending(package):
    log, _, stats_mod, _ = PACKAGES[package]
    stats = stats_mod.ControlPlaneStats()
    rec = log.ReplayRecorder(max_pending=2, stats=stats)
    cand = [_Peer("c1"), _Peer("c2")]
    for i in range(3):
        rec.record_decision(_Peer(f"p{i}"), cand, cand, 4)
    rec.drain()
    assert rec.pending_count() == 2
    assert stats.snapshot()["replay_evicted"] == 1
    evicted = rec.events()
    assert len(evicted) == 1 and evicted[0].outcome == ""
    assert evicted[0].peer_id == "p0"
    rec.close()


@pytest.mark.parametrize("package", PACKAGES)
def test_queue_overflow_sheds_before_extraction(package):
    log = PACKAGES[package][0]
    rec = log.ReplayRecorder(queue_capacity=0)

    class _Boom:
        id = "p"
        task = type("T", (), {"id": "t", "total_piece_count": 4})()
        fsm = type("F", (), {"current": "Succeeded"})()
        cost = 0.0
        host = type("H", (), {"idc": "", "location": ""})()

        def finished_piece_count(self):
            raise AssertionError("extracted a shed decision")

    rec.record_decision(_Boom(), [], [], 4)
    assert rec.dropped == 1
    rec.record_outcome(_Boom())
    assert rec.dropped == 2
    rec.record_back_to_source(_Boom())
    assert rec.dropped == 3
    rec.close()
    rec.record_outcome(_Boom())
    assert rec.dropped == 4


@pytest.mark.parametrize("package", PACKAGES)
def test_commit_is_one_sink_call_per_drain(package):
    log, _, stats_mod, decision = PACKAGES[package]
    calls = []

    class _Sink:
        def create_replay_batch(self, records):
            calls.append(list(records))

    stats = stats_mod.ControlPlaneStats()
    rec = log.ReplayRecorder(_Sink(), stats=stats)
    staged = [("ready", decision(seq=i, verdict="back_to_source"))
              for i in range(12)]
    rec._commit(staged)
    assert len(calls) == 1 and len(calls[0]) == 12
    assert stats.snapshot()["replay_appends_batched"] == 1
    assert len(rec.events()) == 12
    rec._commit([])
    assert len(calls) == 1, "empty drains must not touch the sink"
    rec.close()


@pytest.mark.parametrize("package", ["jax", "port"])
def test_rung_reports_batched_appends(swarms, package):
    rung = swarms[package, 1][0]
    assert 0 < rung["replay_appends_batched"] <= rung["replay_finalized"]
    assert "replay_appends_batched" in \
        PACKAGES[package][2].ControlPlaneStats().snapshot()


@pytest.mark.parametrize("package", PACKAGES)
def test_snapshot_mean(package):
    log = PACKAGES[package][0]
    assert log.snapshot_mean((0, 0.0, 0.0, 0.0)) == -1.0
    assert log.snapshot_mean((1, 2.0, 0.0, 0.0)) == 2.0
    assert log.snapshot_mean((3, 3.0, 1.5, 0.1)) == pytest.approx(2.0)


@pytest.mark.parametrize("costs", [[], [4.0], [1.0, 2.0, 3.0],
                                   [0.5, 0.25, 8.0, 1e-3]])
def test_welford_snapshot_duck_typed(costs):
    class _P:
        def piece_costs(self):
            return costs

    got = replaylog.welford_snapshot(_P())
    assert got == jax_replaylog.welford_snapshot(_P())
    if len(costs) == 3:
        n, last, mean, _ = got
        assert (n, last) == (3, 3.0) and mean == pytest.approx(1.5)


# -- the scheduler ladder's persisted records ---------------------------------


def _rung(dps, p99=1.0, peers_per_task=100):
    return {"decisions_per_sec": dps, "announce_p99_ms": p99,
            "bytes_per_peer": 512.0, "peers_per_task": peers_per_task}


STATE = {
    # The largest top rung wins over a faster small one.
    "scheduler_run_a.json": {"ladder": {"ladder": {
        "100": _rung(9000.0), "400": _rung(8000.0, p99=2.5)}}},
    "scheduler_run_b.json": {"ladder": {"ladder": {
        "100": _rung(50000.0)}}},
    # Ties on the top rung break on decisions/sec.
    "scheduler_run_c.json": {"ladder": {"ladder": {
        "400": _rung(8500.0, p99=3.0, peers_per_task=50)}}},
    "scheduler_run_empty.json": {"ladder": {"ladder": {}}},
    "scheduler_run_zero.json": {"ladder": {"ladder": {"9000": _rung(0)}}},
    "scheduler_run_bad.json": "{not json",
    "other_run.json": {"ladder": {"ladder": {"99999": _rung(1e9)}}},
}


def write_state(root, files: dict) -> str:
    for name, body in files.items():
        text = body if isinstance(body, str) else json.dumps(body)
        (root / name).write_text(text)
    return str(root)


@pytest.mark.parametrize("files", ["all", "none", "only_bad"])
def test_best_recorded_scheduler_run_equal_jax(tmp_path, files):
    chosen = {"all": STATE, "none": {},
              "only_bad": {k: v for k, v in STATE.items()
                           if k in ("scheduler_run_bad.json",
                                    "scheduler_run_empty.json",
                                    "scheduler_run_zero.json")}}[files]
    state = write_state(tmp_path, chosen)
    got = loadbench.best_recorded_scheduler_run(state)
    assert got == jax_loadbench.best_recorded_scheduler_run(state)
    if files == "all":
        assert got["file"] == "scheduler_run_c.json"
        assert (got["rung"], got["peers_per_task"]) == (400, 50)
    else:
        assert got is None


@pytest.mark.parametrize("record", ["easy", "unreachable"])
def test_check_scheduler_regression_equal_jax(tmp_path, record):
    """A fresh run of the record's top rung: a record no host can miss
    passes in both packages, one no host can reach fails in both."""
    dps, p99 = {"easy": (1.0, 1e6), "unreachable": (1e12, 1e-9)}[record]
    state = write_state(tmp_path, {"scheduler_run_x.json": {"ladder": {
        "ladder": {"60": _rung(dps, p99=p99, peers_per_task=30)}}}})
    got = loadbench.check_scheduler_regression(state)
    want = jax_loadbench.check_scheduler_regression(state)
    shared = ("rung", "best_recorded", "decisions_fraction", "p99_factor",
              "passed")
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}
    assert set(got) == set(want)
    assert got["passed"] is (record == "easy")
    assert got["fresh_decisions_per_sec"] > 0


def test_check_scheduler_regression_without_record(tmp_path, monkeypatch):
    """No record: both packages check the ladder's own bound, here on a
    stand-in ladder (the real one's verdict is a host-speed limit)."""
    def ladder(ratio):
        def run(sizes, **kwargs):
            assert tuple(sizes) == (100, 1000, 5000)
            return {"decision_p99_ratio": ratio,
                    "p99_within_bound": ratio <= 4.0}
        return run

    for ratio in (1.5, 9.0):
        monkeypatch.setattr(loadbench, "run_swarm_ladder", ladder(ratio))
        monkeypatch.setattr(jax_loadbench, "run_swarm_ladder", ladder(ratio))
        got = loadbench.check_scheduler_regression(str(tmp_path))
        assert got == jax_loadbench.check_scheduler_regression(
            str(tmp_path))
        assert got["passed"] is (ratio <= 4.0)
        assert got["best_recorded"] is None
