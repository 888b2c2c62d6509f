"""Port parity for the scheduler's evaluators and the MLP scorers: the
port copies (``dragonfly2_tpu_torch.scheduler``, ``inference.modelguard``,
``inference.scorer``) against the JAX package's on numpy-seeded inputs
given to both.

Rule scoring and the rule evaluator are numpy in both packages, so they
must agree exactly (float64 where ``rule_scores`` promotes). The learned
evaluators run both packages' models in f32 on the same params, where
orders, verdicts, guard trips, counters and quality samples must be
identical; scores agree within 1e-4 in f32 and 6e-2 in bf16 (the
tolerances of tests/test_torch_serving.py).
"""

from __future__ import annotations

import sys
import threading
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.inference import modelguard as jax_guard
from dragonfly2_tpu.inference import scorer as jax_scorer
from dragonfly2_tpu.models.mlp import MLPBandwidthPredictor as JaxMLP
from dragonfly2_tpu.models.mlp import Normalizer as JaxNormalizer
from dragonfly2_tpu.scheduler import controlstats as jax_controlstats
from dragonfly2_tpu.scheduler.evaluator import base as jax_base
from dragonfly2_tpu.scheduler.evaluator import new_evaluator as jax_new_evaluator
from dragonfly2_tpu.scheduler.evaluator import scoring as jax_scoring
from dragonfly2_tpu.scheduler.replaylog import welford_snapshot as jax_welford
from dragonfly2_tpu.utils.hosttypes import HostType
from dragonfly2_tpu.utils.servingstats import ServingStats as JaxServingStats
from dragonfly2_tpu_torch.inference import modelguard
from dragonfly2_tpu_torch.inference.batcher import MicroBatcher
from dragonfly2_tpu_torch.inference.scorer import (
    CostScorer,
    LearnedCostEvaluator,
    MLEvaluator,
    ParentScorer,
)
from dragonfly2_tpu_torch.models.mlp import MLPBandwidthPredictor, Normalizer
from dragonfly2_tpu_torch.scheduler import controlstats
from dragonfly2_tpu_torch.scheduler.evaluator import (
    PLUGIN_GROUP,
    BaseEvaluator,
    new_evaluator,
    scoring,
)
from dragonfly2_tpu_torch.scheduler.evaluator.base import (
    build_feature_matrix,
    pair_features,
)
from dragonfly2_tpu_torch.scheduler.replaylog import welford_snapshot
from dragonfly2_tpu_torch.train.checkpoint import mlp_state_dict_from_flax
from dragonfly2_tpu_torch.utils.servingstats import ServingStats

F32_TOL = 1e-4
BF16_TOL = 6e-2
HIDDEN = (32, 32)


# -- duck-typed peers (tests/test_inference.py's fakes, with cost stats) ---


@dataclass
class FakeHost:
    type: HostType = HostType.NORMAL
    upload_count: int = 0
    upload_failed_count: int = 0
    concurrent_upload_limit: int = 50
    concurrent_upload_count: int = 0
    idc: str = ""
    location: str = ""

    def free_upload_count(self) -> int:
        return self.concurrent_upload_limit - self.concurrent_upload_count


@dataclass
class FakeCostStats:
    """Windowed Welford aggregates as the resource model keeps them."""

    costs: list
    appends: int = 0

    def snapshot(self) -> tuple:
        c = np.asarray(self.costs, np.float64)
        if len(c) < 2:
            return len(c), float(c[-1]) if len(c) else 0.0, 0.0, 0.0
        return len(c), float(c[-1]), float(c[:-1].mean()), float(c[:-1].std())


@dataclass
class FakePeer:
    id: str = "peer"
    host: FakeHost = field(default_factory=FakeHost)
    _state: str = "Running"
    _finished: int = 0
    costs: list = field(default_factory=list)
    stats: FakeCostStats | None = None

    def state(self) -> str:
        return self._state

    def finished_piece_count(self) -> int:
        return self._finished

    def piece_costs(self):
        return self.costs


class StatsPeer(FakePeer):
    """A peer that carries O(1) cost aggregates (the fast path)."""

    def piece_cost_stats(self):
        return self.stats


STATES = ("Running", "ReceivedNormal", "Succeeded", "Pending", "Failed",
          "ReceivedSmall", "BackToSource", "Leave")


def seeded_peer(rng, name: str, with_stats: bool = False) -> FakePeer:
    seed_type = HostType(int(rng.choice([0, 0, 0, 0, 1, 2, 3])))
    limit = 300 if seed_type.is_seed else 50
    uploads = int(rng.integers(0, 80))
    region, zone, rack = (int(v) for v in rng.integers(0, (3, 3, 4)))
    host = FakeHost(
        type=seed_type, upload_count=uploads,
        upload_failed_count=int(rng.integers(0, uploads + 5)),
        concurrent_upload_limit=int(rng.choice([limit, 0])),
        concurrent_upload_count=int(rng.integers(0, limit)),
        idc=str(rng.choice(["", f"idc-{region}", f"IDC-{region}"])),
        location=str(rng.choice(["", f"r{region}|z{zone}|k{rack}",
                                 f"r{region}|z{zone}"])))
    n_costs = int(rng.choice([0, 1, 2, 5, 29, 30, 45]))
    costs = list(rng.lognormal(np.log(0.05), 0.4, n_costs))
    if costs and rng.random() < 0.4:
        costs[-1] *= float(rng.choice([4.0, 25.0]))
    cls = StatsPeer if with_stats else FakePeer
    return cls(name, host, str(rng.choice(STATES[:3] if rng.random() < 0.85
                                         else STATES)),
               int(rng.integers(0, 300)), costs,
               FakeCostStats(costs, appends=len(costs)))


def seeded_decisions(seed: int, n: int, k: int = 15,
                     with_stats: bool = False) -> list:
    rng = np.random.default_rng(seed)
    return [([seeded_peer(rng, f"p{d}-{i}", with_stats) for i in range(k)],
             seeded_peer(rng, f"c{d}", with_stats),
             int(rng.choice([0, 64, 256, 1024]))) for d in range(n)]


def ids(peers) -> list:
    return [p.id for p in peers]


# -- the numeric core --------------------------------------------------------


def random_features(seed: int, n: int = 4096) -> np.ndarray:
    rng = np.random.default_rng(seed)
    f = np.stack([
        rng.integers(0, 300, n), rng.integers(0, 300, n),
        rng.choice([0, 64, 256, 1024], n), rng.integers(0, 80, n),
        rng.integers(0, 90, n), rng.integers(-2, 60, n),
        rng.choice([0, 50, 300], n), rng.integers(0, 2, n),
        rng.integers(0, 2, n), rng.integers(0, 2, n), rng.integers(0, 6, n),
    ], axis=1).astype(np.float32)
    return f


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rule_scores_equal_in_float64(seed):
    f = random_features(seed)
    got, want = scoring.rule_scores(f), jax_scoring.rule_scores(f)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert scoring.FEATURE_NAMES == jax_scoring.FEATURE_NAMES


def test_pack_features_and_affinities_equal():
    rng = np.random.default_rng(3)
    names = ["", "a", "A", "r1|z2|k3", "R1|z2|k4", "r1|z9", "r1|z2|k3|x|y|z",
             "r1|Z2|k3|x|y|w"]
    for _ in range(400):
        kw = dict(
            parent_finished_pieces=float(rng.integers(0, 99)),
            child_finished_pieces=float(rng.integers(0, 99)),
            total_pieces=float(rng.choice([0, 64])),
            upload_count=float(rng.integers(0, 9)),
            upload_failed_count=float(rng.integers(0, 9)),
            free_upload_count=float(rng.integers(0, 9)),
            concurrent_upload_limit=float(rng.integers(0, 9)),
            is_seed=bool(rng.integers(0, 2)),
            seed_ready=bool(rng.integers(0, 2)),
            parent_idc=str(rng.choice(names)), child_idc=str(rng.choice(names)),
            parent_location=str(rng.choice(names)),
            child_location=str(rng.choice(names)))
        got, want = scoring.pack_features(**kw), jax_scoring.pack_features(**kw)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(scoring.rule_scores(got),
                                      jax_scoring.rule_scores(want))


@pytest.mark.parametrize("with_stats", [False, True])
def test_build_feature_matrix_matches_pair_features(with_stats):
    for parents, child, total in seeded_decisions(4, 20,
                                                  with_stats=with_stats):
        got = build_feature_matrix(parents, child, total)
        rows = np.stack([jax_base.pair_features(p, child, total)
                         for p in parents])
        np.testing.assert_array_equal(got, rows)
        np.testing.assert_array_equal(
            got, jax_base.build_feature_matrix(parents, child, total))
        np.testing.assert_array_equal(
            np.stack([pair_features(p, child, total) for p in parents]), rows)


@pytest.mark.parametrize("with_stats", [False, True])
def test_base_evaluator_matches_jax(with_stats):
    stats, jax_stats = (controlstats.ControlPlaneStats(),
                        jax_controlstats.ControlPlaneStats())
    port, ref = BaseEvaluator(stats), jax_base.BaseEvaluator(jax_stats)
    for parents, child, total in seeded_decisions(5, 40,
                                                  with_stats=with_stats):
        assert ids(port.evaluate_parents(parents, child, total)) == ids(
            ref.evaluate_parents(parents, child, total))
        assert [port.is_bad_node(p) for p in parents] == [
            ref.is_bad_node(p) for p in parents]
        assert port.evaluate(parents[0], child, total) == ref.evaluate(
            parents[0], child, total)
    for key in ("bad_node_fast", "bad_node_slow"):
        assert getattr(stats, key) == getattr(jax_stats, key)
    assert (stats.bad_node_fast > 0) == with_stats
    assert (stats.bad_node_slow > 0) != with_stats


def test_welford_snapshot_equal_on_both_paths():
    rng = np.random.default_rng(6)
    for with_stats in (False, True):
        for i in range(60):
            peer = seeded_peer(rng, f"w{i}", with_stats)
            assert welford_snapshot(peer) == jax_welford(peer)


GUARD_CASES = {
    "empty": (np.zeros(0), None),
    "nan": (np.array([1.0, np.nan, 2.0]), None),
    "inf": (np.array([1.0, 2.0, -np.inf, 3.0]), None),
    "constant": (np.full(6, 2.5), np.arange(66.0).reshape(6, 11)),
    "constant_no_features": (np.full(6, 2.5), None),
    "constant_waived": (np.full(6, 2.5), np.ones((6, 11))),
    "constant_small_batch": (np.full(3, 2.5), np.arange(33.0).reshape(3, 11)),
    "spread_below_limit": (2.5 + np.arange(5) * 1e-9, None),
    "healthy": (np.array([0.1, 0.5, 0.3, 0.9]), np.eye(4, 11)),
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_guard_reason_matches_jax(case):
    scores, features = GUARD_CASES[case]
    assert modelguard.guard_reason(scores, features) == \
        jax_guard.guard_reason(scores, features)
    assert (modelguard.GUARD_MIN_CONSTANT_ROWS,
            modelguard.GUARD_MIN_SCORE_SPREAD) == (
        jax_guard.GUARD_MIN_CONSTANT_ROWS, jax_guard.GUARD_MIN_SCORE_SPREAD)


# -- scorers over one set of params ------------------------------------------


@pytest.fixture(scope="module")
def mlp():
    rng = np.random.default_rng(7)
    x = random_features(7, 2048)
    norm = JaxNormalizer.fit(x)
    target = JaxNormalizer(np.array([0.3], np.float32),
                           np.array([0.4], np.float32))
    params = jax.device_get(JaxMLP(hidden=HIDDEN).init(
        jax.random.key(0), jnp.zeros((1, 11))))
    return dict(x=x, norm=norm, target=target, params=params, rng=rng)


def port_scorer(mlp, dtype, params=None, target=None, **kw) -> ParentScorer:
    model = MLPBandwidthPredictor(hidden=HIDDEN, dtype=dtype)
    model.load_state_dict(mlp_state_dict_from_flax(
        mlp["params"] if params is None else params))
    norm, tgt = mlp["norm"], target or mlp["target"]
    return ParentScorer(model, Normalizer(norm.mean, norm.std),
                        Normalizer(tgt.mean, tgt.std), device="cpu", **kw)


def jax_parent_scorer(mlp, dtype, params=None, target=None, **kw):
    return jax_scorer.ParentScorer(
        JaxMLP(hidden=HIDDEN, dtype=dtype),
        mlp["params"] if params is None else params, mlp["norm"],
        target or mlp["target"], **kw)


def nan_params(params):
    return jax.tree_util.tree_map(lambda a: np.full_like(a, np.nan), params)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_score_corpus_row_stable_and_matches_jax(mlp, dtype):
    torch_dtype, jax_dtype, tol = {
        "f32": (torch.float32, jnp.float32, F32_TOL),
        "bf16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}[dtype]
    port = port_scorer(mlp, torch_dtype)
    x = mlp["x"]
    corpus = port.score_corpus(x)
    assert port.buckets == [port.max_batch] == [64]
    # Any order of the corpus gives the same bits; so do requests of
    # every size, each padded to the one forward shape.
    perm = np.random.default_rng(1).permutation(len(x))
    np.testing.assert_array_equal(port.score_corpus(x[perm]), corpus[perm])
    np.testing.assert_array_equal(port.score_corpus(x[:100]), corpus[:100])
    for n in (1, 8, 15, 16, 17, 32, 33, 64):
        got = np.concatenate([port.score(x[perm[s:s + n]])
                              for s in range(0, 256, n)])
        np.testing.assert_array_equal(got, corpus[perm[:len(got)]])
    assert len(port.score_corpus(x[:0])) == 0
    ref = jax_parent_scorer(mlp, jax_dtype).score_corpus(x)
    np.testing.assert_allclose(corpus, ref, rtol=tol, atol=tol)


def test_ensure_staging_depth_grows_while_scoring(mlp):
    scorer = port_scorer(mlp, torch.float32)
    want = {n: scorer.score(mlp["x"][:n]) for n in (3, 15, 40)}
    assert scorer._staging.depth == 2
    errors, stop = [], threading.Event()

    def work():
        try:
            while not stop.is_set():
                for n, ref in want.items():
                    np.testing.assert_array_equal(
                        scorer.score(mlp["x"][:n]), ref)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for depth in (3, 5, 8, 4):
            scorer.ensure_staging_depth(depth)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    assert scorer._staging.depth == 8
    for n, ref in want.items():
        np.testing.assert_array_equal(scorer.score(mlp["x"][:n]), ref)


def test_benchmark_reports_percentiles(mlp):
    out = port_scorer(mlp, torch.float32).benchmark(batch=15, iters=20)
    assert set(out) == {"p50_ms", "p95_ms", "p99_ms"}
    assert 0 < out["p50_ms"] <= out["p95_ms"] <= out["p99_ms"]


# -- the learned evaluators --------------------------------------------------


def test_ml_evaluator_matches_jax_in_f32(mlp):
    stats, jax_stats = ServingStats(), JaxServingStats()
    port = MLEvaluator(port_scorer(mlp, torch.float32), stats=stats,
                       track_quality=True)
    ref = jax_scorer.MLEvaluator(jax_parent_scorer(mlp, jnp.float32),
                                 stats=jax_stats, track_quality=True)
    for parents, child, total in seeded_decisions(8, 60):
        assert ids(port.evaluate_parents(parents, child, total)) == ids(
            ref.evaluate_parents(parents, child, total))
        assert [port.is_bad_node(p) for p in parents] == [
            ref.is_bad_node(p) for p in parents]
    assert list(port.quality_samples) == list(ref.quality_samples)
    assert port.scored_count == ref.scored_count == 60
    assert stats.snapshot() == jax_stats.snapshot()
    assert port.evaluate_parents([], FakePeer(), 0) == []


@pytest.mark.parametrize("poison", ["nan", "zero"])
def test_ml_evaluator_guard_matches_jax(mlp, poison):
    params = (nan_params(mlp["params"]) if poison == "nan" else
              jax.tree_util.tree_map(np.zeros_like, mlp["params"]))
    fired, jax_fired = [], []
    stats, jax_stats = ServingStats(), JaxServingStats()
    port = MLEvaluator(port_scorer(mlp, torch.float32, params), stats=stats,
                       on_quarantine=fired.append, track_quality=True)
    ref = jax_scorer.MLEvaluator(
        jax_parent_scorer(mlp, jnp.float32, params), stats=jax_stats,
        on_quarantine=jax_fired.append, track_quality=True)
    rule = BaseEvaluator()
    for parents, child, total in seeded_decisions(9, 12):
        got = port.evaluate_parents(parents, child, total)
        assert ids(got) == ids(ref.evaluate_parents(parents, child, total))
        assert ids(got) == ids(rule.evaluate_parents(parents, child, total))
    assert port.guard_trips == ref.guard_trips == 12
    assert fired == jax_fired and len(fired) == 1
    assert (port.fallback_count, port.scored_count) == (
        ref.fallback_count, ref.scored_count) == (12, 0)
    assert list(port.quality_samples) == list(ref.quality_samples)
    assert stats.snapshot() == jax_stats.snapshot()
    port.reset_guard()
    assert port.guard_trips == 0


def test_ml_evaluator_latches_only_on_delivery(mlp):
    """A hook that returns False or raises leaves the latch unarmed: the
    next trip retries, as the JAX evaluator does."""
    def make_hook(seen):
        answers = iter([False, RuntimeError("manager down"), True])

        def hook(reason):
            seen.append(reason)
            answer = next(answers)
            if isinstance(answer, Exception):
                raise answer
            return answer
        return hook

    port_calls, jax_calls = [], []
    port = MLEvaluator(
        port_scorer(mlp, torch.float32, nan_params(mlp["params"])),
        stats=ServingStats(), on_quarantine=make_hook(port_calls))
    ref = jax_scorer.MLEvaluator(
        jax_parent_scorer(mlp, jnp.float32, nan_params(mlp["params"])),
        stats=JaxServingStats(), on_quarantine=make_hook(jax_calls))
    for parents, child, total in seeded_decisions(10, 8):
        port.evaluate_parents(parents, child, total)
        ref.evaluate_parents(parents, child, total)
    # Trips 3, 4 and 5 escalate (False, raise, delivered); later ones not.
    assert len(port_calls) == len(jax_calls) == 3


def test_ml_evaluator_concurrent_trips_quarantine_once(mlp):
    scorer = port_scorer(mlp, torch.float32, nan_params(mlp["params"]))
    fired, stats = [], ServingStats()
    gate = threading.Event()

    def hook(reason):
        gate.wait(0.05)           # an RPC's latency: others trip meanwhile
        fired.append(reason)

    ev = MLEvaluator(scorer, stats=stats, on_quarantine=hook)
    decisions = seeded_decisions(11, 6)
    errors = []

    def work():
        try:
            for _ in range(5):
                for parents, child, total in decisions:
                    ev.evaluate_parents(parents, child, total)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(fired) == 1
    assert ev.guard_trips == stats.get("ml_guard_trips") == 8 * 5 * 6
    assert stats.get("ml_quarantines_reported") == 1


def cost_scorers(mlp, params=None, target=None):
    target = target or JaxNormalizer(np.array([0.05], np.float32),
                                     np.array([0.3], np.float32))
    typical = float(np.expm1(float(target.mean[0])))
    port = CostScorer(port_scorer(mlp, torch.float32, params, target),
                      version="v1", typical_cost_s=typical)
    ref = jax_scorer.CostScorer(
        jax_parent_scorer(mlp, jnp.float32, params, target), version="v1",
        typical_cost_s=typical)
    return port, ref


def test_cost_scorer_predictions_and_clipping(mlp):
    port, ref = cost_scorers(mlp)
    x = mlp["x"][:64]
    np.testing.assert_allclose(port.predict_cost_s(x), ref.predict_cost_s(x),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(port.score_corpus(x), ref.score_corpus(x),
                               rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_array_equal(port.score_corpus(x),
                                  -port._scorer.score_corpus(x))
    np.testing.assert_array_equal(port.score(x), -port._scorer.score(x))
    # A target normalizer far out of range: predictions clip at
    # expm1(±20) instead of overflowing; NaN weights pass NaN through.
    for mean in (100.0, -100.0):
        far = JaxNormalizer(np.array([mean], np.float32),
                            np.array([1.0], np.float32))
        port, ref = cost_scorers(mlp, target=far)
        got = port.predict_cost_s(x)
        np.testing.assert_array_equal(got, np.expm1(np.float32(
            20.0 if mean > 0 else -20.0)) * np.ones_like(got))
        np.testing.assert_array_equal(got, ref.predict_cost_s(x))
    port, ref = cost_scorers(mlp, nan_params(mlp["params"]))
    assert np.isnan(port.predict_cost_s(x)).all()
    assert np.isnan(ref.predict_cost_s(x)).all()


@pytest.mark.parametrize("with_stats", [False, True])
def test_learned_cost_evaluator_matches_jax_in_f32(mlp, with_stats):
    port_cs, ref_cs = cost_scorers(mlp)
    stats, jax_stats = (controlstats.ControlPlaneStats(),
                        jax_controlstats.ControlPlaneStats())
    port = LearnedCostEvaluator(port_cs, stats=stats)
    ref = jax_scorer.LearnedCostEvaluator(ref_cs, stats=jax_stats)
    decisions = seeded_decisions(12, 40, with_stats=with_stats)
    for parents, child, total in decisions:
        assert ids(port.evaluate_parents(parents, child, total)) == ids(
            ref.evaluate_parents(parents, child, total))
        for _ in range(2):                      # a miss, then a cache hit
            assert [port.is_bad_node(p) for p in parents] == [
                ref.is_bad_node(p) for p in parents]
    assert port.scored_count == ref.scored_count == 40
    assert port_cs.version == ref_cs.version == "v1"
    snap = stats.snapshot()
    assert snap == jax_stats.snapshot()
    assert snap["bad_node_learned_bad"] > 0
    assert snap["bad_node_learned"] > snap["bad_node_learned_bad"]


def test_learned_cost_evaluator_guard_matches_jax(mlp):
    port_cs, ref_cs = cost_scorers(mlp, nan_params(mlp["params"]))
    stats, jax_stats = (controlstats.ControlPlaneStats(),
                        jax_controlstats.ControlPlaneStats())
    port = LearnedCostEvaluator(port_cs, stats=stats)
    ref = jax_scorer.LearnedCostEvaluator(ref_cs, stats=jax_stats)
    rule = BaseEvaluator()
    for parents, child, total in seeded_decisions(13, 10):
        got = port.evaluate_parents(parents, child, total)
        assert ids(got) == ids(ref.evaluate_parents(parents, child, total))
        assert ids(got) == ids(rule.evaluate_parents(parents, child, total))
        verdicts = [port.is_bad_node(p) for p in parents]
        assert verdicts == [ref.is_bad_node(p) for p in parents]
        assert verdicts == [rule.is_bad_node(p) for p in parents]
    assert port.guard_trips == ref.guard_trips > 10
    assert port.fallback_count == ref.fallback_count == 10
    snap = stats.snapshot()
    assert snap == jax_stats.snapshot()
    assert snap["cost_guard_trips"] == port.guard_trips


# -- the factory ---------------------------------------------------------------


def test_new_evaluator_every_algorithm(mlp, monkeypatch):
    scorer = port_scorer(mlp, torch.float32)
    port_cs, _ = cost_scorers(mlp)
    assert type(new_evaluator()) is BaseEvaluator
    assert type(new_evaluator("unknown")) is BaseEvaluator
    ml = new_evaluator("ml", scorer=scorer, guard_trip_limit=7)
    assert isinstance(ml, MLEvaluator) and ml.has_model
    assert ml.guard_trip_limit == 7
    assert not new_evaluator("ml").has_model
    cost = new_evaluator("cost", scorer=port_cs, bad_cost_ratio=5.0)
    assert isinstance(cost, LearnedCostEvaluator)
    assert cost.bad_cost_ratio == 5.0
    for make in (new_evaluator, jax_new_evaluator):
        with pytest.raises(ValueError, match="CostScorer"):
            make("cost")
    with pytest.raises(NotImplementedError, match="transport slice"):
        new_evaluator("ml", scorer=scorer, sidecar_target="localhost:1")
    batched = new_evaluator("ml", scorer=scorer, micro_batch=True,
                            batch_lanes=2, batch_queue_depth=4)
    assert isinstance(batched, MLEvaluator)
    assert isinstance(batched._scorer, MicroBatcher)
    assert (batched._scorer.lanes, batched._scorer.queue_depth) == (2, 4)
    batched.close()

    import importlib.metadata as metadata

    class EntryPoint:
        def load(self):
            return BaseEvaluator

    groups = []

    def entry_points(group):
        groups.append(group)
        return [EntryPoint()] if group == PLUGIN_GROUP else []

    monkeypatch.setattr(metadata, "entry_points", entry_points)
    assert type(new_evaluator("plugin")) is BaseEvaluator
    assert groups == ["dragonfly2_tpu_torch.evaluator"]
    monkeypatch.setattr(metadata, "entry_points", lambda group: [])
    for make in (new_evaluator, jax_new_evaluator):
        with pytest.raises(ValueError, match="no evaluator plugin"):
            make("plugin")
