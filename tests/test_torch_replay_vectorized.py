"""Port parity for the vectorized replay engine
(``scheduler/replay.py``: ``replay_decisions_vectorized``,
``_corpus_scores``, ``_replay_chunk``, ``bad_node_labels_batch``,
``rule_bad_node_verdicts``, ``score_run_vectorized``) against the port's
sequential harness and the JAX package, on the CPU.

Tolerances: the rule evaluator's digests, orders, labels, verdicts and
metrics equal JAX's and the sequential harness's exactly. The ``ml`` and
``cost`` evaluators run one MLP's params in f32 in both packages: the
port's vectorized digest, orders and counters equal its sequential
harness's exactly (the scorer's forward is row-stable), and its orders
equal JAX's except between candidates whose scores are within
ORDER_TOL (the f32 parity tolerance of tests/test_torch_evaluator.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.inference import scorer as jax_scorer
from dragonfly2_tpu.models.mlp import MLPBandwidthPredictor as JaxMLP
from dragonfly2_tpu.models.mlp import Normalizer as JaxNormalizer
from dragonfly2_tpu.scheduler import replay as jax_replay
from dragonfly2_tpu.scheduler import replaybench as jax_bench
from dragonfly2_tpu.scheduler import replaystore as jax_store
from dragonfly2_tpu.scheduler.controlstats import ControlPlaneStats
from dragonfly2_tpu.scheduler.evaluator import BaseEvaluator as JaxRule
from dragonfly2_tpu.scheduler.loadbench import run_swarm_bench
from dragonfly2_tpu.scheduler.replaylog import ReplayRecorder
from dragonfly2_tpu.utils.servingstats import ServingStats as JaxServingStats
from dragonfly2_tpu_torch import schema
from dragonfly2_tpu_torch.inference.scorer import (
    CostScorer,
    LearnedCostEvaluator,
    MLEvaluator,
    ParentScorer,
)
from dragonfly2_tpu_torch.models.mlp import MLPBandwidthPredictor, Normalizer
from dragonfly2_tpu_torch.scheduler import controlstats, replay, replaystore
from dragonfly2_tpu_torch.scheduler.evaluator import BaseEvaluator
from dragonfly2_tpu_torch.scheduler.replaybench import synth_replay_corpus
from dragonfly2_tpu_torch.schema import MAX_REPLAY_CANDIDATES
from dragonfly2_tpu_torch.train.checkpoint import mlp_state_dict_from_flax
from dragonfly2_tpu_torch.utils.servingstats import ServingStats

ORDER_TOL = 1e-4
HIDDEN = (32, 16)


def to_port(event):
    """A JAX ``ReplayDecision`` as the port's record, field for field."""
    fields = dataclasses.asdict(event)
    candidates = [schema.ReplayCandidate(**{
        **c, "features": schema.ReplayFeatureRow(**c["features"])})
        for c in fields.pop("candidates")]
    return schema.ReplayDecision(**fields, candidates=candidates)


@pytest.fixture(scope="module")
def recorded():
    """A corpus the JAX recorder captures from its in-process swarm
    (tests/test_replay.py's recipe): (JAX events, the port's copies)."""
    recorder = ReplayRecorder(None, stats=ControlPlaneStats())
    run_swarm_bench(150, workers=4, recorder=recorder,
                    cost_profile="profiled", profile_seed=3)
    recorder.finalize_all()
    events = jax_replay.corpus_from_events(recorder.events())
    recorder.close()
    return events, [to_port(e) for e in events]


def both_columnar(port_events, jax_events):
    return (replay.as_columnar(port_events),
            jax_replay.as_columnar(jax_events))


# -- the rule evaluator -------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 3])
def test_rule_recorded_corpus_equals_jax_and_sequential(recorded, shards):
    jax_events, port_events = recorded
    cc, jc = both_columnar(port_events, jax_events)
    seq = replay.replay_decisions(port_events, BaseEvaluator(), seed=0)
    vec = replay.replay_decisions_vectorized(cc, seed=0, shards=shards)
    ref = jax_replay.replay_decisions_vectorized(jc, seed=0, shards=shards)
    assert seq.digest == vec.digest == ref.digest
    assert seq.decisions == vec.decisions == ref.decisions
    assert seq.full_order == vec.full_order == ref.full_order
    assert vec.shards == ref.shards == shards
    assert [(s["start"], s["stop"]) for s in vec.shard_stats] == \
        [(s["start"], s["stop"]) for s in ref.shard_stats]
    assert sum(s["decisions"] for s in vec.shard_stats) == cc.n > 100


@pytest.mark.parametrize("variant", ["k1", "kmax"])
def test_bucket_edges_equal_jax_and_sequential(recorded, variant):
    """Every decision cut to ONE candidate (the most padding) and every
    decision widened to MAX_REPLAY_CANDIDATES with feature-tied clones
    (no padding)."""
    _, port_events = recorded
    events = [e for e in port_events if e.candidates]
    if variant == "k1":
        events = [dataclasses.replace(e, candidates=list(e.candidates[:1]))
                  for e in events]
        want_k = replaystore.bucket_candidates(1)
    else:
        events = [dataclasses.replace(e, candidates=list(e.candidates) + [
            dataclasses.replace(e.candidates[0],
                                id=f"{e.candidates[0].id}~dup{j}", rank=-1)
            for j in range(MAX_REPLAY_CANDIDATES - len(e.candidates))])
            for e in events]
        want_k = replaystore.bucket_candidates(MAX_REPLAY_CANDIDATES)
    cc = replay.as_columnar(events)
    assert cc.k == want_k
    seq = replay.replay_decisions(events, BaseEvaluator())
    vec = replay.replay_decisions_vectorized(cc)
    ref = jax_replay.replay_decisions_vectorized(
        jax_store.ColumnarCorpus(cc.columns()))
    assert seq.digest == vec.digest == ref.digest
    assert seq.full_order == vec.full_order


def test_ties_resolved_in_candidate_order():
    """Every candidate of a decision tied on its features: both engines
    order the tie by slot, as the sequential stable argsort does."""
    cc = synth_replay_corpus(300, seed=7)
    cols = cc.columns()
    cols["features"] = np.ascontiguousarray(
        np.broadcast_to(cc.features[:, :1, :], cc.features.shape)
        * cc.valid[..., None], dtype=np.float32)
    tied = replaystore.ColumnarCorpus(cols)
    seq = replay.replay_decisions(tied.decisions(), BaseEvaluator())
    vec = replay.replay_decisions_vectorized(tied)
    ref = jax_replay.replay_decisions_vectorized(
        jax_store.ColumnarCorpus(tied.columns()))
    assert seq.digest == vec.digest == ref.digest
    assert seq.full_order == vec.full_order
    for i in range(tied.n):
        nc = int(tied.n_candidates[i])
        order = vec.full_order.get(int(tied.seq[i]))
        if nc and order is not None:
            assert order == tuple(tied.cand_id[i, :nc].tolist())


@pytest.mark.parametrize("n,seed,limit", [(2000, 0, 4), (1500, 3, 1),
                                          (997, 11, 16), (1, 2, 4),
                                          (0, 0, 4)])
def test_rule_synthetic_corpus_equals_jax(n, seed, limit):
    cc = synth_replay_corpus(n, seed=seed)
    vec = replay.replay_decisions_vectorized(cc, candidate_limit=limit,
                                             shards=2, name="rule")
    ref = jax_replay.replay_decisions_vectorized(
        jax_bench.synth_replay_corpus(n, seed=seed), candidate_limit=limit,
        shards=2, name="rule")
    seq = replay.replay_decisions(cc.decisions(), BaseEvaluator(),
                                  candidate_limit=limit)
    assert vec.digest == ref.digest == seq.digest
    assert vec.decisions == ref.decisions
    assert (vec.evaluator, vec.shards) == (ref.evaluator, ref.shards)


# -- labels, verdicts and metrics ---------------------------------------------


def test_bad_node_labels_batch_equal_jax_and_per_event(recorded):
    jax_events, port_events = recorded
    cc, jc = both_columnar(port_events, jax_events)
    labels, has_label = replay.bad_node_labels_batch(cc)
    want = jax_replay.bad_node_labels_batch(jc)
    np.testing.assert_array_equal(labels, want[0])
    np.testing.assert_array_equal(has_label, want[1])
    for i, event in enumerate(port_events):
        per_event = replay.bad_node_labels(event)
        by_id = {str(cc.cand_id[i, j]): (bool(labels[i, j]),
                                         bool(has_label[i, j]))
                 for j in range(int(cc.n_candidates[i]))}
        for cand_id, is_bad in per_event.items():
            assert by_id[cand_id] == (is_bad, True)
        assert sum(has for _, has in by_id.values()) == len(per_event)
    empty = replay.bad_node_labels_batch(replay.as_columnar([]))
    assert [a.shape for a in empty] == [(0, 8), (0, 8)]


def test_rule_bad_node_verdicts_equal_jax_and_evaluator(recorded):
    jax_events, port_events = recorded
    cc, jc = both_columnar(port_events, jax_events)
    synth = synth_replay_corpus(800, seed=4)
    for got, want in ((cc, jc), (synth, jax_bench.synth_replay_corpus(
            800, seed=4))):
        np.testing.assert_array_equal(replay.rule_bad_node_verdicts(got),
                                      jax_replay.rule_bad_node_verdicts(want))
    rule = BaseEvaluator()
    verdicts = replay.rule_bad_node_verdicts(synth)
    for i, event in enumerate(synth.decisions()):
        if event.candidates:
            _, parents = replay.rebuild_decision(event)
            assert [rule.is_bad_node(p) for p in parents] == \
                verdicts[i, :len(parents)].tolist()
    assert verdicts.any()


@pytest.mark.parametrize("corpus", ["recorded", "synthetic"])
def test_score_run_vectorized_equals_jax_and_sequential(recorded, corpus):
    if corpus == "recorded":
        jax_events, port_events = recorded
    else:
        port_events = synth_replay_corpus(1200, seed=9).to_events()
        jax_events = list(jax_bench.synth_replay_corpus(
            1200, seed=9).decisions())
    cc, jc = both_columnar(port_events, jax_events)
    evaluator = BaseEvaluator()
    run = replay.replay_decisions(port_events, evaluator, name="rule")
    ref = jax_replay.replay_decisions(jax_events, JaxRule(), name="rule")
    ref.latencies_ms = list(run.latencies_ms)
    seq_scored = replay.score_run(port_events, run, evaluator=evaluator)
    vec_scored = replay.score_run_vectorized(
        cc, run, bad_node_verdicts=replay.rule_bad_node_verdicts(cc))
    want = jax_replay.score_run_vectorized(
        jc, ref, bad_node_verdicts=jax_replay.rule_bad_node_verdicts(jc))
    assert vec_scored == seq_scored == want
    assert vec_scored["regret_scored"] > 50
    assert vec_scored["bad_node_labeled"] > 0
    bare = replay.score_run_vectorized(port_events, run)
    assert bare == replay.score_run(port_events, run) and \
        "bad_node_tp" not in bare


# -- the learned evaluators ---------------------------------------------------


@pytest.fixture(scope="module")
def mlp():
    """One flax MLP init and the normalizers, shared by both packages."""
    x = synth_replay_corpus(500, seed=21).features.reshape(-1, 11)
    norm = JaxNormalizer.fit(x)
    params = jax.device_get(JaxMLP(hidden=HIDDEN).init(
        jax.random.key(3), jnp.zeros((1, 11))))
    target = JaxNormalizer(np.array([0.05], np.float32),
                           np.array([0.3], np.float32))
    return dict(params=params, norm=norm, target=target)


def nan_params(params):
    return jax.tree_util.tree_map(lambda a: np.full_like(a, np.nan), params)


def zero_params(params):
    return jax.tree_util.tree_map(np.zeros_like, params)


def port_scorer(mlp, params=None) -> ParentScorer:
    model = MLPBandwidthPredictor(hidden=HIDDEN, dtype=torch.float32)
    model.load_state_dict(mlp_state_dict_from_flax(
        mlp["params"] if params is None else params))
    norm, tgt = mlp["norm"], mlp["target"]
    return ParentScorer(model, Normalizer(norm.mean, norm.std),
                        Normalizer(tgt.mean, tgt.std), device="cpu")


def jax_parent_scorer(mlp, params=None):
    return jax_scorer.ParentScorer(
        JaxMLP(hidden=HIDDEN, dtype=jnp.float32),
        mlp["params"] if params is None else params, mlp["norm"],
        mlp["target"])


def typical(mlp) -> float:
    return float(np.expm1(float(mlp["target"].mean[0])))


def make_port(kind: str, mlp, params=None):
    if kind == "ml":
        return MLEvaluator(port_scorer(mlp, params), stats=ServingStats())
    return LearnedCostEvaluator(
        CostScorer(port_scorer(mlp, params), version="v1",
                   typical_cost_s=typical(mlp)),
        stats=controlstats.ControlPlaneStats())


def make_jax(kind: str, mlp, params=None):
    if kind == "ml":
        return jax_scorer.MLEvaluator(jax_parent_scorer(mlp, params),
                                      stats=JaxServingStats())
    return jax_scorer.LearnedCostEvaluator(
        jax_scorer.CostScorer(jax_parent_scorer(mlp, params), version="v1",
                              typical_cost_s=typical(mlp)),
        stats=ControlPlaneStats())


def counters(evaluator) -> tuple:
    return (evaluator.scored_count, evaluator.fallback_count,
            evaluator.guard_trips)


@pytest.fixture(scope="module")
def learned_corpus():
    return synth_replay_corpus(1500, seed=17)


@pytest.mark.parametrize("kind", ["ml", "cost"])
@pytest.mark.parametrize("shards", [1, 3])
def test_learned_vectorized_equals_sequential(mlp, learned_corpus, kind,
                                              shards):
    cc = learned_corpus
    e_seq, e_vec = make_port(kind, mlp), make_port(kind, mlp)
    seq = replay.replay_decisions(cc.decisions(), e_seq, name=kind)
    vec = replay.replay_decisions_vectorized(cc, e_vec, name=kind,
                                             shards=shards)
    assert seq.digest == vec.digest
    assert seq.full_order == vec.full_order
    assert counters(e_vec) == counters(e_seq)
    assert e_seq.scored_count == int((cc.n_candidates > 0).sum()) > 1000
    rule = replay.replay_decisions_vectorized(cc)
    assert vec.digest != rule.digest


def _swapped_gaps(order_a, order_b, scores: dict) -> float:
    """The largest score gap between two candidates that ``order_a`` and
    ``order_b`` put in opposite orders (0.0 when the orders agree)."""
    if order_a == order_b:
        return 0.0
    pos = {cid: i for i, cid in enumerate(order_a)}
    worst = 0.0
    for i, a in enumerate(order_b):
        for b in order_b[i + 1:]:
            if pos[a] > pos[b]:
                worst = max(worst, abs(scores[a] - scores[b]))
    return worst


@pytest.mark.parametrize("kind", ["ml", "cost"])
def test_learned_orders_match_jax_beyond_tolerance(mlp, learned_corpus,
                                                   kind):
    cc = learned_corpus
    got = replay.replay_decisions_vectorized(cc, make_port(kind, mlp))
    want = jax_replay.replay_decisions_vectorized(
        jax_store.ColumnarCorpus(cc.columns()), make_jax(kind, mlp))
    scores = make_port(kind, mlp)._scorer.score_corpus(cc.features[cc.valid])
    by_id = dict(zip(cc.cand_id[cc.valid].tolist(), scores.tolist()))
    assert got.full_order.keys() == want.full_order.keys()
    worst = max(_swapped_gaps(got.full_order[s], want.full_order[s], by_id)
                for s in got.full_order)
    assert worst < ORDER_TOL
    identical = sum(got.full_order[s] == want.full_order[s]
                    for s in got.full_order)
    assert identical >= 0.99 * len(got.full_order)


@pytest.mark.parametrize("kind", ["ml", "cost"])
@pytest.mark.parametrize("poison", ["nan", "zero"])
def test_guard_trips_equal_sequential_and_jax(mlp, kind, poison):
    """A poisoned model trips the guard on every decision with candidates
    (NaN), or on every decision of 4+ non-identical candidates (zero:
    constant scores): those decisions are the rule evaluator's, and the
    counters equal the sequential harness's and JAX's."""
    cc = synth_replay_corpus(400, seed=23)
    params = (nan_params if poison == "nan" else zero_params)(mlp["params"])
    e_seq, e_vec = make_port(kind, mlp, params), make_port(kind, mlp, params)
    e_jax = make_jax(kind, mlp, params)
    seq = replay.replay_decisions(cc.decisions(), e_seq)
    vec = replay.replay_decisions_vectorized(cc, e_vec, shards=2)
    ref = jax_replay.replay_decisions_vectorized(
        jax_store.ColumnarCorpus(cc.columns()), e_jax)
    assert seq.digest == vec.digest == ref.digest
    assert counters(e_vec) == counters(e_seq) == counters(e_jax)
    parents = int((cc.n_candidates > 0).sum())
    if poison == "nan":
        assert vec.digest == replay.replay_decisions_vectorized(cc).digest
        assert e_vec.fallback_count == e_vec.guard_trips == parents
    else:
        assert 0 < e_vec.guard_trips < parents
        assert e_vec.guard_trips == int((cc.n_candidates >= 4).sum())
    if kind == "ml":
        assert e_vec._stats.get("ml_guard_trips") == e_vec.guard_trips
    else:
        assert e_vec._stats.cost_guard_trips == e_vec.guard_trips


def test_ml_evaluator_without_a_model_replays_the_rule():
    cc = synth_replay_corpus(300, seed=1)
    got = replay.replay_decisions_vectorized(cc, MLEvaluator(None))
    assert got.digest == replay.replay_decisions_vectorized(cc).digest


def test_unsupported_evaluators_raise_type_error(mlp):
    cc = synth_replay_corpus(20, seed=2)

    class Weird:
        def evaluate_parents(self, parents, child, total):
            return parents

    class Facade:  # a serving-path wrapper: no score_corpus
        def score(self, features):
            return np.zeros(len(features), np.float32)

    custom_inner = LearnedCostEvaluator(
        CostScorer(port_scorer(mlp), typical_cost_s=typical(mlp)),
        inner=MLEvaluator(None))
    for evaluator in (Weird(), MLEvaluator(Facade()), custom_inner):
        with pytest.raises(TypeError):
            replay.replay_decisions_vectorized(cc, evaluator)
        with pytest.raises(TypeError):
            jax_replay.replay_decisions_vectorized(
                jax_store.ColumnarCorpus(cc.columns()), evaluator)


def test_learned_score_run_vectorized_equals_sequential(mlp,
                                                        learned_corpus):
    cc = learned_corpus.slice(0, 600)
    events = cc.to_events()
    for kind in ("ml", "cost"):
        evaluator = make_port(kind, mlp)
        run = replay.replay_decisions(events, evaluator, name=kind)
        verdicts = (replay.rule_bad_node_verdicts(cc) if kind == "ml"
                    else None)
        want = replay.score_run(events, run,
                                evaluator=evaluator if kind == "ml" else None)
        assert replay.score_run_vectorized(
            cc, run, bad_node_verdicts=verdicts) == want
