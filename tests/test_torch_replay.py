"""Port parity for the replay corpus and the sequential replay harness:
``scheduler/replaystore.py``'s in-memory half, ``scheduler/replay.py``'s
rebuild and A/B scoring, and the federated bench's corpus generators,
against the JAX package, on the CPU.

Tolerances: columns, rebuilt feature matrices and the rule evaluator's
run digests and metrics equal; with one MLP's params in both packages
(bf16 scorers on both sides) the replay regret within REGRET_RTOL
relative and the rank agreement within AGREEMENT_ATOL.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from dragonfly2_tpu.inference.scorer import MLEvaluator as JaxMLEvaluator
from dragonfly2_tpu.inference.scorer import ParentScorer as JaxParentScorer
from dragonfly2_tpu.models.mlp import MLPBandwidthPredictor as JaxMLP
from dragonfly2_tpu.models.mlp import Normalizer as JaxNormalizer
from dragonfly2_tpu.scheduler import replay as jax_replay
from dragonfly2_tpu.scheduler import replaystore as jax_store
from dragonfly2_tpu.scheduler.controlstats import ControlPlaneStats
from dragonfly2_tpu.scheduler.evaluator import BaseEvaluator as JaxRule
from dragonfly2_tpu.scheduler.loadbench import run_swarm_bench
from dragonfly2_tpu.scheduler.replaylog import ReplayRecorder
from dragonfly2_tpu.train import fedbench as jax_fedbench
from dragonfly2_tpu.train import federated as jax_federated
from dragonfly2_tpu_torch import schema
from dragonfly2_tpu_torch.inference.scorer import MLEvaluator, ParentScorer
from dragonfly2_tpu_torch.scheduler import replay, replaystore
from dragonfly2_tpu_torch.scheduler.evaluator import BaseEvaluator
from dragonfly2_tpu_torch.scheduler.evaluator.base import build_feature_matrix
from dragonfly2_tpu_torch.train import fedbench, federated
from dragonfly2_tpu_torch.train.mlp_trainer import MLPTrainConfig, train_mlp

REGRET_RTOL = 0.05
AGREEMENT_ATOL = 0.05


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's fits while this module runs:
    the MLPs are small, and beside other test workers torch's default
    pool oversubscribes the cores (a bench run took 20 × longer)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


@pytest.fixture(scope="module")
def eval_corpora():
    """The federated bench's mixed-band eval corpus in both packages."""
    return (jax_fedbench.synth_federated_corpus(400, seed=7919, band=None),
            fedbench.synth_federated_corpus(400, seed=7919, band=None))


def assert_columns_equal(got: dict, want: dict):
    assert set(got) == set(want) == set(replaystore.ALL_COLUMNS)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


# -- corpora -------------------------------------------------------------------


@pytest.mark.parametrize("seed,band,n", [(0, None, 300), (0, 0, 300),
                                         (1, 1, 120), (4, 2, 57),
                                         (7919, None, 400), (2, None, 0)])
def test_synth_federated_corpus_equal(seed, band, n):
    got = fedbench.synth_federated_corpus(n, seed=seed, band=band)
    want = jax_fedbench.synth_federated_corpus(n, seed=seed, band=band)
    assert_columns_equal(got.columns(), want.columns())
    assert (got.n, got.k) == (want.n, want.k)


@pytest.mark.parametrize("scale", [10.0, 0.5])
def test_cluster_corpora_flip_and_datasets_equal(scale):
    got = fedbench.synth_cluster_corpora(3, 200, seed=5)
    want = jax_fedbench.synth_cluster_corpora(3, 200, seed=5)
    assert sorted(got) == sorted(want) == [1, 2, 3]
    for sid in want:
        assert_columns_equal(got[sid].columns(), want[sid].columns())
    assert_columns_equal(
        fedbench.flip_realized_costs(got[2], scale).columns(),
        jax_fedbench.flip_realized_costs(want[2], scale).columns())
    for a, b in zip(federated.cluster_datasets_from_corpora(got),
                    jax_federated.cluster_datasets_from_corpora(want)):
        assert a.scheduler_id == b.scheduler_id
        np.testing.assert_array_equal(a.X, b.X)
        np.testing.assert_array_equal(a.y, b.y)


def test_from_events_round_trips():
    corpus = fedbench.synth_federated_corpus(200, seed=3, band=None)
    events = list(corpus.decisions())
    assert all(isinstance(e, schema.ReplayDecision) for e in events)
    packed = replaystore.ColumnarCorpus.from_events(events)
    for name, want in corpus.columns().items():
        np.testing.assert_array_equal(packed.columns()[name], want,
                                      err_msg=name)
    ref = jax_store.ColumnarCorpus.from_events(
        jax_fedbench.synth_federated_corpus(200, seed=3).decisions())
    assert_columns_equal(
        replaystore.ColumnarCorpus.from_events(
            fedbench.synth_federated_corpus(200, seed=3).decisions()
        ).columns(), ref.columns())
    view = packed.slice(50, 60)
    assert len(view) == 10 and view.decision(0) == events[50]
    assert packed.to_events() == events


def test_pack_recorded_corpus_equal(recorded):
    jax_events, port_events = recorded
    assert_columns_equal(
        replaystore.ColumnarCorpus.from_events(port_events).columns(),
        jax_store.ColumnarCorpus.from_events(jax_events).columns())


def test_pack_refuses_bad_events():
    good = schema.ReplayDecision(seq=1, verdict="parents")
    for bad in (dataclasses.replace(good, version=2),
                dataclasses.replace(good, verdict="maybe"),
                dataclasses.replace(good, candidates=[
                    schema.ReplayCandidate()] * 17)):
        with pytest.raises(replaystore.ReplayStoreError):
            replaystore.pack_columns([bad])
    with pytest.raises(replaystore.ReplayStoreError):
        replaystore.ColumnarCorpus({"seq": np.zeros(0)})


def test_concat_corpora_equal(recorded):
    jax_events, port_events = recorded
    parts = (port_events[:40], fedbench.synth_federated_corpus(30, seed=1))
    got = replaystore.concat_corpora(
        [replaystore.ColumnarCorpus.from_events(parts[0]), parts[1]])
    want = jax_store.concat_corpora(
        [jax_store.ColumnarCorpus.from_events(jax_events[:40]),
         jax_fedbench.synth_federated_corpus(30, seed=1)])
    assert got.k == want.k == 16
    assert_columns_equal(got.columns(), want.columns())
    assert replaystore.concat_corpora([]).n == 0


@pytest.mark.parametrize("n", [0, 7, 8, 9, 16])
def test_bucket_candidates_equal(n):
    assert replaystore.bucket_candidates(n) == jax_store.bucket_candidates(n)


# -- the harness ---------------------------------------------------------------


def test_rebuilt_feature_matrices_are_the_recorded_ones(recorded,
                                                        eval_corpora):
    """``build_feature_matrix(rebuild_decision(event))`` reproduces every
    recorded matrix exactly (the determinism contract's premise)."""
    events = recorded[1] + list(eval_corpora[1].decisions())
    checked = 0
    for event in events:
        if not event.candidates:
            continue
        child, parents = replay.rebuild_decision(event)
        got = build_feature_matrix(parents, child, event.total_piece_count)
        want = np.stack([replay._row_array(c) for c in event.candidates])
        np.testing.assert_array_equal(got, want)
        checked += 1
    assert checked > 400


def test_labels_and_realized_costs_equal(recorded):
    jax_events, port_events = recorded
    for a, b in zip(port_events, jax_events):
        assert replay.realized_costs(a) == jax_replay.realized_costs(b)
        assert replay.bad_node_labels(a) == jax_replay.bad_node_labels(b)


def test_corpus_from_events_orders_and_checks_versions():
    events = [schema.ReplayDecision(seq=s, verdict="parents") for s in (3, 1)]
    assert [e.seq for e in replay.corpus_from_events(events)] == [1, 3]
    with pytest.raises(ValueError):
        replay.corpus_from_events([dataclasses.replace(events[0],
                                                       version=99)])


def _strip_latency(scored: dict) -> dict:
    return {k: v for k, v in scored.items()
            if not k.startswith("decision_latency")}


@pytest.mark.parametrize("corpus", ["recorded", "eval"])
def test_replay_ab_rule_matches_jax(recorded, eval_corpora, corpus):
    """The rule evaluator through both harnesses: the same run digests,
    decisions and metrics, bad-node counts included."""
    if corpus == "recorded":
        jax_events, port_events = recorded
    else:
        jax_events = list(eval_corpora[0].decisions())
        port_events = list(eval_corpora[1].decisions())
    got = replay.replay_ab(port_events, {"rule": BaseEvaluator(),
                                         "again": BaseEvaluator()}, seed=3)
    want = jax_replay.replay_ab(jax_events, {"rule": JaxRule(),
                                             "again": JaxRule()}, seed=3)
    assert got["deterministic"] and want["deterministic"]
    assert set(got["evaluators"]) == {"rule", "again"}
    for name in ("rule", "again"):
        assert _strip_latency(got["evaluators"][name]) == \
            _strip_latency(want["evaluators"][name])
    assert got["evaluators"]["rule"]["regret_scored"] > 50
    run = replay.replay_decisions(port_events, BaseEvaluator(), seed=3)
    ref = jax_replay.replay_decisions(jax_events, JaxRule(), seed=3)
    assert run.decisions == ref.decisions and run.digest == ref.digest
    assert _strip_latency(replay.score_run(port_events, run)) == \
        _strip_latency(jax_replay.score_run(jax_events, ref))


def test_back_to_source_decisions_replay_equal():
    def events(module):
        cand = module.ReplayCandidate(id="p", realized_n=2, realized_cost=0.1)
        return [module.ReplayDecision(seq=2, verdict="back_to_source"),
                module.ReplayDecision(seq=1, verdict="parents",
                                      candidates=[cand])]

    from dragonfly2_tpu import schema as jax_schema

    got = replay.replay_decisions(replay.corpus_from_events(events(schema)),
                                  BaseEvaluator())
    want = jax_replay.replay_decisions(
        jax_replay.corpus_from_events(events(jax_schema)), JaxRule())
    assert got.decisions == want.decisions
    assert got.decisions[1] == (2, "back_to_source", ())
    assert got.digest == want.digest


@pytest.fixture(scope="module")
def mlp_evaluators():
    """One MLP, trained by the port on the three bands' pooled examples,
    behind each package's bf16 ParentScorer and MLEvaluator."""
    datasets = federated.cluster_datasets_from_corpora(
        fedbench.synth_cluster_corpora(3, 300, seed=0))
    X = np.concatenate([d.X for d in datasets])
    y = np.concatenate([d.y for d in datasets])
    cfg = MLPTrainConfig(hidden=(32, 16), epochs=10, batch_size=64,
                         eval_fraction=0.2)
    result = train_mlp(X, y, cfg, "cpu")
    port = MLEvaluator(ParentScorer(result.model, result.normalizer,
                                    result.target_norm, device="cpu"))
    ref = JaxMLEvaluator(JaxParentScorer(
        JaxMLP(hidden=cfg.hidden), result.params,
        JaxNormalizer(result.normalizer.mean, result.normalizer.std),
        JaxNormalizer(result.target_norm.mean, result.target_norm.std)))
    yield port, ref
    port.close()


def test_replay_ab_mlp_close_to_jax(eval_corpora, mlp_evaluators):
    port, ref = mlp_evaluators
    got = replay.replay_ab(list(eval_corpora[1].decisions()),
                           {"ml": port, "rule": BaseEvaluator()})
    want = jax_replay.replay_ab(list(eval_corpora[0].decisions()),
                                {"ml": ref, "rule": JaxRule()})
    assert got["deterministic"] and want["deterministic"]
    g, w = got["evaluators"]["ml"], want["evaluators"]["ml"]
    assert g["regret_scored"] == w["regret_scored"] > 300
    np.testing.assert_allclose(g["regret_mean_s"], w["regret_mean_s"],
                               rtol=REGRET_RTOL)
    assert abs(g["rank_agreement_mean"] - w["rank_agreement_mean"]) \
        <= AGREEMENT_ATOL
    # The model beats the rule order on realized regret in both packages.
    assert g["regret_mean_s"] < got["evaluators"]["rule"]["regret_mean_s"]
    assert g["bad_node_labeled"] == w["bad_node_labeled"]
