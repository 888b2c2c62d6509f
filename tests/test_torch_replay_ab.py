"""Port parity for the recorded A/B (``replaybench.run_replay_ab``) and
``check_replay_regression`` on the CPU, against the JAX package.

Both packages record a profiled 300-peer swarm with one announce worker
and the swarm's GC-churn thread off (``run_swarm_bench`` wrapped in each
package: the GC thread's timing is the one input ``random.seed`` does
not fix), train their own cost model and MLP, gate them and replay the
corpus rule vs ``ml`` vs ``cost``.

Tolerances: the ``record`` section, the example count, the corpus (but
for its two wall-clock stamps) and the rule evaluator's digest and
metrics are equal; the gates' states are equal and each package's
learned regret is within its own bound of its rule regret. The trained
models differ (each package draws its own initial weights), so the
learned evaluators are compared with one set of weights, JAX's trained
MLP and cost model. Loaded into the port through the sidecar's loaders
(bf16, as served): the replay counts equal, rank agreement within
AGREEMENT_ATOL of JAX's A/B and every candidate's score within BF16_TOL
of JAX's bf16 scorer's. In f32 in both packages: the same decision
digest, regret within REGRET_RTOL and rank agreement within
AGREEMENT_ATOL.
"""

from __future__ import annotations

import dataclasses
import functools
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dragonfly2_tpu.inference.scorer import CostScorer as JaxCostScorer
from dragonfly2_tpu.inference.scorer import (
    LearnedCostEvaluator as JaxLearnedCostEvaluator,
)
from dragonfly2_tpu.inference.scorer import MLEvaluator as JaxMLEvaluator
from dragonfly2_tpu.inference.scorer import ParentScorer as JaxParentScorer
from dragonfly2_tpu.models.mlp import MLPBandwidthPredictor as JaxMLP
from dragonfly2_tpu.scheduler import loadbench as jax_loadbench
from dragonfly2_tpu.scheduler import replay as jax_replay
from dragonfly2_tpu.scheduler import replaybench as jax_bench
from dragonfly2_tpu.train import cost_trainer as jax_cost
from dragonfly2_tpu.train import mlp_trainer as jax_mlp
from dragonfly2_tpu.train.checkpoint import mlp_tree as jax_mlp_tree
from dragonfly2_tpu_torch.device import DeviceFault
from dragonfly2_tpu_torch.inference.scorer import (
    CostScorer,
    LearnedCostEvaluator,
    MLEvaluator,
    ParentScorer,
)
from dragonfly2_tpu_torch.inference.sidecar import (
    _cost_scorer_from_artifact,
    _scorer_from_artifact,
)
from dragonfly2_tpu_torch.manager.service import ManagerService
from dragonfly2_tpu_torch.models.mlp import MLPBandwidthPredictor, Normalizer
from dragonfly2_tpu_torch.scheduler import loadbench, replay, replaybench
from dragonfly2_tpu_torch.scheduler.evaluator import BaseEvaluator
from dragonfly2_tpu_torch.train import cost_trainer
from dragonfly2_tpu_torch.train.checkpoint import (
    ModelMetadata,
    mlp_state_dict_from_flax,
    write_artifact,
)

REGRET_RTOL = 0.05
BF16_TOL = 6e-2
AGREEMENT_ATOL = 0.05
RECORD_PEERS = 300
SEED = 0


def strip_latency(scored: dict) -> dict:
    return {k: v for k, v in scored.items()
            if not k.startswith("decision_latency")}


def without_stamps(events) -> list:
    out = []
    for event in events:
        fields = dataclasses.asdict(event)
        fields.pop("decided_at")
        fields.pop("finalized_at")
        out.append(fields)
    return out


def quiet_swarm(mp, module):
    """``module.run_swarm_bench`` with the GC-churn thread off."""
    mp.setattr(module, "run_swarm_bench", functools.partial(
        module.run_swarm_bench, gc_churn=False))


def capture(mp, module, name: str, into: dict):
    original = getattr(module, name)

    def wrapped(*args, **kwargs):
        into[name] = out = original(*args, **kwargs)
        return out

    mp.setattr(module, name, wrapped)


def record_both() -> dict:
    """Each package's A/B, with JAX's trained results and both corpora."""
    jax_seen, port_seen = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        quiet_swarm(mp, jax_loadbench)
        quiet_swarm(mp, loadbench)
        capture(mp, jax_cost, "train_cost", jax_seen)
        capture(mp, jax_mlp, "train_mlp", jax_seen)
        capture(mp, jax_replay, "corpus_from_storage", jax_seen)
        capture(mp, replay, "corpus_from_storage", port_seen)
        random.seed(SEED)
        want = jax_bench.run_replay_ab(seed=SEED, record_peers=RECORD_PEERS,
                                       workers=1, overhead_guard=False)
        random.seed(SEED)
        got = replaybench.run_replay_ab(seed=SEED, record_peers=RECORD_PEERS,
                                        workers=1, overhead_guard=False,
                                        device="cpu")
    return {"got": got, "want": want, "jax": jax_seen, "port": port_seen}


@pytest.fixture(scope="module")
def runs():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield record_both()
    torch.set_num_threads(threads)


def test_record_and_corpus_equal_jax(runs):
    got, want = runs["got"], runs["want"]
    assert "error" not in got and "error" not in want
    assert got["record"] == want["record"]
    assert got["record"]["corpus_decisions"] == RECORD_PEERS
    assert got["record"]["replay_files"] > 1
    assert without_stamps(runs["port"]["corpus_from_storage"]) == \
        without_stamps(runs["jax"]["corpus_from_storage"])
    assert got["train"]["examples"] == want["train"]["examples"] > 1000


def test_rule_replay_equal_jax(runs):
    got = runs["got"]["ab"]["evaluators"]["rule"]
    want = runs["want"]["ab"]["evaluators"]["rule"]
    assert got["digest"] == want["digest"]
    assert strip_latency(got) == strip_latency(want)


def test_verdicts_equal_jax(runs):
    got, want = runs["got"], runs["want"]
    assert {n: g["state"] for n, g in got["gate"].items()} == \
        {n: g["state"] for n, g in want["gate"].items()} == \
        {"cost": "active", "mlp": "active"}
    for report in (got, want):
        assert report["ab"]["deterministic"]
        assert report["regret_within_bound"] == {"ml": True, "cost": True}
        assert report["verdict_pass"] is True
    assert set(got["ab"]["evaluators"]) == {"rule", "ml", "cost"}
    assert got["regret_bounds"] == want["regret_bounds"]
    for name in ("cost", "mlp"):
        validation = got["gate"][name]["validation"]
        assert validation["passed"] and validation["trace_source"] == \
            "recorded"
        assert validation["batches"] == RECORD_PEERS
    assert set(got["seconds"]) == {"record", "train", "gate", "ab"}


def jax_artifacts(runs) -> dict:
    """JAX's trained MLP and cost model as port artifacts."""
    mlp = runs["jax"]["train_mlp"]
    cost = runs["jax"]["train_cost"]
    return {
        "ml": write_artifact(
            jax_mlp_tree(mlp.params, mlp.normalizer, mlp.target_norm),
            ModelMetadata(model_id="replay-mlp", model_type="mlp",
                          config={"hidden": [32, 16]})),
        "cost": write_artifact(
            jax_cost.cost_tree(cost),
            ModelMetadata(model_id="replay-cost", model_type="cost",
                          config={"hidden": [32, 16]})),
    }


def f32_scorers(runs) -> dict:
    """(port, JAX) f32 ``ParentScorer`` pairs over JAX's trained weights."""
    out = {}
    for name, key in (("ml", "train_mlp"), ("cost", "train_cost")):
        result = runs["jax"][key]
        model = MLPBandwidthPredictor(hidden=(32, 16), dtype=torch.float32)
        model.load_state_dict(mlp_state_dict_from_flax(result.params))
        out[name] = (
            ParentScorer(model, Normalizer(result.normalizer.mean,
                                           result.normalizer.std),
                         Normalizer(result.target_norm.mean,
                                    result.target_norm.std), device="cpu"),
            JaxParentScorer(JaxMLP(hidden=(32, 16), dtype=jnp.float32),
                            result.params, result.normalizer,
                            result.target_norm))
    return out


def replay_jax_models(runs) -> tuple:
    """JAX's trained models behind the port's evaluators, replayed on the
    port's corpus: through the sidecar's loaders (bf16, as served), and
    in f32 beside JAX's own f32 evaluators on JAX's corpus. Returns the
    results and the evaluators to close."""
    artifacts = jax_artifacts(runs)
    ml = _scorer_from_artifact(artifacts["ml"], device="cpu")
    cost = _cost_scorer_from_artifact(artifacts["cost"], version="jax",
                                      device="cpu")
    f32 = f32_scorers(runs)
    typical = cost.typical_cost_s
    port = {"rule": BaseEvaluator(), "ml": MLEvaluator(ml),
            "cost": LearnedCostEvaluator(cost)}
    port32 = {"ml": MLEvaluator(f32["ml"][0]),
              "cost": LearnedCostEvaluator(CostScorer(
                  f32["cost"][0], typical_cost_s=typical))}
    ref32 = {"ml": JaxMLEvaluator(f32["ml"][1]),
             "cost": JaxLearnedCostEvaluator(JaxCostScorer(
                 f32["cost"][1], typical_cost_s=typical))}
    corpus = runs["port"]["corpus_from_storage"]
    out = {"bf16": replay.replay_ab(corpus, port, seed=SEED),
           "f32": replay.replay_ab(corpus, port32, seed=SEED),
           "jax_f32": jax_replay.replay_ab(
               runs["jax"]["corpus_from_storage"], ref32, seed=SEED),
           "score": {"ml": ml.score, "cost": cost.score}}
    return out, [port["ml"], port32["ml"]]


@pytest.fixture(scope="module")
def jax_models_in_port(runs):
    out, to_close = replay_jax_models(runs)
    yield out
    for evaluator in to_close:
        evaluator.close()


def in_blocks(score, rows: np.ndarray, block: int = 64) -> np.ndarray:
    return np.concatenate([score(rows[i:i + block])
                           for i in range(0, len(rows), block)])


def jax_model_scorer(runs, name: str):
    """JAX's own bf16 scorer over its trained weights, as its A/B ran it."""
    result = runs["jax"]["train_mlp" if name == "ml" else "train_cost"]
    scorer = JaxParentScorer(result.model, result.params, result.normalizer,
                             result.target_norm)
    if name == "ml":
        return scorer
    return JaxCostScorer(scorer, typical_cost_s=float(np.expm1(
        float(result.target_norm.mean[0]))))


@pytest.mark.parametrize("name", ["ml", "cost"])
def test_jax_trained_models_replay_close_to_jax(runs, jax_models_in_port,
                                                name):
    """Served in bf16 (the sidecar's loaders): the same replay counts,
    rank agreement within AGREEMENT_ATOL of JAX's A/B, and every
    candidate's score within BF16_TOL of JAX's bf16 scorer's. Mean regret
    is held to REGRET_RTOL in f32 (below): in bf16 the cost model's
    outputs lie one or two bf16 steps (~0.15 ms) apart between ordinary
    peers, and the two packages round such near-ties differently."""
    got = jax_models_in_port["bf16"]["evaluators"][name]
    want = runs["want"]["ab"]["evaluators"][name]
    assert jax_models_in_port["bf16"]["deterministic"]
    assert got["regret_scored"] == want["regret_scored"] == RECORD_PEERS
    assert got["bad_node_labeled"] == want["bad_node_labeled"]
    assert abs(got["rank_agreement_mean"] - want["rank_agreement_mean"]) \
        <= AGREEMENT_ATOL
    rows = np.concatenate([
        np.stack([replay._row_array(c) for c in event.candidates])
        for event in runs["port"]["corpus_from_storage"]
        if event.candidates])
    np.testing.assert_allclose(
        in_blocks(jax_models_in_port["score"][name], rows),
        in_blocks(jax_model_scorer(runs, name).score, rows), rtol=BF16_TOL,
        atol=BF16_TOL)


@pytest.mark.parametrize("name", ["ml", "cost"])
def test_jax_trained_models_f32_replay_matches_jax(jax_models_in_port,
                                                   name):
    """JAX's weights in f32 in both packages: the same decisions."""
    got = jax_models_in_port["f32"]["evaluators"][name]
    want = jax_models_in_port["jax_f32"]["evaluators"][name]
    assert got["digest"] == want["digest"]
    assert got["regret_scored"] == want["regret_scored"] == RECORD_PEERS
    assert got["bad_node_labeled"] == want["bad_node_labeled"]
    np.testing.assert_allclose(got["regret_mean_s"], want["regret_mean_s"],
                               rtol=REGRET_RTOL)
    assert abs(got["rank_agreement_mean"] - want["rank_agreement_mean"]) \
        <= AGREEMENT_ATOL


@pytest.mark.parametrize("fault", [
    DeviceFault("the kernel did not launch"),
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
], ids=["device_fault", "cuda_oom", "cuda_runtime"])
def test_device_fault_propagates(monkeypatch, fault):
    def train_cost(*args, **kwargs):
        raise fault

    monkeypatch.setattr(cost_trainer, "train_cost", train_cost)
    quiet_swarm(monkeypatch, loadbench)
    with pytest.raises(type(fault)) as raised:
        replaybench.run_replay_ab(record_peers=120, workers=1,
                                  overhead_guard=False, device="cpu")
    assert raised.value is fault


def test_artifact_fault_lands_in_the_report(monkeypatch):
    """An active version whose bytes do not load is the artifact's fault:
    the JAX package's report shape, not a raise."""
    original = ManagerService.get_active_model

    def corrupt(self, model_type, scheduler_id=0):
        active = original(self, model_type, scheduler_id)
        return dataclasses.replace(active, artifact=b"not a model tar")

    monkeypatch.setattr(ManagerService, "get_active_model", corrupt)
    quiet_swarm(monkeypatch, loadbench)
    # The fixture's port run, whose gates both promote.
    random.seed(SEED)
    report = replaybench.run_replay_ab(seed=SEED, record_peers=RECORD_PEERS,
                                       workers=1, overhead_guard=False,
                                       device="cpu")
    assert report["verdict_pass"] is False
    assert report["error"] and "ab" not in report
    assert report["gate"]["mlp"]["state"] == "active"


@pytest.mark.parametrize("package", ["jax", "port"])
def test_small_corpus_is_an_error(monkeypatch, package):
    module, bench, kwargs = {
        "jax": (jax_loadbench, jax_bench, {}),
        "port": (loadbench, replaybench, {"device": "cpu"})}[package]
    quiet_swarm(monkeypatch, module)
    report = bench.run_replay_ab(record_peers=40, workers=1,
                                 overhead_guard=False, **kwargs)
    assert report["verdict_pass"] is False
    assert report["error"] == "corpus too small: 40 < 100"
    assert report["record"]["corpus_decisions"] == 40


@pytest.mark.parametrize("fresh", [
    {"verdict_pass": True, "ab": {"deterministic": True, "evaluators": {
        "rule": {"regret_mean_s": 0.007}, "ml": {"regret_mean_s": 1e-4}}}},
    {"verdict_pass": False, "error": "corpus too small: 40 < 100"},
], ids=["green", "red"])
def test_check_replay_regression_equal_jax(monkeypatch, tmp_path, fresh):
    """The check around a canned fresh A/B, in both packages."""
    for bench in (jax_bench, replaybench):
        monkeypatch.setattr(bench, "run_replay_ab",
                            lambda fresh=fresh, **kw: dict(fresh))
        monkeypatch.setattr(bench, "LADDER_RUNGS", (500,))
    got = replaybench.check_replay_regression(str(tmp_path), device="cpu")
    want = jax_bench.check_replay_regression(str(tmp_path))
    assert list(got) == list(want)
    for key in got:
        if key == "ladder_rung":
            assert got[key]["digest"] == want[key]["digest"]
            assert got[key]["digests_equal"] is True
        else:
            assert got[key] == want[key], key
    assert got["passed"] is fresh["verdict_pass"]
