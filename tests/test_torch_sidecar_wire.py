"""The inference sidecar over the wire: the port's ``InferenceService``
served through ``rpc.serve`` and called through ``InferenceClient``,
against the JAX package's served over gRPC — the same MLP and ``gat``
weights (the port's side loaded from a port artifact written by
``train/checkpoint.py``), the same requests, the same statuses and
details, the same evaluator decisions and sheds, and the trace of one
call (``rpc.client`` → ``rpc.server`` → ``infer.batch``).

Tolerances as in tests/test_torch_serving.py: BF16_TOL for the default
bf16 models; f32 scorers where decisions must be identical; the wire
itself adds nothing (tolerance 0 against the service in process).
"""

from __future__ import annotations

import json
import os
import threading
import time

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.inference import scorer as jax_scorer
from dragonfly2_tpu.inference import sidecar as jax_sidecar
from dragonfly2_tpu.models.graph_transformer import GraphTransformer as JaxGT
from dragonfly2_tpu.models.mlp import MLPBandwidthPredictor as JaxMLP
from dragonfly2_tpu.models.mlp import Normalizer as JaxNormalizer
from dragonfly2_tpu.rpc import service as jax_service
from dragonfly2_tpu.scheduler.evaluator import new_evaluator as jax_new_evaluator
from dragonfly2_tpu_torch.data import SyntheticCluster
from dragonfly2_tpu_torch.inference import sidecar
from dragonfly2_tpu_torch.inference.scorer import ParentScorer
from dragonfly2_tpu_torch.inference.sidecar import (
    INFERENCE_SPEC,
    CallContext,
    InferenceClient,
    InferenceService,
    ModelInferRequest,
    RemoteMLEvaluator,
)
from dragonfly2_tpu_torch.models.graph_transformer import (
    build_neighbor_lists,
    pad_graph_sparse,
)
from dragonfly2_tpu_torch.models.mlp import (
    FEATURE_DIM,
    MLPBandwidthPredictor,
    Normalizer,
)
from dragonfly2_tpu_torch.rpc import serve
from dragonfly2_tpu_torch.rpc.status import RpcError, StatusCode
from dragonfly2_tpu_torch.scheduler.evaluator import new_evaluator
from dragonfly2_tpu_torch.train.checkpoint import (
    ModelMetadata,
    gat_tree,
    mlp_state_dict_from_flax,
    mlp_tree,
    write_artifact,
)
from dragonfly2_tpu_torch.utils import tracing
from tests.test_torch_evaluator import ids, random_features, seeded_decisions

BF16_TOL = 6e-2
GAT_CFG = dict(hidden=32, embed=16, layers=2, heads=4, chunk=16,
               attention="gather")
MAX_BATCH = 64  # every scorer's default
HIDDEN = (32, 32)


@pytest.fixture(scope="module")
def weights():
    """One set of weights for both packages: config #1's MLP (bf16, as
    served), an f32 MLP for decisions, and a small ``gat``."""
    x = random_features(11, 512)
    norm = JaxNormalizer.fit(x)
    target = JaxNormalizer(np.array([0.3], np.float32),
                           np.array([0.4], np.float32))
    mlp_params = jax.device_get(JaxMLP().init(jax.random.key(1), x[:2]))
    f32_params = jax.device_get(JaxMLP(hidden=HIDDEN).init(
        jax.random.key(2), x[:2]))
    g = SyntheticCluster(n_hosts=50, seed=4).probe_graph(2500)
    nbr, val = build_neighbor_lists(g.n_nodes, g.edge_src, g.edge_dst,
                                    g.edge_rtt_ns, cap=16)
    feats, nbr, val, n_real = pad_graph_sparse(g.node_features, nbr, val, 16)
    gat_params = jax.device_get(JaxGT(**GAT_CFG).init(
        jax.random.key(0), feats, nbr, val, np.zeros(2, np.int32),
        np.zeros(2, np.int32)))
    return dict(x=x, norm=norm, target=target, mlp=mlp_params,
                f32=f32_params, gat=gat_params, feats=feats, nbr=nbr,
                val=val, ids=list(g.node_ids), n_real=n_real)


def port_scorers(w) -> dict:
    """The port's scorers, the bf16 ones loaded from port artifacts."""
    mlp_art = write_artifact(
        mlp_tree(w["mlp"], w["norm"], w["target"]),
        ModelMetadata(model_id="wire-mlp", model_type="mlp",
                      config={"hidden": [128, 128, 64]}))
    gat_art = write_artifact(
        gat_tree(w["gat"], w["feats"], w["nbr"], w["val"],
                 node_ids=w["ids"]),
        ModelMetadata(model_id="wire-gat", model_type="gat",
                      config=GAT_CFG))
    mlp = sidecar._scorer_from_artifact(mlp_art, device="cpu")
    gat = sidecar._gat_scorer_from_artifact(gat_art, device="cpu")
    f32 = MLPBandwidthPredictor(hidden=HIDDEN, dtype=torch.float32)
    f32.load_state_dict(mlp_state_dict_from_flax(w["f32"]))
    return {"mlp": mlp, "gat": gat, "f32": ParentScorer(
        f32, Normalizer(w["norm"].mean, w["norm"].std),
        Normalizer(w["target"].mean, w["target"].std), device="cpu")}


def jax_scorers(w) -> dict:
    return {
        "mlp": jax_scorer.ParentScorer(JaxMLP(), w["mlp"], w["norm"],
                                       w["target"]),
        "gat": jax_scorer.GATParentScorer(
            JaxGT(**GAT_CFG), w["gat"], w["feats"], w["nbr"], w["val"],
            node_ids=w["ids"]),
        "f32": jax_scorer.ParentScorer(
            JaxMLP(hidden=HIDDEN, dtype=jnp.float32), w["f32"], w["norm"],
            w["target"]),
    }


@pytest.fixture(scope="module")
def stacks(weights):
    """Each package's service with the same models, each served over its
    own transport."""
    port = InferenceService()
    for name, scorer in port_scorers(weights).items():
        port.install_scorer(name, scorer, version=f"v-{name}")
    ref = jax_sidecar.InferenceService()
    for name, scorer in jax_scorers(weights).items():
        ref.install_scorer(name, scorer, version=f"v-{name}")
    port_server = serve([(INFERENCE_SPEC, port)])
    ref_server = jax_service.serve([(jax_sidecar.INFERENCE_SPEC, ref)])
    yield dict(port=port, ref=ref, port_target=port_server.target,
               ref_target=ref_server.target)
    port_server.stop()
    ref_server.stop()
    port.stop()
    ref.stop()


def _inputs(weights, model: str, rows: int, seed: int = 0):
    rng = np.random.default_rng(seed + rows)
    if model == "gat":
        return rng.integers(0, weights["n_real"], (rows, 2)).astype(np.int32)
    return weights["x"][rng.integers(0, len(weights["x"]), rows)]


@pytest.mark.parametrize("model,rows", [("mlp", 1), ("mlp", 16),
                                        ("gat", 1), ("gat", 16)])
def test_scores_over_the_wire_equal_jax(stacks, weights, model, rows):
    inputs = _inputs(weights, model, rows)
    port_cli = InferenceClient(stacks["port_target"], timeout=30)
    ref_cli = jax_sidecar.InferenceClient(stacks["ref_target"], timeout=30)
    got, version = port_cli.model_infer_full(model, inputs)
    want, ref_version = ref_cli.model_infer_full(model, inputs)
    port_cli.close()
    ref_cli.close()
    assert version == ref_version == f"v-{model}"
    assert got.shape == want.shape == (rows,)
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)
    # The wire adds nothing: the in-process answer, bit for bit.
    local = stacks["port"].ModelInfer(ModelInferRequest(model, inputs),
                                      CallContext())
    np.testing.assert_array_equal(got, local.outputs)
    assert got.dtype == local.outputs.dtype


def test_ready_and_live_over_the_wire_equal_jax(stacks):
    port_cli = InferenceClient(stacks["port_target"], timeout=30)
    ref_cli = jax_sidecar.InferenceClient(stacks["ref_target"], timeout=30)
    for cli in (port_cli, ref_cli):
        assert cli.model_ready("gat") and not cli.model_ready("nope")
        assert cli.server_live() and cli.server_ready()
    port_cli.close()
    ref_cli.close()


BAD_REQUESTS = {
    "unknown model": ("nope", lambda w: w["x"][:2]),
    "empty": ("mlp", lambda w: w["x"][:0]),
    "mlp bad shape": ("mlp", lambda w: w["x"][:2, :5]),
    "gat bad shape": ("gat", lambda w: np.zeros((3, 3), np.int32)),
    "gat index past real rows": (
        "gat", lambda w: np.array([[0, w["n_real"]]])),
    "gat negative index": ("gat", lambda w: np.array([[-1, 0]])),
    "gat int64 wrap": ("gat", lambda w: np.array([[0, 2**32]])),
    "too many rows": ("mlp", lambda w: w["x"][:MAX_BATCH + 1]),
}


@pytest.mark.parametrize("case", sorted(BAD_REQUESTS))
def test_bad_request_status_and_details_equal_jax(stacks, weights, case):
    model, make = BAD_REQUESTS[case]
    inputs = make(weights)
    port_cli = InferenceClient(stacks["port_target"], timeout=30)
    ref_cli = jax_sidecar.InferenceClient(stacks["ref_target"], timeout=30)
    with pytest.raises(RpcError) as got:
        port_cli.model_infer_full(model, inputs)
    with pytest.raises(grpc.RpcError) as want:
        ref_cli.model_infer_full(model, inputs)
    port_cli.close()
    ref_cli.close()
    assert got.value.code().name == want.value.code().name
    assert got.value.code() in (StatusCode.NOT_FOUND,
                                StatusCode.INVALID_ARGUMENT)
    assert got.value.details() == want.value.details()


def test_remote_evaluator_decisions_equal_jax(stacks):
    """``new_evaluator("ml", sidecar_target=...)`` in each package, over
    its own transport, ranks seeded candidates alike (f32 scorers)."""
    port = new_evaluator("ml", sidecar_target=stacks["port_target"])
    ref = jax_new_evaluator("ml", sidecar_target=stacks["ref_target"])
    assert isinstance(port, RemoteMLEvaluator)
    for ev in (port, ref):
        ev._scorer.model_name = "f32"
        ev.client.timeout = 30
    for parents, child, total in seeded_decisions(21, 30):
        assert ids(port.evaluate_parents(parents, child, total)) == ids(
            ref.evaluate_parents(parents, child, total))
    assert port.scored_count == ref.scored_count == 30
    assert port.fallback_count == ref.fallback_count == 0
    assert port.serving_version == ref.serving_version == "v-f32"
    port.client.close()
    ref.client.close()


class BlockingScorer:
    """Scores feature sums once released; ``entered`` is set when a
    dispatch is waiting."""

    max_batch = MAX_BATCH

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def score(self, features):
        self.entered.set()
        self.release.wait(30)
        return np.asarray(features, np.float32).sum(axis=1)


def _wait_queued(service, depth: int, timeout_s: float = 30.0) -> None:
    """Until the MLP's batcher lanes hold ``depth`` queued requests."""
    end = time.monotonic() + timeout_s
    with service._lock:
        lanes = service._models["mlp"].batcher._lanes
    while sum(lane.queue.qsize() for lane in lanes) < depth:
        if time.monotonic() > end:
            raise AssertionError("the request never reached the queue")
        time.sleep(0.01)


def _shed_case(pkg: str) -> dict:
    """A lane at its depth cap behind a blocked dispatch: the evaluator's
    next decision is shed (RESOURCE_EXHAUSTED over the transport), ranked
    by the rule, counted, and the breaker stays closed."""
    if pkg == "port":
        service = InferenceService(batch_lanes=1, batch_queue_depth=1)
        server = serve([(INFERENCE_SPEC, service)])
        client = InferenceClient(server.target, timeout=30)
        evaluator = RemoteMLEvaluator(client)
    else:
        service = jax_sidecar.InferenceService(batch_lanes=1,
                                               batch_queue_depth=1)
        server = jax_service.serve([(jax_sidecar.INFERENCE_SPEC, service)])
        client = jax_sidecar.InferenceClient(server.target, timeout=30)
        evaluator = jax_sidecar.RemoteMLEvaluator(client)
    scorer = BlockingScorer()
    service.install_scorer("mlp", scorer, version="v-block")
    rows = np.ones((2, FEATURE_DIM), np.float32)
    held = [threading.Thread(target=client.model_infer_full,
                             args=("mlp", rows), daemon=True)
            for _ in range(2)]
    try:
        held[0].start()
        assert scorer.entered.wait(10)
        held[1].start()  # waits in the lane's queue: depth 1
        _wait_queued(service, 1)
        parents, child, total = seeded_decisions(5, 1)[0]
        evaluator.evaluate_parents(parents, child, total)
        return {"shed": evaluator.shed_count,
                "fallbacks": evaluator.fallback_count,
                "scored": evaluator.scored_count,
                "breaker_closed": evaluator._scorer._open_until == 0.0}
    finally:
        scorer.release.set()
        for t in held:
            t.join(timeout=10)
        client.close()
        server.stop()
        service.stop()


def test_shed_over_the_wire_behaves_as_jax():
    port, ref = _shed_case("port"), _shed_case("jax")
    assert port == ref
    assert port["shed"] == 1 and port["breaker_closed"]


def test_unavailable_opens_the_breaker_as_jax(stacks):
    """A stopped service: the call is retried, fails UNAVAILABLE, the
    decision falls back to the rule and the breaker opens."""
    outcomes = {}
    for pkg in ("port", "jax"):
        if pkg == "port":
            server = serve([(INFERENCE_SPEC, stacks["port"])])
            evaluator = RemoteMLEvaluator(InferenceClient(server.target))
        else:
            server = jax_service.serve([(jax_sidecar.INFERENCE_SPEC,
                                         stacks["ref"])])
            evaluator = jax_sidecar.RemoteMLEvaluator(
                jax_sidecar.InferenceClient(server.target))
        evaluator._scorer.model_name = "f32"
        server.stop()
        parents, child, total = seeded_decisions(6, 1)[0]
        ranked = evaluator.evaluate_parents(parents, child, total)
        outcomes[pkg] = (len(ranked), evaluator.fallback_count,
                         evaluator.shed_count,
                         evaluator._scorer._open_until > time.monotonic())
        evaluator.client.close()
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][1:] == (1, 0, True)


def test_model_infer_trace_spans_one_trace(stacks, weights, tmp_path):
    """With tracing on, a ModelInfer over the wire is one trace:
    ``rpc.client`` → ``rpc.server`` → ``infer.batch``."""
    old = tracing.default_tracer()
    tracer = tracing.Tracer("wire-test", out_dir=str(tmp_path))
    tracing.set_default_tracer(tracer)
    try:
        cli = InferenceClient(stacks["port_target"], timeout=30)
        cli.model_infer_full("mlp", _inputs(weights, "mlp", 4))
        cli.close()
    finally:
        tracing.set_default_tracer(old)
        tracer.close()
    with open(os.path.join(tmp_path, "trace-wire-test.jsonl")) as f:
        spans = {r["name"]: r for r in map(json.loads, f)}
    full = "/df2.inference.GRPCInferenceService/ModelInfer"
    client = spans[f"rpc.client{full}"]
    server = spans[f"rpc.server{full}"]
    batch = spans["infer.batch"]
    assert client["trace_id"] == server["trace_id"] == batch["trace_id"]
    assert server["parent_id"] == client["span_id"]
    assert batch["parent_id"] == server["span_id"]
    assert batch["attrs"]["requests"] == 1 and batch["attrs"]["rows"] == 4
