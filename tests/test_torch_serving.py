"""Port parity for serving: the port's GATParentScorer / ParentScorer
against the JAX package's on the same params and graph, the port's
InferenceService status codes against the JAX service's, and the port
artifact (written here from a JAX param tree with numpy and tarfile
alone) loading into the port scorers.

Tolerances as in tests/test_torch_model.py: 1e-4 with f32 compute on
both sides (where the ranking must also be identical), 6e-2 for the
default bf16 models.
"""

import io
import json
import os
import tarfile
import tempfile

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
from dragonfly2_tpu.train.checkpoint import gat_tree as jax_gat_tree
from dragonfly2_tpu.train.checkpoint import mlp_tree as jax_mlp_tree
from dragonfly2_tpu_torch.data import SyntheticCluster
from dragonfly2_tpu_torch.inference.scorer import GATParentScorer, ParentScorer
from dragonfly2_tpu_torch.inference.sidecar import (
    CallContext,
    InferenceService,
    ModelInferRequest,
    ModelReadyRequest,
    RpcAbort,
    ServerLiveRequest,
    ServerReadyRequest,
    StatusCode,
    _gat_scorer_from_artifact,
    _scorer_from_artifact,
)
from dragonfly2_tpu_torch.models.graph_transformer import (
    GraphTransformer,
    build_neighbor_lists,
    pad_graph_sparse,
)
from dragonfly2_tpu_torch.models.mlp import (
    FEATURE_DIM,
    MLPBandwidthPredictor,
    Normalizer,
)
from dragonfly2_tpu_torch.train.checkpoint import (
    ArtifactError,
    gat_state_dict_from_flax,
    mlp_state_dict_from_flax,
    untar_to_directory,
)

F32_TOL = 1e-4
BF16_TOL = 6e-2
GAT_CFG = dict(hidden=32, embed=16, layers=2, heads=4, chunk=16)


@pytest.fixture(scope="module")
def gat():
    g = SyntheticCluster(n_hosts=50, seed=4).probe_graph(2500)
    nbr, val = build_neighbor_lists(g.n_nodes, g.edge_src, g.edge_dst,
                                    g.edge_rtt_ns, cap=16)
    feats, nbr, val, n_real = pad_graph_sparse(g.node_features, nbr, val, 16)
    params = JaxGT(**GAT_CFG).init(
        jax.random.key(0), feats, nbr, val, np.zeros(2, np.int32),
        np.zeros(2, np.int32))
    ids = list(g.node_ids)
    return dict(params=jax.device_get(params), feats=feats, nbr=nbr, val=val,
                ids=ids, n_real=n_real)


@pytest.fixture(scope="module")
def mlp():
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 50, (200, FEATURE_DIM)).astype(np.float32)
    norm = JaxNormalizer.fit(x)
    target = JaxNormalizer(np.array([2.5], np.float32),
                           np.array([0.7], np.float32))
    params = jax.device_get(JaxMLP().init(jax.random.key(3), x[:2]))
    return dict(params=params, norm=norm, target=target, x=x)


def _pairs(n_real, n=40, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_real, (n, 2)).astype(np.int32)


def _ranking(scores):
    return np.argsort(-np.asarray(scores), kind="stable")


@pytest.mark.parametrize("attention", ["gather", "blocks", "ring"])
def test_gat_scorer_matches_jax_f32(gat, attention):
    cfg = dict(GAT_CFG, attention=attention)
    ref = jax_scorer.GATParentScorer(
        JaxGT(**cfg, dtype=jnp.float32), gat["params"], gat["feats"],
        gat["nbr"], gat["val"], node_ids=gat["ids"])
    model = GraphTransformer(**cfg, dtype=torch.float32)
    model.load_state_dict(gat_state_dict_from_flax(gat["params"]))
    got = GATParentScorer(model, gat["feats"], gat["nbr"], gat["val"],
                          node_ids=gat["ids"], device="cpu")
    assert got.n_real == ref.n_real == gat["n_real"]
    pairs = _pairs(gat["n_real"])
    a, b = got.score(pairs), ref.score(pairs)
    np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_array_equal(_ranking(a), _ranking(b))
    host_pairs = [(gat["ids"][3], gat["ids"][7]), (gat["ids"][0],
                                                   gat["ids"][1])]
    np.testing.assert_allclose(got.score_host_pairs(host_pairs),
                               ref.score_host_pairs(host_pairs),
                               rtol=F32_TOL, atol=F32_TOL)
    assert got.index_of(gat["ids"][9]) == 9 and got.index_of("nope") is None


def test_parent_scorer_matches_jax(mlp):
    for jdt, tdt, tol in ((jnp.float32, torch.float32, F32_TOL),
                          (jnp.bfloat16, torch.bfloat16, BF16_TOL)):
        ref = jax_scorer.ParentScorer(JaxMLP(dtype=jdt), mlp["params"],
                                      mlp["norm"], mlp["target"])
        model = MLPBandwidthPredictor(dtype=tdt)
        model.load_state_dict(mlp_state_dict_from_flax(mlp["params"]))
        got = ParentScorer(model, Normalizer(mlp["norm"].mean,
                                             mlp["norm"].std),
                           Normalizer(mlp["target"].mean, mlp["target"].std),
                           device="cpu")
        for n in (1, 15, 64):
            a, b = got.score(mlp["x"][:n]), ref.score(mlp["x"][:n])
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol)
            if tdt == torch.float32:
                np.testing.assert_array_equal(_ranking(a), _ranking(b))
        assert got.score(mlp["x"][:0]).shape == (0,)
        with pytest.raises(ValueError, match="max_batch"):
            got.score(mlp["x"][:65])


def test_staging_reuse_rezeroes_dirty_rows(mlp):
    model = MLPBandwidthPredictor()
    model.load_state_dict(mlp_state_dict_from_flax(mlp["params"]))
    scorer = ParentScorer(model, Normalizer(mlp["norm"].mean, mlp["norm"].std),
                          Normalizer(mlp["target"].mean, mlp["target"].std),
                          device="cpu")
    first = scorer.score(mlp["x"][:3])
    for _ in range(2 * scorer._staging.depth):
        scorer.score(mlp["x"][10:16])        # dirties rows 0-5 of bucket 8
    np.testing.assert_array_equal(scorer.score(mlp["x"][:3]), first)


def _write_jax_artifact(tree, metadata) -> bytes:
    """A port artifact from a JAX checkpoint tree with numpy + tarfile."""
    def flatten(node, prefix=""):
        out = {}
        for key, value in node.items():
            if isinstance(value, dict):
                out.update(flatten(value, f"{prefix}{key}/"))
            else:
                out[f"{prefix}{key}"] = np.asarray(value)
        return out

    buf = io.BytesIO()
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "tree.npz"), **flatten(tree))
        with open(os.path.join(tmp, "metadata.json"), "w") as f:
            json.dump(metadata, f)
        with tarfile.open(fileobj=buf, mode="w") as tar:
            for name in ("tree.npz", "metadata.json"):
                tar.add(os.path.join(tmp, name), arcname=name)
    return buf.getvalue()


def _metadata(model_type, config):
    return {"model_id": f"test-{model_type}", "model_type": model_type,
            "version": 1, "evaluation": {}, "config": config,
            "feature_schema": []}


@pytest.mark.parametrize("attention", ["gather", "blocks", "ring"])
def test_gat_artifact_from_jax_tree_serves(gat, attention):
    cfg = dict(GAT_CFG, attention=attention)
    tree = jax_gat_tree(gat["params"], gat["feats"], gat["nbr"], gat["val"],
                        node_ids=gat["ids"])
    artifact = _write_jax_artifact(tree, _metadata("gat", cfg))
    got = _gat_scorer_from_artifact(artifact, device="cpu")
    ref = jax_scorer.GATParentScorer(JaxGT(**cfg), gat["params"],
                                     gat["feats"], gat["nbr"], gat["val"],
                                     node_ids=gat["ids"])
    assert got.node_ids == gat["ids"] and got.n_real == gat["n_real"]
    pairs = _pairs(gat["n_real"], seed=1)
    np.testing.assert_allclose(got.score(pairs), ref.score(pairs),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_mlp_artifact_from_jax_tree_serves(mlp):
    tree = jax_mlp_tree(mlp["params"], mlp["norm"], mlp["target"])
    artifact = _write_jax_artifact(
        tree, _metadata("mlp", {"hidden": [128, 128, 64]}))
    got = _scorer_from_artifact(artifact, device="cpu")
    ref = jax_scorer.ParentScorer(JaxMLP(), mlp["params"], mlp["norm"],
                                  mlp["target"])
    np.testing.assert_allclose(got.score(mlp["x"][:20]),
                               ref.score(mlp["x"][:20]),
                               rtol=BF16_TOL, atol=BF16_TOL)


class _JaxContext:
    def abort(self, code, details):
        raise RpcAbort(StatusCode[code.name], details)


def _code(service, request, context):
    try:
        service.ModelInfer(request, context)
    except RpcAbort as exc:
        return exc.code
    return StatusCode.OK


def test_model_infer_status_codes_match_jax(gat, mlp):
    cfg = dict(GAT_CFG, attention="gather")
    port_gat = GATParentScorer(
        _loaded(GraphTransformer(**cfg), gat_state_dict_from_flax,
                gat["params"]),
        gat["feats"], gat["nbr"], gat["val"], node_ids=gat["ids"],
        device="cpu", max_batch=16)
    port_mlp = ParentScorer(
        _loaded(MLPBandwidthPredictor(), mlp_state_dict_from_flax,
                mlp["params"]),
        Normalizer(mlp["norm"].mean, mlp["norm"].std),
        Normalizer(mlp["target"].mean, mlp["target"].std), device="cpu",
        max_batch=16)
    port = InferenceService()
    port.install_scorer("gat", port_gat, "v-gat")
    port.install_scorer("mlp", port_mlp, "v-mlp")
    ref = jax_sidecar.InferenceService(micro_batch=False)
    ref.install_scorer("gat", jax_scorer.GATParentScorer(
        JaxGT(**cfg), gat["params"], gat["feats"], gat["nbr"], gat["val"],
        node_ids=gat["ids"], max_batch=16), "v-gat")
    ref.install_scorer("mlp", jax_scorer.ParentScorer(
        JaxMLP(), mlp["params"], mlp["norm"], mlp["target"], max_batch=16),
        "v-mlp")

    n_real = gat["n_real"]
    cases = {
        "unknown model": (ModelInferRequest("nope", mlp["x"][:2]),
                          StatusCode.NOT_FOUND),
        "empty": (ModelInferRequest("mlp", mlp["x"][:0]),
                  StatusCode.INVALID_ARGUMENT),
        "mlp bad shape": (ModelInferRequest("mlp", mlp["x"][:2, :5]),
                          StatusCode.INVALID_ARGUMENT),
        "gat bad shape": (ModelInferRequest("gat", np.zeros((3, 3), np.int32)),
                          StatusCode.INVALID_ARGUMENT),
        "gat index past real rows": (
            ModelInferRequest("gat", np.array([[0, n_real]])),
            StatusCode.INVALID_ARGUMENT),
        "gat negative index": (ModelInferRequest("gat", np.array([[-1, 0]])),
                               StatusCode.INVALID_ARGUMENT),
        "gat int64 wrap": (ModelInferRequest("gat", np.array([[0, 2**32]])),
                           StatusCode.INVALID_ARGUMENT),
        "too many rows": (ModelInferRequest("mlp", mlp["x"][:17]),
                          StatusCode.INVALID_ARGUMENT),
        "mlp ok": (ModelInferRequest("mlp", mlp["x"][:16]), StatusCode.OK),
        "gat ok": (ModelInferRequest("gat", _pairs(n_real, 16)),
                   StatusCode.OK),
    }
    for name, (request, want) in cases.items():
        assert _code(port, request, CallContext()) == want, name
        assert _code(ref, request, _JaxContext()) == want, name

    resp = port.ModelInfer(ModelInferRequest("gat", _pairs(n_real, 5)),
                           CallContext())
    assert resp.model_version == "v-gat" and resp.outputs.shape == (5,)
    assert port.ModelReady(ModelReadyRequest("mlp"), None).version == "v-mlp"
    assert not port.ModelReady(ModelReadyRequest("nope"), None).ready
    assert port.ServerLive(ServerLiveRequest(), None).live
    assert port.ServerReady(ServerReadyRequest(), None).ready
    assert not InferenceService().ServerReady(ServerReadyRequest(), None).ready


def _loaded(model, convert, params):
    model.load_state_dict(convert(params))
    return model


def _tar(*members) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        for info, data in members:
            tar.addfile(info, io.BytesIO(data) if data is not None else None)
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["escape", "symlink", "hardlink"])
def test_untar_rejects_unsafe_members(tmp_path, kind):
    info = tarfile.TarInfo("../evil" if kind == "escape" else "tree.npz")
    data = b"x"
    if kind == "escape":
        info.size = 1
    else:
        info.type = tarfile.SYMTYPE if kind == "symlink" else tarfile.LNKTYPE
        info.linkname = "/etc/passwd"
        data = None
    with pytest.raises(ArtifactError):
        untar_to_directory(_tar((info, data)), str(tmp_path / "out"))
    assert not (tmp_path / "evil").exists()
