"""Port parity: GraphTransformer and MLPBandwidthPredictor of
``dragonfly2_tpu_torch`` against the flax models, from one flax-initialised
param tree carried across by ``*_state_dict_from_flax``.

Tolerances: f32 on both sides is the same algebra in another summation
order — 1e-4 (measured worst 1.3e-6 on these cases). In bf16 the two
frameworks round at different places (XLA rounds each elementwise op,
PyTorch rounds fused ops once, scores round before or after the f32
upcast) — 6e-2, the tolerance tests/test_gat.py uses between the JAX
package's own attention modes (measured worst: embeddings 2.7e-2 at
|emb| ≤ 2.6, i.e. two bf16 ulps; scores 1.1e-2; MLP 4.4e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.models.graph_transformer import GraphTransformer as JaxGT
from dragonfly2_tpu.models.mlp import MLPBandwidthPredictor as JaxMLP
from dragonfly2_tpu_torch.data import SyntheticCluster
from dragonfly2_tpu_torch.models.graph_transformer import (
    GraphTransformer,
    build_neighbor_lists,
    pad_graph_sparse,
    pad_multiple,
)
from dragonfly2_tpu_torch.models.mlp import FEATURE_DIM, MLPBandwidthPredictor
from dragonfly2_tpu_torch.train.checkpoint import (
    flax_from_gat_state_dict,
    flax_from_mlp_state_dict,
    gat_state_dict_from_flax,
    mlp_state_dict_from_flax,
)

F32_TOL = 1e-4
BF16_TOL = 6e-2
CHUNK = 16
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


@pytest.fixture(scope="module")
def graph():
    g = SyntheticCluster(n_hosts=60, seed=0).probe_graph(3000)
    nbr, val = build_neighbor_lists(g.n_nodes, g.edge_src, g.edge_dst,
                                    g.edge_rtt_ns, cap=16)
    feats, nbr, val, n = pad_graph_sparse(
        g.node_features, nbr, val, pad_multiple(1, CHUNK, g.n_nodes))
    rng = np.random.default_rng(0)
    src = rng.integers(0, n, 40).astype(np.int32)
    dst = rng.integers(0, n, 40).astype(np.int32)
    return feats, nbr, val, src, dst


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("attention", ["gather", "blocks", "flash"])
def test_graph_transformer_matches_flax(graph, attention, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    feats, nbr, val, src, dst = graph
    jm = JaxGT(hidden=32, embed=16, layers=2, heads=4, chunk=CHUNK,
               attention=attention, dtype=jdt)
    params = jm.init(jax.random.key(0), feats, nbr, val, src[:2], dst[:2])
    ref_emb = jm.apply(params, feats, nbr, val,
                       method=JaxGT.node_embeddings)
    ref_scores = np.asarray(jm.apply(params, ref_emb, src, dst,
                                     method=JaxGT.score_pairs))

    model = GraphTransformer(hidden=32, embed=16, layers=2, heads=4,
                             chunk=CHUNK, attention=attention, dtype=tdt)
    model.load_state_dict(gat_state_dict_from_flax(params))
    with torch.no_grad():
        emb = model.node_embeddings(*map(torch.from_numpy, (feats, nbr, val)))
        scores = model.score_pairs(emb, torch.from_numpy(src),
                                   torch.from_numpy(dst))
        head_only = model.score_pairs(
            torch.from_numpy(np.array(ref_emb, np.float32)).to(tdt),
            torch.from_numpy(src), torch.from_numpy(dst))
    assert emb.dtype == tdt and scores.dtype == torch.float32
    np.testing.assert_allclose(emb.float().numpy(),
                               np.asarray(ref_emb, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(scores.numpy(), ref_scores, rtol=tol, atol=tol)
    # The head alone on identical embeddings is f32-tight in both dtypes
    # up to its one bf16 hidden layer.
    np.testing.assert_allclose(head_only.numpy(), ref_scores,
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_mlp_matches_flax(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x = np.random.default_rng(1).standard_normal(
        (64, FEATURE_DIM)).astype(np.float32)
    jm = JaxMLP(dtype=jdt)
    params = jm.init(jax.random.key(1), x)
    ref = np.asarray(jm.apply(params, x))
    model = MLPBandwidthPredictor(dtype=tdt)
    model.load_state_dict(mlp_state_dict_from_flax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)


def test_feature_dim_matches_scoring_layout():
    from dragonfly2_tpu.scheduler.evaluator.scoring import (
        FEATURE_DIM as JAX_FEATURE_DIM,
    )

    assert FEATURE_DIM == JAX_FEATURE_DIM


def _assert_tree_equal(a, b):
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], dict):
            _assert_tree_equal(a[key], b[key])
        else:
            np.testing.assert_array_equal(np.asarray(a[key]),
                                          np.asarray(b[key]))


def test_state_dict_round_trips(graph):
    feats, nbr, val, src, dst = graph
    jm = JaxGT(hidden=32, embed=16, layers=2, heads=4, chunk=CHUNK)
    params = jax.device_get(
        jm.init(jax.random.key(2), feats, nbr, val, src[:2], dst[:2]))
    state = gat_state_dict_from_flax(params)
    model = GraphTransformer(hidden=32, embed=16, layers=2, heads=4)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    _assert_tree_equal(flax_from_gat_state_dict(model.state_dict()),
                       params["params"])

    mlp = MLPBandwidthPredictor(generator=torch.Generator().manual_seed(3))
    back = mlp_state_dict_from_flax(flax_from_mlp_state_dict(mlp.state_dict()))
    assert set(back) == set(mlp.state_dict())
    for key, value in mlp.state_dict().items():
        assert torch.equal(back[key], value)


def test_ring_mode_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GraphTransformer(hidden=32, embed=16, layers=1, heads=4,
                         attention="ring")


def test_seeded_init_is_deterministic():
    def make():
        return GraphTransformer(hidden=32, embed=16, layers=2, heads=4,
                                generator=torch.Generator().manual_seed(7))

    a, b = make().state_dict(), make().state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
