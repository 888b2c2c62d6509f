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
import optax
import pytest
import torch
import torch.nn.functional as F

from dragonfly2_tpu.models.graph_transformer import GraphTransformer as JaxGT
from dragonfly2_tpu.models.graph_transformer import (
    build_inverse_index as jax_build_inverse_index,
)
from dragonfly2_tpu.models.mlp import MLPBandwidthPredictor as JaxMLP
from dragonfly2_tpu_torch.data import SyntheticCluster
from dragonfly2_tpu_torch.models.graph_transformer import (
    PAD_ID,
    GraphTransformer,
    build_inverse_index,
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
# One-step parameter gradients, each leaf's max |error| over its max
# |grad| (floored at 1e-3 of the largest leaf's, since the key bias's true
# gradient is 0 — softmax ignores a per-row shift — and both sides hold
# rounding noise there). The port in f32 against flax in f32: 1e-4
# (measured worst 3.2e-5). The port in bf16 against flax in f32, the
# exact reference: 6e-2 (measured 2.0e-2). The port in bf16 against flax
# in bf16: 0.2, because flax's own bf16 gradients sit 16% (measured) from
# its f32 ones on this case, while the port's sit 2% from them
# (measured 0.14 between the two bf16 sets).
GRAD_TOL = {"f32": 1e-4, "bf16": 6e-2}
GRAD_BF16_VS_BF16_TOL = 0.2
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


def test_build_inverse_index_bit_equal(graph):
    _, nbr, _, _, _ = graph
    rng = np.random.default_rng(4)
    ragged = rng.integers(0, 30, (30, 9)).astype(np.int32)
    ragged[rng.random((30, 9)) < 0.3] = PAD_ID
    ragged[5] = PAD_ID                    # a row that lists nobody
    for case in (nbr, ragged, np.full((4, 3), PAD_ID, np.int32)):
        ours, ref = build_inverse_index(case), jax_build_inverse_index(case)
        assert ours.dtype == ref.dtype == np.int64
        np.testing.assert_array_equal(ours, ref)


def _flax_grads(attention, jdt, params, graph, y, inv):
    feats, nbr, val, src, dst = graph
    jm = JaxGT(hidden=32, embed=16, layers=2, heads=4, chunk=CHUNK,
               attention=attention, dtype=jdt)

    def loss_fn(p):
        logits = jm.apply(p, feats, nbr, val, src, dst, inv=inv)
        return optax.sigmoid_binary_cross_entropy(logits, y).mean()

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), gat_state_dict_from_flax(jax.device_get(grads))


def _assert_grads_close(model, ref_grads, tol):
    floor = 1e-3 * max(float(g.abs().max()) for g in ref_grads.values())
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        ref = ref_grads[name]
        err = float((p.grad - ref).abs().max())
        assert err <= tol * max(float(ref.abs().max()), floor), (name, err)


@pytest.mark.parametrize("attention,dtype", [("gather", "f32"),
                                             ("gather", "bf16"),
                                             ("blocks", "f32")])
def test_one_step_grads_match_flax(graph, attention, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    feats, nbr, val, src, dst = graph
    y = (np.random.default_rng(5).random(len(src)) < 0.4).astype(np.float32)
    inv = build_inverse_index(nbr) if attention == "gather" else None
    params = JaxGT(hidden=32, embed=16, layers=2, heads=4, chunk=CHUNK,
                   attention=attention).init(
        jax.random.key(3), feats, nbr, val, src[:2], dst[:2])
    ref_loss, ref_grads = _flax_grads(attention, jnp.float32, params, graph,
                                      y, inv)

    model = GraphTransformer(hidden=32, embed=16, layers=2, heads=4,
                             chunk=CHUNK, attention=attention, dtype=tdt)
    model.load_state_dict(gat_state_dict_from_flax(params))
    args = [torch.from_numpy(a) for a in (feats, nbr, val, src, dst)]
    logits = model(*args, inv=None if inv is None else torch.from_numpy(inv))
    loss = F.binary_cross_entropy_with_logits(logits, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=GRAD_TOL[dtype])
    _assert_grads_close(model, ref_grads, GRAD_TOL[dtype])
    if dtype == "bf16":
        _, bf16_grads = _flax_grads(attention, jdt, params, graph, y, inv)
        _assert_grads_close(model, bf16_grads, GRAD_BF16_VS_BF16_TOL)
