"""Port parity for GraphSAGE training (BASELINE config #2): the port's
counter hash, on-device and host sampling, CSR, model, gradients, one
optimizer step, whole ``train_gnn`` runs and the ``gnn`` artifact against
the JAX package's, on the JAX tests' graph
(``SyntheticCluster(n_hosts=100, seed=0).probe_graph(10000)``).

Tolerances: the hash, both samplers and the CSR are integer or copied
float work — bit-equal. Logits from one flax init: f32 1e-5 (summation
order), bf16 3e-2 (bf16 rounding at other places in the two frameworks),
each the max-abs error over the max |logit|. Gradients of the loss on one
batch, per leaf over that leaf's max: f32 1e-4, bf16 6e-2. One AdamW step
in f32: 1e-5. A whole run: the JAX test's quality bar
(tests/test_train_gnn.py: F1 > 0.9, precision and recall > 0.85, last
epoch loss < 0.3) and F1 within 0.05 of the JAX trainer's on the same
graph and config; on the host path, whose batches are bit-identical to
the JAX trainer's, the per-epoch losses from one flax init within 1e-2
(bf16 drift). Measured: logits f32 1.1e-6, bf16 0 (equal); gradients f32
4.1e-7, bf16 2.2e-2 (JAX's own bf16 gradients sit 7.2e-2 from its f32
ones); both paths F1 1.0 as JAX's; host-path losses 6.0e-4 apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dragonfly2_tpu.data import SyntheticCluster as JaxCluster
from dragonfly2_tpu.data.features import Graph as JaxGraph
from dragonfly2_tpu.data.graph_sampler import CSRGraph as JaxCSR
from dragonfly2_tpu.data.graph_sampler import (
    EdgeBatchSampler as JaxSampler,
)
from dragonfly2_tpu.models.graphsage import GraphSAGE as JaxSAGE
from dragonfly2_tpu.parallel import data_parallel_mesh
from dragonfly2_tpu.train import GNNTrainConfig as JaxConfig
from dragonfly2_tpu.train import fused_sampling as jax_fs
from dragonfly2_tpu.train import train_gnn as jax_train_gnn
from dragonfly2_tpu.train.checkpoint import gnn_tree as jax_gnn_tree
from dragonfly2_tpu_torch.data import SyntheticCluster
from dragonfly2_tpu_torch.data.features import Graph
from dragonfly2_tpu_torch.data.graph_sampler import CSRGraph, EdgeBatchSampler
from dragonfly2_tpu_torch.data.prefetch import prefetch
from dragonfly2_tpu_torch.models.graphsage import GraphSAGE, masked_mean
from dragonfly2_tpu_torch.train import fused_sampling as fs
from dragonfly2_tpu_torch.train.checkpoint import (
    ModelMetadata,
    flax_from_gnn_state_dict,
    gnn_artifact_from_result,
    gnn_model_from_artifact,
    gnn_state_dict_from_flax,
    load_artifact,
    write_artifact,
)
from dragonfly2_tpu_torch.train.gnn_trainer import (
    GNNTrainConfig,
    GNNTrainer,
    train_gnn,
)
from dragonfly2_tpu_torch.train.split import edge_split

LOGIT_TOL = {"f32": 1e-5, "bf16": 3e-2}
GRAD_TOL = {"f32": 1e-4, "bf16": 6e-2}
ADAMW_TOL = 1e-5
F1_ATOL = 0.05
HOST_LOSS_ATOL = 1e-2
HIDDEN, EMBED = 32, 16
FANOUTS = (4, 3)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SALTS = (0, 7, 2**31, 2**32 - 1)


@pytest.fixture(scope="module")
def graphs():
    return (JaxCluster(n_hosts=100, seed=0).probe_graph(10000),
            SyntheticCluster(n_hosts=100, seed=0).probe_graph(10000))


def _drop_out_edges(g, graph_cls, node):
    keep = g.edge_src != node
    return graph_cls(g.node_ids, g.node_features, g.edge_src[keep],
                     g.edge_dst[keep], g.edge_rtt_ns[keep])


@pytest.fixture(scope="module")
def tables(graphs):
    """(JAX device tables, the port's on the CPU, the port's CSR) of the
    graph with the last node's out-edges removed: its CSR offset is E,
    the out-of-bounds trap."""
    jg, tg = graphs
    last = tg.n_nodes - 1
    jcsr = JaxCSR.from_graph(_drop_out_edges(jg, JaxGraph, last))
    tcsr = CSRGraph.from_graph(_drop_out_edges(tg, Graph, last))
    mesh = data_parallel_mesh(jax.devices()[:1])
    return jax_fs.put_graph_tables(jcsr, mesh), fs.put_graph_tables(
        tcsr, "cpu"), tcsr


# -- the counter hash and on-device sampling --------------------------------

@pytest.mark.parametrize("salt", SALTS)
@pytest.mark.parametrize("shape", [(37,), (5, 7), (3, 2, 10), (4, 2, 10, 5)])
def test_hashed_bits_bit_identical(shape, salt):
    ref = np.asarray(jax.jit(lambda s: jax_fs._hashed_bits(s, shape))(
        np.uint32(salt)))
    got = fs._hashed_bits(salt, shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("salt", SALTS)
def test_sample_neighbors_bit_identical(tables, salt):
    jt, tt, tcsr = tables
    last = tcsr.n_nodes - 1
    assert tcsr.indptr[last] == tcsr.indptr[-1]  # zero degree, offset E
    nodes = np.random.default_rng(salt % 97).integers(
        0, tcsr.n_nodes, (6, 2)).astype(np.int32)
    nodes[-1] = [last, last]
    ref = jax.jit(lambda n, s: jax_fs.sample_neighbors(jt, n, 7, s))(
        jnp.asarray(nodes), np.uint32(salt))
    got = fs.sample_neighbors(tt, torch.from_numpy(nodes), 7, salt)
    for g, r, dtype in zip(got, ref, (torch.int32, torch.float32,
                                      torch.float32)):
        assert g.dtype == dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert float(got[2][-1].sum()) == 0 and int(got[0][-1].sum()) == 0


def _jax_sample_indices(jt, src, dst, salts, fanouts):
    """The sampling half of JAX's ``sample_and_apply`` for given salts."""
    f1, f2 = fanouts
    centers = jnp.stack([src, dst], axis=-1)
    nbr1, rtt1, mask1 = jax_fs.sample_neighbors(jt, centers, f1, salts[0])
    nbr2, rtt2, mask2 = jax_fs.sample_neighbors(jt, nbr1, f2, salts[1])
    mask2 = mask2 * mask1[..., None]
    return centers, nbr1, rtt1, mask1, nbr2, rtt2 * mask2, mask2


def _edges(tcsr, n, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, tcsr.n_nodes, n).astype(np.int32)
    dst = rng.integers(0, tcsr.n_nodes, n).astype(np.int32)
    src[0] = dst[-1] = tcsr.n_nodes - 1   # the zero-degree last node
    return src, dst


@pytest.mark.parametrize("salts", [(0, 7), (2**31, 2**32 - 1), (12345, 1)])
def test_sample_indices_bit_identical(tables, salts):
    jt, tt, tcsr = tables
    src, dst = _edges(tcsr, 64, salts[0] % 101)
    ref = jax.jit(lambda a, b, s1, s2: _jax_sample_indices(
        jt, a, b, (s1, s2), (10, 5)))(
        jnp.asarray(src), jnp.asarray(dst), np.uint32(salts[0]),
        np.uint32(salts[1]))
    got = fs.sample_indices(tt, torch.from_numpy(src), torch.from_numpy(dst),
                            salts, (10, 5))
    assert [tuple(g.shape) for g in got] == [
        (64, 2), (64, 2, 10), (64, 2, 10), (64, 2, 10),
        (64, 2, 10, 5), (64, 2, 10, 5), (64, 2, 10, 5)]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # The zero-degree centre pads its whole 1-hop and 2-hop tree.
    assert float(got[3][0, 0].sum()) == 0 and float(got[6][0, 0].sum()) == 0


def _jax_params(dtype, fanouts=FANOUTS, seed=0):
    jg = JaxCluster(n_hosts=100, seed=0).probe_graph(10000)
    csr = JaxCSR.from_graph(jg)
    batch = JaxSampler(csr, jg.edge_src, jg.edge_dst, jg.edge_labels(),
                       fanouts).sample(np.zeros(2, np.int64),
                                       np.random.default_rng(0))
    return JaxSAGE(hidden=HIDDEN, embed=EMBED, dtype=dtype).init(
        jax.random.key(seed), *map(jnp.asarray, batch.astuple()[:-1]))


def _port_model(params, dtype):
    model = GraphSAGE(hidden=HIDDEN, embed=EMBED, dtype=dtype)
    model.load_state_dict(gnn_state_dict_from_flax(jax.device_get(params)))
    return model


def test_sample_and_apply_logits_match_jax(tables):
    """JAX's ``sample_and_apply`` (threefry salts from a key) against the
    port's given the same two salts, f32, one flax init: equal logits
    mean the same neighborhoods were drawn."""
    jt, tt, tcsr = tables
    src, dst = _edges(tcsr, 128, 5)
    params = _jax_params(jnp.float32, (10, 5))
    key = jax.random.key(11)
    ref = np.asarray(jax.jit(lambda p, a, b: jax_fs.sample_and_apply(
        JaxSAGE(hidden=HIDDEN, embed=EMBED, dtype=jnp.float32), p, jt, a, b,
        key, (10, 5)))(params, jnp.asarray(src), jnp.asarray(dst)))
    k1, k2 = jax.random.split(key)
    salts = tuple(int(jax.random.bits(k, (), jnp.uint32)) for k in (k1, k2))
    with torch.no_grad():
        got = fs.sample_and_apply(_port_model(params, torch.float32), tt,
                                  torch.from_numpy(src),
                                  torch.from_numpy(dst), salts, (10, 5))
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert err <= LOGIT_TOL["f32"], err


def test_hashed_bits_uniform():
    bits = fs._hashed_bits(123, (1 << 16,)).numpy()
    counts = np.bincount(bits % 8, minlength=8) / len(bits)
    assert np.all(np.abs(counts - 1 / 8) < 0.05 / 8 + 0.01)
    assert (bits == fs._hashed_bits(124, (1 << 16,)).numpy()).mean() < 0.01


def test_gather_features_one_launch(tables, monkeypatch):
    """Centres, 1-hop and 2-hop rows come from ONE table_gather call on
    the concatenated int32 ids, and equal numpy's row gather."""
    _, tt, tcsr = tables
    calls = []
    real = fs.table_gather
    monkeypatch.setattr(fs, "table_gather", lambda t, i: calls.append(
        (i.dtype, tuple(i.shape))) or real(t, i))
    src, dst = _edges(tcsr, 16, 3)
    ids = fs.sample_indices(tt, torch.from_numpy(src), torch.from_numpy(dst),
                            (1, 2), (10, 5))
    feats = fs.gather_features(tt.node_features, ids[0], ids[1], ids[4])
    assert calls == [(torch.int32, (16 * 2 * (1 + 10 + 50),))]
    for f, i in zip(feats, (ids[0], ids[1], ids[4])):
        np.testing.assert_array_equal(f.numpy(),
                                      tcsr.node_features[i.numpy()])


# -- host sampling ----------------------------------------------------------

def test_csr_bit_identical(graphs):
    jg, tg = graphs
    ours, ref = CSRGraph.from_graph(tg), JaxCSR.from_graph(jg)
    for name in ("indptr", "indices", "edge_rtt", "node_features"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3, 9])
def test_host_sampler_bit_identical(graphs, seed):
    jg, tg = graphs
    labels = tg.edge_labels()
    ours = EdgeBatchSampler(CSRGraph.from_graph(tg), tg.edge_src, tg.edge_dst,
                            labels, (10, 5))
    ref = JaxSampler(JaxCSR.from_graph(jg), jg.edge_src, jg.edge_dst,
                     jg.edge_labels(), (10, 5))
    ids = np.random.default_rng(seed).permutation(tg.n_edges)[:96]
    for a, b in zip(ours.sample_indices(ids, np.random.default_rng(seed)
                                        ).astuple(),
                    ref.sample_indices(ids, np.random.default_rng(seed)
                                       ).astuple()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ours.sample(ids, np.random.default_rng(seed)).astuple(),
                    ref.sample(ids, np.random.default_rng(seed)).astuple()):
        np.testing.assert_array_equal(a, b)


def test_host_sampler_pads_zero_degree_and_empty_graph(graphs):
    _, tg = graphs
    last = tg.n_nodes - 1
    csr = CSRGraph.from_graph(_drop_out_edges(tg, Graph, last))
    nbr, rtt, mask = csr.sample_neighbors(np.array([last]), 5,
                                          np.random.default_rng(0))
    assert mask.sum() == 0 and nbr.sum() == 0 and rtt.sum() == 0
    empty = CSRGraph.from_graph(Graph(
        np.array(["a", "b"]), np.zeros((2, 8), np.float32),
        np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, np.int64)))
    nbr, _, mask = empty.sample_neighbors(np.array([0, 1]), 3,
                                          np.random.default_rng(0))
    assert mask.sum() == 0 and nbr.shape == (2, 3)


def test_prefetch_order_break_and_errors():
    assert list(prefetch(range(50), lambda i: i * i, depth=3, workers=4)) == [
        i * i for i in range(50)]
    seen = []
    stream = prefetch(range(1000), lambda i: seen.append(i) or i, depth=2,
                      workers=2)
    for v in stream:
        if v >= 5:
            stream.close()
            break
    assert len(seen) < 20

    def boom(i):
        if i == 3:
            raise RuntimeError("sampler died")
        return i

    with pytest.raises(RuntimeError, match="sampler died"):
        list(prefetch(range(10), boom, depth=2, workers=2))
    with pytest.raises(ValueError):
        list(prefetch(range(3), lambda i: i, depth=0))


# -- the model, its gradients and one optimizer step ------------------------

def _host_batch(graphs, n=64, seed=1):
    jg, tg = graphs
    sampler = EdgeBatchSampler(CSRGraph.from_graph(tg), tg.edge_src,
                               tg.edge_dst, tg.edge_labels(20_000_000),
                               FANOUTS)
    ids = np.random.default_rng(seed).permutation(tg.n_edges)[:n]
    return sampler.sample(ids, np.random.default_rng(seed)).astuple()


def test_masked_mean_promotes_to_f32():
    x = torch.randn(3, 4, 5).to(torch.bfloat16)
    mask = torch.tensor([[1, 1, 0, 0], [0, 0, 0, 0], [1, 0, 1, 1]],
                        dtype=torch.float32)
    out = masked_mean(x, mask)
    assert out.dtype == torch.float32
    assert torch.equal(out[1], torch.zeros(5))
    torch.testing.assert_close(out[0], x[0, :2].float().mean(0))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_logits_match_jax(graphs, dtype):
    jdt, tdt = DTYPES[dtype]
    params = _jax_params(jdt)
    *inputs, _ = _host_batch(graphs)
    ref = np.asarray(JaxSAGE(hidden=HIDDEN, embed=EMBED, dtype=jdt).apply(
        params, *map(jnp.asarray, inputs)))
    with torch.no_grad():
        got = _port_model(params, tdt)(*map(torch.from_numpy, inputs))
    assert got.dtype == torch.float32 and got.shape == (64,)
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert err <= LOGIT_TOL[dtype], err


def test_flax_tree_layout():
    params = jax.device_get(_jax_params(jnp.float32))["params"]
    assert tuple(params["SageLayer_0"]["Dense_0"]["kernel"].shape) == (
        18, HIDDEN)
    assert tuple(params["SageLayer_1"]["Dense_0"]["kernel"].shape) == (
        2 * HIDDEN, EMBED)
    assert tuple(params["Dense_0"]["kernel"].shape) == (4 * EMBED, HIDDEN)
    assert tuple(params["Dense_1"]["kernel"].shape) == (HIDDEN, 1)
    model = GraphSAGE(hidden=HIDDEN, embed=EMBED,
                      generator=torch.Generator().manual_seed(0))
    back = flax_from_gnn_state_dict(model.state_dict())
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape, path
    # flax's init: lecun-normal kernels (std √(1/fan_in)), zero biases.
    w = back["SageLayer_1"]["Dense_0"]["kernel"]
    assert abs(w.std() * np.sqrt(2 * HIDDEN) - 1) < 0.1
    assert all(not np.any(layer.get("bias", np.zeros(1)))
               for layer in (back["Dense_0"], back["Dense_1"]))


def _jax_loss(dtype):
    model = JaxSAGE(hidden=HIDDEN, embed=EMBED, dtype=dtype)

    def loss(params, inputs, labels):
        logits = model.apply(params, *inputs)
        return optax.sigmoid_binary_cross_entropy(logits, labels).mean()

    return loss


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gradients_match_jax(graphs, dtype):
    jdt, tdt = DTYPES[dtype]
    params = _jax_params(jdt)
    *inputs, labels = _host_batch(graphs)
    ref = jax.device_get(jax.grad(_jax_loss(jdt))(
        params, tuple(map(jnp.asarray, inputs)), jnp.asarray(labels)))
    model = _port_model(params, tdt)
    torch.nn.functional.binary_cross_entropy_with_logits(
        model(*map(torch.from_numpy, inputs)),
        torch.from_numpy(labels)).backward()
    got = flax_from_gnn_state_dict({k: p.grad for k, p in
                                    model.named_parameters()})
    ref_leaves = dict(jax.tree_util.tree_leaves_with_path(ref["params"]))
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(got_leaves) == len(ref_leaves) == 8
    for path, r in ref_leaves.items():
        g = got_leaves[path]
        err = np.abs(g - r).max() / np.abs(r).max()
        assert err <= GRAD_TOL[dtype], (path, err)


def test_one_adamw_step_matches_optax(graphs):
    params = _jax_params(jnp.float32)
    *inputs, labels = _host_batch(graphs)
    lr = 1e-2
    tx = optax.adamw(lr, weight_decay=1e-4)
    grads = jax.grad(_jax_loss(jnp.float32))(
        params, tuple(map(jnp.asarray, inputs)), jnp.asarray(labels))
    updates, _ = tx.update(grads, tx.init(params), params)
    ref = jax.device_get(optax.apply_updates(params, updates))["params"]
    model = _port_model(params, torch.float32)
    opt = torch.optim.AdamW(model.parameters(), lr=0.0, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    t_in = tuple(map(torch.from_numpy, inputs))
    loss = fs.train_step(opt, lambda: (model(*t_in),
                                       torch.from_numpy(labels)), lr)
    assert loss.shape == ()
    got = flax_from_gnn_state_dict(model.state_dict())
    for (path, g), r in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(g, r, rtol=ADAMW_TOL, atol=ADAMW_TOL,
                                   err_msg=str(path))


# -- whole runs ----------------------------------------------------------------

def _flax_init_state(cfg, dtype=jnp.bfloat16):
    """The JAX trainer's flax init (seed, fanouts of ``cfg``) as a port
    state dict."""
    jg = JaxCluster(n_hosts=100, seed=0).probe_graph(10000)
    sampler = JaxSampler(JaxCSR.from_graph(jg), jg.edge_src, jg.edge_dst,
                         jg.edge_labels(), cfg["fanouts"])
    dummy = sampler.sample(np.zeros(2, np.int64), np.random.default_rng(0))
    params = JaxSAGE(hidden=cfg["hidden"], embed=cfg["embed"]).init(
        jax.random.key(cfg.get("seed", 0)),
        *map(jnp.asarray, dummy.astuple()[:-1]))
    return gnn_state_dict_from_flax(jax.device_get(params))


# The JAX test's run (tests/test_train_gnn.py::test_learns_topology).
RUN_CFG = dict(hidden=HIDDEN, embed=EMBED, fanouts=(10, 5), batch_size=512,
               epochs=10, learning_rate=1e-2)


@pytest.fixture(scope="module", params=["device", "host"])
def runs(request, graphs):
    """(path, the JAX trainer's result, the port's from the same flax
    init) on one device each."""
    jg, tg = graphs
    cfg = dict(RUN_CFG, device_sample=request.param == "device")
    ref = jax_train_gnn(jg, JaxConfig(**cfg),
                        data_parallel_mesh(jax.devices()[:1]))
    ours = train_gnn(tg, GNNTrainConfig(**cfg), device="cpu",
                     init_state=_flax_init_state(cfg))
    return request.param, ref, ours


def test_train_gnn_reaches_jax_bar(runs):
    path, ref, got = runs
    assert got.f1 > 0.9, (path, got.f1)
    assert got.precision > 0.85 and got.recall > 0.85
    assert got.history[-1] < 0.3
    assert len(got.history) == len(ref.history) == RUN_CFG["epochs"]
    assert got.history[-1] < got.history[0]
    assert abs(got.f1 - ref.f1) <= F1_ATOL, (path, got.f1, ref.f1)
    if path == "host":
        np.testing.assert_allclose(got.history, ref.history,
                                   atol=HOST_LOSS_ATOL)
    assert got.samples_per_sec > 0 and got.steps == ref.steps
    np.testing.assert_array_equal(got.node_features, ref.node_features)


def test_seeded_init_trains(graphs):
    """The port's own lecun-normal init (no JAX tree) clears the bar."""
    _, tg = graphs
    got = train_gnn(tg, GNNTrainConfig(**RUN_CFG), device="cpu")
    assert got.f1 > 0.9 and got.history[-1] < 0.3


@pytest.mark.parametrize("device_sample", [True, False])
def test_steps_per_call_keeps_trajectory(graphs, device_sample):
    _, tg = graphs
    cfg = dict(hidden=8, embed=4, batch_size=1024, epochs=2,
               device_sample=device_sample)
    one = train_gnn(tg, GNNTrainConfig(**cfg), device="cpu")
    four = train_gnn(tg, GNNTrainConfig(**cfg, steps_per_call=4),
                     device="cpu")
    assert one.step_losses == four.step_losses
    spe = len(one.step_losses) // 2
    assert one.steps == 2 * spe and four.steps == 2 * -(-spe // 4)
    for key, value in one.state_dict.items():
        assert torch.equal(value, four.state_dict[key]), key


def test_one_gather_per_forward(graphs, monkeypatch):
    """Every forward (train steps and eval chunks) gathers its feature
    rows in one table_gather call."""
    _, tg = graphs
    calls = []
    real = fs.table_gather
    monkeypatch.setattr(fs, "table_gather",
                        lambda t, i: calls.append(i.dtype) or real(t, i))
    trainer = GNNTrainer(tg, GNNTrainConfig(hidden=8, embed=4,
                                            batch_size=1024, epochs=1),
                         device="cpu")
    result = trainer.fit()
    chunks = -(-len(trainer.eval_ids) // trainer.batch)
    assert len(calls) == len(result.step_losses) + chunks
    assert set(calls) == {torch.int32}


def test_time_budget(graphs):
    _, tg = graphs
    res = train_gnn(tg, GNNTrainConfig(hidden=16, embed=8, batch_size=256,
                                       epochs=50, max_seconds=0.5),
                    device="cpu")
    assert 1 <= res.steps < 50 * (tg.n_edges * 9 // 10 // 256)
    assert res.compile_seconds > 0 and res.samples_per_sec > 0
    assert len(res.step_losses) == res.steps and 0.0 <= res.f1 <= 1.0


def test_too_few_edges_raises():
    g = SyntheticCluster(n_hosts=10, seed=0).probe_graph(4)
    with pytest.raises(ValueError, match="can't fill"):
        train_gnn(g, GNNTrainConfig(eval_fraction=1.0), device="cpu")


def test_default_device_is_the_card(graphs, monkeypatch):
    """No fallback: without a card, train_gnn(device=None) raises."""
    _, tg = graphs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_gnn(tg, GNNTrainConfig(hidden=8, embed=4, epochs=1))


def test_artifact_loader_defaults_to_the_card(runs, monkeypatch):
    """No fallback: without a card, gnn_model_from_artifact(device=None)
    raises."""
    _, _, got = runs
    artifact = gnn_artifact_from_result(got, "gnn-test")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gnn_model_from_artifact(artifact)


def test_pair_level_split_no_leak(graphs):
    _, tg = graphs
    train_ids, eval_ids = edge_split(tg, 0.2, seed=0)
    assert len(train_ids) + len(eval_ids) == tg.n_edges
    train_pairs = set(zip(tg.edge_src[train_ids], tg.edge_dst[train_ids]))
    eval_pairs = set(zip(tg.edge_src[eval_ids], tg.edge_dst[eval_ids]))
    assert not train_pairs & eval_pairs


# -- the gnn artifact ----------------------------------------------------------

def test_trained_artifact_round_trips(runs, graphs):
    _, _, got = runs
    artifact = gnn_artifact_from_result(got, "gnn-test", n_samples=10000)
    tree, metadata = load_artifact(artifact)
    assert metadata.model_type == "gnn"
    assert metadata.evaluation == {"precision": got.precision,
                                   "recall": got.recall, "f1": got.f1,
                                   "n_samples": 10000}
    assert metadata.config == {"hidden": HIDDEN, "embed": EMBED,
                               "fanouts": [10, 5]}
    model, nf, _ = gnn_model_from_artifact(artifact, device="cpu")
    np.testing.assert_array_equal(nf, got.node_features)
    *inputs, _ = _host_batch(graphs, seed=4)
    t_in = tuple(map(torch.from_numpy, inputs))
    with torch.no_grad():
        assert torch.equal(model(*t_in), got.model(*t_in))


def test_jax_trained_artifact_loads(runs, graphs):
    """A JAX-trained params tree written as a port artifact gives JAX's
    logits on the port."""
    jg, _ = graphs
    _, ref, _ = runs
    params = jax.device_get(ref.params)
    artifact = write_artifact(
        jax_gnn_tree(params, ref.node_features),
        ModelMetadata(model_id="jax-gnn", model_type="gnn",
                      config={"hidden": HIDDEN, "embed": EMBED,
                              "fanouts": [10, 5]}))
    model, nf, _ = gnn_model_from_artifact(artifact, device="cpu")
    np.testing.assert_array_equal(nf, ref.node_features)
    sampler = JaxSampler(JaxCSR.from_graph(jg), jg.edge_src, jg.edge_dst,
                         jg.edge_labels(), (10, 5))
    batch = sampler.sample(np.arange(48), np.random.default_rng(0)).astuple()
    want = np.asarray(ref.model.apply(params, *map(jnp.asarray, batch[:-1])))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, batch[:-1])).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= LOGIT_TOL["bf16"], err


def test_artifact_of_other_type_refused(runs):
    _, _, got = runs
    artifact = write_artifact({"params": flax_from_gnn_state_dict(
        got.state_dict), "node_features": got.node_features},
        ModelMetadata(model_id="x", model_type="mlp"))
    with pytest.raises(ValueError, match="gnn"):
        gnn_model_from_artifact(artifact, device="cpu")
