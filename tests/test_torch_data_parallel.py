"""Port parity for data-parallel training: the port's trainers in gloo
worlds of 2 and 4 ranks (one process a rank, on the CPU) against the
JAX trainers on a data-parallel mesh of as many virtual CPU devices, and
against the port in a world of one.

Every trainer starts from the JAX trainer's flax init; GraphSAGE on the
device path takes the JAX trainer's salts (threefry's, derived here), so
both sample the same neighborhoods. The problems are tiny
(``torch_dp_worker``: 48 hosts, 2000 probes, 4000 pair examples; hidden
≤ 16; two epochs of two steps), and the GraphSAGE, MLP and cost batches
are 1 more than a multiple of 4: both packages round them down to a
multiple of the world, the same for 2 and 4 ranks, which the world of
one then takes.

Tolerances.
- Against the JAX trainer on the same mesh: the world-of-one parity
  tests' own limits (``test_torch_graphsage.py``: per-epoch losses 1e-2
  on the host path, bf16 drift; ``test_torch_mlp_train.py``: losses
  1e-2, MSE/MAE 5e-2 relative; ``test_torch_train.py``: losses 5e-2, F1
  0.1); GraphSAGE's device path samples the same neighborhoods as the
  host path and takes the host path's limits.
- Against the port's world of one, both in f32 compute (the point is
  the algorithm): the ranks compute the same function in another
  reduction order (each rank's mean over its share, then the mean of
  the means), so losses agree to LOSS_WORLD and parameters to
  PARAM_WORLD (absolute; measured worst 7.2e-7 on the GraphTransformer),
  eval F1 to F1_WORLD (one edge of the 214 moves it by ~0.005) and MAE
  relatively to 1e-4. The GraphTransformer's ranks hold their rows of
  the graph in every mode, as the JAX trainer shards them over its data
  axis (each rank's queries against the all-gathered K/V, whose
  gradients the ranks then sum). Ring mode's ranks run another algorithm than the
  world of one's (the ring's einsums against K1's plain twin) and are
  held to the same limits (measured worst parameter gap 6.3e-7). In bf16 the shares' gradients round to bf16
  before the all-reduce adds them, and AdamW's first steps turn the
  2⁻⁸ rounding of a near-zero gradient into whole learning-rate steps
  (measured 1.5e-2 apart on the GraphTransformer): bf16 runs are held
  to the JAX trainer instead. The GraphTransformer's key biases
  (``blocks.<i>.Dense_1.bias``) are left out of the parameter check: a
  key bias adds one constant to a query's every score, which the
  softmax cancels, so their true gradient is 0 and AdamW moves them by
  whole steps of rounding noise in either world.
- Between the ranks of one world: bit-equal parameters and losses (one
  all-reduce, then the same update on the same bits).
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker as worker
from dragonfly2_tpu.data import SyntheticCluster as JaxCluster
from dragonfly2_tpu.data.graph_sampler import CSRGraph as JaxCSR
from dragonfly2_tpu.data.graph_sampler import EdgeBatchSampler as JaxSampler
from dragonfly2_tpu.models.graph_transformer import GraphTransformer as JaxGT
from dragonfly2_tpu.models.graph_transformer import (
    build_neighbor_lists as jax_build_neighbor_lists,
)
from dragonfly2_tpu.models.graph_transformer import (
    pad_graph_sparse as jax_pad_graph_sparse,
)
from dragonfly2_tpu.models.graphsage import GraphSAGE as JaxSAGE
from dragonfly2_tpu.models.mlp import MLPBandwidthPredictor as JaxMLP
from dragonfly2_tpu.parallel import data_parallel_mesh
from dragonfly2_tpu.train import cost_trainer as jax_cost
from dragonfly2_tpu.train import fused_sampling as jax_fs
from dragonfly2_tpu.train import gat_trainer as jax_gat
from dragonfly2_tpu.train import gnn_trainer as jax_gnn
from dragonfly2_tpu.train import mlp_trainer as jax_mlp
from dragonfly2_tpu.train.gnn_trainer import edge_split as jax_edge_split
from dragonfly2_tpu_torch.data.graph_sampler import CSRGraph
from dragonfly2_tpu_torch.data.pipeline import ArrayDataset
from dragonfly2_tpu_torch.parallel.mesh import global_batch
from dragonfly2_tpu_torch.train import fused_sampling as fs
from dragonfly2_tpu_torch.train.checkpoint import (
    flax_from_gat_state_dict,
    flax_from_gnn_state_dict,
    gat_state_dict_from_flax,
    gnn_state_dict_from_flax,
    mlp_state_dict_from_flax,
)
from dragonfly2_tpu_torch.train.split import edge_split
from torch_dist_worker import spawn_once

WORLDS = (2, 4)
SEED = 0
# (trainer, config): two epochs of two steps on every world.
CASES = {
    "gnn_device": ("gnn", dict(hidden=16, embed=8, fanouts=(4, 3),
                               batch_size=893, epochs=2, learning_rate=1e-2,
                               device_sample=True)),
    "gnn_host": ("gnn", dict(hidden=16, embed=8, fanouts=(4, 3),
                             batch_size=893, epochs=2, learning_rate=1e-2,
                             device_sample=False)),
    "mlp": ("mlp", dict(hidden=(16,), batch_size=1797, epochs=2,
                        learning_rate=1e-2)),
    "cost": ("cost", dict(hidden=(16, 8), batch_size=1697, epochs=2)),
    "gat_gather": ("gat", dict(hidden=16, embed=8, layers=2, heads=2,
                               edge_batch_size=888, epochs=2,
                               learning_rate=1e-2, attention="gather")),
    "gat_blocks": ("gat", dict(hidden=16, embed=8, layers=2, heads=2,
                               edge_batch_size=888, epochs=2,
                               learning_rate=1e-2, attention="blocks")),
    # Rows sharded over the ranks, K/V around the ring: 24 rows a rank
    # of 2 over 8-row chunks (48 rows), 12 a rank of 4 (padded to 64);
    # the world of one trains through K1's plain twin.
    "gat_ring": ("gat", dict(hidden=16, embed=8, layers=2, heads=2,
                             edge_batch_size=888, epochs=2,
                             learning_rate=1e-2, attention="ring", chunk=8)),
}
CASE_IDS = [f"{name}-{world}" for name in CASES for world in WORLDS]
LOSS_JAX = {"gnn": 1e-2, "mlp": 1e-2, "cost": 1e-2, "gat": 5e-2}
F1_JAX = 0.1
ERR_JAX_RTOL = 5e-2
LOSS_WORLD = 1e-5
PARAM_WORLD = 1e-5
F1_WORLD = 0.02
KEY_BIAS = re.compile(r"blocks\.\d+\.Dense_1\.bias")
# The federated clusters of test_federated_fit_stays_local, a rank each.
CLUSTERS = (0, 1)


def _batch_key(trainer):
    return "edge_batch_size" if trainer == "gat" else "batch_size"


def _rounded(config, trainer, world):
    """``config`` with its batch rounded for ``world`` (what a world of
    ``world`` trains on, given to a world of one)."""
    key = _batch_key(trainer)
    return dict(config, **{key: config[key] // world * world})


# -- the JAX side ------------------------------------------------------------


def _jax_graph():
    return JaxCluster(n_hosts=worker.N_HOSTS, seed=0).probe_graph(
        worker.N_PROBES)


def _gnn_init(cfg):
    jg = _jax_graph()
    sampler = JaxSampler(JaxCSR.from_graph(jg), jg.edge_src, jg.edge_dst,
                         jg.edge_labels(), cfg["fanouts"])
    dummy = sampler.sample(np.zeros(2, np.int64), np.random.default_rng(0))
    params = jax.jit(JaxSAGE(hidden=cfg["hidden"], embed=cfg["embed"]).init)(
        jax.random.key(SEED), *map(jnp.asarray, dummy.astuple()[:-1]))
    return gnn_state_dict_from_flax(jax.device_get(params))


def _gat_init(cfg):
    jg = _jax_graph()
    c = jax_gat.GATTrainConfig(**cfg)
    train_ids, _ = jax_edge_split(jg, c.eval_fraction, c.seed)
    nbr, val = jax_build_neighbor_lists(
        jg.n_nodes, jg.edge_src[train_ids], jg.edge_dst[train_ids],
        jg.edge_rtt_ns[train_ids], cap=c.neighbor_cap)
    feats, nbr, val, _ = jax_pad_graph_sparse(jg.node_features, nbr, val, 1)
    params = jax.jit(JaxGT(hidden=c.hidden, embed=c.embed, layers=c.layers,
                           heads=c.heads, chunk=c.chunk).init)(
        jax.random.key(c.seed), jnp.asarray(feats), jnp.asarray(nbr),
        jnp.asarray(val), jnp.zeros(2, jnp.int32), jnp.zeros(2, jnp.int32))
    return gat_state_dict_from_flax(jax.device_get(params))


def _mlp_init(cfg):
    params = JaxMLP(hidden=tuple(cfg["hidden"])).init(
        jax.random.key(SEED), jnp.zeros((1, 11)))
    return mlp_state_dict_from_flax(jax.device_get(params))


# The keys that shape a trainer's flax init (the attention mode and the
# sampling path do not).
MODEL_KEYS = {"gnn": ("hidden", "embed", "fanouts"),
              "gat": ("hidden", "embed", "layers", "heads"),
              "mlp": ("hidden",), "cost": ("hidden",)}


def _init(trainer, cfg):
    return _init_of(trainer, tuple(cfg[k] for k in MODEL_KEYS[trainer]))


@functools.lru_cache(maxsize=None)
def _init_of(trainer, shape):
    cfg = dict(zip(MODEL_KEYS[trainer], shape))
    fn = {"gnn": _gnn_init, "gat": _gat_init}.get(trainer, _mlp_init)
    return {k: v.detach().numpy() for k, v in fn(cfg).items()}


@functools.lru_cache(maxsize=None)
def _jax_salts(batch_size, epochs, world):
    """The JAX device path's two salts a step, then an eval chunk's:
    threefry bits of ``fold_in(key(seed + 1), i)``, split in two."""
    tg = worker.graph()
    train_ids, eval_ids = edge_split(tg, 0.1, SEED)
    batch = global_batch(batch_size, len(train_ids), world)
    n_steps = epochs * (len(train_ids) // batch)
    n_chunks = -(-len(eval_ids) // batch)
    base = jax.random.key(SEED + 1)

    def salts(i):
        k1, k2 = jax.random.split(jax.random.fold_in(base, i))
        return [int(jax.random.bits(k, (), jnp.uint32)) for k in (k1, k2)]

    return np.array([salts(i) for i in range(n_steps)]
                    + [salts(i) for i in range(n_chunks)], np.int64)


def _jax_run(name, world):
    """The JAX trainer's result on a ``world``-device mesh → (history,
    quality, port state dict)."""
    trainer, cfg = CASES[name]
    mesh = data_parallel_mesh(devices=jax.devices()[:world])
    if trainer == "gnn":
        res = jax_gnn.train_gnn(_jax_graph(), jax_gnn.GNNTrainConfig(**cfg),
                                mesh)
        return res.history, res.f1, gnn_state_dict_from_flax(res.params)
    if trainer == "gat":
        res = jax_gat.train_gat(_jax_graph(), jax_gat.GATTrainConfig(**cfg),
                                mesh)
        return res.history, res.f1, gat_state_dict_from_flax(res.params)
    if trainer == "mlp":
        X, y = worker.pairs()
        res = jax_mlp.train_mlp(X, y, jax_mlp.MLPTrainConfig(**cfg), mesh)
    else:
        X, y = worker.cost_pairs()
        res = jax_cost.train_cost(X, y, jax_cost.CostTrainConfig(**cfg), mesh)
    return res.history, res.mae, mlp_state_dict_from_flax(res.params)


# -- the port's side: every world at once, once a test run -----------------


def _case(name, world, f32=False):
    trainer, cfg = CASES[name]
    cfg = _rounded(cfg, trainer, world)
    case = {"call": "run_trainer", "trainer": trainer, "config": cfg,
            "init": _init(trainer, cfg), "f32": f32}
    if trainer == "gnn" and cfg["device_sample"]:
        case["salts"] = _jax_salts(cfg["batch_size"], cfg["epochs"], world)
    return case


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """``{world: {case: {key: per-rank arrays}}}`` of the port: each case
    in worlds of 2 and 4 in bf16 and in f32 (``case:f32``), and in f32 in
    a world of one at their rounded batch; the federated clusters in a
    world of two and of one; ``Training.train`` in a world of two and of
    one; a wall-clock budget on one rank of two. Only the worker that
    spawns the ranks builds their cases (``names`` lists them)."""
    def build():
        spec = {1: {}, 2: {}, 4: {}}
        for name, (trainer, cfg) in CASES.items():
            key = _batch_key(trainer)
            assert len({_rounded(cfg, trainer, w)[key]
                        for w in WORLDS}) == 1
            for world in WORLDS:
                spec[world][name] = _case(name, world)
                spec[world][f"{name}:f32"] = _case(name, world, f32=True)
            spec[1][name] = _case(name, WORLDS[0], f32=True)
        for world in (1, len(CLUSTERS)):
            spec[world]["fed"] = {"call": "run_federated_local",
                                  "clusters": list(CLUSTERS)}
        for world in (1, 2):
            spec[world]["training"] = {"call": "run_training"}
        spec[2]["budget"] = {"call": "run_budget"}
        assert {w: list(cases) for w, cases in spec.items()} == names
        return spec

    pair = [n for name in CASES for n in (name, f"{name}:f32")]
    names = {1: list(CASES) + ["fed", "training"],
             2: pair + ["fed", "training", "budget"], 4: pair}
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    root = (tmp_path_factory.getbasetemp().parent / f"dp-{run}" if run
            else tmp_path_factory.mktemp("dp"))
    return spawn_once(names, build, str(root), timeout_s=240.0)


def _params(result, rank=0):
    return {k.split("/", 1)[1]: v[rank] for k, v in result.items()
            if k.startswith("param/")}


@pytest.mark.parametrize("name,world", [(n, w) for n in CASES
                                        for w in WORLDS], ids=CASE_IDS)
def test_ranks_hold_the_same_parameters(worlds, name, world):
    """One all-reduce a step, then the same AdamW update on the same bits:
    every rank ends bit-equal, with the same losses and metrics, at the
    batch the JAX trainers round to."""
    for run in (name, f"{name}:f32"):
        got = worlds[world][run]
        assert len(got["history"]) == world
        for key, per_rank in got.items():
            for rank in range(1, world):
                np.testing.assert_array_equal(
                    per_rank[rank], per_rank[0],
                    err_msg=f"{run} {key} rank {rank}")
    trainer, cfg = CASES[name]
    if "batch" in got:
        n_train = (len(edge_split(worker.graph(), 0.1, SEED)[0])
                   if trainer in ("gnn", "gat") else
                   len(ArrayDataset(*worker.pairs()).split(0.1, SEED)[0]))
        want = (min(cfg[_batch_key(trainer)], n_train) // world) * world
        assert int(got["batch"][0]) == want


@pytest.mark.parametrize("name,world", [(n, w) for n in CASES
                                        for w in WORLDS], ids=CASE_IDS)
def test_port_world_matches_world_one(worlds, name, world):
    """A world of N trains the model a world of one trains (f32)."""
    got, one = worlds[world][f"{name}:f32"], worlds[1][name]
    losses, want = got["step_losses"][0], one["step_losses"][0]
    assert len(losses) == len(want) == 4
    np.testing.assert_allclose(losses, want, rtol=0, atol=LOSS_WORLD)
    ours, ref = _params(got), _params(one)
    assert ours.keys() == ref.keys()
    for key in ref:
        if KEY_BIAS.fullmatch(key):
            continue
        np.testing.assert_allclose(ours[key], ref[key], rtol=0,
                                   atol=PARAM_WORLD, err_msg=key)
    if "f1" in got:
        assert abs(float(got["f1"][0]) - float(one["f1"][0])) <= F1_WORLD
    else:
        np.testing.assert_allclose(got["mae"][0], one["mae"][0], rtol=1e-4)


@pytest.mark.parametrize("name,world", [(n, w) for n in CASES
                                        for w in WORLDS], ids=CASE_IDS)
def test_port_world_matches_jax_mesh(worlds, name, world):
    """The port in a world of N against the JAX trainer on an N-device
    data-parallel mesh, from the same init (and, on GraphSAGE's device
    path, the same salts)."""
    trainer, _ = CASES[name]
    got = worlds[world][name]
    history, quality, _ = _jax_run(name, world)
    assert len(got["history"][0]) == len(history) == 2
    np.testing.assert_allclose(got["history"][0], history, rtol=0,
                               atol=LOSS_JAX[trainer])
    if trainer in ("gnn", "gat"):
        assert abs(float(got["f1"][0]) - quality) <= F1_JAX
    else:
        np.testing.assert_allclose(got["mae"][0], quality,
                                   rtol=ERR_JAX_RTOL)


# -- sampling a rank's rows ------------------------------------------------


@pytest.mark.parametrize("world", [2, 3, 4, 8])
@pytest.mark.parametrize("salt", [0, 2**31 + 5, 2**32 - 1])
def test_hashed_bits_of_a_rank_slice_equal_jax(world, salt):
    """Each rank's slice of the counter hash, with its global offset, is
    bit-equal to its rows of the JAX hash over the global shape (and of
    the port's world of one): identical neighbors at any world size."""
    shape = (8 * world, 2, 5)
    ref = np.asarray(jax.jit(lambda s: jax_fs._hashed_bits(s, shape))(
        np.uint32(salt))).astype(np.int64)
    per_row = 2 * 5
    rows = []
    for rank in range(world):
        b = shape[0] // world
        rows.append(fs._hashed_bits(salt, (b, 2, 5),
                                    offset=rank * b * per_row).numpy())
    np.testing.assert_array_equal(np.concatenate(rows), ref)
    np.testing.assert_array_equal(fs._hashed_bits(salt, shape).numpy(), ref)


@pytest.mark.parametrize("world", [2, 4])
def test_sampled_rows_of_a_rank_equal_world_one(world):
    """``sample_indices`` on a rank's edges at its row offset gives those
    rows of the whole batch's neighborhoods, both hops."""
    tg = worker.graph()
    tables = fs.put_graph_tables(CSRGraph.from_graph(tg), "cpu")
    ids = np.random.default_rng(world).integers(0, tg.n_edges, 64)
    src = torch.from_numpy(tg.edge_src[ids].astype(np.int32))
    dst = torch.from_numpy(tg.edge_dst[ids].astype(np.int32))
    whole = fs.sample_indices(tables, src, dst, (11, 2**32 - 3), (4, 3))
    b = len(ids) // world
    for rank in range(world):
        rows = slice(rank * b, (rank + 1) * b)
        part = fs.sample_indices(tables, src[rows], dst[rows],
                                 (11, 2**32 - 3), (4, 3), rank * b)
        for got, want in zip(part, whole):
            torch.testing.assert_close(got, want[rows], rtol=0, atol=0)


@pytest.mark.parametrize("batch,n,world", [
    (893, 1786, 4), (1797, 3600, 2), (8192, 3000, 4), (3, 2, 4), (7, 7, 1)])
def test_global_batch_rounds_as_jax(batch, n, world):
    """``(min(batch, n) // n_data) * n_data``, the JAX trainers' rule."""
    assert global_batch(batch, n, world) == (min(batch, n) // world) * world


# -- what stays a world of one, and the orchestrator -------------------------


def test_federated_fit_stays_local(worlds):
    """Inside a default group of two, each rank fits its own federated
    cluster through ``LocalClusterEndpoint``: the fits issue no
    collective (the clusters' datasets differ in size, so their steps
    could not pair up) and equal the same fits in a process without a
    group, bit for bit."""
    ranks, one = worlds[len(CLUSTERS)]["fed"], worlds[1]["fed"]
    assert {k.split("/")[0] for k in one} == {f"c{c}" for c in CLUSTERS}
    for key, per_rank in ranks.items():
        path = key.split("/", 1)[1]
        for cluster in CLUSTERS:
            np.testing.assert_array_equal(
                per_rank[cluster], one[f"c{cluster}/{path}"][0],
                err_msg=f"{key} cluster {cluster}")


def test_a_budget_on_one_rank_stops_every_rank(worlds):
    """Rank 1's wall-clock budget runs out at the first step, rank 0 has
    none: both stop after that step with the same parameters (a rank
    that stepped on alone would wait in its all-reduce for ever)."""
    got = worlds[2]["budget"]
    assert [int(s) for s in got["steps"]] == [1, 1]
    for key, per_rank in got.items():
        np.testing.assert_array_equal(per_rank[1], per_rank[0], err_msg=key)


def test_training_takes_a_group(worlds):
    """``Training.train`` over a default group of two trains every job on
    both ranks; rank 0 alone uploads, and its evaluations are the world
    of one's."""
    two, one = worlds[2]["training"], worlds[1]["training"]
    assert list(two["errors"]) == [0, 0] and int(one["errors"][0]) == 0
    assert str(two["registered"][0]) == str(one["registered"][0]) \
        == "gat,gnn,mlp"
    assert str(two["registered"][1]) == ""
    for key in ("gnn_f1", "gat_f1", "mlp_mae"):
        assert two[key][0] == two[key][1]
        np.testing.assert_allclose(two[key][0], one[key][0], rtol=1e-4,
                                   atol=1e-6, err_msg=key)
