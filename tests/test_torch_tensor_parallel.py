"""Port parity for tensor parallelism: the GraphTransformer on a ``(data,
model)`` grid of gloo ranks (one process a rank, on the CPU) against the
JAX trainer on a ``data_parallel_mesh(..., model_parallel=2)`` of as many
virtual CPU devices, and against the port in a world of one.

Worlds of 2 (a 1 × 2 grid) and 4 (2 × 2) train ``tests/test_gat_tp.py``'s
configuration on its 48-host graph in gather and in blocks mode, from
the JAX trainer's flax init; a world of 2 also trains with the rows
sharded alone (a 2 × 1 grid) against JAX's 2-device data-parallel
trainer, which shards them too. Every world is spawned once a test run
(``torch_dist_worker.spawn_worlds``) and the JAX references are computed
once beside it.

Tolerances: JAX's own TP-vs-DP bounds (``tests/test_gat_tp.py``): loss
histories within rtol/atol 2e-3, F1 within 5e-2, embeddings of sharded
weights within 2e-2 of the replicated model's, a rank's parameter bytes
below 0.75 of the replicated ones. The configuration sits on the
majority plateau after its three epochs (F1 0 in both packages), so the
F1 bound holds trivially there; the losses carry the comparison. The
served artifact is held to ``tests/test_torch_serving.py``'s bf16 bound.
Shards are bit-equal to JAX's ``addressable_shards``, and the ranks'
gathered states bit-equal to one another.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.data import SyntheticCluster as JaxCluster
from dragonfly2_tpu.inference import scorer as jax_scorer
from dragonfly2_tpu.models.graph_transformer import GraphTransformer as JaxGT
from dragonfly2_tpu.parallel import data_parallel_mesh
from dragonfly2_tpu.train import gat_trainer as jax_gat
from dragonfly2_tpu_torch.data import SyntheticCluster
from dragonfly2_tpu_torch.inference.sidecar import _gat_scorer_from_artifact
from dragonfly2_tpu_torch.models.graph_transformer import (
    GraphTransformer,
    build_neighbor_lists,
    pad_graph_sparse,
)
from dragonfly2_tpu_torch.parallel.mesh import LOCAL, Grid
from dragonfly2_tpu_torch.train.checkpoint import (
    gat_from_tree,
    gat_state_dict_from_flax,
    load_artifact,
)
from dragonfly2_tpu_torch.train.gat_trainer import GATTrainConfig, GATTrainer
from torch_dist_worker import load_worlds, run_once, spawn_worlds

N_HOSTS, GRAPH_SEED, N_PROBES = 48, 4, 2500
CFG = dict(hidden=32, embed=16, layers=2, heads=4, epochs=3,
           edge_batch_size=512, eval_fraction=0.2)
MODES = ("gather", "blocks")
# world → model axis: the 1 × 2 and 2 × 2 grids.
GRIDS = {2: 2, 4: 2}
GRID_IDS = [f"{mode}-{world}" for mode in MODES for world in GRIDS]
LOSS_TOL, F1_TOL, EMB_TOL, BYTES_SHARE = 2e-3, 5e-2, 2e-2, 0.75
SCORE_TOL = 6e-2
# The embeddings' graph: every probe's neighbor list, rows padded to 8.
EMB_PAD = 8
# What each world runs: the world of one, the grids, rows sharded alone.
NAMES = {1: ["one"], 2: ["tp", "dp"], 4: ["tp"]}


def _jax_graph():
    return JaxCluster(n_hosts=N_HOSTS, seed=GRAPH_SEED).probe_graph(N_PROBES)


def _mesh(world, model_parallel):
    return data_parallel_mesh(devices=jax.devices()[:world],
                              model_parallel=model_parallel)


def _port(params) -> dict:
    return {k: v.numpy() for k, v in gat_state_dict_from_flax(
        jax.device_get(params)).items()}


def _jax_run(refs: dict, mode: str, world: int, mp: int):
    """The JAX trainer on a ``world``-device mesh with a model axis of
    ``mp``: its history and F1 into ``refs`` (``<mode>/<world>x<mp>/``);
    returns its trained params."""
    res = jax_gat.train_gat(_jax_graph(),
                            jax_gat.GATTrainConfig(**CFG, attention=mode),
                            _mesh(world, mp))
    refs[f"{mode}/{world}x{mp}/history"] = np.array(res.history)
    refs[f"{mode}/{world}x{mp}/f1"] = np.array(res.f1)
    return res.params


def _jax_inputs() -> tuple[dict, dict]:
    """(refs, the flax init): what the ranks start from, flat for
    ``np.savez`` — the init as a port state dict (``init/``) and the
    2-device data-parallel trainer's gather-mode state (``emb_state/``,
    whose embeddings the grids reproduce), with that run's history and
    F1."""
    params = JaxGT(**{k: CFG[k] for k in ("hidden", "embed", "layers",
                                          "heads")}).init(
        jax.random.key(0), jnp.zeros((N_HOSTS, 8)),
        jnp.zeros((N_HOSTS, 4), jnp.int32), jnp.zeros((N_HOSTS, 4)),
        jnp.zeros(2, jnp.int32), jnp.zeros(2, jnp.int32))
    refs = {f"init/{k}": v for k, v in _port(params).items()}
    trained = _jax_run(refs, "gather", 2, 1)
    refs.update({f"emb_state/{k}": v for k, v in _port(trained).items()})
    return refs, params


def _jax_refs(refs: dict, params) -> None:
    """The rest of the JAX side into ``refs``: the TP trainer's history
    and F1 on each grid, the data-parallel trainer's on 2 devices in
    blocks mode, and each device's ``addressable_shards`` of the init
    ``params`` under ``tp_state_shardings`` as a port state dict
    (``shard/<world>/<i>/``)."""
    for mode in MODES:
        for world, mp in [*GRIDS.items(), (2, 1)]:
            if f"{mode}/{world}x{mp}/history" not in refs:
                _jax_run(refs, mode, world, mp)
    for world, mp in GRIDS.items():
        mesh = _mesh(world, mp)
        placed = jax.device_put(params,
                                jax_gat.tp_state_shardings(params, mesh))
        for i, device in enumerate(jax.devices()[:world]):
            mine = jax.tree.map(
                lambda leaf: next(np.asarray(s.data)
                                  for s in leaf.addressable_shards
                                  if s.device == device), placed)
            refs.update({f"shard/{world}/{i}/{k}": v
                         for k, v in _port(mine).items()})


def _prefixed(refs: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in refs.items()
            if k.startswith(prefix)}


def _spec(refs: dict) -> dict:
    def case(model_parallel):
        return {"call": "run_tensor_parallel",
                "module": "torch_parallel_worker",
                "model_parallel": model_parallel, "n_hosts": N_HOSTS,
                "graph_seed": GRAPH_SEED, "n_probes": N_PROBES,
                "config": CFG, "init": _prefixed(refs, "init/"),
                "emb_state": _prefixed(refs, "emb_state/"),
                "emb_pad": EMB_PAD}

    return {1: {"one": case(1)}, 2: {"tp": case(2), "dp": case(1)},
            4: {"tp": case(GRIDS[4])}}


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """(JAX references, ``{world: {case: {key: per-rank arrays}}}``),
    computed once a test run: the first pytest worker to ask computes the
    ranks' inputs, spawns every world and computes the rest of the JAX
    side while the ranks train; the others read both back."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    root = (tmp_path_factory.getbasetemp().parent / f"tp-{run}" if run
            else tmp_path_factory.mktemp("tp"))

    def build():
        refs, params = _jax_inputs()
        with ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(spawn_worlds, _spec(refs), str(root), 240.0)
            _jax_refs(refs, params)
            ranks.result()
        np.savez(root / "jax.npz", **refs)

    run_once(str(root), build)
    return dict(np.load(root / "jax.npz")), load_worlds(NAMES, str(root))


def _params(result, mode, rank=0):
    prefix = f"{mode}.param/"
    return {k[len(prefix):]: v[rank] for k, v in result.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("world", list(GRIDS))
def test_grid_places_rank_i_as_jax_device_i(tp, world):
    """``grid_groups`` lays the ranks out as ``jax.make_mesh((n // mp,
    mp), ("data", "model"))`` lays out the devices."""
    _, worlds = tp
    mesh = _mesh(world, GRIDS[world]).mesh
    for rank, got in enumerate(worlds[world]["tp"]["grid"]):
        where = np.argwhere(mesh.devices == jax.devices()[rank])[0]
        assert list(got) == [*where, world // GRIDS[world], GRIDS[world]]


@pytest.mark.parametrize("world", list(GRIDS))
def test_shards_equal_jax_addressable_shards(tp, world):
    """Each rank's ``tp_shard_state`` slice of every parameter is device
    i's shard under ``tp_state_shardings`` (kernels transposed to torch's
    ``[out, in]``), bit for bit: q/k/v and MLP-up kernels and biases on
    their output features, out and MLP-down kernels on their input
    features, everything else whole."""
    refs, worlds = tp
    got = worlds[world]["tp"]
    init = _prefixed(refs, "init/")
    split = 0
    for rank in range(world):
        want = _prefixed(refs, f"shard/{world}/{rank}/")
        mine = {k[len("shard/"):]: v[rank] for k, v in got.items()
                if k.startswith("shard/")}
        assert mine.keys() == want.keys() == init.keys()
        for key in want:
            np.testing.assert_array_equal(mine[key], want[key], err_msg=key)
            split += mine[key].shape != init[key].shape
    # 4 column kernels and biases and 2 row kernels a block, every rank.
    assert split == world * CFG["layers"] * 10


@pytest.mark.parametrize("mode,world", [(m, w) for m in MODES for w in GRIDS],
                         ids=GRID_IDS)
def test_tp_training_matches_jax(tp, mode, world):
    """The port on a grid walks the JAX TP trainer's loss path on the
    same mesh shape, from the same init."""
    refs, worlds = tp
    got = worlds[world]["tp"]
    ref = f"{mode}/{world}x{GRIDS[world]}/"
    assert len(got[f"{mode}.history"][0]) == CFG["epochs"]
    np.testing.assert_allclose(got[f"{mode}.history"][0],
                               refs[ref + "history"], rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert abs(float(got[f"{mode}.f1"][0]) - float(refs[ref + "f1"])) \
        <= F1_TOL


@pytest.mark.parametrize("mode,world", [(m, w) for m in MODES for w in GRIDS],
                         ids=GRID_IDS)
def test_tp_training_matches_world_one(tp, mode, world):
    """Against the port's world of one: the same loss path, and every
    rank ends holding the same whole state, of the world of one's
    shapes."""
    _, worlds = tp
    got, one = worlds[world]["tp"], worlds[1]["one"]
    np.testing.assert_allclose(got[f"{mode}.history"][0],
                               one[f"{mode}.history"][0], rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert abs(float(got[f"{mode}.f1"][0]) - float(one[f"{mode}.f1"][0])) \
        <= F1_TOL
    whole = _params(one, mode)
    for rank in range(world):
        mine = _params(got, mode, rank)
        assert mine.keys() == whole.keys()
        for key, value in mine.items():
            assert value.shape == whole[key].shape, key
            np.testing.assert_array_equal(value, _params(got, mode)[key],
                                          err_msg=f"{key} rank {rank}")
        np.testing.assert_array_equal(got[f"{mode}.step_losses"][rank],
                                      got[f"{mode}.step_losses"][0])


@pytest.mark.parametrize("mode,world", [(m, w) for m in MODES for w in GRIDS],
                         ids=GRID_IDS)
def test_tp_embeddings_match_and_param_memory_drops(tp, mode, world):
    """Trained weights placed on the grid give the replicated model's
    embeddings, at under 0.75 of its parameter bytes a rank."""
    refs, worlds = tp
    got = worlds[world]["tp"]
    graph = SyntheticCluster(n_hosts=N_HOSTS, seed=GRAPH_SEED).probe_graph(
        N_PROBES)
    nbr, val = build_neighbor_lists(graph.n_nodes, graph.edge_src,
                                    graph.edge_dst, graph.edge_rtt_ns)
    feats, nbr, val, _ = pad_graph_sparse(graph.node_features, nbr, val,
                                          EMB_PAD)
    model = GraphTransformer(
        in_features=feats.shape[1], attention=mode, group=LOCAL,
        **{k: CFG[k] for k in ("hidden", "embed", "layers", "heads")})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           _prefixed(refs, "emb_state/").items()})
    with torch.no_grad():
        plain = model.node_embeddings(*(torch.from_numpy(a)
                                        for a in (feats, nbr, val)))
    for rank in range(world):
        np.testing.assert_allclose(got[f"{mode}.emb"][rank],
                                   plain.float().numpy(), rtol=EMB_TOL,
                                   atol=EMB_TOL)
        mine = int(got[f"{mode}.param_bytes"][rank])
        whole = int(got[f"{mode}.whole_bytes"][rank])
        assert mine < BYTES_SHARE * whole, (mine, whole)


@pytest.mark.parametrize("mode", MODES)
def test_row_sharding_matches_jax_data_parallel(tp, mode):
    """Rows sharded over 2 ranks with no model axis (a 2 × 1 grid), as
    JAX's 2-device data-parallel trainer shards them: its loss path and
    F1, and the port's world of one's; the ranks end bit-equal."""
    refs, worlds = tp
    got, one = worlds[2]["dp"], worlds[1]["one"]
    for want in (refs[f"{mode}/2x1/history"], one[f"{mode}.history"][0]):
        np.testing.assert_allclose(got[f"{mode}.history"][0], want,
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
    assert abs(float(got[f"{mode}.f1"][0])
               - float(refs[f"{mode}/2x1/f1"])) <= F1_TOL
    assert got[f"{mode}.param_bytes"][0] == got[f"{mode}.whole_bytes"][0]
    for key, value in _params(got, mode, 1).items():
        np.testing.assert_array_equal(value, _params(got, mode)[key],
                                      err_msg=key)


@pytest.mark.parametrize("mode", MODES)
def test_tp_artifact_serves_in_a_world_of_one(tp, mode):
    """Rank 0's artifact of the 1 × 2 grid's run holds the whole state in
    the flax layout: loaded by the sidecar in this process alone, it
    scores as the JAX scorer does on the same parameters."""
    _, worlds = tp
    artifact = worlds[2]["tp"][f"{mode}.artifact"][0].tobytes()
    tree, metadata = load_artifact(artifact)
    params, feats, nbr, val, ids = gat_from_tree(tree)
    got = _gat_scorer_from_artifact(artifact, device="cpu")
    ref = jax_scorer.GATParentScorer(
        JaxGT(**{k: metadata.config[k] for k in (
            "hidden", "embed", "layers", "heads", "chunk", "attention")}),
        {"params": params} if "params" not in params else params,
        feats, nbr, val, node_ids=ids)
    pairs = np.random.default_rng(1).integers(0, N_HOSTS, (40, 2)).astype(
        np.int32)
    np.testing.assert_allclose(got.score(pairs), ref.score(pairs),
                               rtol=SCORE_TOL, atol=SCORE_TOL)


def _grid(n_model: int) -> Grid:
    """A grid with a model axis of ``n_model`` and no exchange to make:
    what the refusals see before anything is placed."""
    return Grid(LOCAL, LOCAL, 1, n_model, 0, 0)


def test_tp_refuses_what_jax_refuses():
    """Ring mode with a model axis, and heads or 2·hidden that the axis
    does not divide: both packages refuse before training."""
    jg = _jax_graph()
    tg = SyntheticCluster(n_hosts=N_HOSTS, seed=GRAPH_SEED).probe_graph(
        N_PROBES)
    for kw, match in ((dict(attention="ring"), "ring"),
                      (dict(heads=3, hidden=33), "divisible")):
        with pytest.raises(ValueError, match=match):
            jax_gat.train_gat(jg, jax_gat.GATTrainConfig(**kw), _mesh(2, 2))
        with pytest.raises(ValueError, match=match):
            GATTrainer(tg, GATTrainConfig(**kw), "cpu", grid=_grid(2))
        with pytest.raises(ValueError, match=match):
            GraphTransformer(hidden=kw.get("hidden", 128),
                             heads=kw.get("heads", 4),
                             attention=kw.get("attention", "gather"),
                             grid=_grid(2))


@pytest.mark.parametrize("mode", ["blocks", "flash"])
def test_tp_refuses_a_head_share_k1_cannot_take(monkeypatch, mode):
    """On the card K1 runs a rank's head share: a grid that leaves it a
    share the kernels refuse (here 2 heads of 8, 16 wide) raises when
    the trainer is built, before anything is placed. Config #3's share
    at model 2 (2 heads of 32) and at model 4 (1 of 32) passes. The CPU's
    plain twin takes any share."""
    from dragonfly2_tpu_torch.ops.flash_attention import (
        check_graph_flash_heads,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    tg = SyntheticCluster(n_hosts=N_HOSTS, seed=GRAPH_SEED).probe_graph(
        N_PROBES)
    with pytest.raises(ValueError, match="heads dividing 32"):
        GATTrainer(tg, GATTrainConfig(**CFG, attention=mode), "cuda",
                   grid=_grid(2))
    for n_model in (2, 4):
        check_graph_flash_heads(4 // n_model, 128 // 4)
