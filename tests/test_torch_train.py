"""Port parity for gather-mode GraphTransformer training: the port's split,
labels, eval helpers, step budget, learning-rate schedule, optimizer step
and whole ``train_gat`` run against the JAX package's, and a trained
result served through the port's artifact loader.

Tolerances: the host helpers are bit-equal. The schedule is computed in
float64 here and in float32 (cos included) by optax — 1e-6 of the peak
rate, since near the end of the cosine the float32 value cancels
(measured worst 1.1e-7 of the peak). One AdamW step in
f32 differs from optax's only by rounding order — 1e-6. The trajectory
runs both trainers in their default bf16 compute from one flax init, so
the per-epoch losses drift by bf16 rounding — 5e-2 absolute (measured
worst 2.5e-2, in the epoch where both leave the majority-class plateau);
the eval F1 and accuracy on ~300 edges — 0.1 and 0.05 absolute (measured
4.2e-2 and 6.5e-3). Blocks and ring mode (through K1's plain twins) are
held to the same limits. A JAX-trained model served by the port: bf16
scores, 6e-2 as tests/test_torch_serving.py holds them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dragonfly2_tpu.data import SyntheticCluster as JaxCluster
from dragonfly2_tpu.inference import scorer as jax_scorer
from dragonfly2_tpu.models.graph_transformer import GraphTransformer as JaxGT
from dragonfly2_tpu.models.graph_transformer import (
    build_neighbor_lists as jax_build_neighbor_lists,
)
from dragonfly2_tpu.models.graph_transformer import (
    pad_graph_sparse as jax_pad_graph_sparse,
)
from dragonfly2_tpu.parallel import data_parallel_mesh
from dragonfly2_tpu.train import gat_trainer as jax_gat_trainer
from dragonfly2_tpu.train import metrics as jax_metrics
from dragonfly2_tpu.train.gnn_trainer import edge_split as jax_edge_split
from dragonfly2_tpu.train.step_budget import StepBudget as JaxStepBudget
from dragonfly2_tpu.train.checkpoint import gat_tree as jax_gat_tree
from dragonfly2_tpu_torch.data import SyntheticCluster
from dragonfly2_tpu_torch.inference.scorer import GATParentScorer
from dragonfly2_tpu_torch.inference.sidecar import (
    CallContext,
    InferenceService,
    ModelInferRequest,
    _gat_scorer_from_artifact,
)
from dragonfly2_tpu_torch.train import gat_trainer, metrics
from dragonfly2_tpu_torch.train.checkpoint import (
    ModelMetadata,
    gat_artifact_from_result,
    gat_state_dict_from_flax,
    load_artifact,
    write_artifact,
)
from dragonfly2_tpu_torch.train.gat_trainer import GATTrainConfig, train_gat
from dragonfly2_tpu_torch.train.schedule import warmup_cosine_lr
from dragonfly2_tpu_torch.train.split import edge_split
from dragonfly2_tpu_torch.train.step_budget import StepBudget
from tests.torch_dist_worker import spawn_worlds

LR_TOL = 1e-6
ADAMW_TOL = 1e-6
LOSS_ATOL = 5e-2
F1_ATOL = 0.1
ACCURACY_ATOL = 0.05
SCORE_TOL = 6e-2

# Batch 64 at lr 3e-3: with fewer steps or a larger rate this init stays
# on the majority-class plateau for 3 epochs, and F1 would compare 0
# with 0.
CFG = dict(hidden=16, embed=8, layers=2, heads=2, epochs=3,
           edge_batch_size=64, learning_rate=3e-3, eval_fraction=0.15)
# Ring mode across two ranks: 48 rows, 24 a rank, over 16-row chunks.
RING_WORLD = dict(attention="ring", chunk=16)


@pytest.fixture(scope="module")
def graphs():
    return (JaxCluster(n_hosts=48, seed=0).probe_graph(2000),
            SyntheticCluster(n_hosts=48, seed=0).probe_graph(2000))


@pytest.mark.parametrize("fraction,seed", [(0.1, 0), (0.15, 3), (0.5, 1)])
def test_edge_split_bit_equal(graphs, fraction, seed):
    jg, tg = graphs
    for ours, ref in zip(edge_split(tg, fraction, seed),
                         jax_edge_split(jg, fraction, seed)):
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("threshold", [5_000_000, 20_000_000])
def test_edge_labels_bit_equal(graphs, threshold):
    jg, tg = graphs
    ours, ref = tg.edge_labels(threshold), jg.edge_labels(threshold)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("n,batch", [(0, 8), (16, 8), (37, 8), (5, 64)])
def test_padded_chunks_bit_equal(n, batch):
    ids = np.random.default_rng(n).permutation(100)[:n]
    ours = list(metrics.padded_chunks(ids, batch))
    ref = list(jax_metrics.padded_chunks(ids, batch))
    assert len(ours) == len(ref)
    for (oi, ow), (ri, rw) in zip(ours, ref):
        np.testing.assert_array_equal(oi, ri)
        np.testing.assert_array_equal(ow, rw)


@pytest.mark.parametrize("cm", [[5, 2, 1, 9], [0, 0, 3, 4], [0, 0, 0, 0],
                                [3, 0, 0, 0]])
def test_metrics_from_confusion_equal(cm):
    cm = np.asarray(cm, np.float64)
    ours = metrics.metrics_from_confusion(cm)
    ref = jax_metrics.metrics_from_confusion(cm)
    assert ours.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(ours[key], ref[key])


@pytest.mark.parametrize("total", [2, 30, 137, 1500])
def test_lr_schedule_matches_optax(total):
    warmup = min(100, total // 10 + 1)
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-3, warmup, total)
    for step in range(total + 3):
        np.testing.assert_allclose(
            warmup_cosine_lr(step, 3e-3, warmup, total), float(ref(step)),
            rtol=0, atol=LR_TOL * 3e-3)
    assert warmup_cosine_lr(0, 3e-3, warmup, total) == 0.0


def test_adamw_steps_match_optax():
    rng = np.random.default_rng(0)
    shapes = {"w": (6, 4), "b": (4,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    lrs = [0.0, 1e-2, 5e-3]
    tx = optax.adamw(lambda count: jnp.asarray(lrs)[count],
                     weight_decay=1e-4)
    ref = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(ref)
    ours = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for k, v in params.items()}
    opt = torch.optim.AdamW(ours.values(), lr=0.0, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    for lr, g in zip(lrs, grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, ref)
        ref = optax.apply_updates(ref, updates)
        for group in opt.param_groups:
            group["lr"] = lr
        for k, p in ours.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(ours[k].detach().numpy(),
                                       np.asarray(ref[k]),
                                       rtol=ADAMW_TOL, atol=ADAMW_TOL)


@pytest.mark.parametrize("cls", [StepBudget, JaxStepBudget])
def test_step_budget_excludes_first_step(cls):
    import time

    compiles, progress = [], []
    b = cls(max_seconds=10.0, on_compile=compiles.append,
            on_progress=lambda steps, rate: progress.append(steps),
            progress_every=2)
    time.sleep(0.15)                      # the first step's build-up
    b.tick(10, torch.zeros(()))
    deadline = b._deadline
    for _ in range(5):
        time.sleep(0.01)
        assert b.tick(10, torch.zeros(())) is False
    b.finish()
    assert b.compile_seconds >= 0.15 and compiles == [b.compile_seconds]
    assert deadline == pytest.approx(b._start + 10.0)
    assert b.samples == 50 and b._elapsed < 0.15
    assert progress == [2, 4, 6]
    rate = b.samples_per_sec(10)
    assert 50 / 0.15 < rate < 50 / 0.05


@pytest.mark.parametrize("cls", [StepBudget, JaxStepBudget])
def test_step_budget_deadline(cls):
    import time

    b = cls(max_seconds=0.05)
    b.tick(10, torch.zeros(()))
    time.sleep(0.08)
    assert b.tick(10, torch.zeros(())) is True


def _flax_init(jg, cfg):
    """The JAX trainer's flax init (the same tree in every mode) as a port
    state dict."""
    train_ids, _ = jax_edge_split(jg, cfg.eval_fraction, cfg.seed)
    nbr, val = jax_build_neighbor_lists(
        jg.n_nodes, jg.edge_src[train_ids], jg.edge_dst[train_ids],
        jg.edge_rtt_ns[train_ids], cap=cfg.neighbor_cap)
    feats, nbr, val, _ = jax_pad_graph_sparse(jg.node_features, nbr, val, 1)
    init = JaxGT(hidden=cfg.hidden, embed=cfg.embed, layers=cfg.layers,
                 heads=cfg.heads, chunk=cfg.chunk).init(
        jax.random.key(cfg.seed), jnp.asarray(feats), jnp.asarray(nbr),
        jnp.asarray(val), jnp.zeros(2, jnp.int32), jnp.zeros(2, jnp.int32))
    return gat_state_dict_from_flax(jax.device_get(init))


@pytest.fixture(scope="module")
def trajectories(graphs):
    """The JAX trainer and the port's from one flax init."""
    jg, tg = graphs
    cfg = jax_gat_trainer.GATTrainConfig(**CFG)
    ref = jax_gat_trainer.train_gat(jg, cfg,
                                    data_parallel_mesh(jax.devices()[:1]))
    state = _flax_init(jg, cfg)
    ours = {k: train_gat(tg, GATTrainConfig(**CFG, steps_per_call=k),
                         device="cpu", init_state=state)
            for k in (1, 4)}
    return ref, ours


# The modes that train through K1: blocks at the default 1024-row chunk
# (one key block here) and ring at a 32-row chunk, so its 48 rows pad to
# 64 as the JAX trainer pads them. Both trainers on one device (JAX: a
# one-device mesh, on which the ring has one member).
K1_MODES = {"blocks": dict(attention="blocks"),
            "ring": dict(attention="ring", chunk=32)}


@pytest.fixture(scope="module", params=sorted(K1_MODES))
def k1_trajectories(request, graphs):
    """(mode, the JAX trainer's result, the port's) from one flax init."""
    jg, tg = graphs
    cfg = jax_gat_trainer.GATTrainConfig(**CFG, **K1_MODES[request.param])
    ref = jax_gat_trainer.train_gat(jg, cfg,
                                    data_parallel_mesh(jax.devices()[:1]))
    ours = train_gat(tg, GATTrainConfig(**CFG, **K1_MODES[request.param]),
                     device="cpu", init_state=_flax_init(jg, cfg))
    return request.param, ref, ours


def test_k1_mode_trajectory_matches_jax(k1_trajectories):
    """Blocks and ring mode train through GraphFlashAttention's plain
    twins, held to the JAX trainer as gather mode is."""
    _, ref, got = k1_trajectories
    assert len(got.history) == len(ref.history) == CFG["epochs"]
    np.testing.assert_allclose(got.history, ref.history, atol=LOSS_ATOL)
    assert got.history[-1] < got.history[0]
    assert got.f1 > 0 and abs(got.f1 - ref.f1) <= F1_ATOL
    assert abs(got.accuracy - ref.accuracy) <= ACCURACY_ATOL
    np.testing.assert_array_equal(got.node_features, ref.node_features)
    np.testing.assert_array_equal(got.neighbors, ref.neighbors)
    np.testing.assert_array_equal(got.neighbor_vals, ref.neighbor_vals)
    assert got.n_real_nodes == ref.n_real_nodes


def test_jax_trained_k1_artifact_serves(k1_trajectories, graphs):
    """A blocks- or ring-mode model trained by the JAX package, written as
    an artifact, loads and serves on the port: its scores match the JAX
    scorer's on the same params and graph."""
    mode, ref, _ = k1_trajectories
    jg, tg = graphs
    cfg = dict(hidden=ref.config.hidden, embed=ref.config.embed,
               layers=ref.config.layers, heads=ref.config.heads,
               attention=mode, chunk=ref.config.chunk)
    params = jax.device_get(ref.params)
    artifact = write_artifact(
        jax_gat_tree(params, ref.node_features, ref.neighbors,
                     ref.neighbor_vals, node_ids=jg.node_ids),
        ModelMetadata(model_id=f"jax-{mode}", model_type="gat", config=cfg))
    got = _gat_scorer_from_artifact(artifact, device="cpu")
    assert isinstance(got, GATParentScorer)
    assert got.node_ids == list(tg.node_ids)
    want = jax_scorer.GATParentScorer(
        JaxGT(**cfg), params, ref.node_features, ref.neighbors,
        ref.neighbor_vals, node_ids=jg.node_ids)
    pairs = np.random.default_rng(2).integers(0, tg.n_nodes, (40, 2))
    np.testing.assert_allclose(got.score(pairs), want.score(pairs),
                               rtol=SCORE_TOL, atol=SCORE_TOL)


def test_train_gat_trajectory_matches_jax(trajectories):
    ref, ours = trajectories
    got = ours[1]
    assert len(got.history) == len(ref.history) == CFG["epochs"]
    np.testing.assert_allclose(got.history, ref.history, atol=LOSS_ATOL)
    assert got.history[-1] < got.history[0]
    assert got.f1 > 0 and abs(got.f1 - ref.f1) <= F1_ATOL
    assert abs(got.accuracy - ref.accuracy) <= ACCURACY_ATOL
    np.testing.assert_array_equal(got.neighbors, ref.neighbors)
    np.testing.assert_array_equal(got.neighbor_vals, ref.neighbor_vals)
    assert got.n_real_nodes == ref.n_real_nodes


def test_steps_per_call_keeps_trajectory(trajectories):
    _, ours = trajectories
    assert ours[1].step_losses == ours[4].step_losses
    assert ours[1].history == ours[4].history
    for key, value in ours[1].state_dict.items():
        assert torch.equal(value, ours[4].state_dict[key]), key


def test_trained_model_serves_through_artifact(trajectories, graphs):
    _, tg = graphs
    result = trajectories[1][1]
    artifact = gat_artifact_from_result(result, tg, "gat-test")
    _, metadata = load_artifact(artifact)
    assert metadata.model_type == "gat"
    assert metadata.evaluation["f1"] == result.f1
    assert metadata.config["attention"] == "gather"
    scorer = _gat_scorer_from_artifact(artifact, device="cpu")
    service = InferenceService()
    service.install_scorer("gat", scorer)
    pairs = np.random.default_rng(0).integers(0, tg.n_nodes, (16, 2))
    out = service.ModelInfer(ModelInferRequest("gat", pairs),
                             CallContext()).outputs
    model = result.model
    with torch.no_grad():
        emb = model.node_embeddings(*map(torch.from_numpy, (
            result.node_features, result.neighbors, result.neighbor_vals)))
        ref = model.score_pairs(emb, *torch.from_numpy(
            pairs.astype(np.int32)).T)
    np.testing.assert_array_equal(out, ref.numpy())


def test_ring_mode_refused(graphs, tmp_path):
    """Ring mode across ranks is ported: trained on two gloo ranks (rows
    sharded, K/V around the ring), rank 0's result written as an artifact
    loads in this process, a world of one, and its scores match the JAX
    scorer's on the artifact's params and graph."""
    jg, tg = graphs
    case = {"call": "run_ring_artifact",
            "config": dict(CFG, epochs=1, **RING_WORLD)}
    got = spawn_worlds({2: {"ring": case}}, str(tmp_path),
                       timeout_s=120.0)[2]["ring"]
    assert got["artifact"][1].size == 0
    artifact = got["artifact"][0].tobytes()
    tree, metadata = load_artifact(artifact)
    assert metadata.config["attention"] == "ring"
    scorer = _gat_scorer_from_artifact(artifact, device="cpu")
    cfg = {k: metadata.config[k] for k in ("hidden", "embed", "layers",
                                           "heads", "attention", "chunk")}
    want = jax_scorer.GATParentScorer(
        JaxGT(**cfg), {"params": tree["params"]}, tree["node_features"],
        tree["neighbors"], tree["neighbor_vals"], node_ids=jg.node_ids)
    pairs = np.random.default_rng(3).integers(0, tg.n_nodes, (40, 2))
    np.testing.assert_allclose(scorer.score(pairs), want.score(pairs),
                               rtol=SCORE_TOL, atol=SCORE_TOL)


class _RankOfTwo:
    """``DataParallel`` as rank ``rank`` of a world of two sees it, without
    a process group (the constructor's collective, the broadcast, is a
    no-op)."""

    def __init__(self, rank):
        self.world, self.rank = 2, rank

    def rows(self, n):
        return slice(self.rank * n // 2, (self.rank + 1) * n // 2)

    def broadcast_(self, module):
        pass


@pytest.mark.parametrize("attention", ["ring"])
def test_train_gat_refuses_a_larger_world(graphs, monkeypatch, attention):
    """Ring mode in a world of two pads the rows as the JAX trainer does on
    a two-device mesh (a rank's 24 rows exceed the 16-row chunk, so to a
    multiple of 2 · 16) and places each rank's half of the features and
    neighbor lists, global ids kept, without the inverse index the
    world-of-one kernel needs. (Training across ranks:
    tests/test_torch_data_parallel.py.)"""
    jg, tg = graphs
    cfg = dict(CFG, epochs=0, **RING_WORLD)
    assert cfg["attention"] == attention
    ref = jax_gat_trainer.train_gat(jg, jax_gat_trainer.GATTrainConfig(**cfg),
                                    data_parallel_mesh(jax.devices()[:2]))
    halves = []
    for rank in range(2):
        monkeypatch.setattr(gat_trainer, "DataParallel",
                            lambda group, rank=rank: _RankOfTwo(rank))
        trainer = gat_trainer.GATTrainer(tg, GATTrainConfig(**cfg), "cpu")
        np.testing.assert_array_equal(trainer.node_features,
                                      ref.node_features)
        np.testing.assert_array_equal(trainer.nbr, ref.neighbors)
        np.testing.assert_array_equal(trainer.val, ref.neighbor_vals)
        assert trainer.n_real == ref.n_real_nodes
        assert trainer.g_inv is None
        halves.append(trainer.g_nbr.numpy())
    assert ref.node_features.shape[0] == 64
    np.testing.assert_array_equal(np.concatenate(halves), ref.neighbors)


def test_blocks_mode_trains_on_cpu(graphs):
    _, tg = graphs
    cfg = dataclasses.replace(GATTrainConfig(**CFG), epochs=1,
                              attention="blocks", chunk=16)
    result = train_gat(tg, cfg, device="cpu")
    assert np.isfinite(result.step_losses).all()
    assert result.node_features.shape[0] % 16 == 0
