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
4.2e-2 and 6.5e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dragonfly2_tpu.data import SyntheticCluster as JaxCluster
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
from dragonfly2_tpu_torch.data import SyntheticCluster
from dragonfly2_tpu_torch.inference.sidecar import (
    CallContext,
    InferenceService,
    ModelInferRequest,
    _gat_scorer_from_artifact,
)
from dragonfly2_tpu_torch.train import metrics
from dragonfly2_tpu_torch.train.checkpoint import (
    gat_artifact_from_result,
    gat_state_dict_from_flax,
    load_artifact,
)
from dragonfly2_tpu_torch.train.gat_trainer import (
    GATTrainConfig,
    train_gat,
    warmup_cosine_lr,
)
from dragonfly2_tpu_torch.train.split import edge_split
from dragonfly2_tpu_torch.train.step_budget import StepBudget

LR_TOL = 1e-6
ADAMW_TOL = 1e-6
LOSS_ATOL = 5e-2
F1_ATOL = 0.1
ACCURACY_ATOL = 0.05

# Batch 64 at lr 3e-3: with fewer steps or a larger rate this init stays
# on the majority-class plateau for 3 epochs, and F1 would compare 0
# with 0.
CFG = dict(hidden=16, embed=8, layers=2, heads=2, epochs=3,
           edge_batch_size=64, learning_rate=3e-3, eval_fraction=0.15)


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


@pytest.fixture(scope="module")
def trajectories(graphs):
    """The JAX trainer and the port's from one flax init."""
    jg, tg = graphs
    cfg = jax_gat_trainer.GATTrainConfig(**CFG)
    ref = jax_gat_trainer.train_gat(jg, cfg,
                                    data_parallel_mesh(jax.devices()[:1]))
    train_ids, _ = jax_edge_split(jg, cfg.eval_fraction, cfg.seed)
    nbr, val = jax_build_neighbor_lists(
        jg.n_nodes, jg.edge_src[train_ids], jg.edge_dst[train_ids],
        jg.edge_rtt_ns[train_ids], cap=cfg.neighbor_cap)
    feats, nbr, val, _ = jax_pad_graph_sparse(jg.node_features, nbr, val, 1)
    init = JaxGT(hidden=cfg.hidden, embed=cfg.embed, layers=cfg.layers,
                 heads=cfg.heads, chunk=cfg.chunk).init(
        jax.random.key(cfg.seed), jnp.asarray(feats), jnp.asarray(nbr),
        jnp.asarray(val), jnp.zeros(2, jnp.int32), jnp.zeros(2, jnp.int32))
    state = gat_state_dict_from_flax(jax.device_get(init))
    ours = {k: train_gat(tg, GATTrainConfig(**CFG, steps_per_call=k),
                         device="cpu", init_state=state)
            for k in (1, 4)}
    return ref, ours


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


def test_ring_mode_refused(graphs):
    _, tg = graphs
    with pytest.raises(NotImplementedError, match="parallel slice"):
        train_gat(tg, GATTrainConfig(**CFG, attention="ring"), device="cpu")


def test_blocks_mode_trains_on_cpu(graphs):
    _, tg = graphs
    cfg = dataclasses.replace(GATTrainConfig(**CFG), epochs=1,
                              attention="blocks", chunk=16)
    result = train_gat(tg, cfg, device="cpu")
    assert np.isfinite(result.step_losses).all()
    assert result.node_features.shape[0] % 16 == 0
