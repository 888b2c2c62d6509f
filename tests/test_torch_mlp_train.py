"""Port parity for MLP and cost-model training (BASELINE config #1): the
port's data pipeline, synthetic pair examples, optimizer step, trainers
and ``mlp``/``cost`` artifacts against the JAX package's, on the CPU.

Tolerances: data and example extraction bit-equal; one AdamW step 1e-5
in f32 and 6e-2 in bf16 (tests/test_torch_serving.py's bf16 bound);
epoch losses of a whole run from the same initial params within 1e-2.
The cost model trains on a corpus the JAX package's replay recorder
captures from its in-process swarm (tests/test_replay.py's recipe), fed
to both packages' example extraction.
"""

from __future__ import annotations

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

from dragonfly2_tpu.data import SyntheticCluster as JaxCluster
from dragonfly2_tpu.data.pipeline import ArrayDataset as JaxArrayDataset
from dragonfly2_tpu.inference import scorer as jax_scorer
from dragonfly2_tpu.inference import sidecar as jax_sidecar
from dragonfly2_tpu.manager.service import _tar_directory
from dragonfly2_tpu.models.mlp import MLPBandwidthPredictor as JaxMLP
from dragonfly2_tpu.parallel import data_parallel_mesh
from dragonfly2_tpu.scheduler import replay as jax_replay
from dragonfly2_tpu.scheduler.controlstats import ControlPlaneStats
from dragonfly2_tpu.scheduler.loadbench import run_swarm_bench
from dragonfly2_tpu.scheduler.replaylog import ReplayRecorder
from dragonfly2_tpu.scheduler.replaystore import ColumnarCorpus
from dragonfly2_tpu.train import checkpoint as jax_checkpoint
from dragonfly2_tpu.train import cost_trainer as jax_cost
from dragonfly2_tpu.train import mlp_trainer as jax_mlp
from dragonfly2_tpu_torch.data import ArrayDataset, SyntheticCluster
from dragonfly2_tpu_torch.inference.sidecar import (
    _cost_scorer_from_artifact,
    _scorer_from_artifact,
)
from dragonfly2_tpu_torch.models.mlp import MLPBandwidthPredictor
from dragonfly2_tpu_torch.train import cost_trainer, mlp_trainer
from dragonfly2_tpu_torch.train.checkpoint import (
    ModelMetadata,
    load_artifact,
    mlp_state_dict_from_flax,
    mlp_tree,
    write_artifact,
)
from dragonfly2_tpu_torch.train.schedule import warmup_cosine_lr

F32_STEP_TOL = 1e-5
BF16_TOL = 6e-2
LOSS_TOL = 1e-2
# tests/test_train_mlp.py's SMALL run.
SMALL = dict(hidden=(32, 32), epochs=3, batch_size=1024, learning_rate=3e-3)
# tests/test_replay.py:73's cost run.
COST_CFG = dict(hidden=(16, 8), epochs=15, batch_size=256)


@pytest.fixture(scope="module")
def dataset():
    return SyntheticCluster(n_hosts=64, seed=0).pair_example_columns(20000)


def jax_params(hidden, seed=0):
    return jax.device_get(JaxMLP(hidden=tuple(hidden)).init(
        jax.random.key(seed), jnp.zeros((1, 11))))


def one_device_mesh():
    return data_parallel_mesh(devices=jax.devices()[:1])


# -- data ----------------------------------------------------------------------


@pytest.mark.parametrize("n_hosts,seed,n", [(64, 0, 20000), (300, 3, 5000)])
def test_pair_example_columns_bit_equal(n_hosts, seed, n):
    got = SyntheticCluster(n_hosts=n_hosts, seed=seed).pair_example_columns(n)
    want = JaxCluster(n_hosts=n_hosts, seed=seed).pair_example_columns(n)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 3), (5, 1)])
def test_array_dataset_batches_and_split_bit_equal(dataset, shuffle, seed,
                                                   epoch):
    X, y = dataset
    for port, ref in ((ArrayDataset(X, y), JaxArrayDataset(X, y)),
                      (ArrayDataset(X, y).split(0.1, seed)[0],
                       JaxArrayDataset(X, y).split(0.1, seed)[0]),
                      (ArrayDataset(X, y).split(0.25, seed)[1],
                       JaxArrayDataset(X, y).split(0.25, seed)[1])):
        got = list(port.batches(1000, seed=seed, epoch=epoch,
                                shuffle=shuffle))
        want = list(ref.batches(1000, seed=seed, epoch=epoch,
                                shuffle=shuffle))
        assert len(got) == len(want) == len(ref) // 1000
        for a, b in zip(got, want):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
    with pytest.raises(ValueError):
        ArrayDataset(X, y[:10])


# -- one optimizer step --------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_adamw_steps_match_jax(dataset, dtype):
    """Three steps of warmup-cosine AdamW from the same flax params on the
    same batches: the port's train_step against the JAX trainer's own
    jitted step (its first step has learning rate 0)."""
    torch_dtype, jax_dtype, tol = {
        "f32": (torch.float32, jnp.float32, F32_STEP_TOL),
        "bf16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}[dtype]
    X, y = dataset
    hidden, lr, wd, warmup, total = (32, 32), 3e-3, 1e-4, 2, 10
    params = jax_params(hidden, seed=1)
    x = (X[:512] - X.mean(0)) / (X.std(0) + 1e-6)
    t_mean, t_std = 2.0, 1.5

    model = JaxMLP(hidden=hidden, dtype=jax_dtype)
    state = train_state.TrainState.create(
        apply_fn=model.apply, params=params,
        tx=optax.adamw(optax.warmup_cosine_decay_schedule(
            0.0, lr, warmup, total), weight_decay=wd))
    step = jax_mlp._make_train_step(model, one_device_mesh(), t_mean, t_std)
    jax_losses = []
    for k in range(3):
        rows = slice(128 * k, 128 * (k + 1))
        state, loss = step(state, x[rows], y[rows])
        jax_losses.append(float(loss))

    port = MLPBandwidthPredictor(hidden=hidden, dtype=torch_dtype)
    port.load_state_dict(mlp_state_dict_from_flax(params))
    optimizer = mlp_trainer.adamw(port, wd)
    losses = []
    for k in range(3):
        rows = slice(128 * k, 128 * (k + 1))
        target = (torch.log1p(torch.from_numpy(y[rows])) - t_mean) / t_std
        losses.append(float(mlp_trainer.train_step(
            port, optimizer, torch.from_numpy(x[rows]), target,
            warmup_cosine_lr(k, lr, warmup, total))))
    np.testing.assert_allclose(losses, jax_losses, rtol=tol, atol=tol)
    got = port.state_dict()
    for key, want in mlp_state_dict_from_flax(
            jax.device_get(state.params)).items():
        np.testing.assert_allclose(got[key].numpy(), want.numpy(), rtol=tol,
                                   atol=tol, err_msg=key)
    # The steps moved the params (the schedule's first lr is 0).
    start = mlp_state_dict_from_flax(params)
    assert any(not torch.equal(got[k], start[k]) for k in start)


# -- whole runs ------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(dataset):
    X, y = dataset
    params = jax_params(SMALL["hidden"])
    port = mlp_trainer.train_mlp(X, y, mlp_trainer.MLPTrainConfig(**SMALL),
                                 device="cpu", init_params=params)
    ref = jax_mlp.train_mlp(X, y, jax_mlp.MLPTrainConfig(**SMALL),
                            one_device_mesh(), init_params=params)
    return port, ref


def test_train_mlp_loss_falls_and_beats_predict_mean(dataset, runs):
    port, _ = runs
    X, y = dataset
    assert port.history[-1] < port.history[0] * 0.7
    # The loss is on the standardized log target: predicting the mean
    # scores exactly 1.0.
    assert port.history[-1] < 0.8
    train, held = ArrayDataset(X, y).split(0.1, 0)
    mean_mae = float(np.abs(held.arrays[1] - train.arrays[1].mean()).mean())
    assert port.mae < mean_mae
    assert np.isfinite(port.mse) and np.isfinite(port.mae)
    assert port.samples_per_sec > 0
    assert len(port.step_losses) == 3 * (18000 // 1024)


def test_train_mlp_matches_jax(runs):
    port, ref = runs
    np.testing.assert_allclose(port.history, ref.history, atol=LOSS_TOL)
    np.testing.assert_array_equal(port.normalizer.mean, ref.normalizer.mean)
    np.testing.assert_array_equal(port.target_norm.std, ref.target_norm.std)
    np.testing.assert_allclose([port.mse, port.mae], [ref.mse, ref.mae],
                               rtol=5e-2)


def test_train_mlp_own_init_and_state_dict_warm_start(dataset):
    X, y = dataset
    cfg = mlp_trainer.MLPTrainConfig(hidden=(16,), epochs=1, batch_size=2048)
    first = mlp_trainer.train_mlp(X, y, cfg, device="cpu")
    again = mlp_trainer.train_mlp(X, y, cfg, device="cpu")
    assert first.history == again.history                  # seeded init
    warm = mlp_trainer.train_mlp(
        X, y, cfg, device="cpu", init_params=first.model.state_dict(),
        normalizer=first.normalizer, target_norm=first.target_norm)
    assert warm.history[0] < first.history[0]


def test_train_mlp_edge_cases(dataset):
    X, y = dataset
    no_eval = mlp_trainer.train_mlp(
        X[:3000], y[:3000], mlp_trainer.MLPTrainConfig(
            hidden=(8,), epochs=1, batch_size=1024, eval_fraction=0.0),
        device="cpu")
    assert np.isnan(no_eval.mse) and np.isnan(no_eval.mae)
    shrunk = mlp_trainer.train_mlp(
        X[:600], y[:600], mlp_trainer.MLPTrainConfig(
            hidden=(8,), epochs=1, batch_size=8192), device="cpu")
    assert len(shrunk.history) == 1 and np.isfinite(shrunk.history[0])
    assert len(shrunk.step_losses) == 1
    with pytest.raises(ValueError, match="fill a batch"):
        mlp_trainer.train_mlp(X[:4], y[:4], mlp_trainer.MLPTrainConfig(
            eval_fraction=1.0), device="cpu")


# -- the cost model ---------------------------------------------------------------


@pytest.fixture(scope="module")
def recorded():
    """A replay corpus the JAX recorder captures from its in-process swarm
    (tests/test_replay.py's recipe): decision events and their columnar
    view."""
    recorder = ReplayRecorder(None, stats=ControlPlaneStats())
    run_swarm_bench(150, workers=4, recorder=recorder,
                    cost_profile="profiled", profile_seed=3)
    recorder.finalize_all()
    events = jax_replay.corpus_from_events(recorder.events())
    recorder.close()
    return events, ColumnarCorpus.from_events(events)


def test_cost_examples_from_corpus_equal_on_both_branches(recorded):
    events, columnar = recorded
    for corpus in (events, columnar):
        X, y = cost_trainer.cost_examples_from_corpus(corpus)
        jX, jy = jax_cost.cost_examples_from_corpus(corpus)
        assert X.dtype == jX.dtype == np.float32 and len(X) > 100
        np.testing.assert_array_equal(X, jX)
        np.testing.assert_array_equal(y, jy)
    X, y = cost_trainer.cost_examples_from_corpus([])
    assert X.shape == (0, 11) and y.shape == (0,)
    for got, want in zip(mlp_trainer.bandwidth_examples_from_corpus(columnar),
                         jax_mlp.bandwidth_examples_from_corpus(columnar)):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def cost_run(recorded):
    X, y = cost_trainer.cost_examples_from_corpus(recorded[1])
    result = cost_trainer.train_cost(
        X, y, cost_trainer.CostTrainConfig(**COST_CFG), device="cpu")
    return X, y, result


def test_train_cost_refuses_a_noise_corpus():
    X = np.ones((cost_trainer.MIN_COST_EXAMPLES - 1, 11), np.float32)
    for train in (cost_trainer.train_cost, jax_cost.train_cost):
        with pytest.raises(ValueError, match="noise model"):
            train(X, np.ones(len(X), np.float32))


def test_train_cost_learns_the_profiled_cost_signal(cost_run):
    X, y, result = cost_run
    scorer = _cost_scorer_from_artifact(write_artifact(
        cost_trainer.cost_tree(result), ModelMetadata(
            model_id="t-cost", model_type=cost_trainer.MODEL_TYPE_COST,
            config={"hidden": list(COST_CFG["hidden"])})), device="cpu")
    pred = np.concatenate([scorer.predict_cost_s(X[i:i + 64])
                           for i in range(0, len(X), 64)])
    corr = float(np.corrcoef(pred, y)[0, 1])
    assert corr > 0.9, f"cost model failed to learn: corr={corr}"
    assert result.n_samples == len(X) and np.isfinite(result.mae)
    assert result.history[-1] < result.history[0]


# -- artifacts in both directions ----------------------------------------------


def jax_loadable(artifact: bytes) -> bytes:
    """A port artifact's tree and metadata, saved by the JAX package's
    ``save_model`` (orbax) and tarred as its manager does: what the JAX
    sidecar's loaders read."""
    tree, metadata = load_artifact(artifact)
    with tempfile.TemporaryDirectory() as tmp:
        jax_checkpoint.save_model(tmp, tree, jax_checkpoint.ModelMetadata(
            **vars(metadata)))
        return _tar_directory(tmp)


def test_port_trained_artifacts_load_in_jax(dataset, runs, cost_run):
    X, _ = dataset
    port, _ = runs
    artifact = write_artifact(
        mlp_tree(port.params, port.normalizer, port.target_norm),
        ModelMetadata(model_id="t-mlp", model_type="mlp",
                      config={"hidden": list(port.config.hidden)}))
    got = _scorer_from_artifact(artifact, device="cpu").score(X[:40])
    want = jax_sidecar._scorer_from_artifact(jax_loadable(artifact)).score(
        X[:40])
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)

    cx, _, result = cost_run
    artifact = write_artifact(cost_trainer.cost_tree(result), ModelMetadata(
        model_id="t-cost", model_type="cost",
        config={"hidden": list(COST_CFG["hidden"])}))
    got = _cost_scorer_from_artifact(artifact, "v2", device="cpu")
    want = jax_sidecar._cost_scorer_from_artifact(jax_loadable(artifact),
                                                  "v2")
    assert got.version == want.version == "v2"
    assert got.typical_cost_s == pytest.approx(want.typical_cost_s,
                                               rel=1e-6)
    np.testing.assert_allclose(got.predict_cost_s(cx[:40]),
                               want.predict_cost_s(cx[:40]),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_jax_trained_artifacts_load_in_port(dataset, runs, cost_run):
    X, _ = dataset
    _, ref = runs
    metadata = ModelMetadata(model_id="t-mlp", model_type="mlp",
                             config={"hidden": list(ref.config.hidden)})
    artifact = write_artifact(jax_checkpoint.mlp_tree(
        ref.params, ref.normalizer, ref.target_norm), metadata)
    got = _scorer_from_artifact(artifact, device="cpu").score(X[:40])
    want = jax_scorer.ParentScorer(ref.model, ref.params, ref.normalizer,
                                   ref.target_norm).score(X[:40])
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)

    cx, cy, _ = cost_run
    jax_result = jax_cost.train_cost(cx, cy, jax_cost.CostTrainConfig(
        **dict(COST_CFG, epochs=2)), one_device_mesh())
    artifact = write_artifact(jax_cost.cost_tree(jax_result), ModelMetadata(
        model_id="t-cost", model_type="cost",
        config={"hidden": list(COST_CFG["hidden"])}))
    got = _cost_scorer_from_artifact(artifact, "v3", device="cpu")
    typical = float(np.expm1(float(jax_result.target_norm.mean[0])))
    want = jax_scorer.CostScorer(jax_scorer.ParentScorer(
        jax_result.model, jax_result.params, jax_result.normalizer,
        jax_result.target_norm), typical_cost_s=typical)
    assert got.typical_cost_s == pytest.approx(typical, rel=1e-6)
    np.testing.assert_allclose(got.predict_cost_s(cx[:40]),
                               want.predict_cost_s(cx[:40]),
                               rtol=BF16_TOL, atol=BF16_TOL)
