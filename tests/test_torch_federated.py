"""Port parity for federated multi-cluster training (BASELINE config #4):
the aggregators, the pooled normalizers, the admission screens, the
in-process ``train_federated_mlp``, the crash-safe coordinator with its journal, the
registry half and the bench's three rungs, against the JAX package's
``train/federated.py``, ``trainer/federation.py`` and
``train/fedbench.py``, on the CPU.

Tolerances: aggregation, the non-model screens, the moments and journal
packing bit-equal on identical numpy trees; the holdout screen with the
real bf16 MLP equal verdicts and ``holdout_mse`` within BF16_TOL
relative; ``train_federated_mlp`` from one initial tree equal lineage,
screens and escalations, losses within LOSS_TOL and ``mse``/``mae``
within METRIC_RTOL relative (tests/test_torch_mlp_train.py's bounds).
"""

from __future__ import annotations

import json
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.data import SyntheticCluster
from dragonfly2_tpu.models.mlp import MLPBandwidthPredictor as JaxMLP
from dragonfly2_tpu.models.mlp import Normalizer as JaxNormalizer
from dragonfly2_tpu.parallel import data_parallel_mesh
from dragonfly2_tpu.train import checkpoint as jax_checkpoint
from dragonfly2_tpu.train import federated as jfed
from dragonfly2_tpu.train.mlp_trainer import MLPTrainConfig as JaxMLPConfig
from dragonfly2_tpu.trainer import federation as jfedn
from dragonfly2_tpu_torch.manager import (
    Database,
    FilesystemObjectStore,
    ManagerService,
)
from dragonfly2_tpu_torch.models.mlp import MLPApply, Normalizer
from dragonfly2_tpu_torch.train import fedbench
from dragonfly2_tpu_torch.train import federated as fed
from dragonfly2_tpu_torch.train.checkpoint import (
    ModelMetadata,
    load_artifact,
    mlp_tree,
    save_model,
)
from dragonfly2_tpu_torch.train.mlp_trainer import MLPTrainConfig, train_mlp
from dragonfly2_tpu_torch.trainer import federation as fedn
from dragonfly2_tpu_torch.utils.backoff import full_jitter

BF16_TOL = 6e-2
LOSS_TOL = 1e-2
METRIC_RTOL = 5e-2
# tests/test_federated.py:32's TINY.
TINY = dict(hidden=(16,), epochs=2, batch_size=128, eval_fraction=0.2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's fits while this module runs:
    the MLPs are small, and beside other test workers torch's default
    pool oversubscribes the cores (a bench run took 20 × longer)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_datasets(module, n_clusters: int = 3, n: int = 800):
    """tests/test_federated.py:36's clusters as ``module.ClusterDataset``
    (the two packages' pair examples are bit-equal)."""
    out = []
    for k in range(n_clusters):
        X, y = SyntheticCluster(n_hosts=12, seed=10 + k).pair_example_columns(n)
        out.append(module.ClusterDataset(scheduler_id=k + 1, X=X, y=y))
    return out


def random_tree(rng, hidden=(16, 8), feature_dim=11, scale=1.0):
    """A flax-layout MLP tree of float32 numpy leaves."""
    widths = [feature_dim, *hidden, 1]
    return {"params": {
        f"Dense_{i}": {
            "kernel": (rng.normal(size=(widths[i], widths[i + 1]))
                       * scale).astype(np.float32),
            "bias": (rng.normal(size=widths[i + 1]) * scale).astype(
                np.float32)}
        for i in range(len(widths) - 1)}}


def assert_trees_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        if isinstance(want[key], dict):
            assert_trees_equal(got[key], want[key])
        else:
            a, b = np.asarray(got[key]), np.asarray(want[key])
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# -- aggregation and moments, bit-equal ----------------------------------------


@pytest.mark.parametrize("m,seed", [(1, 0), (2, 1), (3, 2), (5, 3), (8, 4)])
def test_fedavg_bit_equal(m, seed):
    rng = np.random.default_rng(seed)
    trees = [random_tree(rng) for _ in range(m)]
    weights = list(rng.integers(1, 5000, size=m))
    assert_trees_equal(fed.fedavg(trees, weights),
                       jfed.fedavg(trees, weights))


@pytest.mark.parametrize("m,trim", [(1, 0.2), (3, 0.2), (4, 0.25), (5, 0.2),
                                    (7, 0.3), (9, 0.45)])
def test_trimmed_mean_bit_equal(m, trim):
    rng = np.random.default_rng(m)
    trees = [random_tree(rng, scale=10.0 ** rng.integers(-2, 3))
             for _ in range(m)]
    assert_trees_equal(fed.trimmed_mean(trees, trim),
                       jfed.trimmed_mean(trees, trim))
    with pytest.raises(ValueError):
        fed.trimmed_mean([])


@pytest.mark.parametrize("aggregator", ["fedavg", "trimmed_mean"])
@pytest.mark.parametrize("m", [1, 2, 3, 5])
def test_aggregate_updates_bit_equal(aggregator, m):
    """Both aggregators, and trimmed_mean's FedAvg fallback below 3
    updates."""
    rng = np.random.default_rng(10 + m)
    trees = [random_tree(rng) for _ in range(m)]
    ns = rng.integers(10, 1000, size=m)
    got = fed.aggregate_updates(
        [fed.ClusterUpdate(i + 1, t, int(n))
         for i, (t, n) in enumerate(zip(trees, ns))], aggregator, 0.2)
    want = jfed.aggregate_updates(
        [jfed.ClusterUpdate(i + 1, t, int(n))
         for i, (t, n) in enumerate(zip(trees, ns))], aggregator, 0.2)
    assert_trees_equal(got, want)


def test_aggregate_updates_unknown_aggregator():
    u = [fed.ClusterUpdate(1, {"w": np.ones(2, np.float32)}, 1)]
    with pytest.raises(ValueError):
        fed.aggregate_updates(u, "krum")


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 1e6)])
def test_update_norm_bit_equal(seed, scale):
    rng = np.random.default_rng(seed)
    a, b = random_tree(rng, scale=scale), random_tree(rng)
    assert fed.update_norm(a, b) == jfed.update_norm(a, b)


@pytest.mark.parametrize("rows,offset", [(500, 0.0), (20_000, 4096.0)])
def test_moments_and_normalizers_bit_equal(rows, offset):
    rng = np.random.default_rng(rows)
    X = (rng.normal(size=(rows, 11)) + offset).astype(np.float32)
    got, want = fed.column_moments(X), jfed.column_moments(X)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    parts = [fed.column_moments(p) for p in np.array_split(X, 3)]
    norm, ref = fed.normalizer_from_moments(parts), \
        jfed.normalizer_from_moments(parts)
    np.testing.assert_array_equal(norm.mean, ref.mean)
    np.testing.assert_array_equal(norm.std, ref.std)
    y = np.abs(rng.normal(size=rows)).astype(np.float32) + 1.0
    port_ds = [fed.ClusterDataset(i, X[s], y[s]) for i, s in
               enumerate(np.array_split(np.arange(rows), 3))]
    jax_ds = [jfed.ClusterDataset(d.scheduler_id, d.X, d.y) for d in port_ds]
    for a, b in zip(fed.pooled_normalizers(port_ds),
                    jfed.pooled_normalizers(jax_ds)):
        np.testing.assert_array_equal(a.mean, b.mean)
        np.testing.assert_array_equal(a.std, b.std)


def test_pooled_normalizer_matches_exact():
    datasets = make_datasets(fed, 3, 500)
    feat, _ = fed.pooled_normalizers(datasets)
    exact = Normalizer.fit(np.concatenate([d.X for d in datasets]))
    np.testing.assert_allclose(feat.mean, exact.mean, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(feat.std, exact.std, rtol=1e-3, atol=1e-3)


def test_trimmed_mean_drops_tails_and_outvotes_an_attacker():
    trees = [{"w": np.full((2,), float(v), np.float32)}
             for v in (0.0, 1.0, 2.0, 3.0, 100.0)]
    np.testing.assert_allclose(fed.trimmed_mean(trees, 0.2)["w"], 2.0)
    honest = [{"w": np.array([1.0, -1.0], np.float32)} for _ in range(4)]
    attacker = {"w": np.array([1e9, -1e9], np.float32)}
    np.testing.assert_allclose(
        fed.trimmed_mean(honest + [attacker], 0.2)["w"], [1.0, -1.0])


def test_full_jitter_takes_a_numpy_generator():
    """The coordinator's retry path passes a numpy Generator."""
    rng = np.random.default_rng(0)
    delays = [full_jitter(k, 0.05, 1.0, rng) for k in range(8)]
    assert all(0.0 <= d <= min(1.0, 0.05 * 2 ** k)
               for k, d in enumerate(delays))
    assert delays == [full_jitter(k, 0.05, 1.0, g) for k, g in
                      zip(range(8), [np.random.default_rng(0)] * 8)]


# -- the admission screens -----------------------------------------------------


class _LinModel:
    """tests/test_federated.py:106's stand-in: ``apply`` is a linear map
    in the normalized z-space the screen scores in."""

    def apply(self, params, x):
        return np.asarray(x) @ np.asarray(params["w"])


def _identity_norms(normalizer_cls, dim=1):
    return (normalizer_cls(mean=np.zeros(dim, np.float32),
                           std=np.ones(dim, np.float32)),
            normalizer_cls(mean=np.zeros(1, np.float32),
                           std=np.ones(1, np.float32)))


def _slice_for(w, n=64, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 1)).astype(np.float32)
    return X, np.expm1(X @ np.asarray(w)).astype(np.float32)


def _screen_both(make_updates, global_params, *, model=None, holdout=None,
                 **config):
    """The same updates through both packages' ``screen_updates``."""
    reports = []
    for module, local_cls, norm_cls in ((fed, MLPTrainConfig, Normalizer),
                                        (jfed, JaxMLPConfig, JaxNormalizer)):
        cfg = module.FederatedConfig(local=local_cls(**TINY), **config)
        norms = (_identity_norms(norm_cls) if model is not None
                 else (None, None))
        reports.append(module.screen_updates(
            make_updates(module), global_params, config=cfg, model=model,
            normalizer=norms[0], target_norm=norms[1], holdout=holdout))
    return reports


def _assert_reports_equal(got, want):
    assert got.screened == want.screened
    assert [u.scheduler_id for u in got.admitted] == \
        [u.scheduler_id for u in want.admitted]
    assert got.norms == want.norms
    assert got.holdout_mse == want.holdout_mse


SCREEN_CASES = {
    "nonfinite": (lambda m: [
        m.ClusterUpdate(1, {"w": np.zeros(2, np.float32)}, 10),
        m.ClusterUpdate(2, {"w": np.array([1.0, np.nan], np.float32)}, 10),
        m.ClusterUpdate(3, {"w": np.array([np.inf, 0], np.float32)}, 10)],
        {}, {2: "nonfinite", 3: "nonfinite"}),
    "norm_two_finite": (lambda m: [
        m.ClusterUpdate(1, {"w": np.full(2, 0.1, np.float32)}, 10),
        m.ClusterUpdate(2, {"w": np.full(2, 1e6, np.float32)}, 10)],
        {}, {}),
    "norm_bound": (lambda m: [
        m.ClusterUpdate(1, {"w": np.full(2, 0.1, np.float32)}, 10),
        m.ClusterUpdate(2, {"w": np.full(2, 1e6, np.float32)}, 10),
        m.ClusterUpdate(3, {"w": np.full(2, 0.2, np.float32)}, 10),
        m.ClusterUpdate(4, {"w": np.full(2, 0.15, np.float32)}, 10)],
        {}, {2: "norm_bound"}),
    "disabled": (lambda m: [
        m.ClusterUpdate(1, {"w": np.full(2, 0.1, np.float32)}, 10),
        m.ClusterUpdate(2, {"w": np.full(2, 1e6, np.float32)}, 10),
        m.ClusterUpdate(3, {"w": np.full(2, 0.2, np.float32)}, 10)],
        {"screen_norm_factor": 0.0, "screen_holdout_factor": 0.0}, {}),
}


@pytest.mark.parametrize("case", sorted(SCREEN_CASES))
def test_screen_updates_non_model_bit_equal(case):
    make, config, expected = SCREEN_CASES[case]
    got, want = _screen_both(make, {"w": np.zeros(2, np.float32)}, **config)
    _assert_reports_equal(got, want)
    assert got.screened == expected


@pytest.mark.parametrize("n_honest", [1, 3])
def test_screen_updates_holdout_stub_bit_equal(n_honest):
    """The per-slice median defuses a poisoned slice (three honest
    clusters) and two survivors are judged against their peer (one)."""
    honest_w = np.array([[1.0]], np.float32)
    liar_w = np.array([[-1.0]], np.float32)

    def make(m):
        ups = [m.ClusterUpdate(i + 1, {"w": honest_w * (1 + 0.01 * i)}, 40)
               for i in range(n_honest)]
        return ups + [m.ClusterUpdate(9, {"w": liar_w}, 40)]

    slices = [_slice_for(honest_w, seed=s) for s in range(1, n_honest + 1)]
    if n_honest > 1:
        slices.append(_slice_for(liar_w, seed=9))  # poisoned labels
    got, want = _screen_both(make, {"w": np.zeros_like(honest_w)},
                             model=_LinModel(), holdout=slices,
                             screen_norm_factor=0.0)
    _assert_reports_equal(got, want)
    assert got.screened == {9: "holdout_regression"}


def _trained_like_trees(seed: int, n_honest: int = 3):
    """Honest updates near one base tree and a liar whose output layer is
    negated; a holdout whose targets are the base model's f32 output plus
    noise, so honest MSEs sit near the noise variance and the liar's far
    above factor × it."""
    rng = np.random.default_rng(seed)
    base = jax.device_get(JaxMLP(hidden=(16, 8)).init(
        jax.random.key(seed), jnp.zeros((1, 11))))
    honest = [jax.tree.map(lambda a: (np.asarray(a) + rng.normal(
        scale=0.02, size=a.shape)).astype(np.float32), base)
        for _ in range(n_honest)]
    liar = jax.tree.map(np.asarray, base)
    liar["params"]["Dense_2"] = {
        k: -np.asarray(v) * 3.0 for k, v in base["params"]["Dense_2"].items()}
    f32 = JaxMLP(hidden=(16, 8), dtype=jnp.float32)
    slices = []
    for s in range(n_honest):
        X = rng.normal(size=(256, 11)).astype(np.float32)
        z = np.asarray(f32.apply(base, X)) + rng.normal(scale=0.5, size=256)
        slices.append((X, np.expm1(z).astype(np.float32)))
    return honest + [liar], slices


@pytest.mark.parametrize("seed", [0, 1])
def test_screen_updates_holdout_real_mlp(seed):
    """The holdout screen through the bf16 MLP on both packages: equal
    verdicts on a round no verdict of which is near the factor, and
    holdout MSEs within BF16_TOL relative."""
    trees, slices = _trained_like_trees(seed)
    global_params = trees[0]
    reports = []
    for module, model in ((fed, MLPApply((16, 8), 11, "cpu")),
                          (jfed, JaxMLP(hidden=(16, 8)))):
        norm = module.Normalizer(np.zeros(11, np.float32),
                                 np.ones(11, np.float32))
        target = module.Normalizer(np.zeros(1, np.float32),
                                   np.ones(1, np.float32))
        local = (MLPTrainConfig if module is fed else JaxMLPConfig)(**TINY)
        reports.append(module.screen_updates(
            [module.ClusterUpdate(i + 1, t, 100) for i, t in
             enumerate(trees)], global_params,
            config=module.FederatedConfig(local=local,
                                          screen_norm_factor=0.0),
            model=model, normalizer=norm, target_norm=target,
            holdout=slices))
    got, want = reports
    ref = float(np.median(list(want.holdout_mse.values())))
    for sid, mse in want.holdout_mse.items():
        ratio = mse / ref
        assert not 0.8 * 3.0 < ratio < 1.25 * 3.0, (sid, ratio)
    assert got.screened == want.screened == {4: "holdout_regression"}
    assert [u.scheduler_id for u in got.admitted] == [1, 2, 3]
    for sid in want.holdout_mse:
        np.testing.assert_allclose(got.holdout_mse[sid],
                                   want.holdout_mse[sid], rtol=BF16_TOL)


# -- train_federated_mlp -------------------------------------------------------


def test_init_global_params_changes_nothing():
    """train_mlp from init_global_params' tree is train_mlp with its own
    init, bit for bit."""
    X, y = SyntheticCluster(n_hosts=12, seed=3).pair_example_columns(600)
    cfg = MLPTrainConfig(**TINY, seed=5)
    model, params = fed.init_global_params(cfg.hidden, X.shape[1], cfg.seed,
                                           "cpu")
    assert isinstance(model, MLPApply)
    a = train_mlp(X, y, cfg, "cpu", init_params=params)
    b = train_mlp(X, y, cfg, "cpu")
    assert a.step_losses == b.step_losses
    assert_trees_equal(a.params, b.params)


@pytest.fixture(scope="module")
def federated_pair():
    """``train_federated_mlp`` in both packages from the JAX package's
    initial tree (the port's ``init_global_params`` monkeypatched for the
    run), 3 clusters × 800 rows, TINY, 2 rounds."""
    jax_result = jfed.train_federated_mlp(
        make_datasets(jfed), jfed.FederatedConfig(
            local=JaxMLPConfig(**TINY), rounds=2), data_parallel_mesh())
    _, jax_init = jfed.init_global_params(TINY["hidden"], 11, 0)
    original = fed.init_global_params
    fed.init_global_params = lambda hidden, dim, seed, device=None: (
        MLPApply(hidden, dim, device), jax_init)
    try:
        port_result = fed.train_federated_mlp(
            make_datasets(fed), fed.FederatedConfig(
                local=MLPTrainConfig(**TINY), rounds=2), "cpu")
    finally:
        fed.init_global_params = original
    return port_result, jax_result


def test_train_federated_mlp_matches_jax(federated_pair):
    port, ref = federated_pair
    assert port.lineage == ref.lineage
    assert port.screened == ref.screened
    assert port.escalated == ref.escalated
    assert port.updates_screened == ref.updates_screened
    assert set(port.per_cluster) == set(ref.per_cluster) == {1, 2, 3}
    for sid in ref.per_cluster:
        np.testing.assert_allclose(port.per_cluster[sid].history,
                                   ref.per_cluster[sid].history,
                                   atol=LOSS_TOL)
    np.testing.assert_allclose(port.mse, ref.mse, rtol=METRIC_RTOL)
    np.testing.assert_allclose(port.mae, ref.mae, rtol=METRIC_RTOL)
    np.testing.assert_array_equal(port.normalizer.mean, ref.normalizer.mean)
    np.testing.assert_array_equal(port.target_norm.std, ref.target_norm.std)


def test_train_federated_mlp_degenerate_clusters(caplog):
    ds = make_datasets(fed, 1, 400)[0]
    tiny = fed.ClusterDataset(9, ds.X[:1], ds.y[:1])
    local = MLPTrainConfig(**TINY)
    with caplog.at_level("WARNING"):
        result = fed.train_federated_mlp(
            [ds, tiny], fed.FederatedConfig(local=local, rounds=1), "cpu")
    assert "below min_cluster_examples" in caplog.text
    assert set(result.lineage[0]) == {1}
    assert 9 not in result.per_cluster and np.isfinite(result.mae)
    dropped = fed.train_federated_mlp(
        [ds, tiny], fed.FederatedConfig(local=local, rounds=1), "cpu",
        eval_set=(ds.X[:50], ds.y[:50]))
    assert set(dropped.lineage[0]) == {1}
    with pytest.raises(ValueError):
        fed.train_federated_mlp([], fed.FederatedConfig(local=local), "cpu")
    with pytest.raises(ValueError):
        fed.train_federated_mlp([tiny], fed.FederatedConfig(local=local),
                                "cpu")


# -- the coordinator -----------------------------------------------------------


class StubEndpoint:
    """tests/test_federated.py:341's coordinator-protocol endpoint with
    no training: each round returns the global params shifted by a
    per-cluster constant (or NaN)."""

    def __init__(self, scheduler_id: int, *, fail_always: bool = False,
                 fail_times: int = 0, poison_nan: bool = False):
        self.scheduler_id = scheduler_id
        self.fail_always = fail_always
        self.fail_times = fail_times
        self.poison_nan = poison_nan
        self.train_calls = 0
        rng = np.random.default_rng(scheduler_id)
        self._X = rng.normal(size=(40, 3)).astype(np.float32)
        self._y = (np.abs(rng.normal(size=40)) + 1.0).astype(np.float32)

    def moments(self):
        return (fed.column_moments(self._X),
                fed.column_moments(np.log1p(self._y)[:, None]))

    def holdout(self):
        return (np.empty((0, 3), np.float32), np.empty((0,), np.float32))

    def train_round(self, round_idx, global_params, normalizer, target_norm):
        self.train_calls += 1
        if self.fail_always:
            raise RuntimeError(f"cluster {self.scheduler_id} down")
        if self.fail_times > 0:
            self.fail_times -= 1
            raise RuntimeError(f"cluster {self.scheduler_id} flaky")
        shift = np.nan if self.poison_nan else 0.01 * self.scheduler_id
        params = fed.tree_map(
            lambda leaf: np.asarray(leaf, np.float32) + shift, global_params)
        return fed.ClusterUpdate(self.scheduler_id, params, len(self._X))


def _fed_config(module=fedn, **kw):
    local = (MLPTrainConfig if module is fedn else JaxMLPConfig)(
        hidden=(4,), epochs=1, batch_size=32, eval_fraction=0.2)
    fed_module = fed if module is fedn else jfed
    # A 2 s deadline (tests/test_federated.py's is 10 s): the stubs answer
    # in milliseconds, and a round with a cluster down waits it out.
    base = dict(fed=kw.pop("fed", fed_module.FederatedConfig(local=local)),
                quorum=2, round_deadline_s=2.0, retry_limit=1,
                retry_base_s=0.001, retry_cap_s=0.002)
    base.update(kw)
    return module.FederationConfig(**base)


def _coordinator(endpoints, path, config, **kw):
    return fedn.FederationCoordinator(endpoints, str(path), config,
                                      device="cpu", **kw)


def test_pack_unpack_roundtrip():
    tree = {"layer": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                      "b": np.array([1.5, -2.0], np.float64)},
            "out": {"w": np.zeros((3, 1), np.float32)}}
    restored = fedn.unpack_params(fedn.pack_params(tree))
    assert_trees_equal(restored, tree)
    bare = np.arange(4, dtype=np.float32)
    np.testing.assert_array_equal(
        fedn.unpack_params(fedn.pack_params(bare)), bare)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pack_params_cross_package(direction, seed):
    """A packed tree unpacks bit-exact in the other package, and both
    packages write the same JSON for the same tree."""
    rng = np.random.default_rng(seed)
    tree = random_tree(rng, hidden=(8, 4))
    tree["params"]["Dense_0"]["bias"][0] = np.float32(-0.0)
    pack, unpack = ((fedn.pack_params, jfedn.unpack_params)
                    if direction == "port_to_jax" else
                    (jfedn.pack_params, fedn.unpack_params))
    restored = unpack(json.loads(json.dumps(pack(tree))))
    assert_trees_equal(restored, tree)
    assert np.signbit(restored["params"]["Dense_0"]["bias"][0])
    assert fedn.pack_params(tree)["paths"] == jfedn.pack_params(tree)["paths"]


def test_quorum_outside_range_rejected(tmp_path):
    endpoints = [StubEndpoint(1), StubEndpoint(2)]
    for quorum in (0, 3):
        with pytest.raises(ValueError):
            _coordinator(endpoints, tmp_path, _fed_config(quorum=quorum))
    with pytest.raises(ValueError):
        _coordinator([StubEndpoint(1), StubEndpoint(1)], tmp_path,
                     _fed_config())


def test_straggler_commits_at_quorum(tmp_path):
    coordinator = _coordinator(
        [StubEndpoint(1), StubEndpoint(2), StubEndpoint(3, fail_always=True)],
        tmp_path, _fed_config(quorum=2))
    report = coordinator.run_round()
    assert report.committed
    assert report.received == [1, 2]
    assert report.stragglers == [3]
    assert coordinator.stats["rounds_committed"] == 1
    assert coordinator.drain(timeout=10.0)


def test_transient_failure_retried(tmp_path):
    flaky = StubEndpoint(2, fail_times=1)
    report = _coordinator([StubEndpoint(1), flaky], tmp_path,
                          _fed_config(quorum=2)).run_round()
    assert report.committed and report.received == [1, 2]
    assert flaky.train_calls == 2


def test_quorum_failure_keeps_journal_then_resumes(tmp_path):
    config = _fed_config(quorum=3, retry_limit=0)
    first = [StubEndpoint(1), StubEndpoint(2),
             StubEndpoint(3, fail_always=True)]
    coordinator = _coordinator(first, tmp_path, config)
    with pytest.raises(fedn.FederationQuorumError):
        coordinator.run_round()
    assert coordinator.stats["quorum_failures"] == 1
    second = [StubEndpoint(1), StubEndpoint(2), StubEndpoint(3)]
    resumed = _coordinator(second, tmp_path, config)
    report = resumed.run_round()
    assert report.committed and report.round == 0
    assert report.resumed == [1, 2] and report.received == [1, 2, 3]
    assert [e.train_calls for e in second] == [0, 0, 1]
    clean = _coordinator([StubEndpoint(1), StubEndpoint(2), StubEndpoint(3)],
                         tmp_path / "clean", config)
    clean.run_round()
    assert_trees_equal(resumed.global_params, clean.global_params)


def test_nan_endpoint_screened_and_escalated(tmp_path):
    fed_cfg = fed.FederatedConfig(
        local=MLPTrainConfig(hidden=(4,), epochs=1, batch_size=32,
                             eval_fraction=0.2),
        screen_quarantine_rounds=2)
    coordinator = _coordinator(
        [StubEndpoint(1), StubEndpoint(2), StubEndpoint(5, poison_nan=True)],
        tmp_path, _fed_config(fed=fed_cfg, quorum=3))
    first = coordinator.run_round()
    assert first.screened == {5: "nonfinite"}
    assert first.admitted == [1, 2] and first.escalated == []
    second = coordinator.run_round()
    assert second.screened == {5: "nonfinite"} and second.escalated == [5]
    assert coordinator.stats["updates_screened"] == 2


def test_state_survives_restart_between_rounds(tmp_path):
    config = _fed_config(quorum=2)
    coordinator = _coordinator([StubEndpoint(1), StubEndpoint(2)], tmp_path,
                               config)
    coordinator.run_round()
    reloaded = _coordinator([StubEndpoint(1), StubEndpoint(2)], tmp_path,
                            config)
    assert reloaded.next_round == 1
    assert_trees_equal(reloaded.global_params, coordinator.global_params)
    with open(tmp_path / "state.json") as f:
        state = json.load(f)
    state["version"] = 2
    with open(tmp_path / "state.json", "w") as f:
        json.dump(state, f)
    with pytest.raises(ValueError):
        _coordinator([StubEndpoint(1), StubEndpoint(2)], tmp_path, config)


class JaxStubEndpoint(StubEndpoint):
    """The same stub, returning the JAX package's ClusterUpdate."""

    def train_round(self, *args):
        u = super().train_round(*args)
        return jfed.ClusterUpdate(u.scheduler_id, u.params, u.n_samples)


def _port_coordinator(endpoints, path):
    return _coordinator(endpoints, path, _fed_config(quorum=4,
                                                     retry_limit=0))


def _jax_coordinator(endpoints, path):
    return jfedn.FederationCoordinator(
        endpoints, str(path), _fed_config(jfedn, quorum=4, retry_limit=0))


PACKAGES = {"port": (_port_coordinator, StubEndpoint,
                     fedn.FederationQuorumError),
            "jax": (_jax_coordinator, JaxStubEndpoint,
                    jfedn.FederationQuorumError)}


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_journal_resumes_across_packages(tmp_path, writer, reader):
    """One package's coordinator commits round 0 (a NaN cluster screened:
    one strike), then dies short of quorum in round 1 with three updates
    journaled. The other package's coordinator opens the same journal at
    the same round with the same strikes, lineage and params, trains only
    the missing cluster, and commits the bits an uninterrupted run of the
    writer commits."""
    make_w, stub_w, quorum_error = PACKAGES[writer]
    make_r, stub_r, _ = PACKAGES[reader]

    def endpoints(cls, down=False):
        return [cls(1), cls(2), cls(4, fail_always=down),
                cls(5, poison_nan=True)]

    first = make_w(endpoints(stub_w), tmp_path)
    first.run_round()
    with pytest.raises(quorum_error):
        make_w(endpoints(stub_w, down=True), tmp_path).run_round()
    with open(tmp_path / "round_000001.json") as f:
        assert sorted(json.load(f)["updates"]) == ["1", "2", "5"]

    reader_eps = endpoints(stub_r)
    resumed = make_r(reader_eps, tmp_path)
    assert resumed.next_round == 1
    assert resumed._strikes == first._strikes == {1: 0, 2: 0, 4: 0, 5: 1}
    assert resumed._lineage == first._lineage
    assert resumed._screened_hist == first._screened_hist
    assert_trees_equal(resumed.global_params, first.global_params)
    report = resumed.run_round()
    assert list(report.resumed) == [1, 2, 5]
    assert list(report.received) == [1, 2, 4, 5]
    assert [e.train_calls for e in reader_eps] == [0, 0, 1, 0]

    clean = make_w(endpoints(stub_w), tmp_path / "clean")
    clean.run(2)
    assert_trees_equal(resumed.global_params, clean.global_params)
    assert resumed._strikes == clean._strikes


# -- local fits through the coordinator ----------------------------------------


def _local_run(path, *, deadline_s=120.0, endpoints_kw=None):
    local = fedbench._kill_local_config(seed=0)
    corpora = fedbench.synth_cluster_corpora(3, 120, seed=0)
    endpoints = [fedn.LocalClusterEndpoint(ds, local, "cpu",
                                           **(endpoints_kw or {}).get(
                                               ds.scheduler_id, {}))
                 for ds in fed.cluster_datasets_from_corpora(corpora)]
    config = fedn.FederationConfig(fed=fed.FederatedConfig(local=local),
                                   quorum=3, round_deadline_s=deadline_s)
    return _coordinator(endpoints, path, config), endpoints


def test_local_fits_two_runs_bit_identical(tmp_path):
    """tests/test_federated.py:532 on the port: real local fits through
    the coordinator, two fresh journals, the same bits."""
    params = []
    for name in ("a", "b"):
        coordinator, _ = _local_run(tmp_path / name)
        assert all(r.committed for r in coordinator.run(2))
        params.append(coordinator.global_params)
    assert_trees_equal(params[0], params[1])


def test_local_fits_resumed_equals_clean(tmp_path):
    """Cluster 3 straggles past the deadline (and its late attempt
    fails, so it journals nothing): quorum fails with two updates
    journaled; a new coordinator trains only cluster 3 and commits the
    clean run's bits. The straggler's thread is drained first."""
    counter = str(tmp_path / "counts.txt")
    kw = {sid: {"counter_path": counter} for sid in (1, 2, 3)}
    kw[3].update(delay_s=6.0, fail_times=1)
    coordinator, _ = _local_run(tmp_path / "j", deadline_s=5.0,
                                endpoints_kw=kw)
    with pytest.raises(fedn.FederationQuorumError):
        coordinator.run_round()
    assert coordinator.drain(timeout=30.0)
    with open(tmp_path / "j" / "round_000000.json") as f:
        assert sorted(json.load(f)["updates"]) == ["1", "2"]
    resumed, eps = _local_run(tmp_path / "j", endpoints_kw={
        sid: {"counter_path": counter} for sid in (1, 2, 3)})
    report = resumed.run_round()
    assert report.resumed == [1, 2] and report.received == [1, 2, 3]
    assert [e.train_calls for e in eps] == [0, 0, 1]
    with open(counter) as f:
        fits = [line.split()[0] for line in f]
    assert sorted(fits) == ["1", "2", "3"]
    clean, _ = _local_run(tmp_path / "clean")
    clean.run_round()
    assert_trees_equal(resumed.global_params, clean.global_params)


def test_endpoints_from_storage_match_jax(tmp_path):
    """Replay segments of three hosts (two share a scheduler id) as CSV
    written by the port: the port's endpoints carry the JAX package's
    holdout slices and moments, read through each package's storage."""
    from dragonfly2_tpu.train import fedbench as jax_fedbench
    from dragonfly2_tpu.trainer.storage import TrainerStorage as JaxStorage
    from dragonfly2_tpu_torch.schema import ReplayDecision
    from dragonfly2_tpu_torch.schema.io import CsvRecordWriter
    from dragonfly2_tpu_torch.trainer.storage import TrainerStorage

    corpora = fedbench.synth_cluster_corpora(2, 60, seed=4)
    hosts = {"h1": ("10.0.0.1", "a", 7), "h2": ("10.0.0.2", "b", 7),
             "h3": ("10.0.0.3", "c", 9)}
    parts = {"h1": corpora[1].slice(0, 30), "h2": corpora[1].slice(30, 60),
             "h3": corpora[2]}
    port_st = TrainerStorage(str(tmp_path / "port"))
    jax_st = JaxStorage(str(tmp_path / "jax"))
    for host, corpus in parts.items():
        path = str(tmp_path / f"{host}.csv")
        with CsvRecordWriter(ReplayDecision, path) as writer:
            for event in corpus.decisions():
                writer.write(event)
        with open(path, "rb") as f:
            data = f.read()
        for st in (port_st, jax_st):
            st.append("replay", host, data, new_file=True)
            st.close_host(host)
    local = fedbench._kill_local_config(seed=0)
    got = fedn.endpoints_from_storage(port_st, hosts, local, "cpu")
    want = jfedn.endpoints_from_storage(
        jax_st, hosts, jax_fedbench._kill_local_config(0))
    assert [e.scheduler_id for e in got] == [e.scheduler_id for e in want] \
        == [7, 9]
    for a, b in zip(got, want):
        for u, v in zip(a.holdout(), b.holdout()):
            np.testing.assert_array_equal(u, v)
        for u, v in zip(a.moments(), b.moments()):
            assert u[0] == v[0]
            np.testing.assert_array_equal(u[1], v[1])
            np.testing.assert_array_equal(u[2], v[2])


# -- the registry half ---------------------------------------------------------


def _port_manager(tmp_path, **kw):
    return ManagerService(Database(),
                          FilesystemObjectStore(str(tmp_path / "obj")),
                          device="cpu", **kw)


def _upload(manager, result, scheduler_id, n, tmp_path, tag, hidden):
    d = tempfile.mkdtemp(dir=tmp_path, prefix=tag)
    save_model(d, mlp_tree(result.params, result.normalizer,
                           result.target_norm),
               ModelMetadata(model_id=f"m{scheduler_id}", model_type="mlp",
                             evaluation={"mae": result.mae, "n_samples": n},
                             config={"hidden": list(hidden)}))
    manager.create_model(f"m{scheduler_id}", "mlp", "h", "1.1.1.1", "hn",
                         {"mae": result.mae, "n_samples": n}, d,
                         scheduler_id=scheduler_id)


def test_register_federated_model_loads_in_jax(federated_pair, tmp_path):
    """The port registers its global under GLOBAL_SCHEDULER_ID with
    lineage; the registered tree loads in JAX's ``mlp_from_tree`` and
    scores within BF16_TOL of the port's forward."""
    port_result, _ = federated_pair
    manager = _port_manager(tmp_path)
    row = fed.register_federated_model(manager, port_result)
    assert row.state == "active" and row.scheduler_id == fed.GLOBAL_SCHEDULER_ID
    active = manager.get_active_model("mlp", fed.GLOBAL_SCHEDULER_ID)
    assert active.evaluation["clusters"] == 3
    assert manager.get_active_model("mlp", scheduler_id=5) is None
    tree, metadata = load_artifact(active.artifact)
    assert metadata.config["lineage"] == [
        {str(k): v for k, v in r.items()} for r in port_result.lineage]
    params, norm, target = jax_checkpoint.mlp_from_tree(tree)
    X = make_datasets(fed, 1, 300)[0].X
    want = np.asarray(JaxMLP(hidden=tuple(metadata.config["hidden"])).apply(
        params, JaxNormalizer(norm.mean, norm.std)(X)))
    got = MLPApply(TINY["hidden"], 11, "cpu").apply(
        port_result.params, port_result.normalizer(X))
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL)


def test_escalates_active_model_to_quarantine(tmp_path):
    manager = _port_manager(tmp_path)
    ds = make_datasets(fed, 1, 300)[0]
    result = train_mlp(ds.X, ds.y, MLPTrainConfig(**TINY), "cpu")
    _upload(manager, result, 7, len(ds.X), tmp_path, "m7", TINY["hidden"])
    assert manager.get_active_model("mlp", scheduler_id=7) is not None
    out = fed.escalate_screened_clusters(manager, [7, 8])
    assert out[7] is not None and out[8] is None
    assert manager.get_active_model("mlp", scheduler_id=7) is None


@pytest.mark.parametrize("shared", [True, False])
def test_aggregate_cluster_models(tmp_path, shared):
    """Models trained under one pooled normalizer aggregate at the
    reserved slot (cluster slots untouched); models with their own
    normalizers are refused."""
    manager = _port_manager(tmp_path)
    datasets = make_datasets(fed, 2, 500)
    norms = fed.pooled_normalizers(datasets) if shared else (None, None)
    for ds in datasets:
        result = train_mlp(ds.X, ds.y, MLPTrainConfig(**TINY), "cpu",
                           normalizer=norms[0], target_norm=norms[1])
        _upload(manager, result, ds.scheduler_id, len(ds.X), tmp_path,
                "c", TINY["hidden"])
    assert fed.aggregate_cluster_models(manager, TINY["hidden"]) is shared
    assert (manager.get_active_model("mlp", fed.GLOBAL_SCHEDULER_ID)
            is not None) is shared
    for ds in datasets:
        assert manager.get_active_model("mlp", ds.scheduler_id) is not None


# -- the bench's rungs ---------------------------------------------------------


def test_kill_rung_on_the_cpu(tmp_path):
    out = fedbench.run_federated_kill(str(tmp_path), device="cpu")
    assert out["ok"], out
    assert out["resumed"] == out["killed_after_updates"]
    assert len(out["killed_after_updates"]) >= 2
    assert out["no_retrain"] is True


def test_run_federated_bench_passes_on_the_cpu():
    report = fedbench.run_federated_bench(include_kill=False, device="cpu")
    assert report["error"] is None, report["error"]
    assert report["verdict_pass"], report
    assert report["clean"]["gate_state"] == "active"
    assert report["poisoned"]["screens_ok"]
    assert report["poisoned"]["escalated"] == [4, 5]
    assert report["poisoned"]["quarantined_version"] is not None
    assert report["clean"]["deterministic"]
    assert set(report["seconds"]) == {"clean", "poisoned", "ab"}


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """``device=None`` is the card: without one the entry points raise
    instead of running on the CPU."""
    from dragonfly2_tpu_torch.device import DeviceFault

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceFault):
        fed.init_global_params((4,), 3, 0)
    with pytest.raises(DeviceFault):
        fed.train_federated_mlp(make_datasets(fed, 1, 100),
                                fed.FederatedConfig(local=MLPTrainConfig(
                                    **TINY)))
    with pytest.raises(DeviceFault):
        fedn.FederationCoordinator([StubEndpoint(1)], str(tmp_path),
                                   _fed_config(quorum=1))
    report = fedbench.run_federated_bench(include_kill=False)
    assert report["verdict_pass"] is False
    assert report["error"].startswith("DeviceFault")
