"""Federated multi-cluster training + manager-side aggregation
(BASELINE config #4) — port of ``dragonfly2_tpu/train/federated.py``.

The manager aggregates many scheduler clusters, and every scheduler's
trainer uploads its own model keyed by SchedulerID (unique (type,
version, scheduler_id) in the registry). Each cluster trains locally on
its own download dataset (``train_mlp`` on its card), the round's models
FedAvg into a global model weighted by sample count, and the manager
registers the aggregate under ``GLOBAL_SCHEDULER_ID`` with full lineage —
preserving the per-cluster single-active invariant AND giving the fleet
one blessed global model.

Normalization: FedAvg of raw parameters is only meaningful under one
shared feature/target normalization, so round 0 fits a GLOBAL normalizer
from per-cluster moments (exact pooled mean/variance, no raw data
pooling) and every local trainer reuses it.

Robustness: every per-cluster update passes an admission screen before
it touches the aggregate — finite leaves (``params_guard_reason``), an
update-norm bound relative to the round median (norm-scaling attacks),
and a pooled-holdout regression screen (a cluster whose local model
scores the shared holdout far worse than its peers is lying about its
data). Coordinate-wise trimmed mean is available as a robust aggregator
behind ``FederatedConfig.aggregator`` (FedAvg stays the default). A
cluster screened N consecutive rounds escalates to registry quarantine
(:func:`escalate_screened_clusters`).

Parameter trees are nested dicts of numpy arrays in the flax layout
(``{"params": {"Dense_0": {"kernel", "bias"}, …}}``); :func:`tree_map`
walks them in sorted key order as ``jax.tree.map`` does, so aggregation
and the non-model screens are the JAX package's numpy arithmetic, bit
for bit, on the same updates: same corpora + seed ⇒ bit-identical global
params.
"""

from __future__ import annotations

import logging
import math
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dragonfly2_tpu_torch.device import default_device
from dragonfly2_tpu_torch.inference.modelguard import params_guard_reason
from dragonfly2_tpu_torch.models.mlp import (
    MLPApply,
    MLPBandwidthPredictor,
    Normalizer,
    predict_bandwidth,
)
from dragonfly2_tpu_torch.parallel.mesh import LOCAL
from dragonfly2_tpu_torch.train.checkpoint import (
    ModelMetadata,
    flax_from_mlp_state_dict,
    load_model,
    mlp_from_tree,
    mlp_tree,
    save_model,
    untar_to_directory,
)
from dragonfly2_tpu_torch.train.mlp_trainer import (
    MLPTrainConfig,
    MLPTrainResult,
    bandwidth_examples_from_corpus,
    train_mlp,
)

logger = logging.getLogger(__name__)


def tree_map(fn, *trees):
    """``jax.tree.map`` over nested dicts: ``fn`` on the leaves of
    ``trees`` (one structure), keys in sorted order."""
    first = trees[0]
    if isinstance(first, dict):
        return {key: tree_map(fn, *(tree[key] for tree in trees))
                for key in sorted(first)}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """``jax.tree.leaves`` over nested dicts: leaves in sorted key
    order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in tree_leaves(tree[key])]
    return [tree]


# The aggregate's registry slot. Must NOT collide with real scheduler ids:
# the trainer's default upload path registers at scheduler_id=0, so the
# global model lives at -1 and never evicts a cluster model.
GLOBAL_SCHEDULER_ID = -1


@dataclass
class ClusterDataset:
    """One scheduler cluster's local download examples."""

    scheduler_id: int
    X: np.ndarray  # [n, FEATURE_DIM] raw features
    y: np.ndarray  # [n] MB/s


def cluster_datasets_from_corpora(
    corpora, piece_mb: float = 4.0,
) -> List[ClusterDataset]:
    """Per-replica federated inputs straight off replay corpora — each
    cluster's recorded decisions become its local (features, MB/s)
    examples with no per-row parse when the corpus is columnar
    (``scheduler.replaystore.ColumnarCorpus``: three whole-corpus mask
    ops over its columns).

    ``corpora``: mapping ``scheduler_id -> corpus`` or a sequence of
    ``(scheduler_id, corpus)`` pairs; clusters with zero realized
    examples are dropped (an all-empty input returns ``[]``, which
    ``train_federated_mlp`` rejects loudly)."""
    pairs = corpora.items() if hasattr(corpora, "items") else corpora
    datasets = []
    for scheduler_id, corpus in pairs:
        X, y = bandwidth_examples_from_corpus(corpus, piece_mb=piece_mb)
        if len(X):
            datasets.append(ClusterDataset(int(scheduler_id), X, y))
        else:
            logger.info("cluster %s: no realized replay examples; skipped",
                        scheduler_id)
    return datasets


@dataclass(frozen=True)
class FederatedConfig:
    local: MLPTrainConfig = MLPTrainConfig()
    rounds: int = 3
    #: "fedavg" (sample-weighted mean) or "trimmed_mean" (coordinate-wise
    #: trimmed mean — robust to a minority of arbitrary updates). With
    #: fewer than 3 admitted updates trimming is meaningless and the
    #: aggregator falls back to FedAvg.
    aggregator: str = "fedavg"
    #: Fraction trimmed from EACH end per coordinate under trimmed_mean.
    trim_fraction: float = 0.2
    #: Screen an update whose L2 distance from the current global params
    #: exceeds this multiple of the round-median distance (needs >= 3
    #: finite updates for the median to out-vote one attacker). 0 disables.
    screen_norm_factor: float = 4.0
    #: Screen an update whose local model's pooled-holdout MSE (in the
    #: normalized log-target space training optimizes — scale-calibrated,
    #: so the bound means the same thing on every corpus) exceeds this
    #: multiple of the median of its PEERS' MSEs. 0 disables.
    screen_holdout_factor: float = 3.0
    #: A cluster screened this many CONSECUTIVE rounds escalates to
    #: registry quarantine (admission resets the strike count). 0 disables.
    screen_quarantine_rounds: int = 3
    #: Clusters with fewer local examples contribute to the pooled
    #: holdout only (or are dropped with a warning when the caller
    #: supplied the holdout) — never an empty local fit.
    min_cluster_examples: int = 8


@dataclass
class ClusterUpdate:
    """One cluster's round contribution, as seen by the screens."""

    scheduler_id: int
    params: dict
    n_samples: int


@dataclass
class ScreenReport:
    """Outcome of one round's admission screen."""

    admitted: List[ClusterUpdate]
    screened: Dict[int, str]  # scheduler_id -> reason
    norms: Dict[int, float]  # update L2 norms (finite updates only)
    holdout_mse: Dict[int, float]  # per-update holdout MSE (if screened on)


@dataclass
class FederatedResult:
    params: dict
    normalizer: Normalizer
    target_norm: Normalizer
    config: FederatedConfig
    mse: float
    mae: float
    # Lineage: per round, {scheduler_id: n_samples} that contributed.
    lineage: List[Dict[int, int]] = field(default_factory=list)
    per_cluster: Dict[int, MLPTrainResult] = field(default_factory=dict)
    # Per round, {scheduler_id: reason} for updates the screen rejected.
    screened: List[Dict[int, str]] = field(default_factory=list)
    updates_screened: int = 0
    # Clusters screened screen_quarantine_rounds consecutive rounds.
    escalated: List[int] = field(default_factory=list)


def column_moments(x: np.ndarray) -> Tuple[int, np.ndarray, np.ndarray]:
    """(n, Σx, Σx²) for one cluster's columns — the only thing a cluster
    ships for normalizer pooling. Both sums accumulate in float64: on
    multi-million-row float32 corpora a float32 Σx loses low-order mass
    and the pooled mean drifts from a centrally fitted one."""
    x64 = x.astype(np.float64)
    return len(x), x64.sum(axis=0), (x64**2).sum(axis=0)


def normalizer_from_moments(
    moments: Sequence[Tuple[int, np.ndarray, np.ndarray]],
) -> Normalizer:
    """Exact pooled mean/std from per-cluster (n, Σx, Σx²) moments."""
    n = sum(m[0] for m in moments)
    s1 = np.sum([np.asarray(m[1], np.float64) for m in moments], axis=0)
    s2 = np.sum([np.asarray(m[2], np.float64) for m in moments], axis=0)
    mean = s1 / n
    var = np.maximum(s2 / n - mean**2, 0.0)
    # Same epsilon convention as Normalizer.fit (+1e-6, mlp.py:40) so a
    # pooled normalizer is bit-comparable with a centrally fitted one.
    std = np.sqrt(var) + 1e-6
    return Normalizer(mean=mean.astype(np.float32),
                      std=std.astype(np.float32))


def pooled_normalizers(
    datasets: Sequence[ClusterDataset],
) -> Tuple[Normalizer, Normalizer]:
    """Exact pooled mean/std from per-cluster moments — each cluster ships
    (n, Σx, Σx²), never raw rows."""
    feat = normalizer_from_moments([column_moments(d.X) for d in datasets])
    target = normalizer_from_moments(
        [column_moments(np.log1p(d.y)[:, None]) for d in datasets])
    return feat, target


def fedavg(param_trees: Sequence, weights: Sequence[float]):
    """Sample-weighted parameter average (McMahan et al. FedAvg)."""
    total = float(sum(weights))
    norm = [w / total for w in weights]

    def avg(*leaves):
        return sum(w * leaf for w, leaf in zip(norm, leaves))

    return tree_map(avg, *param_trees)


def trimmed_mean(param_trees: Sequence, trim_fraction: float = 0.2):
    """Coordinate-wise trimmed mean: per parameter coordinate, drop the k
    largest and k smallest values across updates and average the rest.
    Robust to up to k arbitrary updates per coordinate (Yin et al. 2018)
    — a poisoned value that slips the screens lands in the trimmed tails
    instead of the average. Pure sorted-numpy: bit-deterministic."""
    m = len(param_trees)
    if m == 0:
        raise ValueError("no parameter trees")
    k = min(int(m * trim_fraction), (m - 1) // 2)

    def agg(*leaves):
        stacked = np.sort(
            np.stack([np.asarray(leaf) for leaf in leaves], axis=0), axis=0)
        kept = stacked[k:m - k]
        return kept.mean(axis=0, dtype=np.float64).astype(stacked.dtype)

    return tree_map(agg, *param_trees)


def aggregate_updates(updates: Sequence[ClusterUpdate], aggregator: str,
                      trim_fraction: float = 0.2):
    """Dispatch on the ``FederatedConfig.aggregator`` knob. Trimmed mean
    needs >= 3 updates for the trim to out-vote an attacker; below that
    it degrades to FedAvg (logged)."""
    if aggregator not in ("fedavg", "trimmed_mean"):
        raise ValueError(f"unknown aggregator {aggregator!r}")
    trees = [u.params for u in updates]
    if aggregator == "trimmed_mean":
        if len(trees) >= 3:
            return trimmed_mean(trees, trim_fraction)
        logger.warning("trimmed_mean with %d updates degrades to fedavg",
                       len(trees))
    return fedavg(trees, [u.n_samples for u in updates])


def update_norm(params, global_params) -> float:
    """L2 distance between an update and the current global params, in
    float64 (the norm screen must not overflow on a scaled attack)."""
    diffs = tree_map(
        lambda a, b: np.asarray(a, np.float64) - np.asarray(b, np.float64),
        params, global_params)
    return float(np.sqrt(sum(float((d**2).sum())
                             for d in tree_leaves(diffs))))


def init_global_params(hidden: Sequence[int], feature_dim: int, seed: int,
                       device=None):
    """The shared round-0 starting point → ``(model, params)``: an
    :class:`~dragonfly2_tpu_torch.models.mlp.MLPApply` on ``device``
    (``None``: the card) and the flax-layout tree ``{"params": …}``. Same
    construction as ``MLPTrainer``'s own init (``torch.Generator()
    .manual_seed(seed)``), so pre-initializing changes nothing for clean
    fleets — but it makes "update = local − global" well-defined in EVERY
    round, including the first, which the norm screen needs."""
    model = MLPBandwidthPredictor(
        hidden=tuple(hidden), in_features=feature_dim,
        generator=torch.Generator().manual_seed(seed))
    params = {"params": flax_from_mlp_state_dict(model.state_dict())}
    return MLPApply(hidden, feature_dim, device), params


def screen_updates(
    updates: Sequence[ClusterUpdate],
    global_params,
    *,
    config: FederatedConfig,
    model=None,
    normalizer: Normalizer | None = None,
    target_norm: Normalizer | None = None,
    holdout=None,  # (X, y) or sequence of per-cluster (X, y) slices
) -> ScreenReport:
    """The admission screen every update passes before aggregation.

    Three screens, in escalating cost order:

    1. ``nonfinite`` — any NaN/Inf float leaf
       (:func:`~dragonfly2_tpu_torch.inference.modelguard.params_guard_reason`,
       the shared guard discipline: one definition of "poisoned" across
       serving and training).
    2. ``norm_bound`` — update L2 norm (distance from the current global
       params) above ``screen_norm_factor`` × the round-median norm.
       Catches norm-scaling attacks; needs >= 3 finite updates so one
       attacker cannot own the median.
    3. ``holdout_regression`` — the update's model scores the holdout
       with MSE above ``screen_holdout_factor`` × the round-median MSE.
       With >= 3 survivors the median spans ALL survivor scores (an
       honest majority owns it, and each honestly-heterogeneous
       cluster's own score keeps the reference from collapsing onto the
       easy bands); with exactly 2 the all-median is the midpoint and
       can never flag either side, so each update is judged against its
       peer's score instead. Measured in the
       NORMALIZED log-target space training optimizes: raw-MB/s MSE is
       dominated by the heavy bandwidth tail and by honest cross-band
       extrapolation error, which would drown the lying cluster's
       signal; z-space is where a model trained on flipped/scaled
       labels stands apart from honestly-heterogeneous peers.

    ``holdout`` is either one pooled ``(X, y)`` pair or a sequence of
    per-cluster ``(X, y)`` slices. With slices, an update's score is
    the MEDIAN of its per-slice MSEs — clusters volunteer their own
    holdout rows, so a lying cluster's slice carries poisoned labels
    that would reward its own model and punish honest ones in a pooled
    mean; the per-slice median discards any minority of poisoned
    slices. Both holdout forms assume a majority-honest round (the
    medians must land on honest values).

    Pure numpy over the given inputs — bit-deterministic — but for
    ``model.apply``, the bf16 MLP's forward on the model's device (the
    same bits for the same inputs on one device; within bf16 rounding of
    the JAX package's).
    """
    screened: Dict[int, str] = {}
    norms: Dict[int, float] = {}
    holdout_mse: Dict[int, float] = {}

    finite = []
    for u in updates:
        reason = params_guard_reason(u.params)
        if reason is not None:
            screened[u.scheduler_id] = reason
        else:
            finite.append(u)

    survivors = finite
    if config.screen_norm_factor > 0 and len(finite) >= 3:
        for u in finite:
            norms[u.scheduler_id] = update_norm(u.params, global_params)
        median = float(np.median(list(norms.values())))
        bound = config.screen_norm_factor * median
        survivors = []
        for u in finite:
            if median > 0 and norms[u.scheduler_id] > bound:
                screened[u.scheduler_id] = "norm_bound"
            else:
                survivors.append(u)

    if holdout is not None and isinstance(holdout, tuple):
        holdout = [holdout]
    slices = [s for s in (holdout or []) if len(s[0])]
    if (config.screen_holdout_factor > 0 and slices
            and model is not None and len(survivors) >= 2):
        z_slices = []
        for hold_X, hold_y in slices:
            x_norm = normalizer(hold_X)
            z_true = ((np.log1p(hold_y) - target_norm.mean[0])
                      / target_norm.std[0])
            z_slices.append((x_norm, z_true))
        for u in survivors:
            per_slice = []
            for x_norm, z_true in z_slices:
                z_pred = np.asarray(model.apply(u.params, x_norm))
                per_slice.append(float(((z_pred - z_true) ** 2).mean()))
            holdout_mse[u.scheduler_id] = float(np.median(per_slice))
        admitted = []
        all_scores = [holdout_mse[u.scheduler_id] for u in survivors]
        for u in survivors:
            if len(survivors) >= 3:
                reference = float(np.median(all_scores))
            else:
                reference = float(np.median(
                    [holdout_mse[v.scheduler_id] for v in survivors
                     if v.scheduler_id != u.scheduler_id]))
            mse = holdout_mse[u.scheduler_id]
            if mse > config.screen_holdout_factor * reference + 1e-12:
                screened[u.scheduler_id] = "holdout_regression"
            else:
                admitted.append(u)
        survivors = admitted

    return ScreenReport(admitted=list(survivors), screened=screened,
                        norms=norms, holdout_mse=holdout_mse)


def train_federated_mlp(
    datasets: Sequence[ClusterDataset],
    config: FederatedConfig = FederatedConfig(),
    device=None,
    eval_set: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> FederatedResult:
    """R rounds of local training + FedAvg.

    In this single-process form the locals run back to back on one
    ``device`` (``None``: the card) — the aggregation math and lineage
    are those of a fleet whose clusters train on their own cards and
    ship only parameter trees.
    """
    if not datasets:
        raise ValueError("no cluster datasets")
    device = default_device(device)

    # A cluster below min_cluster_examples cannot sustain a local fit
    # (a 1-example cluster used to get n_hold=1 and an EMPTY training
    # set handed to train_mlp). Small clusters contribute their rows to
    # the pooled holdout only; when the caller supplied the holdout they
    # are dropped with a warning — never an empty local fit.
    min_n = max(int(config.min_cluster_examples), 2)
    small = [ds for ds in datasets if len(ds.X) < min_n]
    datasets = [ds for ds in datasets if len(ds.X) >= min_n]
    if small:
        logger.warning(
            "clusters %s below min_cluster_examples=%d: %s",
            [ds.scheduler_id for ds in small], min_n,
            "holdout-only" if eval_set is None else "dropped")
    if not datasets:
        raise ValueError(
            f"no cluster has >= {min_n} examples; nothing to train")

    # Honest global metrics: without a caller-provided eval set, hold out a
    # per-cluster fraction BEFORE any training. Evaluating the aggregate on
    # its own training rows would publish optimistically-biased registry
    # metrics next to the per-cluster models' held-out ones.
    if eval_set is None:
        holdout_X = [ds.X for ds in small]
        holdout_y = [ds.y for ds in small]
        trimmed = []
        fraction = max(config.local.eval_fraction, 0.05)
        for ds in datasets:
            rng = np.random.default_rng((config.local.seed, ds.scheduler_id))
            perm = rng.permutation(len(ds.X))
            # Cap the holdout so the training remainder never drops below
            # half of min_cluster_examples rows.
            n_hold = min(max(int(len(ds.X) * fraction), 1),
                         len(ds.X) - min_n // 2)
            hold, keep = perm[:n_hold], perm[n_hold:]
            holdout_X.append(ds.X[hold])
            holdout_y.append(ds.y[hold])
            trimmed.append(ClusterDataset(ds.scheduler_id,
                                          ds.X[keep], ds.y[keep]))
        datasets = trimmed
        # The screen sees the holdout as per-cluster slices (median over
        # slices defuses poisoned holdout rows); the final eval pools.
        screen_holdout = list(zip(holdout_X, holdout_y))
        eval_set = (np.concatenate(holdout_X), np.concatenate(holdout_y))
    else:
        screen_holdout = eval_set

    normalizer, target_norm = pooled_normalizers(datasets)
    model, global_params = init_global_params(
        config.local.hidden, datasets[0].X.shape[1], config.local.seed,
        device)

    lineage: List[Dict[int, int]] = []
    screened_rounds: List[Dict[int, str]] = []
    strikes: Dict[int, int] = {}
    escalated: List[int] = []
    updates_screened = 0
    per_cluster: Dict[int, MLPTrainResult] = {}
    for round_idx in range(config.rounds):
        updates = []
        for ds in datasets:
            result = train_mlp(
                ds.X, ds.y, config.local, device,
                init_params=global_params,
                normalizer=normalizer, target_norm=target_norm,
                group=LOCAL,
            )
            per_cluster[ds.scheduler_id] = result
            updates.append(ClusterUpdate(
                ds.scheduler_id, result.params, len(ds.X)))
        report = screen_updates(
            updates, global_params, config=config, model=model,
            normalizer=normalizer, target_norm=target_norm,
            holdout=screen_holdout)
        for u in updates:
            if u.scheduler_id in report.screened:
                strikes[u.scheduler_id] = strikes.get(u.scheduler_id, 0) + 1
                if (config.screen_quarantine_rounds > 0
                        and strikes[u.scheduler_id]
                        >= config.screen_quarantine_rounds
                        and u.scheduler_id not in escalated):
                    escalated.append(u.scheduler_id)
            else:
                strikes[u.scheduler_id] = 0
        updates_screened += len(report.screened)
        screened_rounds.append(dict(report.screened))
        if report.admitted:
            global_params = aggregate_updates(
                report.admitted, config.aggregator, config.trim_fraction)
            lineage.append({u.scheduler_id: u.n_samples
                            for u in report.admitted})
        else:
            # Every update screened: the aggregate must not move. Keeping
            # the previous global params is the safe no-op.
            lineage.append({})
            logger.warning("federated round %d: ALL %d updates screened "
                           "(%s); global params unchanged",
                           round_idx, len(updates), report.screened)
        logger.info("federated round %d: aggregated %d clusters, "
                    "screened %d", round_idx, len(report.admitted),
                    len(report.screened))

    # Global eval of the aggregated model on held-out data.
    eval_X, eval_y = eval_set
    pred = predict_bandwidth(model, global_params, normalizer, target_norm,
                             eval_X)
    err = pred - eval_y
    return FederatedResult(
        params=global_params,
        normalizer=normalizer,
        target_norm=target_norm,
        config=config,
        mse=float((err**2).mean()),
        mae=float(np.abs(err).mean()),
        lineage=lineage,
        per_cluster=per_cluster,
        screened=screened_rounds,
        updates_screened=updates_screened,
        escalated=escalated,
    )


# ----------------------------------------------------------------------
# Manager-side aggregation (the registry half of config #4)
# ----------------------------------------------------------------------


def register_federated_model(manager, result: FederatedResult,
                             model_id: str = "df2-mlp-global",
                             hostname: str = "manager",
                             traces=None):
    """Register the aggregate under GLOBAL_SCHEDULER_ID with lineage (both
    admitted contributions and screened-update reasons) in the evaluation
    payload; per-cluster models keep their own registry rows and
    single-active invariants. ``traces`` (feature batches) flow to the
    registry's validation gate, which builds the candidate on the
    manager's device: the aggregate lands as a CANDIDATE and only
    activates if the gate passes — a poisoned aggregate that slips the
    screens still cannot activate. A fault of the card propagates from
    the gate (the row stays a candidate). Returns the registry row."""
    lineage = [
        {str(sid): n for sid, n in round_contrib.items()}
        for round_contrib in result.lineage
    ]
    screened = [
        {str(sid): reason for sid, reason in round_screened.items()}
        for round_screened in result.screened
    ]
    # NaN is not valid JSON to strict parsers; omit undefined metrics.
    evaluation = {
        k: v for k, v in (("mse", result.mse), ("mae", result.mae))
        if not math.isnan(v)
    }
    tmp = tempfile.mkdtemp(prefix="df2-fed-")
    try:
        save_model(
            tmp,
            mlp_tree(result.params, result.normalizer, result.target_norm),
            ModelMetadata(
                model_id=model_id, model_type="mlp",
                evaluation=evaluation,
                config={
                    "hidden": list(result.config.local.hidden),
                    "federated_rounds": result.config.rounds,
                    "aggregator": result.config.aggregator,
                    "lineage": lineage,
                    "screened": screened,
                    "updates_screened": result.updates_screened,
                    "escalated": list(result.escalated),
                },
            ),
        )
        return manager.create_model(
            model_id=model_id, model_type="mlp", host_id="federated",
            ip="", hostname=hostname,
            evaluation={
                **evaluation,
                "clusters": len(result.lineage[-1] if result.lineage else {}),
                "updates_screened": result.updates_screened,
            },
            artifact_dir=tmp,
            scheduler_id=GLOBAL_SCHEDULER_ID,
            traces=traces,
        )
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def escalate_screened_clusters(manager, scheduler_ids: Sequence[int],
                               model_type: str = "mlp",
                               reason: str = "federated-screen") -> Dict[
                                   int, Optional[str]]:
    """Registry consequence for a persistently lying cluster: its ACTIVE
    per-cluster model is quarantined through the registry gate path
    (``ManagerService.quarantine_version`` — terminal state, previous
    version restored), so the cluster's own serving plane falls back
    while its updates stay out of the aggregate. Returns
    {scheduler_id: quarantined version or None when the cluster had no
    active model to quarantine}."""
    quarantined: Dict[int, Optional[int]] = {}
    for sid in scheduler_ids:
        row = manager.get_active_model(model_type, scheduler_id=sid)
        if row is None:
            logger.warning("escalation: cluster %d has no active %s model",
                           sid, model_type)
            quarantined[sid] = None
            continue
        # Returns the RESTORED predecessor (None when the cluster had no
        # earlier good version) — the quarantine itself is unconditional.
        restored = manager.quarantine_version(
            model_type, row.version, scheduler_id=sid,
            reason=f"{reason}: screened {sid}")
        quarantined[sid] = str(row.version)
        logger.warning("escalation: cluster %d %s v%s quarantined (%s)%s",
                       sid, model_type, row.version, reason,
                       f"; restored v{restored.version}"
                       if restored is not None else "")
    return quarantined


def aggregate_cluster_models(manager, hidden: Sequence[int],
                             model_id: str = "df2-mlp-global") -> bool:
    """Pure manager-side FedAvg over the ACTIVE per-cluster models already
    in the registry — the path where clusters upload independently (the
    reference's per-SchedulerID flow) and the manager periodically blesses
    a global aggregate. Returns False when fewer than two compatible
    cluster models exist."""
    rows = [
        r for r in manager.list_models()
        if r.type == "mlp" and r.state == "active"
        and r.scheduler_id != GLOBAL_SCHEDULER_ID
    ]
    if len(rows) < 2:
        return False
    trees, weights, normalizers, target_norms, contrib = [], [], [], [], {}
    for row in rows:
        active = manager.get_active_model("mlp", row.scheduler_id)
        tmp = tempfile.mkdtemp(prefix="df2-agg-")
        try:
            untar_to_directory(active.artifact, tmp)
            tree, metadata = load_model(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        if list(metadata.config.get("hidden", [])) != list(hidden):
            logger.warning("skip model %s: hidden %s != %s",
                           row.name, metadata.config.get("hidden"), hidden)
            continue
        params, normalizer, target_norm = mlp_from_tree(tree)
        n = int(metadata.evaluation.get("n_samples", 0))
        if n <= 0:
            logger.warning("model %s lacks n_samples; weighting it as 1",
                           row.name)
            n = 1
        trees.append(params)
        weights.append(n)
        normalizers.append(normalizer)
        target_norms.append(target_norm)
        contrib[int(row.scheduler_id)] = n
    if len(trees) < 2:
        return False
    # FedAvg of raw parameters is meaningful ONLY under one shared
    # normalization (module docstring). Independently-uploaded cluster
    # models trained with per-cluster statistics cannot be averaged — the
    # cross-normalizer case must go through train_federated_mlp, which
    # pools moments first.
    ref_n, ref_t = normalizers[0], target_norms[0]
    for norm_i, tnorm_i in zip(normalizers[1:], target_norms[1:]):
        if not (np.allclose(norm_i.mean, ref_n.mean, rtol=1e-3, atol=1e-5)
                and np.allclose(norm_i.std, ref_n.std, rtol=1e-3, atol=1e-5)
                and np.allclose(tnorm_i.mean, ref_t.mean, rtol=1e-3, atol=1e-5)
                and np.allclose(tnorm_i.std, ref_t.std, rtol=1e-3, atol=1e-5)):
            logger.warning(
                "cluster models use different normalizers; refusing to "
                "average raw parameters (use train_federated_mlp)")
            return False
    global_params = fedavg(trees, weights)
    result = FederatedResult(
        params=global_params, normalizer=ref_n, target_norm=ref_t,
        config=FederatedConfig(local=MLPTrainConfig(hidden=tuple(hidden)),
                               rounds=1),
        mse=float("nan"), mae=float("nan"), lineage=[contrib],
    )
    register_federated_model(manager, result, model_id=model_id)
    return True
