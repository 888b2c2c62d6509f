"""Learned piece-cost predictor over replay corpora — port of
``dragonfly2_tpu/train/cost_trainer.py``.

A small MLP maps the canonical (parent, child) feature vector
(``scoring.FEATURE_NAMES``, the layout ``build_feature_matrix`` stages)
to the parent's REALIZED windowed mean piece cost in seconds. The
predictor ranks parents (lower predicted cost is better, through
``LearnedCostEvaluator``) and sets the learned bad-node threshold.
Mechanically it is :func:`train_mlp` pointed at another label (the
regression target is log1p(seconds), standardized); the checkpoint is the
bandwidth MLP's tree, registered as model type ``"cost"``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np

from dragonfly2_tpu_torch.models.mlp import Normalizer
from dragonfly2_tpu_torch.scheduler.evaluator.scoring import FEATURE_DIM
from dragonfly2_tpu_torch.train.checkpoint import mlp_tree
from dragonfly2_tpu_torch.train.mlp_trainer import MLPTrainConfig, train_mlp

#: Registry model type ("cost" versions never evict "mlp" ones).
MODEL_TYPE_COST = "cost"

#: Below this many (feature row, realized cost) examples a cost model is
#: noise and must not be trained or registered.
MIN_COST_EXAMPLES = 32


@dataclass(frozen=True)
class CostTrainConfig:
    """Cost-predictor training knobs, smaller than the bandwidth MLP's:
    the corpus is one scheduler's recent decisions, and the optimizer
    needs steps, not batch width (25 epochs at batch 512)."""

    hidden: Sequence[int] = (64, 32)
    learning_rate: float = 3e-3
    weight_decay: float = 1e-4
    batch_size: int = 512
    epochs: int = 25
    seed: int = 0
    eval_fraction: float = 0.15
    max_seconds: float | None = None


@dataclass
class CostTrainResult:
    params: dict               # flax layout {"params": {...}}, numpy f32
    normalizer: Normalizer
    target_norm: Normalizer    # over log1p(cost_s)
    config: CostTrainConfig
    # Registry metrics on the raw seconds scale.
    mse: float
    mae: float
    samples_per_sec: float
    n_samples: int = 0
    history: list = field(default_factory=list)
    step_losses: list = field(default_factory=list)


def cost_examples_from_corpus(
    events: Sequence,
) -> Tuple[np.ndarray, np.ndarray]:
    """(X [n, FEATURE_DIM] float32, y [n] seconds) from replay decision
    events: one example per candidate that realized at least one piece
    cost by outcome time — decision-time features, outcome-time label.

    Takes a sequence of decision events (each with ``candidates``, each
    candidate with ``features``, ``realized_n`` and ``realized_cost``)
    or a columnar corpus (any object with ``features`` [N, K, F],
    ``valid``, ``realized_n`` and ``realized_cost`` [N, K] arrays): three
    whole-corpus mask ops, which yield the same rows in the same order
    (row-major over [decision, candidate] is the sequential nesting)."""
    features = getattr(events, "features", None)
    if features is not None and getattr(events, "valid", None) is not None:
        mask = (events.valid
                & (events.realized_n >= 1)
                & (events.realized_cost >= 0))
        X = np.ascontiguousarray(features[mask], dtype=np.float32)
        y = events.realized_cost[mask].astype(np.float32)
        return X, y

    from dragonfly2_tpu_torch.scheduler.replay import _row_array

    rows: List[np.ndarray] = []
    costs: List[float] = []
    for event in events:
        for cand in getattr(event, "candidates", ()) or ():
            if cand.realized_n >= 1 and cand.realized_cost >= 0:
                rows.append(_row_array(cand))
                costs.append(float(cand.realized_cost))
    if not rows:
        return (np.zeros((0, FEATURE_DIM), np.float32),
                np.zeros(0, np.float32))
    return np.stack(rows).astype(np.float32), np.asarray(costs, np.float32)


def train_cost(
    X: np.ndarray,
    y: np.ndarray,
    config: CostTrainConfig = CostTrainConfig(),
    device=None,
    group=None,
) -> CostTrainResult:
    """Train the cost predictor. ``y`` is realized piece cost in SECONDS
    (positive); the loop regresses log1p(y) standardized, so sub-second
    and multi-second costs share a scale. ``device=None`` means the
    card; ``group`` is :func:`train_mlp`'s data-parallel group."""
    if len(X) < MIN_COST_EXAMPLES:
        raise ValueError(
            f"{len(X)} cost examples < {MIN_COST_EXAMPLES}; refusing to "
            "train a noise model")
    mlp_config = MLPTrainConfig(
        hidden=tuple(config.hidden),
        learning_rate=config.learning_rate,
        weight_decay=config.weight_decay,
        batch_size=config.batch_size,
        epochs=config.epochs,
        seed=config.seed,
        eval_fraction=config.eval_fraction,
        max_seconds=config.max_seconds,
    )
    result = train_mlp(X, np.asarray(y, np.float32), mlp_config, device,
                       group=group)
    return CostTrainResult(
        params=result.params,
        normalizer=result.normalizer,
        target_norm=result.target_norm,
        config=config,
        mse=result.mse,
        mae=result.mae,
        samples_per_sec=result.samples_per_sec,
        n_samples=len(X),
        history=result.history,
        step_losses=result.step_losses,
    )


def cost_tree(result: CostTrainResult) -> dict:
    """Checkpoint tree — the bandwidth MLP's layout (params + both
    normalizers), so the artifact path is shared."""
    return mlp_tree(result.params, result.normalizer, result.target_norm)
