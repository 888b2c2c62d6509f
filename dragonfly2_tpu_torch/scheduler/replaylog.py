"""Replay-plane helpers — the part of ``dragonfly2_tpu/scheduler/replaylog.py``
that the learned-cost evaluator, the columnar store and the replay
harness read. The recorder itself is not ported."""

from __future__ import annotations

from dataclasses import fields as dataclass_fields

import numpy as np

from dragonfly2_tpu_torch.schema import ReplayFeatureRow
from dragonfly2_tpu_torch.scheduler.evaluator import scoring

#: The schema record's field order IS the canonical feature layout; a
#: drift here would silently corrupt every recorded corpus.
_FEATURE_FIELDS = tuple(f.name for f in dataclass_fields(ReplayFeatureRow))
if _FEATURE_FIELDS != scoring.FEATURE_NAMES:  # pragma: no cover - import guard
    raise ImportError(
        "schema.ReplayFeatureRow fields "
        f"{_FEATURE_FIELDS} drifted from scoring.FEATURE_NAMES "
        f"{scoring.FEATURE_NAMES}; keep them in lockstep")

VERDICT_PARENTS = "parents"
VERDICT_BACK_TO_SOURCE = "back_to_source"


def welford_snapshot(candidate) -> tuple:
    """``(n, last, prior_mean, prior_pstd)`` for any PeerLike — the O(1)
    aggregates when the peer carries them, the numpy formulas otherwise
    (the same duck-typing split as ``BaseEvaluator.is_bad_node``)."""
    stats_of = getattr(candidate, "piece_cost_stats", None)
    if stats_of is not None:
        return stats_of().snapshot()
    costs = np.asarray(candidate.piece_costs(), dtype=np.float64)
    n = len(costs)
    if n == 0:
        return 0, 0.0, 0.0, 0.0
    if n == 1:
        return 1, float(costs[-1]), 0.0, 0.0
    prior = costs[:-1]
    return n, float(costs[-1]), float(prior.mean()), float(prior.std())
