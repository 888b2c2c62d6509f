"""Replay-plane helpers — the part of ``dragonfly2_tpu/scheduler/replaylog.py``
the learned-cost evaluator reads. The recorder itself is not ported."""

from __future__ import annotations

import numpy as np


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
