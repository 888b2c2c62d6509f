"""O(1) incremental piece-cost statistics for bad-node detection.

The reference recomputes mean/std of a peer's whole piece-cost history on
every ``IsBadNode`` call (evaluator_base.go:211-247) — O(history) per
candidate, per filter pass, on the announce hot path. This module carries
the statistics ON the peer instead: a bounded window of recent costs plus
running mean/M2 aggregates (Welford), updated in O(1) per appended cost
and queried in O(1) per verdict.

Semantics vs the numpy formulas in
:meth:`~dragonfly2_tpu_torch.scheduler.evaluator.base.BaseEvaluator.is_bad_node`:

- For histories no longer than the window, ``snapshot()`` reproduces the
  exact quantities the numpy path computes — count, latest cost, and the
  mean / POPULATION std of the prior costs (``costs[:-1]``) — proven
  equivalent on randomized histories in tests/test_control_plane.py.
- Histories longer than the window are truncated to the most recent
  ``window`` costs (the reference keeps a small window too; an unbounded
  list on a long-lived seed peer is pure memory growth whose oldest
  entries describe a network that no longer exists).

Thread safety: appends and snapshots take a small internal lock; both are
constant-time, so the lock is never held for more than a few float ops.
"""

from __future__ import annotations

import math
import threading
from collections import deque

# Window of retained piece costs. Must be >= the evaluator's
# NORMAL_DISTRIBUTION_LEN (30) so BOTH bad-node regimes (<30: x20 mean
# rule; >=30: 3-sigma rule) stay reachable on long-lived peers.
DEFAULT_PIECE_COST_WINDOW = 64


class PieceCostStats:
    """Bounded-window running mean/M2 over one peer's piece costs."""

    __slots__ = ("window", "_values", "_mean", "_m2", "_lock", "appends")

    # The evaluator's 3-sigma regime begins at 30 samples
    # (NORMAL_DISTRIBUTION_LEN in evaluator/base.py); a smaller window
    # would silently pin every verdict to the x20-mean small-sample rule.
    MIN_WINDOW = 30

    def __init__(self, window: int = DEFAULT_PIECE_COST_WINDOW):
        if window < self.MIN_WINDOW:
            raise ValueError(
                f"piece-cost window must be >= {self.MIN_WINDOW} so the "
                "normal-distribution bad-node regime stays reachable")
        self.window = window
        self._values: deque[float] = deque()
        self._mean = 0.0
        self._m2 = 0.0
        self._lock = threading.Lock()
        self.appends = 0  # lifetime appends (observability; never windowed)

    def __len__(self) -> int:
        return len(self._values)

    def append(self, cost: float) -> None:
        cost = float(cost)
        with self._lock:
            self.appends += 1
            n = len(self._values)
            if n >= self.window:
                # Evict the oldest sample from the aggregates (reverse
                # Welford update), then the deque.
                oldest = self._values.popleft()
                n -= 1
                if n == 0:
                    self._mean = 0.0
                    self._m2 = 0.0
                else:
                    old_mean = self._mean
                    self._mean = ((n + 1) * old_mean - oldest) / n
                    self._m2 -= (oldest - old_mean) * (oldest - self._mean)
                    if self._m2 < 0.0:  # float cancellation guard
                        self._m2 = 0.0
            # Forward Welford update.
            n += 1
            delta = cost - self._mean
            self._mean += delta / n
            self._m2 += delta * (cost - self._mean)
            self._values.append(cost)

    def values(self) -> list[float]:
        with self._lock:
            return list(self._values)

    def snapshot(self) -> tuple[int, float, float, float]:
        """``(n, last, prior_mean, prior_pstd)`` in O(1).

        ``prior_*`` are the mean and population standard deviation of
        the windowed costs EXCLUDING the most recent one — exactly the
        ``costs[:-1]`` aggregates the bad-node rules compare the latest
        cost against. ``n`` counts the windowed costs including the
        latest. Zeros when there is no prior sample.
        """
        with self._lock:
            n = len(self._values)
            if n == 0:
                return 0, 0.0, 0.0, 0.0
            last = self._values[-1]
            if n == 1:
                return 1, last, 0.0, 0.0
            if n == 2:
                # Exact: one prior sample, zero spread (the reverse
                # Welford update below would leave float-cancellation
                # residue in M2).
                return 2, last, self._values[0], 0.0
            # Remove the last sample from the aggregates without
            # mutating them (reverse Welford, on locals).
            m = n - 1
            prior_mean = (n * self._mean - last) / m
            prior_m2 = self._m2 - (last - prior_mean) * (last - self._mean)
            if prior_m2 < 0.0:
                prior_m2 = 0.0
            return n, last, prior_mean, math.sqrt(prior_m2 / m)
