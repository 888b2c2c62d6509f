"""Exponential backoff with full jitter — port copy of
``dragonfly2_tpu/utils/backoff.py``.

The delay for retry attempt *k* is uniform in ``[0, min(cap, base *
2**k)]`` (the "full jitter" scheme). ``rng`` is anything with a
``uniform(low, high)`` method: a ``random.Random`` or a numpy
``Generator`` (the federation coordinator passes the latter).
"""

from __future__ import annotations

import random


def full_jitter(attempt: int, base: float, cap: float, rng=None) -> float:
    """Delay (seconds) for a 0-indexed retry attempt."""
    upper = min(cap, base * (2 ** max(attempt, 0)))
    return (rng or random).uniform(0.0, upper)
