"""Sorted-sample percentile readout — port of
``dragonfly2_tpu/utils/percentile.py``: one implementation for every
latency ladder of the port, so the index math cannot drift between the
numbers compared.
"""

from __future__ import annotations

from typing import Sequence


def percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over an ALREADY-SORTED sample; 0.0 when
    empty."""
    if not sorted_vals:
        return 0.0
    idx = min(int(len(sorted_vals) * q), len(sorted_vals) - 1)
    return float(sorted_vals[idx])
