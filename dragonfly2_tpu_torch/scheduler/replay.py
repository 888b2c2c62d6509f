"""Replay corpus rows — the part of ``dragonfly2_tpu/scheduler/replay.py``
the cost trainer reads. The replay engine itself is not ported.

A recorded candidate's ``features`` record has one field for each entry
of ``scoring.FEATURE_NAMES``, in that order (``schema.ReplayFeatureRow``
in the JAX package), so the canonical names are its field names.
"""

from __future__ import annotations

import numpy as np

from dragonfly2_tpu_torch.scheduler.evaluator import scoring

_FEATURE_FIELDS = scoring.FEATURE_NAMES


def _row_array(candidate) -> np.ndarray:
    """A candidate's decision-time feature row, float32, in the canonical
    layout."""
    f = candidate.features
    return np.array([getattr(f, name) for name in _FEATURE_FIELDS],
                    dtype=np.float32)
