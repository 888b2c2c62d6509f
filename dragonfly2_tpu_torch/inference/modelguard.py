"""Score-batch guard — port of ``guard_reason`` from
``dragonfly2_tpu/inference/modelguard.py``.

One predicate decides whether a score batch is safe to rank with: a
loadable model whose outputs are NaN/Inf or collapsed to a constant must
degrade to rule scoring, with one definition of "degenerate" for every
consumer (the ``ml`` and ``cost`` evaluators here). The weight-poisoning
helpers (``params_guard_reason``, ``poison_params``) belong to the fault
plans, which are not ported yet (ROADMAP.md, Queue 1 item 4).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

#: A batch needs at least this many rows before "all scores equal" is
#: evidence of a collapsed model rather than a coincidence of a tiny
#: candidate set (1-2 parents with identical features legitimately score
#: identically).
GUARD_MIN_CONSTANT_ROWS = 4

#: Score spread below this (on a batch of >= GUARD_MIN_CONSTANT_ROWS
#: rows with non-identical features) reads as a collapsed-constant
#: model: ranking such scores is ranking noise.
GUARD_MIN_SCORE_SPREAD = 1e-7


def guard_reason(scores, features=None) -> Optional[str]:
    """Why a score batch must NOT be used for ranking, or ``None``.

    Returns ``"nonfinite"`` when any score is NaN/Inf, ``"constant"``
    when a large-enough batch has (numerically) zero spread. When the
    input ``features`` are provided and every row is IDENTICAL,
    identical scores are the only correct answer (a cold-start swarm of
    indistinguishable fresh peers), so the constant check is waived.
    """
    arr = np.asarray(scores, dtype=np.float64)
    if arr.size == 0:
        return None
    if not np.isfinite(arr).all():
        return "nonfinite"
    if arr.size >= GUARD_MIN_CONSTANT_ROWS:
        if float(arr.max() - arr.min()) < GUARD_MIN_SCORE_SPREAD:
            if features is not None:
                f = np.asarray(features)
                if len(f) == arr.size and bool((f == f[0]).all()):
                    return None
            return "constant"
    return None
