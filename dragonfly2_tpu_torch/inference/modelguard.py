"""Score-batch guard and weight-poisoning helpers — port of
``dragonfly2_tpu/inference/modelguard.py``.

One predicate, :func:`guard_reason`, decides whether a score batch is
safe to rank with: a loadable model whose outputs are NaN/Inf or
collapsed to a constant must degrade to rule scoring, with one
definition of "degenerate" for every consumer — the ``ml`` and ``cost``
evaluators, the inference service's shadow/canary controller and the
manager's validation gate.

:func:`poison_params` turns a checkpoint's numpy param tree (the flax
layout, before ``*_state_dict_from_flax``) into exactly such a model for
the ``model.weights`` fault site; :func:`params_guard_reason` is the
same "nonfinite" test applied to weights.
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


def params_guard_reason(params) -> Optional[str]:
    """Why a parameter tree must NOT be served or aggregated, or
    ``None``: ``"nonfinite"`` when any float leaf holds NaN/Inf.
    Non-float leaves (index tables) are ignored, as
    :func:`poison_params` leaves them loadable."""
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
            continue
        if isinstance(node, (list, tuple)):
            stack.extend(node)
            continue
        arr = np.asarray(node)
        if np.issubdtype(arr.dtype, np.floating) \
                and not bool(np.isfinite(arr).all()):
            return "nonfinite"
    return None


def poison_params(params, mode: str):
    """A structurally identical params tree with poisoned leaves.

    ``mode="nan"`` fills every float leaf with NaN (a diverged training
    run); ``mode="zero"`` zeroes every float leaf (the model outputs a
    constant for every input). Integer leaves are left alone so the
    poisoned model stays loadable.
    """
    if mode not in ("nan", "zero"):
        raise ValueError(f"unknown poison mode {mode!r}")

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        arr = np.asarray(node)
        if not np.issubdtype(arr.dtype, np.floating):
            return node
        if mode == "nan":
            return np.full_like(arr, np.nan)
        return np.zeros_like(arr)

    return walk(params)
