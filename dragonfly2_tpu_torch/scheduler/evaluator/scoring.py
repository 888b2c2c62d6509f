"""Numeric core of parent scoring — port copy of
``dragonfly2_tpu/scheduler/evaluator/scoring.py`` (numpy only, so the
port keeps its own copy rather than importing it).

The rule-based evaluator's score (evaluator_base.go:32-209 in the
upstream scheduler):

    score = 0.20 * piece_score
          + 0.20 * upload_success_score
          + 0.15 * free_upload_score
          + 0.15 * host_type_score
          + 0.15 * idc_affinity_score
          + 0.15 * location_affinity_score

over the fixed numeric feature vector :data:`FEATURE_NAMES`, parametrized
over the array namespace ``xp``. String-valued affinities (IDC, '|'-separated
location paths) are folded to numbers host-side by :func:`idc_match` /
:func:`location_matches`. :func:`rule_scores` promotes to float64 (its
host-type term is a where over Python scalars); the replay engine's
ordering depends on that dtype, so it is kept.
"""

from __future__ import annotations

import numpy as np

# Weights — evaluator_base.go:33-49.
FINISHED_PIECE_WEIGHT = 0.2
UPLOAD_SUCCESS_WEIGHT = 0.2
FREE_UPLOAD_WEIGHT = 0.15
HOST_TYPE_WEIGHT = 0.15
IDC_AFFINITY_WEIGHT = 0.15
LOCATION_AFFINITY_WEIGHT = 0.15

MAX_SCORE = 1.0
MIN_SCORE = 0.0

# Maximum '|'-separated location elements compared — evaluator_base.go:70.
MAX_LOCATION_ELEMENTS = 5

# Canonical (parent, child)-pair feature vector. This layout is shared by
# the rule evaluator, the training datasets, and the learned scorers — keep order
# stable; append only.
FEATURE_NAMES = (
    "parent_finished_pieces",   # parent.FinishedPieces.Count()
    "child_finished_pieces",    # child.FinishedPieces.Count()
    "total_pieces",             # task total piece count (0 = unknown)
    "upload_count",             # parent host lifetime uploads
    "upload_failed_count",      # parent host lifetime failed uploads
    "free_upload_count",        # parent host free upload slots
    "concurrent_upload_limit",  # parent host upload slot limit
    "is_seed",                  # 1.0 if parent host type != normal
    "seed_ready",               # 1.0 if parent FSM in {ReceivedNormal, Running}
    "idc_match",                # idc_match(parent.idc, child.idc)
    "location_matches",         # location_matches(parent.loc, child.loc), 0..5
)
FEATURE_DIM = len(FEATURE_NAMES)

_IDX = {name: i for i, name in enumerate(FEATURE_NAMES)}


def idc_match(dst: str, src: str) -> float:
    """1.0 when both IDCs are set and equal (case-insensitive), else 0.0
    (evaluator_base.go:170-180)."""
    if not dst or not src:
        return MIN_SCORE
    return MAX_SCORE if dst.lower() == src.lower() else MIN_SCORE


def location_matches(dst: str, src: str) -> float:
    """Count of matching leading '|'-elements, capped at 5.

    Full case-insensitive equality of non-empty strings counts as 5 (the
    reference returns maxScore outright in that case,
    evaluator_base.go:183-209); empty strings count as 0.
    """
    if not dst or not src:
        return 0.0
    if dst.lower() == src.lower():
        return float(MAX_LOCATION_ELEMENTS)
    dst_elements = dst.split("|")
    src_elements = src.split("|")
    n = min(len(dst_elements), len(src_elements), MAX_LOCATION_ELEMENTS)
    score = 0
    for i in range(n):
        if dst_elements[i].lower() != src_elements[i].lower():
            break
        score += 1
    return float(score)


def rule_scores(features, xp=np):
    """Rule-based parent scores for a ``[..., FEATURE_DIM]`` feature array.

    ``xp`` is the array namespace (``numpy``, or ``torch`` on tensors).
    Branch-free. Returns an array of shape ``features.shape[:-1]``.
    """
    f = lambda name: features[..., _IDX[name]]

    parent_pieces = f("parent_finished_pieces")
    child_pieces = f("child_finished_pieces")
    total = f("total_pieces")
    # calculatePieceScore (evaluator_base.go:107-122): normalized when total
    # known, raw difference otherwise (unbounded by design).
    piece = xp.where(
        total > 0,
        parent_pieces / xp.where(total > 0, total, 1.0),
        parent_pieces - child_pieces,
    )

    uploads = f("upload_count")
    failed = f("upload_failed_count")
    # calculateParentHostUploadSuccessScore (:125-138): never-scheduled hosts
    # score max so they get traffic; more failures than uploads scores min.
    upload_success = xp.where(
        uploads < failed,
        MIN_SCORE,
        xp.where(
            (uploads == 0) & (failed == 0),
            MAX_SCORE,
            (uploads - failed) / xp.where(uploads > 0, uploads, 1.0),
        ),
    )

    free = f("free_upload_count")
    limit = f("concurrent_upload_limit")
    # calculateFreeUploadScore (:141-150).
    free_upload = xp.where(
        (limit > 0) & (free > 0),
        free / xp.where(limit > 0, limit, 1.0),
        MIN_SCORE,
    )

    # calculateHostTypeScore (:153-167): seeds score max only once their peer
    # is past registration (first download goes to seeds; after that normal
    # peers are preferred at 0.5).
    host_type = xp.where(
        f("is_seed") > 0,
        xp.where(f("seed_ready") > 0, MAX_SCORE, MIN_SCORE),
        MAX_SCORE * 0.5,
    )

    idc = f("idc_match")
    location = f("location_matches") / MAX_LOCATION_ELEMENTS

    return (
        FINISHED_PIECE_WEIGHT * piece
        + UPLOAD_SUCCESS_WEIGHT * upload_success
        + FREE_UPLOAD_WEIGHT * free_upload
        + HOST_TYPE_WEIGHT * host_type
        + IDC_AFFINITY_WEIGHT * idc
        + LOCATION_AFFINITY_WEIGHT * location
    )


def pack_features(
    *,
    parent_finished_pieces: float,
    child_finished_pieces: float,
    total_pieces: float,
    upload_count: float,
    upload_failed_count: float,
    free_upload_count: float,
    concurrent_upload_limit: float,
    is_seed: bool,
    seed_ready: bool,
    parent_idc: str = "",
    child_idc: str = "",
    parent_location: str = "",
    child_location: str = "",
) -> np.ndarray:
    """Assemble one (parent, child) feature vector from raw values."""
    return np.array(
        [
            parent_finished_pieces,
            child_finished_pieces,
            total_pieces,
            upload_count,
            upload_failed_count,
            free_upload_count,
            concurrent_upload_limit,
            1.0 if is_seed else 0.0,
            1.0 if seed_ready else 0.0,
            idc_match(parent_idc, child_idc),
            location_matches(parent_location, child_location),
        ],
        dtype=np.float32,
    )
