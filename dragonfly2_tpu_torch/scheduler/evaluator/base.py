"""Object-level rule-based evaluator — port copy of
``dragonfly2_tpu/scheduler/evaluator/base.py``.

Upstream counterpart: scheduler/scheduling/evaluator/evaluator_base.go.
Operates on duck-typed peer objects (anything satisfying
:class:`PeerLike`/:class:`HostLike`) and delegates the arithmetic to the
shared numeric core in :mod:`.scoring`, so the rule evaluator, the label
generator and the learned evaluators' fallback never drift apart.
"""

from __future__ import annotations

import threading
from typing import Optional, Protocol, Sequence

import numpy as np

from dragonfly2_tpu_torch.scheduler import controlstats
from dragonfly2_tpu_torch.scheduler.evaluator import scoring

# Peer FSM state names (reference: scheduler/resource/peer.go:53-81).
PEER_STATE_PENDING = "Pending"
PEER_STATE_RECEIVED_EMPTY = "ReceivedEmpty"
PEER_STATE_RECEIVED_TINY = "ReceivedTiny"
PEER_STATE_RECEIVED_SMALL = "ReceivedSmall"
PEER_STATE_RECEIVED_NORMAL = "ReceivedNormal"
PEER_STATE_RUNNING = "Running"
PEER_STATE_BACK_TO_SOURCE = "BackToSource"
PEER_STATE_SUCCEEDED = "Succeeded"
PEER_STATE_FAILED = "Failed"
PEER_STATE_LEAVE = "Leave"

# IsBadNode thresholds (evaluator_base.go:60-71).
NORMAL_DISTRIBUTION_LEN = 30
MIN_AVAILABLE_COST_LEN = 2

# States in which a peer cannot serve as a parent (evaluator_base.go:211-218).
_BAD_STATES = frozenset(
    {
        PEER_STATE_FAILED,
        PEER_STATE_LEAVE,
        PEER_STATE_PENDING,
        PEER_STATE_RECEIVED_EMPTY,
        PEER_STATE_RECEIVED_TINY,
        PEER_STATE_RECEIVED_SMALL,
        PEER_STATE_RECEIVED_NORMAL,
    }
)


class HostLike(Protocol):
    type: object  # HostType
    upload_count: int
    upload_failed_count: int
    concurrent_upload_limit: int
    idc: str
    location: str

    def free_upload_count(self) -> int: ...


class PeerLike(Protocol):
    id: str
    host: HostLike

    def state(self) -> str: ...
    def finished_piece_count(self) -> int: ...
    def piece_costs(self) -> Sequence[float]: ...


def _locality_idc(host) -> str:
    """Effective IDC for the affinity term: hosts that carry a geo
    cluster expose ``locality_idc`` (idc, else a ``cluster:<id>``
    synthetic; docs/GEO.md of the JAX package), so multi-site fleets get intra-cluster
    affinity through the EXISTING ``idc_match`` column and the trained
    models' 11-wide rows stay valid. Duck-typed hosts without the
    property (and every cluster-blind host) fall back to ``idc`` —
    byte-identical to the pre-geo feature row."""
    return getattr(host, "locality_idc", None) or host.idc


def pair_features(parent: PeerLike, child: PeerLike, total_piece_count: int) -> np.ndarray:
    """Extract the canonical feature vector for one (parent, child) pair."""
    host = parent.host
    is_seed = bool(getattr(host.type, "is_seed", bool(host.type)))
    state = parent.state()
    # seed_ready is defined as "is a seed AND past registration" in the
    # canonical feature layout — training data (data/features.py,
    # data/synthetic.py) uses the same conjunction, and the rule score only
    # reads it when is_seed is set. Keep the three sites in lockstep or the
    # model serves feature combinations it never trained on.
    return scoring.pack_features(
        parent_finished_pieces=parent.finished_piece_count(),
        child_finished_pieces=child.finished_piece_count(),
        total_pieces=total_piece_count,
        upload_count=host.upload_count,
        upload_failed_count=host.upload_failed_count,
        free_upload_count=host.free_upload_count(),
        concurrent_upload_limit=host.concurrent_upload_limit,
        is_seed=is_seed,
        seed_ready=is_seed and state in (PEER_STATE_RECEIVED_NORMAL, PEER_STATE_RUNNING),
        parent_idc=_locality_idc(host),
        child_idc=_locality_idc(child.host),
        parent_location=host.location,
        child_location=child.host.location,
    )


# Feature-row indices hoisted from the canonical layout so the one-pass
# fill below can never silently reorder against pack_features.
_I_PARENT_FIN = scoring.FEATURE_NAMES.index("parent_finished_pieces")
_I_CHILD_FIN = scoring.FEATURE_NAMES.index("child_finished_pieces")
_I_TOTAL = scoring.FEATURE_NAMES.index("total_pieces")
_I_UPLOADS = scoring.FEATURE_NAMES.index("upload_count")
_I_UPLOAD_FAILED = scoring.FEATURE_NAMES.index("upload_failed_count")
_I_FREE_UPLOAD = scoring.FEATURE_NAMES.index("free_upload_count")
_I_UPLOAD_LIMIT = scoring.FEATURE_NAMES.index("concurrent_upload_limit")
_I_IS_SEED = scoring.FEATURE_NAMES.index("is_seed")
_I_SEED_READY = scoring.FEATURE_NAMES.index("seed_ready")
_I_IDC = scoring.FEATURE_NAMES.index("idc_match")
_I_LOCATION = scoring.FEATURE_NAMES.index("location_matches")

_SEED_READY_STATES = (PEER_STATE_RECEIVED_NORMAL, PEER_STATE_RUNNING)


def build_feature_matrix(
    parents: Sequence[PeerLike], child: PeerLike, total_piece_count: int,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Fill the ``[len(parents), FEATURE_DIM]`` feature matrix in ONE
    pass, value-identical to stacking :func:`pair_features` rows.

    Child-side features (finished count, idc, location) are derived once
    per announce instead of once per candidate, and each row is written
    straight into ``out`` (or a fresh matrix) — no per-candidate
    11-float temporary, no ``np.stack`` copy. Callers that reuse a
    staging buffer pass ``out``; it must be float32 with at least
    ``len(parents)`` rows, and the filled view is returned.
    """
    n = len(parents)
    if out is None:
        out = np.empty((n, scoring.FEATURE_DIM), dtype=np.float32)
    m = out[:n]
    child_finished = child.finished_piece_count()
    child_host = child.host
    child_idc = _locality_idc(child_host)
    child_location = child_host.location
    for i, parent in enumerate(parents):
        host = parent.host
        is_seed = bool(getattr(host.type, "is_seed", bool(host.type)))
        row = m[i]
        row[_I_PARENT_FIN] = parent.finished_piece_count()
        row[_I_CHILD_FIN] = child_finished
        row[_I_TOTAL] = total_piece_count
        row[_I_UPLOADS] = host.upload_count
        row[_I_UPLOAD_FAILED] = host.upload_failed_count
        row[_I_FREE_UPLOAD] = host.free_upload_count()
        row[_I_UPLOAD_LIMIT] = host.concurrent_upload_limit
        row[_I_IS_SEED] = 1.0 if is_seed else 0.0
        row[_I_SEED_READY] = (
            1.0 if is_seed and parent.state() in _SEED_READY_STATES else 0.0)
        row[_I_IDC] = scoring.idc_match(_locality_idc(host), child_idc)
        row[_I_LOCATION] = scoring.location_matches(
            host.location, child_location)
    return m


class BaseEvaluator:
    """The ``default`` algorithm (evaluator.go:44-46)."""

    def __init__(self, stats: Optional[controlstats.ControlPlaneStats] = None):
        # Per-thread staging for the candidate feature matrix: the
        # scheduler filters/evaluates from concurrent announce threads,
        # and the matrix only lives within one evaluate_parents call, so
        # thread-local reuse is both safe and allocation-free on the
        # steady state (the staging discipline of inference/scorer.py).
        self._tls = threading.local()
        self._stats = stats if stats is not None else controlstats.STATS

    def _staging(self, n: int) -> np.ndarray:
        buf = getattr(self._tls, "buf", None)
        if buf is None or buf.shape[0] < n:
            rows = 16
            while rows < n:
                rows *= 2
            buf = np.empty((rows, scoring.FEATURE_DIM), dtype=np.float32)
            self._tls.buf = buf
        return buf

    def evaluate(self, parent: PeerLike, child: PeerLike, total_piece_count: int) -> float:
        features = pair_features(parent, child, total_piece_count)
        return float(scoring.rule_scores(features))

    def evaluate_parents(
        self, parents: Sequence[PeerLike], child: PeerLike, total_piece_count: int
    ) -> list[PeerLike]:
        """Sort candidate parents best-first (evaluator_base.go:80-90).

        Scores the whole candidate set as one batched feature matrix —
        one-pass extraction into preallocated thread-local staging + one
        vectorized evaluation, instead of the reference's O(n log n)
        re-evaluation inside a sort comparator.
        """
        if not parents:
            return []
        features = build_feature_matrix(
            parents, child, total_piece_count, out=self._staging(len(parents)))
        scores = scoring.rule_scores(features)
        # Stable descending sort keeps the reference's tie behavior
        # (sort.Slice with strict '>' keeps equal-score input order).
        order = np.argsort(-scores, kind="stable")
        return [parents[i] for i in order]

    def is_bad_node(self, peer: PeerLike) -> bool:
        """Statistical bad-node detection (evaluator_base.go:211-247).

        A peer is bad if its FSM is in a non-serving state, or its latest
        piece cost is an outlier: >20x the mean of prior costs when the
        sample is small (<30), or outside mean+3*sigma once the sample is
        large enough to assume normality.

        Peers that carry incremental statistics (the real resource
        model's ``piece_cost_stats``) are judged from the O(1) windowed
        Welford aggregates — constant work regardless of history length.
        Duck-typed peers without stats fall back to the original numpy
        formulas over ``piece_costs()``; both paths are counted
        (``controlstats``) so a silent fallback regression is visible.
        """
        if peer.state() in _BAD_STATES:
            return True

        stats_of = getattr(peer, "piece_cost_stats", None)
        if stats_of is not None:
            n, last, prior_mean, prior_pstd = stats_of().snapshot()
            self._stats.observe_bad_node(fast=True)
            if n < MIN_AVAILABLE_COST_LEN:
                return False
            if n < NORMAL_DISTRIBUTION_LEN:
                return last > prior_mean * 20
            return last > prior_mean + 3 * prior_pstd

        self._stats.observe_bad_node(fast=False)
        costs = np.asarray(peer.piece_costs(), dtype=np.float64)
        if len(costs) < MIN_AVAILABLE_COST_LEN:
            return False

        last = costs[-1]
        prior = costs[:-1]
        mean = prior.mean()
        if len(costs) < NORMAL_DISTRIBUTION_LEN:
            return bool(last > mean * 20)

        # Population standard deviation, matching the reference's
        # stats.StandardDeviation.
        return bool(last > mean + 3 * prior.std())
