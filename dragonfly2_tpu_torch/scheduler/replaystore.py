"""Columnar replay corpora in memory — the in-memory half of
``dragonfly2_tpu/scheduler/replaystore.py``.

A corpus is a set of flat numpy column arrays:

- per-decision columns (``seq``, ``verdict``, ``n_candidates``,
  identity strings, outcome, timestamps), and
- per-candidate columns padded to a fixed ``K`` slots — a
  ``[N, K, 11]`` float32 feature tensor (the canonical
  ``scoring.FEATURE_NAMES`` layout), a ``[N, K]`` validity mask,
  decision-time Welford snapshots, delivered ranks and realized-cost
  labels. ``K`` is bucketed like the inference scorer's staging
  buckets (powers of two from 8).

The columns are the JAX package's, value for value, so a corpus packed
by either package holds the same arrays. The ``.npc`` file format
(``write_columns``, ``open_corpus``'s mmap, ``check_corpus``,
``ReplayStoreWriter``, ``pack_csv``) is not ported.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np

from dragonfly2_tpu_torch.schema import (
    MAX_REPLAY_CANDIDATES,
    REPLAY_SCHEMA_VERSION,
    ReplayCandidate,
    ReplayDecision,
    ReplayFeatureRow,
)
from dragonfly2_tpu_torch.scheduler.replaylog import (
    VERDICT_BACK_TO_SOURCE,
    VERDICT_PARENTS,
    _FEATURE_FIELDS,
)

FEATURE_DIM = len(_FEATURE_FIELDS)

#: verdict column encoding (uint8).
VERDICT_CODE_PARENTS = 0
VERDICT_CODE_BACK_TO_SOURCE = 1
_VERDICT_CODES = {VERDICT_PARENTS: VERDICT_CODE_PARENTS,
                  VERDICT_BACK_TO_SOURCE: VERDICT_CODE_BACK_TO_SOURCE}
_VERDICT_NAMES = {code: name for name, code in _VERDICT_CODES.items()}

#: Per-decision columns (leading axis N).
DECISION_COLUMNS = (
    "seq", "verdict", "total_piece_count", "n_candidates", "outcome_cost",
    "decided_at", "finalized_at", "task_id", "peer_id", "chosen", "outcome",
)
#: Per-candidate columns (leading axes [N, K]).
CANDIDATE_COLUMNS = (
    "cand_id", "rank", "features", "valid", "cost_n", "cost_last",
    "cost_prior_mean", "cost_prior_pstd", "realized_n", "realized_cost",
)
ALL_COLUMNS = DECISION_COLUMNS + CANDIDATE_COLUMNS


class ReplayStoreError(ValueError):
    """A corpus lacks columns, or events cannot be packed."""


def bucket_candidates(max_candidates: int) -> int:
    """Smallest scorer-style staging bucket (powers of two from 8) with
    at least ``max_candidates`` slots."""
    b = 8
    while b < max_candidates:
        b *= 2
    return b


def _str_col(values: List[str]) -> np.ndarray:
    if not values:
        return np.zeros(0, dtype="<U1")
    return np.asarray(values, dtype=np.str_)


def pack_columns(events: Sequence[ReplayDecision]) -> Dict[str, np.ndarray]:
    """Seq-ordered column arrays for an event list. Feature floats go
    through the ``float32`` cast the recorder's finalize fold applies,
    so a packed corpus is value-identical to its CSV twin."""
    ordered = []
    for e in events:
        if e.version != REPLAY_SCHEMA_VERSION:
            raise ReplayStoreError(
                f"event seq={e.seq} has schema version {e.version}; this "
                f"store understands {REPLAY_SCHEMA_VERSION} only")
        if e.verdict not in _VERDICT_CODES:
            raise ReplayStoreError(
                f"event seq={e.seq} has unknown verdict {e.verdict!r}")
        if len(e.candidates) > MAX_REPLAY_CANDIDATES:
            raise ReplayStoreError(
                f"event seq={e.seq} carries {len(e.candidates)} candidates "
                f"> schema arity {MAX_REPLAY_CANDIDATES}")
        ordered.append(e)
    ordered.sort(key=lambda e: e.seq)

    n = len(ordered)
    counts = np.asarray([len(e.candidates) for e in ordered], np.int32)
    k = bucket_candidates(int(counts.max()) if n else 0)

    features = np.zeros((n, k, FEATURE_DIM), np.float32)
    valid = np.zeros((n, k), bool)
    rank = np.full((n, k), -1, np.int32)
    cost_n = np.zeros((n, k), np.int64)
    cost_last = np.zeros((n, k), np.float64)
    cost_prior_mean = np.zeros((n, k), np.float64)
    cost_prior_pstd = np.zeros((n, k), np.float64)
    realized_n = np.zeros((n, k), np.int64)
    realized_cost = np.full((n, k), -1.0, np.float64)
    cand_ids: List[List[str]] = []

    for i, e in enumerate(ordered):
        ids_row = [""] * k
        for j, c in enumerate(e.candidates):
            f = c.features
            features[i, j] = [getattr(f, name) for name in _FEATURE_FIELDS]
            ids_row[j] = c.id
            rank[i, j] = c.rank
            cost_n[i, j] = c.cost_n
            cost_last[i, j] = c.cost_last
            cost_prior_mean[i, j] = c.cost_prior_mean
            cost_prior_pstd[i, j] = c.cost_prior_pstd
            realized_n[i, j] = c.realized_n
            realized_cost[i, j] = c.realized_cost
        valid[i, :len(e.candidates)] = True
        cand_ids.append(ids_row)

    cand_id = (np.asarray(cand_ids, dtype=np.str_) if n
               else np.zeros((0, k), dtype="<U1"))
    return {
        "seq": np.asarray([e.seq for e in ordered], np.int64),
        "verdict": np.asarray([_VERDICT_CODES[e.verdict] for e in ordered],
                              np.uint8),
        "total_piece_count": np.asarray(
            [e.total_piece_count for e in ordered], np.int64),
        "n_candidates": counts,
        "outcome_cost": np.asarray([e.outcome_cost for e in ordered],
                                   np.float64),
        "decided_at": np.asarray([e.decided_at for e in ordered], np.int64),
        "finalized_at": np.asarray([e.finalized_at for e in ordered],
                                   np.int64),
        "task_id": _str_col([e.task_id for e in ordered]),
        "peer_id": _str_col([e.peer_id for e in ordered]),
        "chosen": _str_col([e.chosen for e in ordered]),
        "outcome": _str_col([e.outcome for e in ordered]),
        "cand_id": cand_id,
        "rank": rank,
        "features": features,
        "valid": valid,
        "cost_n": cost_n,
        "cost_last": cost_last,
        "cost_prior_mean": cost_prior_mean,
        "cost_prior_pstd": cost_prior_pstd,
        "realized_n": realized_n,
        "realized_cost": realized_cost,
    }


class ColumnarCorpus:
    """A replay corpus as flat column arrays, each column of
    :data:`ALL_COLUMNS` also an attribute. ``slice`` returns a view
    corpus over the same arrays; ``decisions()`` lazily materializes
    schema :class:`~dragonfly2_tpu_torch.schema.ReplayDecision` objects
    value-equal to the originals — the bridge to object-level consumers
    such as the replay harness."""

    def __init__(self, columns: Dict[str, np.ndarray]):
        missing = [c for c in ALL_COLUMNS if c not in columns]
        if missing:
            raise ReplayStoreError(f"corpus missing columns {missing}")
        self._columns = columns
        for name in ALL_COLUMNS:
            setattr(self, name, columns[name])
        self.n = int(len(columns["seq"]))
        self.k = int(columns["valid"].shape[1])

    @classmethod
    def from_events(cls, events: Sequence[ReplayDecision]) -> "ColumnarCorpus":
        return cls(pack_columns(events))

    def __len__(self) -> int:
        return self.n

    def columns(self) -> Dict[str, np.ndarray]:
        return dict(self._columns)

    def slice(self, start: int, stop: int) -> "ColumnarCorpus":
        """View corpus over decisions [start:stop) — column views, no
        copies."""
        return ColumnarCorpus({name: arr[start:stop]
                               for name, arr in self._columns.items()})

    def decision(self, i: int) -> ReplayDecision:
        nc = int(self.n_candidates[i])
        candidates = []
        for j in range(nc):
            candidates.append(ReplayCandidate(
                id=str(self.cand_id[i, j]),
                rank=int(self.rank[i, j]),
                features=ReplayFeatureRow(**dict(zip(
                    _FEATURE_FIELDS, self.features[i, j].tolist()))),
                cost_n=int(self.cost_n[i, j]),
                cost_last=float(self.cost_last[i, j]),
                cost_prior_mean=float(self.cost_prior_mean[i, j]),
                cost_prior_pstd=float(self.cost_prior_pstd[i, j]),
                realized_n=int(self.realized_n[i, j]),
                realized_cost=float(self.realized_cost[i, j]),
            ))
        return ReplayDecision(
            version=REPLAY_SCHEMA_VERSION,
            seq=int(self.seq[i]),
            task_id=str(self.task_id[i]),
            peer_id=str(self.peer_id[i]),
            total_piece_count=int(self.total_piece_count[i]),
            verdict=_VERDICT_NAMES[int(self.verdict[i])],
            chosen=str(self.chosen[i]),
            outcome=str(self.outcome[i]),
            outcome_cost=float(self.outcome_cost[i]),
            decided_at=int(self.decided_at[i]),
            finalized_at=int(self.finalized_at[i]),
            candidates=candidates,
        )

    def decisions(self) -> Iterator[ReplayDecision]:
        for i in range(self.n):
            yield self.decision(i)

    def to_events(self) -> List[ReplayDecision]:
        return list(self.decisions())


def concat_corpora(corpora: Sequence[ColumnarCorpus]) -> ColumnarCorpus:
    """Merge corpora into one: candidate columns re-pad to the widest K
    bucket, rows re-sort by seq."""
    if not corpora:
        return ColumnarCorpus(pack_columns([]))
    k = max(c.k for c in corpora)
    pad_value = {"cand_id": "", "rank": -1, "valid": False,
                 "realized_cost": -1.0}

    def widen(c: ColumnarCorpus, name: str) -> np.ndarray:
        arr = c._columns[name]
        if c.k == k:
            return arr
        shape = (c.n, k - c.k) + arr.shape[2:]
        pad = np.full(shape, pad_value.get(name, 0), dtype=arr.dtype)
        return np.concatenate([arr, pad], axis=1)

    cols: Dict[str, np.ndarray] = {}
    for name in DECISION_COLUMNS:
        cols[name] = np.concatenate([c._columns[name] for c in corpora])
    for name in CANDIDATE_COLUMNS:
        cols[name] = np.concatenate([widen(c, name) for c in corpora])
    order = np.argsort(cols["seq"], kind="stable")
    return ColumnarCorpus({name: arr[order] for name, arr in cols.items()})
