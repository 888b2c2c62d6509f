"""Columnar replay-corpus store — the learning loop's batched data path.

The rotating ``replay.*.csv`` corpus (:mod:`.replaylog` →
``storage.Storage``) is row-oriented: every consumer pays a per-row CSV
parse and a per-candidate dataclass materialization before it can score
anything. That is fine for the A/B harness's hundreds of decisions and
hopeless for training-scale replay (millions of counterfactual
evaluations per policy iteration). This module stores the SAME events as
flat numpy-backed column arrays:

- per-decision columns (``seq``, ``verdict``, ``n_candidates``,
  identity strings, outcome, timestamps), and
- per-candidate columns padded to a fixed ``K`` slots — a
  ``[N, K, 11]`` float32 feature tensor (the canonical
  ``scoring.FEATURE_NAMES`` layout, float32-rounded exactly like the
  recorder's finalize fold), a ``[N, K]`` validity mask, decision-time
  Welford snapshots, delivered ranks, and realized-cost labels. ``K``
  is bucketed like the inference scorer's staging buckets (powers of
  two from 8), so a corpus's tensor shape is one of a small set of
  jit-friendly shapes.

On disk a corpus is a single ``.npc`` file: magic, 64-byte-aligned raw
column blobs, a JSON footer index (column → dtype/shape/offset), the
footer length, and a tail magic. Readers mmap the file and expose every
column as a zero-copy ``np.frombuffer`` view over the map — no CSV
parse, no per-row copy; a missing tail magic or an out-of-bounds column
extent reads as truncation and fails loudly. Files are immutable once
written; the :class:`ReplayStoreWriter` rides the rotating-dataset sink
discipline (buffered appends, bounded segment count) by rotating whole
segments instead of appending in place.

The vectorized replay engine (:mod:`.replay`), the trainers
(``train/cost_trainer.py``, ``train/federated.py``) and the
``df2-replay`` CLI consume :class:`ColumnarCorpus` directly;
``pack_csv`` migrates existing CSV corpora and doubles as a format
validator (it re-opens and structurally checks what it wrote).
"""

from __future__ import annotations

import glob as _glob
import json
import mmap
import os
import struct
import threading
from typing import Dict, Iterator, List, Optional, Sequence

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

#: On-disk format identity. The head magic proves "this is a columnar
#: replay corpus"; the tail magic proves the footer (and therefore every
#: column extent it indexes) made it to disk — a truncated write loses
#: the tail first, so truncation is detected before any column is read.
MAGIC = b"DF2RPLYC1\n"
TAIL_MAGIC = b"DF2RPLYF1\n"
STORE_VERSION = 1
FILE_EXT = ".npc"

#: Column blobs start on 64-byte boundaries (cache line) so mmap'd
#: float tensors are aligned for vector loads.
COLUMN_ALIGN = 64

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
    """A corpus file is structurally invalid (bad magic, truncated,
    footer/column inconsistency) or events cannot be packed."""


def bucket_candidates(max_candidates: int) -> int:
    """Smallest scorer-style staging bucket (powers of two from 8 — the
    inference scorer's ``_buckets`` ladder) with at least
    ``max_candidates`` slots."""
    b = 8
    while b < max_candidates:
        b *= 2
    return b


def _str_col(values: List[str]) -> np.ndarray:
    if not values:
        return np.zeros(0, dtype="<U1")
    return np.asarray(values, dtype=np.str_)


# -- packing ---------------------------------------------------------------


def pack_columns(events: Sequence[ReplayDecision]) -> Dict[str, np.ndarray]:
    """Seq-ordered column arrays for an event list. Feature floats go
    through the same ``float32`` cast the recorder's finalize fold
    applies, so a packed corpus is value-identical to its CSV twin."""
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


def write_columns(path: str, columns: Dict[str, np.ndarray]) -> None:
    """Serialize a column dict as one ``.npc`` file (atomic rename)."""
    n = int(len(columns["seq"]))
    k = int(columns["valid"].shape[1]) if columns["valid"].ndim == 2 else 0
    index: Dict[str, dict] = {}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        off = len(MAGIC)
        for name in ALL_COLUMNS:
            arr = np.ascontiguousarray(columns[name])
            pad = (-off) % COLUMN_ALIGN
            if pad:
                f.write(b"\x00" * pad)
                off += pad
            data = arr.tobytes()
            index[name] = {"dtype": arr.dtype.str,
                           "shape": list(arr.shape),
                           "offset": off, "nbytes": len(data)}
            f.write(data)
            off += len(data)
        footer = json.dumps({
            "format": "df2-replay-columnar",
            "store_version": STORE_VERSION,
            "schema_version": REPLAY_SCHEMA_VERSION,
            "n": n, "k": k,
            "feature_fields": list(_FEATURE_FIELDS),
            "columns": index,
        }, sort_keys=True).encode("utf-8")
        f.write(footer)
        f.write(struct.pack("<Q", len(footer)))
        f.write(TAIL_MAGIC)
    os.replace(tmp, path)


def pack_events(events: Sequence[ReplayDecision], path: str) -> Dict[str, object]:
    """Pack an event list into one columnar file; returns pack stats."""
    columns = pack_columns(events)
    write_columns(path, columns)
    return {
        "path": path,
        "decisions": int(len(columns["seq"])),
        "candidates": int(columns["valid"].sum()),
        "k": int(columns["valid"].shape[1]),
        "bytes": os.path.getsize(path),
    }


def pack_csv(csv_paths: Sequence[str], out_path: str) -> Dict[str, object]:
    """Migrate rotating ``replay*.csv`` corpora into one columnar file.

    Doubles as a format validator: the freshly written file is re-opened
    and structurally checked; a red check raises (and the caller keeps
    its CSVs)."""
    from dragonfly2_tpu_torch.schema.io import read_csv_records

    events: List[ReplayDecision] = []
    for p in csv_paths:
        events.extend(read_csv_records(ReplayDecision, p))
    stats = pack_events(events, out_path)
    report = check_corpus(out_path)
    if not report["ok"]:
        raise ReplayStoreError(
            f"pack produced an invalid corpus at {out_path}: "
            f"{report['errors']}")
    stats["sources"] = list(csv_paths)
    stats["check"] = report
    return stats


# -- reading ---------------------------------------------------------------


class ColumnarCorpus:
    """A replay corpus as flat column arrays.

    mmap-backed (zero-copy, read-only views over the map) when opened
    from a file via :func:`open_corpus`; plain ndarrays when packed in
    memory via :meth:`from_events`. Every column in
    :data:`DECISION_COLUMNS` / :data:`CANDIDATE_COLUMNS` is an
    attribute; ``slice`` returns a view corpus sharing the same backing
    store (how the shard fan-out splits work without copying).

    ``decisions()`` lazily materializes schema
    :class:`~dragonfly2_tpu_torch.schema.ReplayDecision` objects value-equal
    to the originals — the compatibility bridge for object-level
    consumers (and the sequential arm of the throughput ladder, which
    deliberately pays that per-row cost).
    """

    def __init__(self, columns: Dict[str, np.ndarray], *,
                 path: Optional[str] = None, mmap_obj=None):
        missing = [c for c in ALL_COLUMNS if c not in columns]
        if missing:
            raise ReplayStoreError(f"corpus missing columns {missing}")
        self._columns = columns
        self.path = path
        self._mmap = mmap_obj
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
        copies, shares the backing mmap."""
        sliced = {name: arr[start:stop]
                  for name, arr in self._columns.items()}
        return ColumnarCorpus(sliced, path=self.path, mmap_obj=self._mmap)

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

    def close(self) -> None:
        """Release the backing map. Only call once every column view
        (including slices) is dropped — live views pin the buffer."""
        if self._mmap is not None:
            self._columns = {}
            for name in ALL_COLUMNS:
                setattr(self, name, None)
            try:
                self._mmap.close()
            except BufferError:
                # Views still alive; the map stays until they die.
                pass
            self._mmap = None


def open_corpus(path: str) -> ColumnarCorpus:
    """mmap a ``.npc`` corpus; every column is a zero-copy view.

    Raises :class:`ReplayStoreError` on bad magic, a missing tail
    marker (truncated write), a footer that does not parse, or any
    column extent that falls outside the file."""
    f = open(path, "rb")
    try:
        size = os.fstat(f.fileno()).st_size
        floor = len(MAGIC) + 8 + len(TAIL_MAGIC)
        if size < floor:
            raise ReplayStoreError(
                f"{path}: {size} bytes < minimum {floor} (truncated?)")
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    finally:
        f.close()
    try:
        if mm[:len(MAGIC)] != MAGIC:
            raise ReplayStoreError(f"{path}: bad magic (not a columnar "
                                   "replay corpus)")
        if mm[size - len(TAIL_MAGIC):] != TAIL_MAGIC:
            raise ReplayStoreError(
                f"{path}: missing end-of-file marker — truncated or "
                "partially written")
        (flen,) = struct.unpack(
            "<Q", mm[size - len(TAIL_MAGIC) - 8:size - len(TAIL_MAGIC)])
        fstart = size - len(TAIL_MAGIC) - 8 - flen
        if flen == 0 or fstart < len(MAGIC):
            raise ReplayStoreError(f"{path}: footer length {flen} out of "
                                   "bounds")
        try:
            footer = json.loads(mm[fstart:fstart + flen].decode("utf-8"))
        except (UnicodeDecodeError, ValueError) as exc:
            raise ReplayStoreError(f"{path}: footer does not parse: {exc}")
        if footer.get("format") != "df2-replay-columnar":
            raise ReplayStoreError(f"{path}: unknown format "
                                   f"{footer.get('format')!r}")
        if footer.get("schema_version") != REPLAY_SCHEMA_VERSION:
            raise ReplayStoreError(
                f"{path}: schema version {footer.get('schema_version')} != "
                f"{REPLAY_SCHEMA_VERSION}")
        if tuple(footer.get("feature_fields") or ()) != _FEATURE_FIELDS:
            raise ReplayStoreError(f"{path}: feature layout drifted from "
                                   "scoring.FEATURE_NAMES")
        specs = footer.get("columns") or {}
        columns: Dict[str, np.ndarray] = {}
        for name in ALL_COLUMNS:
            spec = specs.get(name)
            if spec is None:
                raise ReplayStoreError(f"{path}: footer missing column "
                                       f"{name!r}")
            dt = np.dtype(spec["dtype"])
            shape = tuple(int(s) for s in spec["shape"])
            count = int(np.prod(shape)) if shape else 1
            nbytes = int(spec["nbytes"])
            offset = int(spec["offset"])
            if count * dt.itemsize != nbytes:
                raise ReplayStoreError(
                    f"{path}: column {name!r} dtype/shape disagree with "
                    "its byte extent")
            if offset < len(MAGIC) or offset + nbytes > fstart:
                raise ReplayStoreError(
                    f"{path}: column {name!r} extent [{offset}, "
                    f"{offset + nbytes}) falls outside the data region — "
                    "truncated or corrupt")
            columns[name] = np.frombuffer(
                mm, dtype=dt, count=count, offset=offset).reshape(shape)
        return ColumnarCorpus(columns, path=path, mmap_obj=mm)
    except Exception:
        try:
            mm.close()
        except BufferError:  # pragma: no cover - views escaped mid-error
            pass
        raise


def check_corpus(path: str) -> Dict[str, object]:
    """Structural validator (``df2-replay check``): format/footer checks
    via :func:`open_corpus` plus mask/padding/ordering invariants.
    Returns a report dict; never raises on an invalid file."""
    report: Dict[str, object] = {
        "path": path, "ok": False, "decisions": 0, "candidates": 0,
        "k": 0, "back_to_source": 0, "outcomes": 0,
        "errors": [], "warnings": [],
    }
    errors: List[str] = report["errors"]  # type: ignore[assignment]
    try:
        cc = open_corpus(path)
    except (ReplayStoreError, OSError) as exc:
        errors.append(str(exc))
        return report
    report["decisions"] = cc.n
    report["candidates"] = int(cc.valid.sum())
    report["k"] = cc.k
    report["back_to_source"] = int(
        (cc.verdict == VERDICT_CODE_BACK_TO_SOURCE).sum())
    report["outcomes"] = int((cc.outcome != "").sum())

    if cc.n:
        nc = cc.n_candidates
        if int(nc.min()) < 0 or int(nc.max()) > cc.k:
            errors.append(f"n_candidates outside [0, {cc.k}]")
        want_valid = np.arange(cc.k)[None, :] < nc[:, None]
        if not np.array_equal(cc.valid, want_valid):
            errors.append("validity mask is not the n_candidates prefix")
        unknown = ~np.isin(cc.verdict, list(_VERDICT_NAMES))
        if unknown.any():
            errors.append(f"{int(unknown.sum())} unknown verdict codes")
        if (nc[cc.verdict == VERDICT_CODE_BACK_TO_SOURCE] > 0).any():
            errors.append("back-to-source decisions carry candidates")
        if (np.diff(cc.seq) <= 0).any():
            errors.append("seq column is not strictly increasing")
        pad = ~want_valid
        if (np.abs(cc.features[pad]).sum() != 0.0
                or not np.isfinite(cc.features).all()):
            errors.append("padded feature slots are not zero / features "
                          "not finite")
        if pad.any():
            if (cc.rank[pad] != -1).any() or (cc.cand_id[pad] != "").any() \
                    or (cc.realized_n[pad] != 0).any():
                errors.append("padded candidate slots are not clean "
                              "(rank/-1, id/'', realized_n/0)")
        # Duplicate candidate ids within one decision collapse the
        # id-keyed sequential metrics — flag, but a replay digest is
        # still well-defined, so it is a warning.
        for i in np.flatnonzero(nc > 1):
            ids = cc.cand_id[i, :nc[i]]
            if len(set(ids.tolist())) != int(nc[i]):
                report["warnings"].append(  # type: ignore[union-attr]
                    f"decision seq={int(cc.seq[i])} has duplicate "
                    "candidate ids")
                break
    report["ok"] = not errors
    return report


def concat_corpora(corpora: Sequence[ColumnarCorpus]) -> ColumnarCorpus:
    """Merge segment corpora into one in-memory corpus: candidate
    columns re-pad to the widest K bucket, rows re-sort by seq."""
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


def list_segments(base_dir: str, prefix: str = "replay-columnar") -> List[str]:
    return sorted(_glob.glob(
        os.path.join(base_dir, f"{prefix}-*{FILE_EXT}")))


def open_dir(base_dir: str, prefix: str = "replay-columnar") -> ColumnarCorpus:
    """Concatenated corpus over every segment in a writer directory."""
    return concat_corpora([open_corpus(p)
                           for p in list_segments(base_dir, prefix)])


# -- writing (recorder sink) ----------------------------------------------


class ReplayStoreWriter:
    """Columnar segment writer riding the rotating-dataset sink
    discipline (``storage._RotatingDataset``): buffered appends under a
    cheap lock, whole-segment rotation at ``segment_decisions``, bounded
    backups (oldest segments pruned past ``max_segments``). Columnar
    files are footer-indexed and therefore immutable — "rotation" here
    means sealing the buffered events into a fresh segment file, which
    is also what makes a torn write detectable (no tail magic).

    Thread discipline matches the CSV sink: ``append``/``append_batch``
    are safe from any thread and never block on IO unless they trip the
    segment threshold; ``flush`` serializes the actual write."""

    def __init__(self, base_dir: str, *, prefix: str = "replay-columnar",
                 segment_decisions: int = 4096, max_segments: int = 16):
        if segment_decisions < 1:
            raise ValueError("segment_decisions must be >= 1")
        os.makedirs(base_dir, exist_ok=True)
        self.base_dir = base_dir
        self.prefix = prefix
        self.segment_decisions = segment_decisions
        self.max_segments = max_segments
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        self._buffer: List[ReplayDecision] = []
        existing = list_segments(base_dir, prefix)
        self._seq = len(existing)

    def segments(self) -> List[str]:
        return list_segments(self.base_dir, self.prefix)

    def append(self, event: ReplayDecision) -> None:
        self.append_batch((event,))

    def append_batch(self, events: Sequence[ReplayDecision]) -> None:
        if not events:
            return
        with self._lock:
            self._buffer.extend(events)
            need_flush = len(self._buffer) >= self.segment_decisions
        if need_flush:
            self.flush()

    def flush(self) -> None:
        """Seal buffered events into a new segment (no-op when empty)."""
        with self._io_lock:
            with self._lock:
                batch, self._buffer = self._buffer, []
            if not batch:
                return
            self._seq += 1
            path = os.path.join(
                self.base_dir, f"{self.prefix}-{self._seq:06d}{FILE_EXT}")
            try:
                pack_events(batch, path)
            except BaseException:
                with self._lock:
                    self._buffer[:0] = batch
                raise
            victims = self.segments()[:-self.max_segments] \
                if self.max_segments > 0 else []
            for victim in victims:
                try:
                    os.remove(victim)
                except FileNotFoundError:  # pragma: no cover - racing rm
                    pass

    def close(self) -> None:
        self.flush()
