"""Deterministic offline replay harness — port of
``dragonfly2_tpu/scheduler/replay.py``.

Re-drives a recorded decision corpus (``schema.ReplayDecision`` events)
through the REAL evaluator stack — the port's ``BaseEvaluator``,
``MLEvaluator`` or ``LearnedCostEvaluator``, through their
``evaluate_parents`` and ``is_bad_node`` — and scores each evaluator by
what the live swarm realized afterwards:

- **realized-cost regret** — the chosen parent's realized windowed piece
  cost minus the best realized cost among the candidates the filter
  offered (per decision; every candidate's realized cost was recorded);
- **rank agreement** — Spearman correlation between the evaluator's
  ranking and the realized-cost ordering of the same candidate set;
- **bad-node precision/recall** — each evaluator's ``is_bad_node``
  verdict, judged from the DECISION-TIME cost snapshot, against
  realized-cost outlier labels.

Determinism contract: the harness holds no mutable swarm state —
candidates are rebuilt from the recorded feature rows such that
``build_feature_matrix`` reproduces the recorded matrix BIT-IDENTICALLY —
and every built-in evaluator is deterministic, so the same corpus + seed
yields a bit-identical decision sequence (the run digest; the rule
evaluator's digests equal the JAX package's on the same corpus).

The batched engine (:func:`replay_decisions_vectorized`) scores a whole
columnar corpus (``replaystore.ColumnarCorpus``, in memory or mmapped
from ``.npc`` segments) at once, through the scorers' ``score_corpus``
on the device, with the same digest and tie-break order as the
sequential harness. The corpus loaders read the scheduler storage's
rotating CSV dataset, CSV files and ``.npc`` segments.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from time import perf_counter
from typing import Dict, List, Optional, Sequence

import numpy as np

from dragonfly2_tpu_torch.schema import REPLAY_SCHEMA_VERSION, ReplayDecision
from dragonfly2_tpu_torch.scheduler.replaylog import (
    VERDICT_BACK_TO_SOURCE,
    VERDICT_PARENTS,
    _FEATURE_FIELDS,
)
from dragonfly2_tpu_torch.utils.percentile import percentile

#: A candidate realized at least this many cost samples before its
#: realized mean is trusted as a regret/label input.
MIN_REALIZED_SAMPLES = 1

#: Ground-truth bad-node label: realized cost above this factor of the
#: MEDIAN of the OTHER realized candidates in the same decision. 3x
#: mirrors the spirit of the 3-sigma rule without depending on it
#: (labels must be evaluator-independent or the comparison is
#: circular); the median — not the minimum — is the baseline so one
#: cheap seed in the candidate set cannot label every ordinary peer an
#: outlier.
BAD_LABEL_FACTOR = 3.0

_CHILD_IDC = "replay-idc"
_LOC_ELEMENTS = ("l0", "l1", "l2", "l3", "l4")
_CHILD_LOCATION = "|".join(_LOC_ELEMENTS)


class _ReplayHostType:
    __slots__ = ("is_seed",)

    def __init__(self, is_seed: bool):
        self.is_seed = is_seed

    def __bool__(self) -> bool:  # pragma: no cover - getattr fallback only
        return self.is_seed


class ReplayHost:
    """HostLike reconstructed from one recorded feature row."""

    __slots__ = ("type", "upload_count", "upload_failed_count",
                 "concurrent_upload_limit", "idc", "location",
                 "_free_upload")

    def __init__(self, *, is_seed: bool, upload_count: float,
                 upload_failed_count: float, free_upload_count: float,
                 concurrent_upload_limit: float, idc: str, location: str):
        self.type = _ReplayHostType(is_seed)
        self.upload_count = upload_count
        self.upload_failed_count = upload_failed_count
        self.concurrent_upload_limit = concurrent_upload_limit
        self.idc = idc
        self.location = location
        self._free_upload = free_upload_count

    def free_upload_count(self) -> float:
        return self._free_upload


class _FrozenCostStats:
    """PieceCostStats stand-in answering the recorded snapshot."""

    __slots__ = ("_snap",)

    def __init__(self, snap: tuple):
        self._snap = snap

    def snapshot(self) -> tuple:
        return self._snap

    def values(self) -> list:  # duck parity; history is not recorded
        return []


class _ReplayTask:
    """Task shim: the recorded identity + piece count for consumers
    that read ``peer.task`` (the learned bad-node row builder, and a
    recorder fed rebuilt peers in tests/benches)."""

    __slots__ = ("id", "total_piece_count")

    def __init__(self, total_piece_count: int, id: str = ""):
        self.id = id
        self.total_piece_count = total_piece_count


class ReplayPeer:
    """PeerLike reconstructed from a recorded candidate (or the child)."""

    __slots__ = ("id", "host", "task", "_state", "_finished", "_stats")

    def __init__(self, id: str, host: ReplayHost, state: str,
                 finished: float, snapshot: tuple,
                 total_piece_count: int = 0, task_id: str = ""):
        self.id = id
        self.host = host
        self.task = _ReplayTask(total_piece_count, id=task_id)
        self._state = state
        self._finished = finished
        self._stats = _FrozenCostStats(snapshot)

    def state(self) -> str:
        return self._state

    def finished_piece_count(self) -> float:
        return self._finished

    def piece_cost_stats(self) -> _FrozenCostStats:
        return self._stats

    def piece_costs(self) -> list:
        return self._stats.values()


def _parent_location(matches: float) -> str:
    k = int(matches)
    if k >= len(_LOC_ELEMENTS):
        return _CHILD_LOCATION
    if k <= 0:
        return "x|" + "|".join(_LOC_ELEMENTS[1:])
    return "|".join(_LOC_ELEMENTS[:k]) + "|x" + (
        "|" + "|".join(_LOC_ELEMENTS[k + 1:]) if k + 1 < len(_LOC_ELEMENTS)
        else "")


def _row_array(candidate) -> np.ndarray:
    """A candidate's decision-time feature row, float32, in the canonical
    layout."""
    f = candidate.features
    return np.array([getattr(f, name) for name in _FEATURE_FIELDS],
                    dtype=np.float32)


def rebuild_decision(event: ReplayDecision):
    """(child, parents-in-filter-order) whose ``build_feature_matrix``
    output is bit-identical to the recorded matrix."""
    rows = [_row_array(c) for c in event.candidates]
    child_finished = float(rows[0][1]) if rows else 0.0
    child = ReplayPeer(
        event.peer_id,
        ReplayHost(is_seed=False, upload_count=0.0, upload_failed_count=0.0,
                   free_upload_count=0.0, concurrent_upload_limit=0.0,
                   idc=_CHILD_IDC, location=_CHILD_LOCATION),
        state="Running", finished=child_finished, snapshot=(0, 0.0, 0.0, 0.0),
        total_piece_count=event.total_piece_count, task_id=event.task_id)
    parents = []
    for cand, row in zip(event.candidates, rows):
        is_seed = row[7] > 0
        seed_ready = row[8] > 0
        # seed_ready is the conjunction "is_seed AND state in
        # (ReceivedNormal, Running)"; a seed recorded NOT ready must sit
        # in a state outside that set that is still non-bad for
        # is_bad_node — BackToSource is exactly that.
        state = "Running" if (not is_seed or seed_ready) else "BackToSource"
        host = ReplayHost(
            is_seed=bool(is_seed),
            upload_count=float(row[3]), upload_failed_count=float(row[4]),
            free_upload_count=float(row[5]),
            concurrent_upload_limit=float(row[6]),
            idc=_CHILD_IDC if row[9] > 0 else "",
            location=_parent_location(float(row[10])))
        parents.append(ReplayPeer(
            cand.id, host, state, float(row[0]),
            (cand.cost_n, cand.cost_last, cand.cost_prior_mean,
             cand.cost_prior_pstd),
            total_piece_count=event.total_piece_count,
            task_id=event.task_id))
    return child, parents


# -- corpus loading ---------------------------------------------------------


def _check_versions(events: Sequence[ReplayDecision]) -> List[ReplayDecision]:
    for e in events:
        if e.version != REPLAY_SCHEMA_VERSION:
            raise ValueError(
                f"replay corpus event seq={e.seq} has schema version "
                f"{e.version}; this harness understands "
                f"{REPLAY_SCHEMA_VERSION} only")
    return sorted(events, key=lambda e: e.seq)


def corpus_from_events(events: Sequence[ReplayDecision]) -> List[ReplayDecision]:
    """Validate + seq-order an in-memory event list (recorder ring)."""
    return _check_versions(list(events))


def corpus_from_storage(storage) -> List[ReplayDecision]:
    """Load the full recorded corpus from a scheduler Storage's rotating
    ``replay`` dataset (active file + rotated backups)."""
    return _check_versions(storage.list_replay())


def corpus_from_files(paths: Sequence[str]) -> List[ReplayDecision]:
    events: List[ReplayDecision] = []
    for path in paths:
        if path.endswith(".npc"):
            from dragonfly2_tpu_torch.scheduler.replaystore import open_corpus

            events.extend(open_corpus(path).to_events())
        else:
            from dragonfly2_tpu_torch.schema.io import read_csv_records

            events.extend(read_csv_records(ReplayDecision, path))
    return _check_versions(events)


def columnar_from_files(paths: Sequence[str]):
    """Load a corpus as a :class:`~dragonfly2_tpu_torch.scheduler.replaystore.
    ColumnarCorpus` — ``.npc`` segments mmap in zero-copy, CSV paths pay
    a one-time pack. The vectorized engine and the trainers consume
    this directly."""
    from dragonfly2_tpu_torch.scheduler import replaystore

    columnar = []
    csv_paths = [p for p in paths if not p.endswith(".npc")]
    for path in paths:
        if path.endswith(".npc"):
            columnar.append(replaystore.open_corpus(path))
    if csv_paths:
        columnar.append(replaystore.ColumnarCorpus.from_events(
            corpus_from_files(csv_paths)))
    if len(columnar) == 1:
        return columnar[0]
    return replaystore.concat_corpora(columnar)


def as_columnar(corpus):
    """Columnar view of any corpus input: a ColumnarCorpus passes
    through untouched; an event sequence is packed in memory."""
    from dragonfly2_tpu_torch.scheduler.replaystore import ColumnarCorpus

    if isinstance(corpus, ColumnarCorpus):
        return corpus
    return ColumnarCorpus.from_events(list(corpus))


# -- replay -----------------------------------------------------------------


@dataclass
class ReplayRun:
    """One evaluator's pass over a corpus: the decision sequence (what
    the wire would have carried), the FULL per-event ranking (for rank
    agreement), per-decision latencies, and the determinism digest."""

    evaluator: str = ""
    seed: int = 0
    decisions: List[tuple] = field(default_factory=list)
    full_order: Dict[int, tuple] = field(default_factory=dict)
    latencies_ms: List[float] = field(default_factory=list)
    digest: str = ""
    # Vectorized-path provenance: shard count (1 for the sequential
    # harness and unsharded batch runs) and per-shard merged stats.
    shards: int = 1
    shard_stats: List[dict] = field(default_factory=list)


def replay_decisions(corpus: Sequence[ReplayDecision], evaluator, *,
                     candidate_limit: int = 4, seed: int = 0,
                     name: str = "") -> ReplayRun:
    """Re-drive every recorded decision through ``evaluator`` (the same
    ``evaluate_parents`` contract the live scheduling core calls) and
    return the resulting decision sequence + digest."""
    run = ReplayRun(evaluator=name or type(evaluator).__name__, seed=seed)
    hasher = hashlib.sha256()
    for event in corpus:
        if event.verdict == VERDICT_BACK_TO_SOURCE or not event.candidates:
            entry = (event.seq, VERDICT_BACK_TO_SOURCE, ())
        else:
            child, parents = rebuild_decision(event)
            t0 = perf_counter()
            ranked = evaluator.evaluate_parents(
                parents, child, event.total_piece_count)
            run.latencies_ms.append((perf_counter() - t0) * 1e3)
            order = tuple(p.id for p in ranked)
            run.full_order[event.seq] = order
            entry = (event.seq, VERDICT_PARENTS, order[:candidate_limit])
        run.decisions.append(entry)
        hasher.update(repr(entry).encode())
    run.digest = hasher.hexdigest()
    return run


def realized_costs(event: ReplayDecision) -> Dict[str, float]:
    return {c.id: c.realized_cost for c in event.candidates
            if c.realized_n >= MIN_REALIZED_SAMPLES and c.realized_cost >= 0}


def bad_node_labels(event: ReplayDecision) -> Dict[str, bool]:
    """Evaluator-independent ground truth from realized costs: a
    candidate is BAD when its realized cost exceeds ``BAD_LABEL_FACTOR``
    x the MEDIAN of the OTHER realized candidates of the same
    decision."""
    realized = realized_costs(event)
    labels: Dict[str, bool] = {}
    for cid, cost in realized.items():
        others = [v for k, v in realized.items() if k != cid]
        if not others:
            continue
        labels[cid] = cost > BAD_LABEL_FACTOR * float(np.median(others))
    return labels


def score_run(corpus: Sequence[ReplayDecision], run: ReplayRun,
              evaluator=None) -> Dict[str, object]:
    """Decision-quality metrics for one replay run. ``evaluator`` adds
    the bad-node precision/recall pass (``is_bad_node`` over the
    decision-time snapshots); None skips it."""
    from dragonfly2_tpu_torch.manager.validation import spearman

    regrets: List[float] = []
    rel_regrets: List[float] = []
    agreements: List[float] = []
    parent_events = regret_scored = agree_scored = 0
    tp = fp = fn = tn = 0
    decided = {seq: ids for seq, verdict, ids in run.decisions
               if verdict == VERDICT_PARENTS}
    for event in corpus:
        if event.seq not in decided:
            continue
        parent_events += 1
        realized = realized_costs(event)
        top = decided[event.seq][0] if decided[event.seq] else ""
        if len(realized) >= 2 and top in realized:
            best = min(realized.values())
            regrets.append(realized[top] - best)
            rel_regrets.append((realized[top] - best) / max(best, 1e-9))
            regret_scored += 1
        order = run.full_order.get(event.seq, ())
        ranked_realized = [cid for cid in order if cid in realized]
        if len(ranked_realized) >= 3:
            positions = [float(order.index(cid)) for cid in ranked_realized]
            costs = [realized[cid] for cid in ranked_realized]
            agreements.append(spearman(positions, costs))
            agree_scored += 1
        if evaluator is not None:
            labels = bad_node_labels(event)
            if labels:
                child, parents = rebuild_decision(event)
                verdicts = {p.id: bool(evaluator.is_bad_node(p))
                            for p in parents}
                for cid, label in labels.items():
                    pred = verdicts.get(cid, False)
                    if label and pred:
                        tp += 1
                    elif label and not pred:
                        fn += 1
                    elif not label and pred:
                        fp += 1
                    else:
                        tn += 1
    lat = sorted(run.latencies_ms)
    out: Dict[str, object] = {
        "evaluator": run.evaluator,
        "digest": run.digest,
        "decisions": len(run.decisions),
        "parent_decisions": parent_events,
        "regret_scored": regret_scored,
        "regret_mean_s": round(float(np.mean(regrets)), 6) if regrets else None,
        "regret_p99_s": round(percentile(sorted(regrets), 0.99), 6)
        if regrets else None,
        "regret_rel_mean": round(float(np.mean(rel_regrets)), 4)
        if rel_regrets else None,
        "rank_agreement_scored": agree_scored,
        "rank_agreement_mean": round(float(np.mean(agreements)), 4)
        if agreements else None,
        "decision_latency_p50_ms": round(percentile(lat, 0.50), 4),
        "decision_latency_p99_ms": round(percentile(lat, 0.99), 4),
    }
    if evaluator is not None:
        labeled = tp + fp + fn + tn
        out.update({
            "bad_node_labeled": labeled,
            "bad_node_tp": tp, "bad_node_fp": fp,
            "bad_node_fn": fn, "bad_node_tn": tn,
            "bad_node_precision": round(tp / (tp + fp), 4)
            if (tp + fp) else None,
            "bad_node_recall": round(tp / (tp + fn), 4)
            if (tp + fn) else None,
        })
    return out


def replay_ab(corpus: Sequence[ReplayDecision],
              evaluators: Dict[str, object], *,
              candidate_limit: int = 4, seed: int = 0,
              baseline: str = "rule") -> Dict[str, object]:
    """Head-to-head A/B: replay the SAME corpus through every named
    evaluator twice (the second pass proves bit-identical determinism),
    score each, and report deltas vs the baseline evaluator."""
    results: Dict[str, object] = {"evaluators": {}, "baseline": baseline,
                                  "corpus_decisions": len(corpus)}
    for name, evaluator in evaluators.items():
        run = replay_decisions(corpus, evaluator,
                               candidate_limit=candidate_limit,
                               seed=seed, name=name)
        rerun = replay_decisions(corpus, evaluator,
                                 candidate_limit=candidate_limit,
                                 seed=seed, name=name)
        scored = score_run(corpus, run, evaluator=evaluator)
        scored["deterministic"] = run.digest == rerun.digest
        results["evaluators"][name] = scored
    base = results["evaluators"].get(baseline)
    if base is not None and base.get("regret_mean_s") is not None:
        for name, scored in results["evaluators"].items():
            if name == baseline or scored.get("regret_mean_s") is None:
                continue
            scored["regret_delta_vs_baseline_s"] = round(
                scored["regret_mean_s"] - base["regret_mean_s"], 6)
    results["deterministic"] = all(
        s.get("deterministic") for s in results["evaluators"].values())
    return results


# -- vectorized replay ------------------------------------------------------
#
# The batched engine scores a whole columnar corpus as matrices and is
# BIT-IDENTICAL to replay_decisions on the same corpus: same run digest,
# same tie-break order. The identities it relies on:
#
# - rule_scores is elementwise over [..., FEATURE_DIM], so a [N, K, 11]
#   batch yields the exact float32 values of per-decision [nc, 11] calls;
# - ParentScorer.score_corpus is row-stable: every forward, in
#   score_corpus and in the per-decision score, runs at the scorer's one
#   shape of max_batch zero-padded rows, so row i's output does not
#   depend on the block or the request holding it. No other block shape
#   would do: cuBLAS picks its kernel by shape, and kernels sum in
#   different orders (tests/mlp_row_stability.py), so the JAX package's
#   4096-row chunks have no counterpart here;
# - stable argsort over a row whose padding key is NaN reproduces the
#   per-decision stable argsort exactly (NaN sorts after every finite
#   and infinite score, and after any NaN score in a VALID slot because
#   valid slots precede padding slots in input order);
# - sha256 is chunking-invariant, so hashing the concatenated reprs
#   equals the sequential per-entry update sequence.


def _is_plain_rule(evaluator) -> bool:
    from dragonfly2_tpu_torch.scheduler.evaluator.base import BaseEvaluator

    return type(evaluator) is BaseEvaluator


def _corpus_scores(cc, evaluator) -> np.ndarray:
    """[N, K] float64 scores ordering-identical to what
    ``evaluator.evaluate_parents`` computes per decision — including the modelguard degrade-to-rule
    fallback, applied per decision exactly like the sequential path.
    Padding slots hold zeros; callers mask by ``cc.valid`` before
    ordering."""
    from dragonfly2_tpu_torch.inference.modelguard import (
        GUARD_MIN_CONSTANT_ROWS,
        GUARD_MIN_SCORE_SPREAD,
    )
    from dragonfly2_tpu_torch.scheduler.evaluator import scoring

    from dragonfly2_tpu_torch.scheduler.replaystore import VERDICT_CODE_PARENTS

    # rule_scores promotes to float64 (its host-type term is a pure
    # scalar where) — keep that dtype: the sequential path argsorts the
    # f64 values, and a float32 round-off here would merge near-ties it
    # distinguishes. ML/cost scores are float32 from the model forward;
    # the f64 cast below is exact and monotone, so ordering and tie-sets
    # match the sequential float32 argsort. Scoring only the VALID rows
    # (rule_scores is elementwise, so compact-then-scatter is
    # value-identical) skips the ~half-padding of a bucketed corpus —
    # the dominant rule-path cost at ladder scale.
    rule = np.zeros(cc.valid.shape, np.float64)
    if bool(cc.valid.any()):
        rule[cc.valid] = np.asarray(
            scoring.rule_scores(cc.features[cc.valid]), dtype=np.float64)
    if _is_plain_rule(evaluator):
        return rule
    scorer = getattr(evaluator, "_scorer", None)
    if scorer is None and hasattr(evaluator, "_fallback"):
        # MLEvaluator without a model: every decision is the rule
        # evaluator's (its _fallback is always a plain BaseEvaluator).
        return rule
    score_corpus = getattr(scorer, "score_corpus", None)
    if score_corpus is None:
        raise TypeError(
            f"{type(evaluator).__name__} cannot be replayed in batch: its "
            "scorer has no score_corpus (micro-batcher/remote facades are "
            "serving-path wrappers) — use the sequential harness")
    inner = getattr(evaluator, "_inner", None)
    if inner is not None and not _is_plain_rule(inner):
        raise TypeError(
            "vectorized replay only supports LearnedCostEvaluator with the "
            "default rule inner evaluator (guard fallback parity) — use "
            "the sequential harness for a custom inner")

    scores = rule.copy()
    if bool(cc.valid.any()):
        scores[cc.valid] = score_corpus(
            cc.features[cc.valid]).astype(np.float64)

    # modelguard.guard_reason, batched with identical semantics: the
    # sequential path guards each decision's [nc] score slice (float64),
    # trips on any non-finite score, or on a collapsed spread over >= 4
    # candidates unless every feature row is identical (the waiver).
    is_par = (cc.verdict == VERDICT_CODE_PARENTS) & (cc.n_candidates > 0)
    s64 = scores.astype(np.float64)
    nonfinite = (~np.isfinite(s64) & cc.valid).any(axis=1)
    smax = np.where(cc.valid, s64, -np.inf).max(axis=1, initial=-np.inf)
    smin = np.where(cc.valid, s64, np.inf).min(axis=1, initial=np.inf)
    collapsed = (cc.n_candidates >= GUARD_MIN_CONSTANT_ROWS) & \
        ((smax - smin) < GUARD_MIN_SCORE_SPREAD)
    same_rows = ((cc.features == cc.features[:, :1, :])
                 | ~cc.valid[:, :, None]).all(axis=(1, 2))
    tripped = is_par & (nonfinite | (collapsed & ~same_rows))
    if bool(tripped.any()):
        scores = np.where(tripped[:, None], rule, scores)
    n_trip = int(tripped.sum())
    n_scored = int(is_par.sum()) - n_trip
    # Keep the evaluator's own health counters truthful (the sequential
    # harness ticks them per decision); process-wide serving-stats ticks
    # are not replayed from the offline batch path.
    if hasattr(evaluator, "scored_count"):
        evaluator.scored_count += n_scored
    if hasattr(evaluator, "fallback_count"):
        evaluator.fallback_count += n_trip
    if n_trip:
        reasons = np.where(nonfinite, "nonfinite", "constant")[tripped]
        guard_trip = getattr(evaluator, "_guard_trip", None)
        for reason in reasons.tolist():
            if guard_trip is not None:  # MLEvaluator: count + escalate
                guard_trip(reason)
            else:  # LearnedCostEvaluator counter discipline
                evaluator.guard_trips += 1
                stats = getattr(evaluator, "_stats", None)
                if stats is not None:
                    stats.observe_cost_guard_trip()
    return scores


def _replay_chunk(cc, evaluator, candidate_limit: int):
    """(decisions, full_order, digest-bytes) for one corpus chunk."""
    from dragonfly2_tpu_torch.scheduler.replaystore import VERDICT_CODE_PARENTS

    if cc.n == 0:
        return [], {}, b""
    scores = _corpus_scores(cc, evaluator)
    # NaN padding key: padding sorts after EVERY valid score (finite,
    # +/-inf, or NaN — valid slots precede padding in input order and
    # the sort is stable), so order_idx[:, :nc] is exactly the
    # sequential np.argsort(-scores, kind="stable") permutation.
    keys = np.where(cc.valid, -scores, np.nan)
    order_idx = np.argsort(keys, axis=1, kind="stable")
    ids_sorted = np.take_along_axis(cc.cand_id, order_idx, axis=1)
    counts_arr = cc.n_candidates
    # Valid slots sort before NaN-keyed padding, so each row's first nc
    # sorted slots ARE its ranked candidates — materialize ONLY those
    # Python strings (flat, with per-row offsets) instead of all N*K.
    in_order = np.arange(cc.k)[None, :] < counts_arr[:, None]
    flat_ids = ids_sorted[in_order].tolist()
    seqs = cc.seq.tolist()
    counts = counts_arr.tolist()
    is_par = ((cc.verdict == VERDICT_CODE_PARENTS)
              & (counts_arr > 0)).tolist()
    decisions: List[tuple] = []
    full_order: Dict[int, tuple] = {}
    append = decisions.append
    o = 0
    for i in range(cc.n):
        nc = counts[i]
        if is_par[i]:
            order = tuple(flat_ids[o:o + nc])
            full_order[seqs[i]] = order
            entry = (seqs[i], VERDICT_PARENTS, order[:candidate_limit])
        else:
            entry = (seqs[i], VERDICT_BACK_TO_SOURCE, ())
        o += nc
        append(entry)
    return decisions, full_order, "".join(map(repr, decisions)).encode()


def replay_decisions_vectorized(corpus, evaluator=None, *,
                                candidate_limit: int = 4, seed: int = 0,
                                name: str = "", shards: int = 1,
                                prefetch_depth: int = 2,
                                prefetch_workers: int = 2) -> ReplayRun:
    """Batched counterpart of :func:`replay_decisions`: scores the whole
    corpus as matrices, bit-identical digest and tie-break order.

    ``corpus`` is a ColumnarCorpus or an event sequence (packed in
    memory). ``shards > 1`` fans contiguous corpus shards out through
    :func:`~dragonfly2_tpu_torch.data.prefetch.prefetch` workers and merges
    the per-shard results in order — same digest, per-shard timings in
    ``run.shard_stats``. Evaluators supported: the plain rule evaluator,
    MLEvaluator over a local ParentScorer, and LearnedCostEvaluator with
    the default rule inner (anything else raises TypeError).
    """
    from dragonfly2_tpu_torch.data.prefetch import prefetch

    cc = as_columnar(corpus)
    if evaluator is None:
        from dragonfly2_tpu_torch.scheduler.evaluator.base import BaseEvaluator

        evaluator = BaseEvaluator()
    run = ReplayRun(evaluator=name or type(evaluator).__name__, seed=seed)
    shards = max(1, min(int(shards), cc.n or 1))
    bounds = []
    step = -(-cc.n // shards) if cc.n else 0
    for a in range(0, cc.n, step or 1):
        bounds.append((a, min(a + step, cc.n)))

    def work(rng):
        a, b = rng
        t0 = perf_counter()
        decisions, full_order, blob = _replay_chunk(
            cc.slice(a, b), evaluator, candidate_limit)
        return decisions, full_order, blob, perf_counter() - t0

    if len(bounds) <= 1:
        results = [work(b) for b in (bounds or [(0, 0)])]
    else:
        results = list(prefetch(bounds, work, depth=prefetch_depth,
                                workers=prefetch_workers))
    hasher = hashlib.sha256()
    for (a, b), (decisions, full_order, blob, elapsed) in zip(bounds or [(0, 0)], results):
        run.decisions.extend(decisions)
        run.full_order.update(full_order)
        hasher.update(blob)
        run.shard_stats.append({"start": a, "stop": b,
                                "decisions": b - a,
                                "elapsed_s": round(elapsed, 6)})
    run.digest = hasher.hexdigest()
    run.shards = len(bounds) if bounds else 1
    return run


def bad_node_labels_batch(cc) -> tuple[np.ndarray, np.ndarray]:
    """(labels, has_label) ``[N, K]`` bool arrays, value-identical to
    :func:`bad_node_labels` per decision: a realized candidate is BAD
    when its cost exceeds ``BAD_LABEL_FACTOR`` x the median of the OTHER
    realized candidates (leave-one-out median over sorted positions —
    the even-count midpoint mean matches np.median bitwise)."""
    rm = cc.valid & (cc.realized_n >= MIN_REALIZED_SAMPLES) & \
        (cc.realized_cost >= 0)
    n, k = rm.shape
    if n == 0:
        return np.zeros((0, k), bool), np.zeros((0, k), bool)
    vals = np.where(rm, cc.realized_cost, np.inf)
    order = np.argsort(vals, axis=1, kind="stable")
    svals = np.take_along_axis(vals, order, axis=1)
    # pos[i, slot] = slot's position in the sorted row (inverse perm).
    pos = np.empty((n, k), np.int64)
    np.put_along_axis(pos, order, np.arange(k, dtype=np.int64)[None, :],
                      axis=1)
    m = rm.sum(axis=1)
    m1 = (m - 1)[:, None]  # leave-one-out sample size per row
    # Removing sorted position p shifts every later element down one:
    # sorted index j of the remainder maps to j + (j >= p) in svals.
    h = m1 // 2
    med_odd = np.take_along_axis(
        svals, np.clip(h + (h >= pos), 0, k - 1), axis=1)
    lo, hi = m1 // 2 - 1, m1 // 2
    med_even = (np.take_along_axis(svals, np.clip(lo + (lo >= pos), 0, k - 1),
                                   axis=1)
                + np.take_along_axis(svals,
                                     np.clip(hi + (hi >= pos), 0, k - 1),
                                     axis=1)) / 2
    med = np.where(m1 % 2 == 1, med_odd, med_even)
    has_label = rm & (m[:, None] >= 2)
    labels = has_label & (cc.realized_cost > BAD_LABEL_FACTOR * med)
    return labels, has_label


def rule_bad_node_verdicts(cc) -> np.ndarray:
    """``[N, K]`` rule ``is_bad_node`` verdicts from the decision-time
    cost snapshots — exactly what BaseEvaluator (and MLEvaluator, which
    delegates) answers for the rebuilt peers: rebuilt states are never
    bad, then the windowed-Welford fast path over (n, last, prior mean,
    prior pstd)."""
    from dragonfly2_tpu_torch.scheduler.evaluator.base import (
        MIN_AVAILABLE_COST_LEN,
        NORMAL_DISTRIBUTION_LEN,
    )

    small = cc.cost_last > cc.cost_prior_mean * 20
    large = cc.cost_last > cc.cost_prior_mean + 3 * cc.cost_prior_pstd
    return cc.valid & (cc.cost_n >= MIN_AVAILABLE_COST_LEN) & \
        np.where(cc.cost_n < NORMAL_DISTRIBUTION_LEN, small, large)


def score_run_vectorized(corpus, run: ReplayRun, *,
                         bad_node_verdicts: Optional[np.ndarray] = None
                         ) -> Dict[str, object]:
    """Batched :func:`score_run`: same metric keys, same values on the
    same run (regret/label arithmetic is bit-identical; Spearman runs on
    batch-extracted arrays through the same scalar kernel).

    The bad-node pass takes a precomputed ``[N, K]`` verdict array
    (:func:`rule_bad_node_verdicts` for the rule/ML evaluators) instead
    of an evaluator object; None skips it like ``evaluator=None``.
    """
    from dragonfly2_tpu_torch.manager.validation import spearman
    from dragonfly2_tpu_torch.scheduler.replaystore import VERDICT_CODE_PARENTS

    cc = as_columnar(corpus)
    n, k = cc.valid.shape
    is_par = (cc.verdict == VERDICT_CODE_PARENTS) & (cc.n_candidates > 0)
    rm = cc.valid & (cc.realized_n >= MIN_REALIZED_SAMPLES) & \
        (cc.realized_cost >= 0)
    seqs = cc.seq.tolist()

    # Reconstruct the run's ranking as slot indices: ord_ids[i] is the
    # run's full order (padded with ""), matched against the corpus
    # candidate ids (unique per decision — check_corpus warns).
    ord_ids = np.zeros((n, k), dtype=cc.cand_id.dtype if n else "<U1")
    for i, seq in enumerate(seqs):
        order = run.full_order.get(seq, ())
        if order:
            ord_ids[i, :len(order)] = order
    valid_ord = ord_ids != ""
    match = ord_ids[:, :, None] == cc.cand_id[:, None, :]
    order_idx = match.argmax(axis=2)
    matched = match.any(axis=2) & valid_ord
    scored = is_par & np.array(
        [run.full_order.get(seq) is not None for seq in seqs]
        if n else [], dtype=bool)

    rm_ord = np.take_along_axis(rm, order_idx, axis=1) & matched
    costs_ord = np.take_along_axis(cc.realized_cost, order_idx, axis=1)

    # Regret: chosen top's realized cost minus the best realized cost.
    rcount = rm.sum(axis=1)
    top_realized = rm_ord[:, 0] if k else np.zeros(n, bool)
    q_regret = scored & (rcount >= 2) & top_realized
    best = np.where(rm, cc.realized_cost, np.inf).min(
        axis=1, initial=np.inf)
    top_cost = costs_ord[:, 0] if k else np.zeros(n)
    regrets = (top_cost - best)[q_regret]
    rel_regrets = (regrets / np.maximum(best[q_regret], 1e-9))

    # Rank agreement: Spearman over the realized subset of the ranking,
    # per qualifying decision, through the same scalar spearman kernel
    # on batch-extracted positions/costs.
    agreements: List[float] = []
    mranked = rm_ord.sum(axis=1)
    for i in np.flatnonzero(scored & (mranked >= 3)).tolist():
        positions = np.flatnonzero(rm_ord[i]).astype(np.float64).tolist()
        costs = costs_ord[i][rm_ord[i]].tolist()
        agreements.append(spearman(positions, costs))

    lat = sorted(run.latencies_ms)
    sorted_regrets = np.sort(regrets).tolist()
    out: Dict[str, object] = {
        "evaluator": run.evaluator,
        "digest": run.digest,
        "decisions": len(run.decisions),
        "parent_decisions": int(is_par.sum()),
        "regret_scored": int(q_regret.sum()),
        "regret_mean_s": round(float(np.mean(regrets)), 6)
        if regrets.size else None,
        "regret_p99_s": round(percentile(sorted_regrets, 0.99), 6)
        if regrets.size else None,
        "regret_rel_mean": round(float(np.mean(rel_regrets)), 4)
        if rel_regrets.size else None,
        "rank_agreement_scored": len(agreements),
        "rank_agreement_mean": round(float(np.mean(agreements)), 4)
        if agreements else None,
        "decision_latency_p50_ms": round(percentile(lat, 0.50), 4),
        "decision_latency_p99_ms": round(percentile(lat, 0.99), 4),
    }
    if bad_node_verdicts is not None:
        labels, has_label = bad_node_labels_batch(cc)
        judged = has_label & scored[:, None]
        pred = np.asarray(bad_node_verdicts, bool)
        tp = int((judged & labels & pred).sum())
        fp = int((judged & ~labels & pred).sum())
        fn = int((judged & labels & ~pred).sum())
        tn = int((judged & ~labels & ~pred).sum())
        out.update({
            "bad_node_labeled": tp + fp + fn + tn,
            "bad_node_tp": tp, "bad_node_fp": fp,
            "bad_node_fn": fn, "bad_node_tn": tn,
            "bad_node_precision": round(tp / (tp + fp), 4)
            if (tp + fp) else None,
            "bad_node_recall": round(tp / (tp + fn), 4)
            if (tp + fn) else None,
        })
    return out
