"""Deterministic offline replay harness — the sequential half of
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

The vectorized engine, the file and storage loaders and the ``df2-replay``
CLI are not ported.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from time import perf_counter
from typing import Dict, List, Sequence

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
    that read ``peer.task`` (the learned bad-node row assembly, and a
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
