"""Offline model validation gate — port of
``dragonfly2_tpu/manager/validation.py``: the registry's promotion
criterion.

The gate replays recorded announce traces against a candidate: each
trace is one ``[n, FEATURE_DIM]`` candidate-set feature matrix captured
on the live announce path (``MLEvaluator(trace_log=...)``). The
candidate is promoted only if

- every replayed score batch is finite and non-degenerate (the shared
  :func:`~dragonfly2_tpu_torch.inference.modelguard.guard_reason`),
- its ranking rank-correlates with the rule evaluator's over the same
  features above a floor, and
- per-batch scoring latency fits the serving budget.

With no recorded traces yet, the gate falls back to deterministic
synthetic traces over the canonical feature ranges. :func:`validate_artifact`
builds the candidate through the inference service's loaders on the
device the caller gives (the card by default), so the gate checks the
model as it would serve.
"""

from __future__ import annotations

import io
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from dragonfly2_tpu_torch.inference.modelguard import guard_reason
from dragonfly2_tpu_torch.scheduler.evaluator import scoring

#: Object-store key prefix for recorded announce traces (per scheduler).
TRACES_KEY_PREFIX = "traces"

#: Rank-correlation is only meaningful on batches with enough candidates
#: to rank.
MIN_CORRELATION_ROWS = 3


class TraceLog:
    """Bounded ring of recorded announce feature matrices.

    The scheduler-side ML evaluator records each announce's candidate
    feature matrix here (a copy — the source buffer is staged/reused);
    ``to_bytes``/``from_bytes`` move a log through the manager's object
    store so the gate can replay REAL traffic against a candidate."""

    def __init__(self, capacity: int = 64):
        import collections
        import threading

        self.capacity = capacity
        # record() runs on scheduler announce threads while the
        # keepalive ticker serializes the log for upload — an unlocked
        # deque iteration racing an append raises "deque mutated
        # during iteration" exactly on the busy schedulers whose real
        # corpus the gate needs.
        self._lock = threading.Lock()
        self._batches: "collections.deque" = collections.deque(
            maxlen=capacity)

    def record(self, features: np.ndarray) -> None:
        features = np.asarray(features, dtype=np.float32)
        if features.ndim != 2 or features.shape[0] == 0:
            return
        with self._lock:
            self._batches.append(features.copy())

    def __len__(self) -> int:
        with self._lock:
            return len(self._batches)

    def batches(self) -> List[np.ndarray]:
        with self._lock:
            return list(self._batches)

    def to_bytes(self) -> bytes:
        with self._lock:
            snapshot = list(self._batches)
        buf = io.BytesIO()
        np.savez(buf, **{f"t{i}": b for i, b in enumerate(snapshot)})
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, payload: bytes) -> "TraceLog":
        with np.load(io.BytesIO(payload)) as data:
            batches = [data[k] for k in sorted(
                data.files, key=lambda n: int(n[1:]))]
        log = cls(capacity=max(len(batches), 1))
        for b in batches:
            log.record(b)
        return log


@dataclass
class ValidationConfig:
    """Promotion criteria. The NaN/degenerate guard is not configurable
    — a model failing it is never safe to serve; the correlation floor
    and latency budget are deployment-tuned knobs."""

    min_rank_correlation: float = 0.2
    max_batch_latency_s: float = 0.25
    # Synthetic fallback shape when no traces are recorded yet.
    synthetic_batches: int = 16
    synthetic_rows: int = 12
    seed: int = 0


@dataclass
class ValidationReport:
    passed: bool = False
    reasons: List[str] = field(default_factory=list)
    batches: int = 0
    scored_rows: int = 0
    rank_correlation: Optional[float] = None
    max_batch_latency_s: Optional[float] = None
    trace_source: str = ""
    checks: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "passed": self.passed,
            "reasons": list(self.reasons),
            "batches": self.batches,
            "scored_rows": self.scored_rows,
            "rank_correlation": self.rank_correlation,
            "max_batch_latency_s": self.max_batch_latency_s,
            "trace_source": self.trace_source,
            "checks": dict(self.checks),
        }


def spearman(a, b) -> float:
    """Spearman rank correlation of two equal-length score vectors.

    Average-rank tie handling; returns 0.0 when either side has zero
    variance (no ranking signal to correlate)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)

    def ranks(x: np.ndarray) -> np.ndarray:
        order = np.argsort(x, kind="stable")
        r = np.empty(len(x), dtype=np.float64)
        r[order] = np.arange(len(x), dtype=np.float64)
        # Average ranks over ties so equal scores carry equal rank.
        for v in np.unique(x):
            mask = x == v
            if mask.sum() > 1:
                r[mask] = r[mask].mean()
        return r

    ra, rb = ranks(a), ranks(b)
    sa, sb = ra.std(), rb.std()
    if sa == 0 or sb == 0:
        return 0.0
    return float(((ra - ra.mean()) * (rb - rb.mean())).mean() / (sa * sb))


def synthetic_traces(seed: int = 0, batches: int = 16,
                     rows: int = 12) -> List[np.ndarray]:
    """Deterministic feature batches over the canonical ranges — the
    gate's fallback when a deployment has no recorded announces yet.
    Built through :func:`scoring.pack_features` so layout and derived
    features (idc/location matches) can never drift from the live
    extraction path."""
    rng = np.random.default_rng(seed)
    idcs = ("idc-a", "idc-b", "idc-c")
    locs = ("dc|rack1|row1", "dc|rack1|row2", "dc|rack2|row1", "")
    out = []
    for _ in range(batches):
        matrix = []
        total = int(rng.integers(8, 256))
        child_fin = int(rng.integers(0, total))
        child_idc = str(rng.choice(idcs))
        child_loc = str(rng.choice(locs))
        for _ in range(rows):
            uploads = int(rng.integers(0, 200))
            limit = int(rng.integers(10, 200))
            is_seed = bool(rng.random() < 0.3)
            matrix.append(scoring.pack_features(
                parent_finished_pieces=int(rng.integers(0, total + 1)),
                child_finished_pieces=child_fin,
                total_pieces=total,
                upload_count=uploads,
                upload_failed_count=int(rng.integers(0, uploads + 1)),
                free_upload_count=int(rng.integers(0, limit + 1)),
                concurrent_upload_limit=limit,
                is_seed=is_seed,
                seed_ready=is_seed and bool(rng.random() < 0.7),
                parent_idc=str(rng.choice(idcs)),
                child_idc=child_idc,
                parent_location=str(rng.choice(locs)),
                child_location=child_loc,
            ))
        out.append(np.stack(matrix).astype(np.float32))
    return out


def validate_feature_scorer(scorer, traces: Sequence[np.ndarray],
                            config: ValidationConfig,
                            enforce_correlation: bool = True) -> ValidationReport:
    """Replay feature-matrix traces through a candidate scorer and apply
    the promotion criteria.

    Small recorded batches must not blind the gate: a live swarm whose
    candidate sets have 1-2 parents records batches too small for the
    per-batch constant check or a per-batch rank correlation, so the
    degenerate-score guard ALSO runs over the pooled corpus (a
    collapsed model scores every row of every batch identically) and
    the correlation falls back to one pooled Spearman over all rows
    when no single batch could carry it."""
    report = ValidationReport(batches=len(traces))
    correlations = []
    all_scores = []
    all_rule = []
    max_latency = 0.0
    for batch in traces:
        batch = np.asarray(batch, dtype=np.float32)
        t0 = time.perf_counter()
        try:
            scores = np.asarray(scorer.score(batch))
        except Exception as exc:  # noqa: BLE001 — a scoring crash is a verdict
            report.reasons.append(f"scoring raised: {exc!r}")
            report.checks["scoring"] = "raised"
            return report
        max_latency = max(max_latency, time.perf_counter() - t0)
        report.scored_rows += len(batch)
        reason = guard_reason(scores, features=batch)
        if reason is not None:
            report.reasons.append(f"degenerate scores: {reason}")
            report.checks["guard"] = reason
            report.max_batch_latency_s = round(max_latency, 4)
            return report
        rule = np.asarray(scoring.rule_scores(batch))
        all_scores.append(scores)
        all_rule.append(rule)
        if len(batch) >= MIN_CORRELATION_ROWS:
            correlations.append(spearman(scores, rule))
    report.max_batch_latency_s = round(max_latency, 4)
    pooled_scores = (np.concatenate(all_scores) if all_scores
                     else np.zeros(0))
    corpus_reason = guard_reason(pooled_scores)
    if corpus_reason is not None:
        report.reasons.append(
            f"degenerate scores across corpus: {corpus_reason}")
        report.checks["guard"] = f"corpus_{corpus_reason}"
        report.passed = False
        return report
    report.checks["guard"] = "ok"
    if correlations:
        report.rank_correlation = round(float(np.mean(correlations)), 4)
        report.checks["rank_correlation_scope"] = "per_batch"
    elif len(pooled_scores) >= MIN_CORRELATION_ROWS:
        report.rank_correlation = round(
            spearman(pooled_scores, np.concatenate(all_rule)), 4)
        report.checks["rank_correlation_scope"] = "pooled"
    if report.rank_correlation is not None:
        if not enforce_correlation:
            # A learned-cost candidate ranks by MEASURED realized costs;
            # legitimate disagreement with the hand-tuned rule weights
            # is the whole point of training it, so the rule-correlation
            # floor is recorded as evidence, never enforced. The
            # non-negotiable guard + latency checks above still gate.
            report.checks["rank_correlation"] = "informational"
        elif report.rank_correlation < config.min_rank_correlation:
            report.reasons.append(
                f"rank correlation {report.rank_correlation} below floor "
                f"{config.min_rank_correlation}")
            report.checks["rank_correlation"] = "below_floor"
        else:
            report.checks["rank_correlation"] = "ok"
    if max_latency > config.max_batch_latency_s:
        report.reasons.append(
            f"batch latency {max_latency:.3f}s over budget "
            f"{config.max_batch_latency_s}s")
        report.checks["latency"] = "over_budget"
    else:
        report.checks["latency"] = "ok"
    report.passed = not report.reasons
    return report


def validate_pair_scorer(scorer, config: ValidationConfig,
                         batches: int = 8, rows: int = 12,
                         seed: int = 0) -> ValidationReport:
    """GAT-style pair scorers rank (src, dst) host indexes, not feature
    rows — announce traces don't replay through them. The gate still
    enforces the non-negotiable half: finite, non-collapsed, in-budget
    scores over deterministic valid index pairs."""
    rng = np.random.default_rng(seed)
    n = max(int(getattr(scorer, "n_real", 2)), 2)
    report = ValidationReport(batches=batches, trace_source="index_pairs")
    max_latency = 0.0
    for _ in range(batches):
        pairs = rng.integers(0, n, size=(rows, 2)).astype(np.int32)
        t0 = time.perf_counter()
        try:
            scores = np.asarray(scorer.score(pairs))
        except Exception as exc:  # noqa: BLE001 — a scoring crash is a verdict
            report.reasons.append(f"scoring raised: {exc!r}")
            report.checks["scoring"] = "raised"
            return report
        max_latency = max(max_latency, time.perf_counter() - t0)
        report.scored_rows += rows
        reason = guard_reason(scores)
        if reason is not None:
            report.reasons.append(f"degenerate scores: {reason}")
            report.checks["guard"] = reason
            report.max_batch_latency_s = round(max_latency, 4)
            return report
    report.checks["guard"] = "ok"
    report.max_batch_latency_s = round(max_latency, 4)
    if max_latency > config.max_batch_latency_s:
        report.reasons.append(
            f"batch latency {max_latency:.3f}s over budget "
            f"{config.max_batch_latency_s}s")
        report.checks["latency"] = "over_budget"
    else:
        report.checks["latency"] = "ok"
    report.passed = not report.reasons
    return report


def validate_artifact(model_type: str, artifact: bytes,
                      traces: Optional[Sequence[np.ndarray]],
                      config: ValidationConfig,
                      device=None) -> ValidationReport:
    """Build the candidate the way the inference service would, on
    ``device`` (``None``: the card), and validate it.

    Types without a serving builder (``gnn`` — trained for offline
    analysis, never hot-loaded) pass trivially with an explicit check
    mark: the gate protects the SERVING path. A missing card, and a fault
    of the card or its kernels while the candidate builds
    (:func:`~dragonfly2_tpu_torch.device.is_device_fault`), raise instead
    of giving a verdict: they must not read as a bad artifact."""
    # Lazy imports: the sidecar imports this module for its canary, and
    # the manager's process (cmd/manager.py) reads ValidationConfig
    # without loading torch.
    from dragonfly2_tpu_torch.device import default_device, is_device_fault
    from dragonfly2_tpu_torch.inference.sidecar import (
        MODEL_NAME_COST,
        MODEL_NAME_GAT,
        MODEL_NAME_MLP,
        _cost_scorer_from_artifact,
        _gat_scorer_from_artifact,
        _scorer_from_artifact,
    )

    device = default_device(device)

    def validate_feature_type(builder, enforce_correlation: bool):
        # One load→trace-fallback→replay scaffold for every feature-
        # matrix scorer type (mlp, cost) — a future check added to this
        # path can never land in one type and miss the other.
        try:
            scorer = builder(artifact, device=device)
        except Exception as exc:  # noqa: BLE001 — load failure is a verdict
            if is_device_fault(exc):
                raise
            return ValidationReport(
                reasons=[f"artifact load failed: {exc!r}"],
                checks={"load": "failed"}, trace_source="none")
        replay_traces, source = traces, "recorded"
        if not replay_traces:
            replay_traces = synthetic_traces(
                config.seed, config.synthetic_batches,
                config.synthetic_rows)
            source = "synthetic"
        report = validate_feature_scorer(
            scorer, replay_traces, config,
            enforce_correlation=enforce_correlation)
        report.trace_source = source
        return report

    if model_type == MODEL_NAME_COST:
        # Learned piece-cost predictor: the same feature-matrix traces
        # through the CostScorer ranking view. Guard + latency are
        # enforced exactly like the MLP's; the rule rank-correlation is
        # recorded but NOT enforced — a cost model trained on realized
        # costs may legitimately invert hand-tuned rule preferences.
        return validate_feature_type(_cost_scorer_from_artifact,
                                     enforce_correlation=False)
    if model_type == MODEL_NAME_MLP:
        return validate_feature_type(_scorer_from_artifact,
                                     enforce_correlation=True)
    if model_type == MODEL_NAME_GAT:
        try:
            scorer = _gat_scorer_from_artifact(artifact, device=device)
        except Exception as exc:  # noqa: BLE001 — load failure is a verdict
            if is_device_fault(exc):
                raise
            return ValidationReport(
                reasons=[f"artifact load failed: {exc!r}"],
                checks={"load": "failed"}, trace_source="none")
        return validate_pair_scorer(scorer, config, seed=config.seed)
    return ValidationReport(passed=True, trace_source="none",
                            checks={"servable": f"type {model_type} has no "
                                    "serving path; gate skipped"})
