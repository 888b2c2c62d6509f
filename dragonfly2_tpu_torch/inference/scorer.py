"""Batched parent scorers and the learned evaluators — port of
``dragonfly2_tpu/inference/scorer.py``.

A request is written into a preallocated host staging buffer, copied to
the device once and scored in one forward, padded with zero rows: a
``GATParentScorer`` request to the smallest power-of-two bucket up to
``max_batch``, every ``ParentScorer`` request to ``max_batch`` rows (one
shape; see below). Every shape is run once at construction so the first
request pays no warm-up.

``ParentScorer.score_corpus`` scores corpus-scale batches in blocks of
the same ``max_batch`` rows, each row bit-identical to ``score`` on any
sub-batch holding it. That needs one matrix-product shape: cuBLAS picks
its kernel by shape, and kernels sum in different orders (an H100 gives
other bits at 16 rows than at 8 or 32 in bf16, and at almost every row
count in f32: ``tests/mlp_row_stability.py``).

:class:`MLEvaluator` (the ``ml`` algorithm) ranks candidate parents by
the bandwidth predictor's scores, and :class:`LearnedCostEvaluator` (the
``cost`` algorithm) by a :class:`CostScorer`'s predicted piece cost,
which also sets its bad-node threshold. Every score batch passes
``modelguard.guard_reason`` first; a rejected batch degrades that
decision to the rule evaluator.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Sequence

import numpy as np
import torch

from dragonfly2_tpu_torch.device import default_device
from dragonfly2_tpu_torch.inference.batcher import BatcherSaturatedError
from dragonfly2_tpu_torch.inference.modelguard import guard_reason
from dragonfly2_tpu_torch.models.mlp import Normalizer
from dragonfly2_tpu_torch.scheduler import controlstats
from dragonfly2_tpu_torch.scheduler.evaluator import scoring
from dragonfly2_tpu_torch.scheduler.evaluator.base import (
    _BAD_STATES,
    MIN_AVAILABLE_COST_LEN,
    PEER_STATE_RECEIVED_NORMAL,
    PEER_STATE_RUNNING,
    BaseEvaluator,
    PeerLike,
    build_feature_matrix,
)
from dragonfly2_tpu_torch.scheduler.evaluator.scoring import (
    FEATURE_DIM,
    pack_features,
)
from dragonfly2_tpu_torch.scheduler.replaylog import welford_snapshot
from dragonfly2_tpu_torch.utils.servingstats import SERVING


def _buckets(max_batch: int) -> list[int]:
    out, b = [], 8
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def _bucket(buckets: Sequence[int], n: int) -> int:
    """The smallest bucket holding ``n`` rows (the last is max_batch)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch {n} exceeds max_batch {buckets[-1]}")


class ScoreHandle:
    """An in-flight dispatch: the result plus the valid row count.

    On a CUDA device the result is a pinned host tensor whose copy from
    the device was queued right after the forward, and ``event`` was
    recorded after that copy: :meth:`materialize` waits on that event
    alone. (A ``.cpu()`` at materialize time would queue the copy behind
    whatever was dispatched since — under the micro-batcher, batch N+1's
    forward — so N's callers would wait out N+1 too.) On the CPU the
    result is already computed."""

    __slots__ = ("_out", "_n", "bucket", "_event")

    def __init__(self, out, n: int, bucket: int, event=None):
        self._out = out
        self._n = n
        self.bucket = bucket
        self._event = event

    def materialize(self) -> np.ndarray:
        out = self._out
        if self._event is not None:
            self._event.synchronize()
        if isinstance(out, torch.Tensor):
            out = out.float().numpy()
        return out[: self._n]


class _StagingBuffers:
    """Preallocated zeroed host buffers per bucket, ``depth`` deep
    (default 2: double-buffered for one pipelined caller).

    A request writes its rows into a buffer and re-zeros only the rows
    the previous occupant dirtied. On a CUDA device the buffers are
    pinned and the host→device copy is asynchronous, so a slot must not
    be refilled while the copy that read it may still be running: each
    claim waits on the ``torch.cuda.Event`` recorded after the slot's
    previous dispatch (``commit``). With ``depth ≥ 2 ×`` the callers in
    flight a request refills a slot whose copy has long finished, so the
    wait rarely blocks; :meth:`ensure_depth` grows the pool for more
    concurrent callers. A per-bucket lock covers claim + fill + dispatch
    + commit.
    """

    def __init__(self, buckets: Sequence[int], make, depth: int = 2):
        self._make = make
        self._locks = {b: threading.Lock() for b in buckets}
        self._bufs = {b: [make(b) for _ in range(depth)] for b in buckets}
        self._flip = {b: 0 for b in buckets}
        self._dirty = {b: [0] * depth for b in buckets}
        self._pending = {b: [None] * depth for b in buckets}

    @property
    def depth(self) -> int:
        return len(next(iter(self._bufs.values())))

    def ensure_depth(self, depth: int) -> None:
        """Grow every bucket's pool to at least ``depth`` slots. Growing
        only appends fresh zeroed buffers under the bucket lock — slots
        committed to in-flight dispatches keep their events — so it is
        safe while the scorer serves."""
        for b, lock in self._locks.items():
            with lock:
                for _ in range(len(self._bufs[b]), depth):
                    self._bufs[b].append(self._make(b))
                    self._dirty[b].append(0)
                    self._pending[b].append(None)

    def lock_for(self, bucket: int) -> threading.Lock:
        return self._locks[bucket]

    def claim(self, bucket: int, n: int) -> tuple:
        """Under ``lock_for(bucket)``: (slot, buffer) for ``bucket`` with
        rows ``n:`` zero and no dispatch still reading it."""
        i = self._flip[bucket]
        self._flip[bucket] = (i + 1) % len(self._bufs[bucket])
        pending = self._pending[bucket][i]
        if pending is not None:
            self._pending[bucket][i] = None
            pending.synchronize()
        buf = self._bufs[bucket][i]
        if self._dirty[bucket][i] > n:
            buf[n:self._dirty[bucket][i]] = 0
        self._dirty[bucket][i] = n
        return i, buf

    def commit(self, bucket: int, slot: int, event) -> None:
        """Under the bucket lock: record the event after the dispatch that
        read the slot's buffer (None on the CPU, where it already ran)."""
        self._pending[bucket][slot] = event


def _host_buffer(shape, dtype, device: torch.device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, pin_memory=device.type == "cuda")


def _to_host(out: torch.Tensor) -> tuple:
    """``(host tensor, event)``: on a CUDA device the f32 result's copy
    into fresh pinned host memory, queued now, and an event recorded
    after it — the event covers the staging buffer's host→device copy,
    the forward and this copy. On the CPU, ``(out, None)``."""
    if out.device.type != "cuda":
        return out, None
    host = torch.empty(out.shape, dtype=torch.float32, pin_memory=True)
    host.copy_(out.float(), non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(out.device))
    return host, event


class ParentScorer:
    """Scorer over a trained bandwidth predictor: normalize → model →
    denormalize, one device dispatch per request. Every forward runs at
    ``max_batch`` rows, so each row's score is the same bits in every
    call (the row-stability ``score_corpus`` promises); a request of
    fewer rows is zero-padded to it."""

    def __init__(self, model, normalizer: Normalizer, target_norm: Normalizer,
                 max_batch: int = 64, device=None):
        self._device = default_device(device)
        self._model = model.to(self._device).eval()
        self._mean = torch.as_tensor(normalizer.mean, dtype=torch.float32,
                                     device=self._device)
        self._std = torch.as_tensor(normalizer.std, dtype=torch.float32,
                                    device=self._device)
        self._t_mean = float(target_norm.mean[0])
        self._t_std = float(target_norm.std[0])
        # One bucket: the forward's shape never changes (module note).
        self.buckets = [max_batch]
        self.max_batch = max_batch
        self._staging = _StagingBuffers(
            self.buckets,
            lambda b: _host_buffer((b, FEATURE_DIM), torch.float32,
                                   self._device))
        for b in self.buckets:
            self._forward(torch.zeros(b, FEATURE_DIM))
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    @torch.no_grad()
    def _forward(self, buf: torch.Tensor) -> torch.Tensor:
        # Score = predicted log-bandwidth, denormalized so scores are
        # comparable across model versions.
        x = buf.to(self._device, non_blocking=True)
        out = self._model((x - self._mean) / self._std)
        return out * self._t_std + self._t_mean

    def ensure_staging_depth(self, depth: int) -> None:
        """Grow the per-bucket staging pool to at least ``depth`` slots:
        2 for each caller that keeps a dispatch in flight."""
        self._staging.ensure_depth(max(depth, 2))

    def score_async(self, features: np.ndarray) -> ScoreHandle:
        """Stage ``[n, FEATURE_DIM]`` features and dispatch without waiting
        for the device; ``materialize()`` yields the ``[n]`` scores."""
        n = len(features)
        if n == 0:
            return ScoreHandle(np.zeros(0, np.float32), 0, self.buckets[0])
        b = _bucket(self.buckets, n)
        with self._staging.lock_for(b):
            slot, buf = self._staging.claim(b, n)
            buf[:n] = torch.from_numpy(np.asarray(features, np.float32))
            out, event = _to_host(self._forward(buf))
            self._staging.commit(b, slot, event)
        return ScoreHandle(out, n, b, event)

    def score(self, features: np.ndarray) -> np.ndarray:
        """Scores for [n, FEATURE_DIM] features; higher is better."""
        if len(features) == 0:
            return np.zeros(0, np.float32)
        return self.score_async(features).materialize()

    def score_corpus(self, features: np.ndarray) -> np.ndarray:
        """Corpus-scale scoring: [n, FEATURE_DIM] rows of any n, in
        zero-padded blocks of ``max_batch`` rows — the shape of every
        forward, so each row's output is bit-identical to :meth:`score`
        on any sub-batch holding the row (the replay engine's run digests
        rest on it). The JAX package's ``chunk`` (its blocks of up to
        4096 rows) has no counterpart: another block shape would sum in
        another order. The corpus goes to the device once; uses no
        staging buffer, so concurrent callers need no lock.
        """
        feats = np.ascontiguousarray(features, dtype=np.float32)
        n = len(feats)
        if n == 0:
            return np.zeros(0, np.float32)
        b = self.max_batch
        x = torch.zeros(-(-n // b) * b, FEATURE_DIM, device=self._device)
        x[:n] = torch.from_numpy(feats).to(self._device)
        out = torch.empty(len(x), device=self._device)
        for start in range(0, len(x), b):
            out[start:start + b] = self._forward(x[start:start + b])
        return out[:n].cpu().numpy()

    def benchmark(self, batch: int = 16, iters: int = 200) -> dict:
        """Steady-state :meth:`score` latency percentiles in ms (host
        clock around calls that end in the device result's copy)."""
        rng = np.random.default_rng(0)
        feats = rng.uniform(0, 100, (batch, FEATURE_DIM)).astype(np.float32)
        self.score(feats)  # warm
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            self.score(feats)
            times.append((time.perf_counter() - t0) * 1e3)
        times.sort()
        return {
            "p50_ms": times[len(times) // 2],
            "p95_ms": times[int(len(times) * 0.95)],
            "p99_ms": times[int(len(times) * 0.99)],
        }


class MLEvaluator:
    """The ``ml`` evaluator algorithm (fills evaluator.go:48's TODO).

    Ranks parents by predicted bandwidth; keeps the rule evaluator for
    bad-node detection (a statistical property of observed piece costs,
    not a learned one) and as the fallback when scoring fails.

    Every score batch passes :func:`guard_reason` before it ranks
    anything: a NaN/Inf or collapsed-constant batch degrades THAT
    decision to rule scoring and ticks ``ml_guard_trips``; after
    ``guard_trip_limit`` trips the evaluator escalates ONCE through
    ``on_quarantine`` (the hook owner quarantines the serving version).
    The latch is set only when the hook delivered (it did not raise or
    return False); ``reset_guard()`` re-arms it after a model swap, and a
    scorer that reports ``last_version`` re-arms it by itself when the
    version moves.

    A :class:`~dragonfly2_tpu_torch.inference.batcher.MicroBatcher` in
    front of the scorer may shed a request (``BatcherSaturatedError``):
    that decision is the rule evaluator's, counted in ``shed_count`` and
    ``ml_sheds`` — expected overload behaviour, never logged as a
    failure. ``trace_log`` (``manager.validation.TraceLog``) records
    every decision's feature matrix: the validation gate's replay corpus.
    """

    def __init__(self, scorer: ParentScorer | None, *,
                 stats=None, guard_trip_limit: int = 3,
                 on_quarantine=None, trace_log=None,
                 track_quality: bool = False):
        self._scorer = scorer
        self._fallback = BaseEvaluator()
        # Count scores and fallbacks, log the first failure loudly: an
        # operator must tell "model live" from "model silently failing".
        self.scored_count = 0
        self.fallback_count = 0
        self.shed_count = 0
        self.guard_trips = 0
        self._logged_failure = False
        self._logged_guard = False
        self._stats = stats if stats is not None else SERVING
        self.guard_trip_limit = guard_trip_limit
        self._on_quarantine = on_quarantine
        self._quarantine_fired = False
        # The version the guard state belongs to (see evaluate_parents).
        self._guard_version: str | None = None
        # Guard bookkeeping is mutated from concurrent announce threads:
        # the trip counter's read-modify-write and the escalate-once
        # check-then-act hold the lock. The hook runs OUTSIDE it (it is
        # an RPC); _quarantine_inflight keeps a second thread from
        # duplicating it meanwhile.
        self._guard_lock = threading.Lock()
        self._quarantine_inflight = False
        self._trace_log = trace_log
        # Optional decision-quality ring: per decision, the rule score of
        # the CHOSEN top parent normalized into [0, 1] against the rule
        # evaluator's own best/worst over the same candidates (1.0 ==
        # the rule baseline's pick).
        self.track_quality = track_quality
        self.quality_samples: collections.deque = collections.deque(
            maxlen=4096)

    @property
    def has_model(self) -> bool:
        return self._scorer is not None

    def reset_guard(self) -> None:
        """Re-arm the guard after a model swap: a fresh version starts
        with a clean trip count and may escalate again."""
        with self._guard_lock:
            self._reset_guard_locked()

    def _reset_guard_locked(self) -> None:
        self.guard_trips = 0
        self._quarantine_fired = False
        self._logged_guard = False

    def set_quarantine_hook(self, fn) -> None:
        """Late-bind the escalation hook."""
        self._on_quarantine = fn

    def set_trace_log(self, trace_log) -> None:
        """Late-bind the announce-trace recorder."""
        self._trace_log = trace_log

    def close(self) -> None:
        """Release the scorer if it owns resources (a micro-batcher's
        lane workers); scorers without a ``close`` are left alone."""
        close = getattr(self._scorer, "close", None)
        if close is not None:
            close()

    def _record_quality(self, features: np.ndarray, chosen: int) -> None:
        if not self.track_quality:
            return
        rule = np.asarray(scoring.rule_scores(features), dtype=np.float64)
        lo, hi = float(rule.min()), float(rule.max())
        q = 1.0 if hi - lo <= 1e-12 else (float(rule[chosen]) - lo) / (hi - lo)
        self.quality_samples.append(q)

    def _guard_trip(self, reason: str) -> None:
        with self._guard_lock:
            self.guard_trips += 1
            log_first = not self._logged_guard
            self._logged_guard = True
            escalate = (self.guard_trips >= self.guard_trip_limit
                        and not self._quarantine_fired
                        and not self._quarantine_inflight
                        and self._on_quarantine is not None)
            if escalate:
                self._quarantine_inflight = True
        self._stats.tick("ml_guard_trips")
        if log_first:
            logging.getLogger(__name__).error(
                "ML score batch rejected by runtime guard (%s); decision "
                "fell back to rule scoring (further trips counted, not "
                "logged)", reason)
        if not escalate:
            return
        # Latch only on a DELIVERED escalation: a hook that raises or
        # returns False ("couldn't act yet") leaves the latch unarmed, so
        # the next trip retries instead of abandoning the rollback.
        delivered = False
        try:
            delivered = self._on_quarantine(reason) is not False
        except Exception:  # noqa: BLE001 — escalation must never break
            logging.getLogger(__name__).exception(  # a decision
                "model quarantine escalation failed; will retry on "
                "the next guard trip")
        with self._guard_lock:
            self._quarantine_inflight = False
            if delivered:
                self._quarantine_fired = True
        if delivered:
            self._stats.tick("ml_quarantines_reported")

    def _fallback_ranked(self, parents, child, total_piece_count,
                         features):
        self.fallback_count += 1
        self._stats.tick("ml_fallbacks")
        ranked = self._fallback.evaluate_parents(
            parents, child, total_piece_count)
        if self.track_quality:
            self._record_quality(features, parents.index(ranked[0]))
        return ranked

    def evaluate_parents(
        self, parents: Sequence[PeerLike], child: PeerLike, total_piece_count: int
    ) -> list[PeerLike]:
        if not parents:
            return []
        if self._scorer is None:
            return self._fallback.evaluate_parents(parents, child, total_piece_count)
        # A fresh matrix: the micro-batcher holds the rows across an
        # asynchronous dispatch.
        features = build_feature_matrix(parents, child, total_piece_count)
        if self._trace_log is not None:
            self._trace_log.record(features)
        try:
            scores = self._scorer.score(features)
        except BatcherSaturatedError:
            self.shed_count += 1
            self._stats.tick("ml_sheds")
            return self._fallback_ranked(parents, child, total_piece_count,
                                         features)
        except Exception:  # noqa: BLE001 — a failing model degrades the
            if not self._logged_failure:  # decision to rules
                self._logged_failure = True
                logging.getLogger(__name__).exception(
                    "ML parent scoring failed; falling back to rule-based "
                    "evaluation (further failures counted, not logged)")
            return self._fallback_ranked(parents, child, total_piece_count,
                                         features)
        # A version-aware scorer starting to serve ANOTHER version
        # re-arms the guard: trips of one version never condemn the next.
        version = getattr(self._scorer, "last_version", "")
        if version:
            with self._guard_lock:
                if version != self._guard_version:
                    if self._guard_version is not None:
                        self._reset_guard_locked()
                    self._guard_version = version
        reason = guard_reason(scores, features=features)
        if reason is not None:
            # The poisoned batch never orders anything: this decision is
            # the rule evaluator's, and the trip is counted/escalated.
            self._guard_trip(reason)
            return self._fallback_ranked(parents, child, total_piece_count,
                                         features)
        self.scored_count += 1
        self._stats.tick("ml_scored")
        order = np.argsort(-scores, kind="stable")
        self._record_quality(features, int(order[0]))
        return [parents[i] for i in order]

    def is_bad_node(self, peer: PeerLike) -> bool:
        return self._fallback.is_bad_node(peer)


class CostScorer:
    """Ranking/threshold facade over a trained piece-cost predictor.

    Wraps a :class:`ParentScorer` whose raw output for a ``cost``
    checkpoint is the denormalized predicted ``log1p(cost_seconds)``:
    ``score`` negates it so HIGHER still means BETTER parent (the
    contract every evaluator shares), and ``predict_cost_s`` maps back to
    seconds for the learned bad-node threshold. ``version`` is the
    registry version the artifact was promoted under; ``typical_cost_s``
    the training corpus's typical piece cost (``expm1`` of the target
    normalizer's mean) — the absolute baseline the learned bad-node
    threshold uses for consistently slow peers."""

    def __init__(self, scorer: ParentScorer, version: str = "",
                 typical_cost_s: float = 0.0):
        self._scorer = scorer
        self.version = version
        self.typical_cost_s = typical_cost_s
        self.max_batch = scorer.max_batch

    def predict_cost_s(self, features: np.ndarray) -> np.ndarray:
        # Clip before expm1: an out-of-distribution feature row must
        # produce a large-but-finite cost, not an overflow inf that
        # reads as a poisoned model. NaN passes through for the guard.
        return np.expm1(np.clip(self._scorer.score(features), -20.0, 20.0))

    def score(self, features: np.ndarray) -> np.ndarray:
        return -self._scorer.score(features)

    def score_corpus(self, features: np.ndarray) -> np.ndarray:
        """Corpus-scale :meth:`score`: the same negation over the
        scorer's row-stable blocked forward."""
        return -self._scorer.score_corpus(features)

    def close(self) -> None:
        close = getattr(self._scorer, "close", None)
        if close is not None:
            close()


class LearnedCostEvaluator:
    """The ``cost`` evaluator algorithm — learned piece-cost ranking and
    a learned ``is_bad_node`` in place of the 3-sigma threshold.

    Ranking: candidates order by ASCENDING predicted cost (the
    :class:`CostScorer` negation keeps the higher-is-better contract).
    Bad node: a peer whose LATEST observed piece cost exceeds
    ``bad_cost_ratio`` × a baseline is bad. The baseline is ``min(the
    cost predicted for THIS peer's features, the corpus-typical cost)``:
    the prediction catches a peer performing worse than its features
    explain (a sudden stall), the typical cost a peer that has been
    consistently terrible from its first sample — which the relative
    3-sigma rule cannot see (its own history IS its baseline), nor an
    accurate prediction alone (it predicts a slow host's slowness).

    Every score batch and every bad-node prediction passes
    :func:`guard_reason`; a tripped one degrades THAT decision or verdict
    to the inner (rule) evaluator and ticks ``cost_guard_trips``, so a
    poisoned cost model never orders parents and never condemns peers.
    """

    def __init__(self, cost_scorer: CostScorer, *, inner=None,
                 stats=None, bad_cost_ratio: float = 3.0,
                 min_predicted_cost_s: float = 1e-4,
                 bad_node_cache_size: int = 65536):
        self._scorer = cost_scorer
        self._inner = inner if inner is not None else BaseEvaluator()
        self._stats = stats if stats is not None else controlstats.STATS
        self.bad_cost_ratio = bad_cost_ratio
        # Floor under the predicted cost so a near-zero prediction can't
        # turn every measured cost into a "bad" verdict.
        self.min_predicted_cost_s = min_predicted_cost_s
        self.scored_count = 0
        self.fallback_count = 0
        self.guard_trips = 0
        self._logged_failure = False
        # is_bad_node verdict cache keyed by (peer id, sample marker,
        # latest cost): the filter calls is_bad_node once per candidate
        # per announce, and each miss is a one-row device round trip. A
        # verdict only changes when a new cost lands (the key changes),
        # so steady-state filters are dict hits. Cleared on overflow.
        self._bad_node_cache: dict = {}
        self._bad_node_cache_size = bad_node_cache_size

    @property
    def serving_version(self) -> str:
        """The registry version of the cost model: what the scheduler's
        reload watcher compares with the registry's active one."""
        return getattr(self._scorer, "version", "")

    def close(self) -> None:
        close = getattr(self._scorer, "close", None)
        if close is not None:
            close()

    def _fallback_ranked(self, parents, child, total_piece_count):
        self.fallback_count += 1
        self._stats.observe_cost_fallback()
        return self._inner.evaluate_parents(parents, child,
                                            total_piece_count)

    def evaluate_parents(
        self, parents: Sequence[PeerLike], child: PeerLike, total_piece_count: int
    ) -> list[PeerLike]:
        if not parents:
            return []
        features = build_feature_matrix(parents, child, total_piece_count)
        try:
            scores = self._scorer.score(features)
        except Exception:  # noqa: BLE001 — a failing model degrades the
            if not self._logged_failure:  # decision to the inner one
                self._logged_failure = True
                logging.getLogger(__name__).exception(
                    "learned-cost scoring failed; falling back to the "
                    "inner evaluator (further failures counted, not "
                    "logged)")
            return self._fallback_ranked(parents, child, total_piece_count)
        if guard_reason(scores, features=features) is not None:
            self.guard_trips += 1
            self._stats.observe_cost_guard_trip()
            return self._fallback_ranked(parents, child, total_piece_count)
        self.scored_count += 1
        order = np.argsort(-scores, kind="stable")
        return [parents[i] for i in order]

    def is_bad_node(self, peer: PeerLike) -> bool:
        state = peer.state()
        if state in _BAD_STATES:
            return True
        n, last, _, _ = welford_snapshot(peer)
        if n < MIN_AVAILABLE_COST_LEN:
            return False
        # The lifetime-append counter (when the stats carry one) marks
        # every new cost even when the window is full AND the new cost
        # equals the previous latest — (peer.id, n, last) alone would
        # pin a stale verdict on a constant-rate link forever.
        stats_of = getattr(peer, "piece_cost_stats", None)
        marker = (getattr(stats_of(), "appends", n)
                  if stats_of is not None else n)
        cache_key = (peer.id, marker, last)
        cached = self._bad_node_cache.get(cache_key)
        if cached is not None:
            self._stats.observe_bad_node_learned(bad=cached)
            return cached
        host = peer.host
        is_seed = bool(getattr(host.type, "is_seed", bool(host.type)))
        # The peer judged AS a parent against a fresh child of its own
        # task (the common announce-time pairing, so the row stays in
        # the training distribution): "what should a piece from this
        # peer cost".
        total = getattr(getattr(peer, "task", None), "total_piece_count", 0)
        row = pack_features(
            parent_finished_pieces=peer.finished_piece_count(),
            child_finished_pieces=0,
            total_pieces=total,
            upload_count=host.upload_count,
            upload_failed_count=host.upload_failed_count,
            free_upload_count=host.free_upload_count(),
            concurrent_upload_limit=host.concurrent_upload_limit,
            is_seed=is_seed,
            seed_ready=is_seed and state in (PEER_STATE_RECEIVED_NORMAL,
                                             PEER_STATE_RUNNING),
        )[None, :]
        try:
            predicted = float(self._scorer.predict_cost_s(row)[0])
        except Exception:  # noqa: BLE001 — a failing model degrades the
            self._stats.observe_cost_fallback()  # verdict to the rule
            return self._inner.is_bad_node(peer)
        if guard_reason(np.asarray([predicted])) is not None:
            self.guard_trips += 1
            self._stats.observe_cost_guard_trip()
            return self._inner.is_bad_node(peer)
        # Positive baselines only: a nonpositive prediction carries no
        # per-peer signal and must not collapse the threshold to the
        # floor — the typical cost stands in alone.
        typical = getattr(self._scorer, "typical_cost_s", 0.0)
        positives = [v for v in (predicted, typical) if v > 0]
        baseline = min(positives) if positives else self.min_predicted_cost_s
        bad = last > self.bad_cost_ratio * max(baseline,
                                               self.min_predicted_cost_s)
        if len(self._bad_node_cache) >= self._bad_node_cache_size:
            self._bad_node_cache.clear()
        self._bad_node_cache[cache_key] = bad
        self._stats.observe_bad_node_learned(bad=bad)
        return bad


class GATParentScorer:
    """Pair scorer over a trained GraphTransformer (config #3).

    The full-graph attention runs once at construction —
    ``node_embeddings`` over the checkpointed padded features and neighbor
    lists, through the hand-written kernels on the card — leaving an
    [N, E] table on the device. Every request is then an index gather
    plus the small edge head, bucketed by powers of two up to
    ``max_batch``.
    """

    def __init__(self, model, node_features, neighbors, neighbor_vals,
                 max_batch: int = 64, device=None, node_ids=None):
        self._device = default_device(device)
        self._model = model.to(self._device).eval()
        self.n_nodes = int(np.asarray(node_features).shape[0])
        # Index validation uses the REAL row count when ids ship: a padded
        # phantom row would pass a padded-count check and return a
        # plausible-looking logit from a phantom embedding.
        self.node_ids = list(node_ids) if node_ids is not None else None
        self.n_real = (len(self.node_ids) if self.node_ids is not None
                       else self.n_nodes)
        self._id_index = ({h: i for i, h in enumerate(self.node_ids)}
                          if self.node_ids is not None else None)
        with torch.no_grad():
            self._emb = self._model.node_embeddings(
                torch.as_tensor(np.asarray(node_features, np.float32),
                                device=self._device),
                torch.as_tensor(np.asarray(neighbors, np.int32),
                                device=self._device),
                torch.as_tensor(np.asarray(neighbor_vals, np.float32),
                                device=self._device))
        self.buckets = _buckets(max_batch)
        self.max_batch = max_batch
        # Separate src/dst staging: the head takes two flat [b] vectors.
        make = lambda b: _host_buffer(b, torch.int32, self._device)  # noqa: E731
        self._staging_src = _StagingBuffers(self.buckets, make)
        self._staging_dst = _StagingBuffers(self.buckets, make)
        for b in self.buckets:
            zero = torch.zeros(b, dtype=torch.int32)
            self._forward(zero, zero)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    @property
    def embeddings(self) -> torch.Tensor:
        """The [N, E] embedding table (padded rows included)."""
        return self._emb

    @torch.no_grad()
    def _forward(self, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        return self._model.score_pairs(
            self._emb, src.to(self._device, non_blocking=True),
            dst.to(self._device, non_blocking=True))

    def score_async(self, pairs: np.ndarray) -> ScoreHandle:
        """Stage validated [n, 2] (src, dst) host-index pairs and dispatch
        without waiting for the device."""
        pairs = np.asarray(pairs)
        n = len(pairs)
        if n == 0:
            return ScoreHandle(np.zeros(0, np.float32), 0, self.buckets[0])
        if pairs.ndim != 2 or pairs.shape[1] != 2:
            raise ValueError(f"expected [n, 2] host-index pairs, "
                             f"got {pairs.shape}")
        if (pairs < 0).any() or (pairs >= self.n_real).any():
            raise ValueError("host index out of range for the "
                             f"{self.n_real}-host embedding table")
        b = _bucket(self.buckets, n)
        # src-then-dst lock order (always) keeps the two vectors paired
        # under concurrent callers.
        with self._staging_src.lock_for(b), self._staging_dst.lock_for(b):
            si, src = self._staging_src.claim(b, n)
            di, dst = self._staging_dst.claim(b, n)
            src[:n] = torch.from_numpy(pairs[:, 0].astype(np.int32))
            dst[:n] = torch.from_numpy(pairs[:, 1].astype(np.int32))
            out, event = _to_host(self._forward(src, dst))
            self._staging_src.commit(b, si, event)
            self._staging_dst.commit(b, di, event)
        return ScoreHandle(out, n, b, event)

    def score(self, pairs: np.ndarray) -> np.ndarray:
        """Edge logits for [n, 2] (src, dst) host indices; higher is a
        better parent edge."""
        if len(pairs) == 0:
            return np.zeros(0, np.float32)
        return self.score_async(pairs).materialize()

    def index_of(self, host_id: str):
        """Embedding-row index for a host ID, or None when the host was
        not in the training graph."""
        if self._id_index is None:
            return None
        return self._id_index.get(host_id)

    def score_host_pairs(self, id_pairs) -> np.ndarray:
        """Edge logits for [(src_host_id, dst_host_id), ...]; raises
        KeyError on hosts outside the training graph."""
        if self._id_index is None:
            raise ValueError("checkpoint carries no node_ids")
        pairs = np.array([[self._id_index[a], self._id_index[b]]
                          for a, b in id_pairs], np.int32).reshape(-1, 2)
        return self.score(pairs)
