"""Replay-plane bench helpers — port of
``dragonfly2_tpu/scheduler/replaybench.py`` without the swarm.

- :func:`synth_replay_corpus`: a deterministic synthetic columnar corpus
  built with whole-corpus numpy ops, column for column the JAX
  package's for the same size and seed;
- the throughput ladder (:func:`run_replay_throughput_ladder`):
  sequential vs vectorized decisions/s of the rule evaluator over
  synthetic corpora, with bit-identical digests on every rung;
- the persisted-record readers (:func:`best_recorded_replay_run`,
  :func:`best_recorded_replay_ladder`) and the ladder half of the
  regression check (:func:`ladder_regression`), with the stage's regret
  bounds.

The ladder replays with the rule evaluator only, whose scores are numpy
on the host: its ``VECTORIZED_SPEEDUP_BOUND`` is a limit on the host's
speed. The recorded A/B (``run_replay_ab``: the announce-stream
recorder over a swarm, training, the gate, the evaluators head to head)
and the regression check's fresh A/B are not ported.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

#: An ML/learned-cost evaluator may exceed the rule baseline's mean
#: realized-cost regret by at most this much before the stage goes red:
#: the larger of 10% of the rule regret or 2 ms absolute (a micro-regret
#: corpus must not fail on noise). Deltas are reported either way.
REGRET_REL_BOUND = 0.10
REGRET_ABS_BOUND_S = 0.002

#: Minimum corpus size before the A/B means anything.
MIN_CORPUS_DECISIONS = 100


def _regret_within_bound(candidate: Optional[float],
                         baseline: Optional[float]) -> Optional[bool]:
    if candidate is None or baseline is None:
        return None
    return candidate <= baseline + max(REGRET_REL_BOUND * abs(baseline),
                                       REGRET_ABS_BOUND_S)


def best_recorded_replay_run(state_dir: str):
    """Best persisted ``replay_run_*.json`` (largest corpus, tiebroken
    by lowest learned-cost regret); skip artifacts are ignored."""
    import glob
    import json

    best = None
    for path in glob.glob(os.path.join(state_dir, "replay_run_*.json")):
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        if data.get("skipped") or not data.get("verdict_pass"):
            continue
        corpus = (data.get("record") or {}).get("corpus_decisions", 0)
        evaluators = (data.get("ab") or {}).get("evaluators") or {}
        cost_regret = (evaluators.get("cost") or {}).get("regret_mean_s")
        # Larger corpus wins; equal corpora tiebreak on the LOWER
        # learned-cost regret (deterministic across filesystems).
        key = (corpus, -(cost_regret if cost_regret is not None
                         else float("inf")))
        if best is None or key > best["_key"]:
            best = {
                "_key": key,
                "file": os.path.basename(path),
                "corpus_decisions": corpus,
                "evaluators": evaluators,
            }
    if best is not None:
        best.pop("_key")
    return best


def ladder_regression(state_dir: str) -> Dict[str, object]:
    """The throughput ladder's half of ``check_replay_regression``: a
    fresh rung (sized like the best persisted record's smallest rung)
    must keep bit-identical digests AND hold
    ``LADDER_REGRESSION_FACTOR`` x the record's vectorized decisions/sec
    at that size. Returns the check's ``ladder_*`` and
    ``best_recorded_ladder`` keys, valued as the JAX package's."""
    best_ladder = best_recorded_replay_ladder(state_dir)

    # Fresh ladder rung at the best record's smallest measured size (so
    # the decisions/sec comparison is like-for-like); the 20x bound is
    # NOT asserted here — it belongs to the full ladder's 100k rung —
    # only digest identity and the relative-throughput floor.
    ladder_size = min(LADDER_RUNGS)
    best_rung = None
    if best_ladder:
        sized = [r for r in best_ladder.get("rungs") or []
                 if r.get("vec_decisions_per_s")]
        if sized:
            best_rung = min(sized, key=lambda r: r["decisions"])
            ladder_size = int(best_rung["decisions"])
    ladder = run_replay_throughput_ladder(rungs=(ladder_size,), bound=0.0)
    fresh_rung = (ladder.get("rungs") or [_ladder_rung_report(0)])[0]
    ladder_ok = bool(fresh_rung["error"] is None
                     and fresh_rung["digests_equal"])
    throughput_ok = True
    if best_rung is not None and fresh_rung["vec_decisions_per_s"]:
        throughput_ok = (
            fresh_rung["vec_decisions_per_s"]
            >= LADDER_REGRESSION_FACTOR * best_rung["vec_decisions_per_s"])
    return {
        "ladder_rung": fresh_rung,
        "ladder_digests_ok": ladder_ok,
        "ladder_throughput_ok": throughput_ok,
        "ladder_regression_factor": LADDER_REGRESSION_FACTOR,
        "best_recorded_ladder": best_ladder,
    }


# -- throughput ladder -------------------------------------------------------

#: Ladder rungs in decisions. The large rung is where the documented
#: speedup bound applies (per-decision Python overhead fully amortized);
#: the small rung exists for trend reading and as the like-for-like size
#: the regression check re-measures.
LADDER_RUNGS: Tuple[int, ...] = (10_000, 100_000)

#: Vectorized decisions/sec must beat the sequential harness by at
#: least this factor on the LARGEST rung, with bit-identical digests.
VECTORIZED_SPEEDUP_BOUND = 20.0

#: Shard count for the prefetch fan-out arm of the ladder.
LADDER_SHARDS = 2

#: A fresh regression-check rung may not fall below this fraction of the
#: best persisted record's vectorized throughput at the same rung size —
#: generous, because CI boxes share cores; a real vectorization
#: regression is order-of-magnitude, not 3x.
LADDER_REGRESSION_FACTOR = 0.33


def synth_replay_corpus(n_decisions: int, *, seed: int = 0,
                        b2s_fraction: float = 0.05):
    """Deterministic synthetic corpus as a ``ColumnarCorpus``, built
    with whole-corpus numpy ops (a 100k-decision corpus packs in well
    under a second — generating it through the recorder would dominate
    the ladder).

    Every feature row obeys the ``rebuild_decision`` consistency rules,
    so the sequential harness's rebuilt feature matrices are
    bit-identical to the stored ones (the same contract recorded
    corpora carry): one ``child_finished``/``total_pieces`` per event
    (the rebuilt child is shared by all its candidates), ``seed_ready``
    only on seeds, ``idc_match`` in {0, 1}, integral
    ``location_matches`` in [0, 5]."""
    from dragonfly2_tpu_torch.scheduler.replaystore import (
        ColumnarCorpus,
        bucket_candidates,
    )
    from dragonfly2_tpu_torch.schema import MAX_REPLAY_CANDIDATES

    n = int(n_decisions)
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, MAX_REPLAY_CANDIDATES + 1,
                          size=n).astype(np.int32)
    b2s = rng.random(n) < b2s_fraction
    counts[b2s] = 0
    k = bucket_candidates(int(counts.max()) if n else 0)
    valid = np.arange(k)[None, :] < counts[:, None]

    total = rng.integers(64, 2048, size=n).astype(np.float64)
    child_fin = np.floor(rng.random(n) * total)
    feats = np.empty((n, k, 11), np.float32)
    feats[..., 0] = np.floor(rng.random((n, k)) * total[:, None])
    feats[..., 1] = child_fin[:, None]
    feats[..., 2] = total[:, None]
    feats[..., 3] = rng.integers(0, 500, size=(n, k))
    feats[..., 4] = rng.integers(0, 50, size=(n, k))
    feats[..., 5] = rng.integers(0, 100, size=(n, k))
    feats[..., 6] = rng.integers(50, 300, size=(n, k))
    is_seed = (rng.random((n, k)) < 0.3).astype(np.float32)
    feats[..., 7] = is_seed
    feats[..., 8] = is_seed * (rng.random((n, k)) < 0.8)
    feats[..., 9] = (rng.random((n, k)) < 0.5).astype(np.float32)
    feats[..., 10] = rng.integers(0, 6, size=(n, k))
    feats *= valid[..., None]

    ids = np.char.add("c", np.arange(n * k).astype("U8")).reshape(n, k)
    ids = np.where(valid, ids, "")
    slot = np.broadcast_to(np.arange(k)[None, :], (n, k))
    rank = np.where(valid & (slot < 4), slot, -1).astype(np.int32)
    cost_n = (rng.integers(0, 40, size=(n, k)) * valid).astype(np.int64)
    cost_last = rng.random((n, k)) * 0.2 * valid
    cost_prior_mean = rng.random((n, k)) * 0.2 * valid
    cost_prior_pstd = rng.random((n, k)) * 0.05 * valid
    realized_n = (rng.integers(0, 5, size=(n, k)) * valid).astype(np.int64)
    realized_cost = np.where(realized_n > 0,
                             rng.random((n, k)) * 0.2 + 1e-3, -1.0)

    seq = np.arange(n, dtype=np.int64)
    verdict = b2s.astype(np.uint8)
    str_ids = np.char.add("p", seq.astype("U8"))
    chosen = np.where(counts > 0, ids[:, 0], "")
    return ColumnarCorpus({
        "seq": seq,
        "verdict": verdict,
        "total_piece_count": total.astype(np.int64),
        "n_candidates": counts,
        "outcome_cost": np.zeros(n, np.float64),
        "decided_at": seq * 1000,
        "finalized_at": seq * 1000 + 500,
        "task_id": np.char.add("t", (seq % 50).astype("U4")),
        "peer_id": str_ids,
        "chosen": chosen.astype(np.str_),
        "outcome": np.zeros(n, dtype="<U1"),
        "cand_id": ids.astype(np.str_),
        "rank": rank,
        "features": feats,
        "valid": valid,
        "cost_n": cost_n,
        "cost_last": cost_last,
        "cost_prior_mean": cost_prior_mean,
        "cost_prior_pstd": cost_prior_pstd,
        "realized_n": realized_n,
        "realized_cost": realized_cost,
    })


def _ladder_rung_report(n: int) -> Dict[str, object]:
    """Every key a consumer reads, present from the START: a rung that
    dies mid-measurement ships the same shape with ``error`` set, so
    downstream dict reads never KeyError on a partial report."""
    return {
        "decisions": int(n),
        "corpus_k": None,
        "seq_elapsed_s": None,
        "seq_decisions_per_s": None,
        "vec_elapsed_s": None,
        "vec_decisions_per_s": None,
        "sharded_elapsed_s": None,
        "sharded_decisions_per_s": None,
        "speedup": None,
        "sharded_speedup": None,
        "digests_equal": None,
        "digest": None,
        "error": None,
    }


def run_replay_throughput_ladder(
    *, rungs: Sequence[int] = LADDER_RUNGS, seed: int = 0,
    shards: int = LADDER_SHARDS,
    bound: float = VECTORIZED_SPEEDUP_BOUND,
) -> Dict[str, object]:
    """Sequential vs vectorized decisions/sec over synthetic columnar
    corpora, one rung per size. Green iff every rung measured without
    error, every rung's three digests (sequential, vectorized, sharded
    fan-out) are bit-identical, and the vectorized path clears
    ``bound``x sequential on the largest rung."""
    from dragonfly2_tpu_torch.scheduler import replay as rp
    from dragonfly2_tpu_torch.scheduler.evaluator import BaseEvaluator

    report: Dict[str, object] = {
        "rungs": [],
        "bound": bound,
        "bound_rung": int(max(rungs)) if rungs else None,
        "shards": int(shards),
        "verdict_pass": False,
        "error": None,
    }
    # Warm both paths once (imports, numpy ufunc setup) so the first
    # rung measures steady-state throughput, not one-time process cost.
    try:
        warm = synth_replay_corpus(64, seed=seed)
        rp.replay_decisions(warm.decisions(), BaseEvaluator(), seed=seed)
        rp.replay_decisions_vectorized(warm, seed=seed)
    except Exception as exc:  # noqa: BLE001 — surfaced, not swallowed
        report["error"] = f"warmup: {type(exc).__name__}: {exc}"
        return report
    for n in rungs:
        rung = _ladder_rung_report(n)
        report["rungs"].append(rung)
        try:
            cc = synth_replay_corpus(n, seed=seed)
            rung["corpus_k"] = cc.k
            t0 = time.perf_counter()
            seq_run = rp.replay_decisions(
                cc.decisions(), BaseEvaluator(), seed=seed,
                name=f"seq-{n}")
            seq_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            vec_run = rp.replay_decisions_vectorized(
                cc, seed=seed, name=f"vec-{n}")
            vec_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            sharded_run = rp.replay_decisions_vectorized(
                cc, seed=seed, shards=shards, name=f"vec-{n}-s{shards}")
            sharded_s = time.perf_counter() - t0
            rung["seq_elapsed_s"] = round(seq_s, 4)
            rung["vec_elapsed_s"] = round(vec_s, 4)
            rung["sharded_elapsed_s"] = round(sharded_s, 4)
            rung["seq_decisions_per_s"] = round(n / max(seq_s, 1e-9), 1)
            rung["vec_decisions_per_s"] = round(n / max(vec_s, 1e-9), 1)
            rung["sharded_decisions_per_s"] = round(
                n / max(sharded_s, 1e-9), 1)
            rung["speedup"] = round(seq_s / max(vec_s, 1e-9), 2)
            rung["sharded_speedup"] = round(seq_s / max(sharded_s, 1e-9), 2)
            rung["digests_equal"] = bool(
                seq_run.digest == vec_run.digest == sharded_run.digest)
            rung["digest"] = seq_run.digest
        except Exception as exc:  # noqa: BLE001 — rung must report
            rung["error"] = f"{type(exc).__name__}: {exc}"
    measured = report["rungs"]
    bound_rung = next(
        (r for r in measured if r["decisions"] == report["bound_rung"]),
        None)
    report["verdict_pass"] = bool(
        measured
        and all(r["error"] is None and r["digests_equal"] for r in measured)
        and bound_rung is not None
        and bound_rung["speedup"] is not None
        and bound_rung["speedup"] >= bound)
    return report


def best_recorded_replay_ladder(state_dir: str):
    """Best persisted ``replay_ladder_run_*.json`` by vectorized
    decisions/sec on its largest measured rung; skips and red runs are
    ignored."""
    import glob
    import json

    best = None
    for path in glob.glob(os.path.join(state_dir,
                                       "replay_ladder_run_*.json")):
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        if data.get("skipped") or not data.get("verdict_pass"):
            continue
        rungs = [r for r in data.get("rungs") or []
                 if r.get("vec_decisions_per_s")]
        if not rungs:
            continue
        top = max(rungs, key=lambda r: r["decisions"])
        key = (top["vec_decisions_per_s"], top["decisions"])
        if best is None or key > best["_key"]:
            best = {
                "_key": key,
                "file": os.path.basename(path),
                "rungs": data.get("rungs"),
                "bound": data.get("bound"),
            }
    if best is not None:
        best.pop("_key")
    return best
