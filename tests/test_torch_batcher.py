"""Micro-batcher parity: the port's ``inference/batcher.py`` against the
JAX package's, case for case (``tests/test_microbatch.py``'s cases, each
run on both implementations over framework-free stub scorers, where the
behaviour is deterministic and both give the same ``stats()`` keys and
counts), the inference service's batcher path, the same seeded MLP
behind both packages' ``ParentScorer`` + ``MicroBatcher`` under 8
threads (port batched ≡ port solo bit for bit; port ≡ JAX within
F32_TOL), and ``new_evaluator(micro_batch=True)``'s shed counters
against the JAX evaluator's on the same wedged-lane script."""

from __future__ import annotations

import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.inference import batcher as jax_batcher
from dragonfly2_tpu.inference import loadgen as jax_loadgen
from dragonfly2_tpu.inference import scorer as jax_scorer
from dragonfly2_tpu.scheduler.evaluator import new_evaluator as jax_new_evaluator
from dragonfly2_tpu.utils.servingstats import ServingStats as JaxServingStats
from dragonfly2_tpu_torch.inference import batcher, loadgen, scorer
from dragonfly2_tpu_torch.inference.sidecar import (
    CallContext,
    InferenceService,
    ModelInferRequest,
    RpcAbort,
    StatusCode,
)
from dragonfly2_tpu_torch.scheduler.evaluator import new_evaluator
from dragonfly2_tpu_torch.scheduler.evaluator.scoring import FEATURE_DIM
from dragonfly2_tpu_torch.utils.servingstats import ServingStats

# Port scores against the JAX package's, both in f32 on the same params
# (tests/test_torch_evaluator.py's tolerance).
F32_TOL = 1e-4
# guardbench.train_rule_distilled_mlp's hidden widths.
DISTILLED_HIDDEN = (32,)

IMPLS = {
    "jax": types.SimpleNamespace(
        MicroBatcher=jax_batcher.MicroBatcher,
        BatcherSaturatedError=jax_batcher.BatcherSaturatedError,
        MLEvaluator=jax_scorer.MLEvaluator,
        measure_colocated=jax_loadgen.measure_colocated),
    "port": types.SimpleNamespace(
        MicroBatcher=batcher.MicroBatcher,
        BatcherSaturatedError=batcher.BatcherSaturatedError,
        MLEvaluator=scorer.MLEvaluator,
        measure_colocated=loadgen.measure_colocated),
}


@pytest.fixture(params=sorted(IMPLS))
def impl(request):
    return IMPLS[request.param]


class SlowScorer:
    """Deterministic scorer (sum of features) with a controllable delay so
    requests pile up behind an in-flight dispatch."""

    max_batch = 64

    def __init__(self, delay: float = 0.02):
        self.delay = delay
        self.calls = 0

    def score(self, features: np.ndarray) -> np.ndarray:
        self.calls += 1
        time.sleep(self.delay)
        return features.sum(axis=1).astype(np.float32)


class _AsyncHandle:
    def __init__(self, compute, bucket):
        self.compute = compute
        self.bucket = bucket

    def materialize(self):
        return self.compute()


class AsyncScorer:
    """ParentScorer-shaped scorer with a ``score_async`` whose device
    time is simulated at MATERIALIZE (dispatch returns instantly), so
    the batcher's stage/dispatch overlap actually has something to
    hide. Deterministic scores: sum of each row."""

    max_batch = 64
    buckets = (8, 16, 32, 64)

    def __init__(self, device_s: float = 0.005):
        self.device_s = device_s
        self.dispatch_calls = 0

    def _bucket(self, n):
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"batch {n} exceeds max_batch {self.max_batch}")

    def score_async(self, features):
        self.dispatch_calls += 1
        bucket = self._bucket(len(features))
        done_at = time.monotonic() + self.device_s
        total = features.sum(axis=1).astype(np.float32)

        def compute():
            wait = done_at - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            return total

        return _AsyncHandle(compute, bucket)

    def score(self, features):
        return self.score_async(features).materialize()


class TestMicroBatcher:
    def test_single_request_passthrough(self, impl):
        scorer = SlowScorer(delay=0.0)
        b = impl.MicroBatcher(scorer)
        feats = np.arange(12, dtype=np.float32).reshape(3, 4)
        np.testing.assert_allclose(b.score(feats), feats.sum(axis=1))
        b.close()

    def test_concurrent_requests_coalesce_and_stay_correct(self, impl):
        scorer = SlowScorer(delay=0.03)
        b = impl.MicroBatcher(scorer)
        rng = np.random.default_rng(0)
        inputs = [rng.uniform(0, 1, (rng.integers(1, 5), 4))
                  .astype(np.float32) for _ in range(20)]
        results: dict = {}
        errors = []

        def call(i):
            try:
                results[i] = b.score(inputs[i])
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(20)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        b.close()
        assert not errors
        for i, feats in enumerate(inputs):
            np.testing.assert_allclose(results[i], feats.sum(axis=1),
                                       rtol=1e-6)
        # Requests piled behind the slow dispatch must have shared
        # dispatches — strictly fewer device calls than requests.
        assert scorer.calls < 20, scorer.calls
        assert b.coalesced_requests == 20

    def test_oversize_rejected_and_errors_fan_out(self, impl):
        scorer = SlowScorer(delay=0.0)
        # max_rows clamps to the scorer's capacity: a bigger value would
        # assemble batches no bucket can serve, failing only under load.
        big = impl.MicroBatcher(scorer, max_rows=9999)
        assert big.max_rows == scorer.max_batch
        big.close()
        b = impl.MicroBatcher(scorer, max_rows=8)
        with pytest.raises(ValueError, match="exceeds"):
            b.score(np.zeros((9, 4), np.float32))

        def boom(features):
            raise RuntimeError("device fell over")

        scorer.score = boom
        with pytest.raises(RuntimeError, match="device fell over"):
            b.score(np.zeros((2, 4), np.float32))
        b.close()

    def test_empty_batch_short_circuits(self, impl):
        b = impl.MicroBatcher(SlowScorer())
        assert b.score(np.zeros((0, 4), np.float32)).shape == (0,)
        b.close()

    def test_max_wait_holds_batch_open_for_stragglers(self, impl):
        """max_wait_s > 0: requests arriving within the window share one
        dispatch even when the device is otherwise idle (the remote-
        device throughput knob)."""
        scorer = SlowScorer(delay=0.0)
        b = impl.MicroBatcher(scorer, max_wait_s=0.2)
        results: dict = {}

        def call(i, delay):
            time.sleep(delay)
            results[i] = b.score(np.full((1, 4), float(i), np.float32))

        threads = [threading.Thread(target=call, args=(i, 0.02 * i))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        b.close()
        assert scorer.calls == 1, scorer.calls
        for i in range(4):
            np.testing.assert_allclose(results[i], [4.0 * i])

    def test_max_wait_deadline_is_firm(self, impl):
        """The deadline is measured from the FIRST request: a trickle of
        stragglers cannot hold the batch open past max_wait_s."""
        scorer = SlowScorer(delay=0.0)
        b = impl.MicroBatcher(scorer, max_wait_s=0.1)
        t0 = time.monotonic()
        b.score(np.zeros((1, 4), np.float32))
        elapsed = time.monotonic() - t0
        b.close()
        # One lone request waits out the window but no longer.
        assert 0.08 <= elapsed < 1.0, elapsed
        assert scorer.calls == 1


class TestPipelinedBatcher:
    """The double-buffered serving path: stage batch N+1 while N is on
    the device, coalesce past the request-sized ceiling under load, keep
    the idle path wait-free."""

    def test_load_ladder_coalesce_exceeds_8_and_results_aligned(self, impl):
        """32 concurrent threads × 2-row requests through a 64-row
        batcher: the drain must fill warm buckets past 8 requests per
        dispatch, and every response must carry ITS request's rows even
        under heavy interleaving. The 10 ms simulated device and the
        barrier start give every 32-request round a full device window
        to pile up behind, so a slow CI host still coalesces deeply —
        at 50 iterations the steady state dominates any ramp-up tail."""
        scorer = AsyncScorer(device_s=0.01)
        b = impl.MicroBatcher(scorer, adaptive_wait_s=0.002)
        n_threads, per_thread = 32, 50
        errors: list = []
        start_barrier = threading.Barrier(n_threads)

        def call(tid):
            rng = np.random.default_rng(tid)
            start_barrier.wait()
            for i in range(per_thread):
                feats = rng.uniform(1, 100, (2, 4)).astype(np.float32)
                try:
                    got = b.score(feats)
                    np.testing.assert_allclose(
                        got, feats.sum(axis=1), rtol=1e-6)
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
                    return

        threads = [threading.Thread(target=call, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        stats = b.stats()
        b.close()
        assert not errors
        assert b.coalesced_requests == n_threads * per_thread
        assert stats["coalesce_factor"] > 8.0, stats
        # Large warm buckets must actually be hit — the coalesce lift
        # comes from draining past the old per-request ceiling.
        assert max(stats["bucket_hits"]) >= 32, stats["bucket_hits"]

    def test_pipelining_overlaps_stage_with_device(self, impl):
        """Six 2-row requests through a 4-row batcher with a slow device
        (50 ms) MUST split into ≥3 batches, and with requests queued for
        the whole first device window at least one successor batch is
        staged while its predecessor is in flight — counted, with
        staging time hidden behind the device."""
        scorer = AsyncScorer(device_s=0.05)
        b = impl.MicroBatcher(scorer, max_rows=4)
        errors: list = []

        def call(tid):
            feats = np.full((2, 4), float(tid + 1), np.float32)
            try:
                got = b.score(feats)
                np.testing.assert_allclose(got, feats.sum(axis=1))
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        threads = [threading.Thread(target=call, args=(t,))
                   for t in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        stats = b.stats()
        b.close()
        assert not errors
        assert stats["dispatches"] >= 3, stats
        assert stats["pipelined_dispatches"] > 0, stats
        # Staging 6 tiny requests takes µs against a 150 ms device span,
        # so the ratio can legitimately ROUND to 0 — assert its bounds,
        # not a strictly positive value (that'd be load-dependent).
        assert 0.0 <= stats["overlap_ratio"] <= 1.0, stats
        assert 0.0 < stats["inflight_depth_avg"] <= 1.0, stats

    def test_idle_path_adds_zero_wait(self, impl):
        """A lone request with the adaptive controller enabled must not
        pay any batch window — the zero-wait idle guarantee."""
        scorer = AsyncScorer(device_s=0.0)
        b = impl.MicroBatcher(scorer, adaptive_wait_s=0.05)
        b.score(np.ones((2, 4), np.float32))  # warm the worker path
        t0 = time.monotonic()
        for _ in range(20):
            b.score(np.ones((2, 4), np.float32))
        elapsed = time.monotonic() - t0
        stats = b.stats()
        b.close()
        # 20 sequential idle requests; any window opening would cost
        # ≥ 50 ms each. Generous bound for slow CI hosts.
        assert elapsed < 0.5, elapsed
        assert stats["adaptive_opens"] == 0, stats

    def test_adaptive_window_opens_on_queue_growth(self, impl):
        """A building backlog (blocked worker + burst of requests) must
        open the adaptive window; the batch that follows coalesces."""
        scorer = SlowScorer(delay=0.05)  # first dispatch blocks worker
        b = impl.MicroBatcher(scorer, adaptive_wait_s=0.005)
        results: dict = {}

        def call(i):
            results[i] = b.score(np.full((1, 4), float(i), np.float32))

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
            time.sleep(0.004)  # stagger: queue strictly grows
        for t in threads:
            t.join(timeout=30)
        stats = b.stats()
        b.close()
        assert stats["adaptive_opens"] > 0, stats
        for i in range(12):
            np.testing.assert_allclose(results[i], [4.0 * i])

    def test_stats_shape(self, impl):
        b = impl.MicroBatcher(AsyncScorer())
        b.score(np.ones((3, 4), np.float32))
        stats = b.stats()
        b.close()
        for key in ("dispatches", "coalesced_requests", "coalesce_factor",
                    "pipelined_dispatches", "inflight_depth_avg",
                    "stage_overlap_s", "block_s", "overlap_ratio",
                    "adaptive_opens", "max_queue_depth", "bucket_hits",
                    "lanes", "active_lanes", "lane_activations",
                    "lane_grow_depth", "queue_depth_cap", "sheds",
                    "shed_rate", "per_lane"):
            assert key in stats, key
        assert stats["dispatches"] == 1
        assert stats["bucket_hits"] == {8: 1}
        assert stats["lanes"] == 1
        assert stats["sheds"] == 0
        assert len(stats["per_lane"]) == 1
        for key in ("lane", "dispatches", "coalesced_requests",
                    "coalesce_factor", "sheds", "max_queue_depth",
                    "p99_ms"):
            assert key in stats["per_lane"][0], key

    def test_async_error_fans_out(self, impl):
        """An error surfacing at MATERIALIZE (device-side failure) must
        reach every coalesced caller, not kill the worker."""
        scorer = AsyncScorer()

        def bad_async(features):
            def boom():
                raise RuntimeError("device fell over late")
            return _AsyncHandle(boom, 8)

        scorer.score_async = bad_async
        b = impl.MicroBatcher(scorer)
        with pytest.raises(RuntimeError, match="fell over late"):
            b.score(np.ones((2, 4), np.float32))

        # A MALFORMED result (non-sliceable) must also fan out as an
        # error instead of killing the worker mid-fan-out.
        scorer.score_async = lambda f: _AsyncHandle(lambda: None, 8)
        with pytest.raises(TypeError):
            b.score(np.ones((2, 4), np.float32))

        # Worker survived both; a healthy scorer serves the next request.
        del scorer.score_async
        np.testing.assert_allclose(
            b.score(np.full((1, 4), 2.0, np.float32)), [8.0])
        b.close()


class GatedScorer:
    """Scorer whose score() blocks until released — wedges a lane's
    worker so its queue fills deterministically. ``gate_first_only``
    blocks only the first dispatch (whichever lane makes it), leaving
    every later dispatch fast."""

    max_batch = 64

    def __init__(self, gate_first_only: bool = False):
        self.release = threading.Event()
        self.gate_first_only = gate_first_only
        self._gated_once = False
        self.calls = 0

    def score(self, features: np.ndarray) -> np.ndarray:
        self.calls += 1
        if not self.gate_first_only or not self._gated_once:
            self._gated_once = True
            self.release.wait(timeout=10)
        return features.sum(axis=1).astype(np.float32)


class TestLaneSharding:
    """Multi-lane serving: per-request correctness across lanes, bounded
    admission with fail-fast sheds, and close() draining every lane."""

    def test_multilane_concurrent_correctness(self, impl):
        """32 threads through 4 lanes: every response carries ITS
        request's rows (same contract as the sync scorer), work spreads
        across all lanes, and nothing sheds below the caps."""
        scorer = AsyncScorer(device_s=0.002)
        b = impl.MicroBatcher(scorer, lanes=4, queue_depth=64,
                         adaptive_wait_s=0.0005, lane_grow_depth=0)
        n_threads, per_thread = 32, 20
        errors: list = []
        start_barrier = threading.Barrier(n_threads)

        def call(tid):
            rng = np.random.default_rng(tid)
            start_barrier.wait()
            for _ in range(per_thread):
                n = int(rng.integers(1, 5))
                feats = rng.uniform(1, 100, (n, 4)).astype(np.float32)
                try:
                    got = b.score(feats)
                    np.testing.assert_allclose(
                        got, feats.sum(axis=1), rtol=1e-6)
                except Exception as exc:  # noqa: BLE001
                    errors.append(exc)
                    return

        threads = [threading.Thread(target=call, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        stats = b.stats()
        b.close()
        assert not errors
        assert stats["lanes"] == 4
        assert stats["sheds"] == 0
        assert b.coalesced_requests == n_threads * per_thread
        # Round-robin assignment must actually exercise every lane.
        for lane in stats["per_lane"]:
            assert lane["dispatches"] > 0, stats["per_lane"]

    def test_admission_cap_sheds_fail_fast(self, impl):
        """lanes=1, depth cap 1: with the worker wedged and one request
        queued, the next arrival fails immediately with
        BatcherSaturatedError instead of queueing — and the queued
        request is never dropped."""
        scorer = GatedScorer()
        b = impl.MicroBatcher(scorer, lanes=1, queue_depth=1)
        results: dict = {}

        def call(key, feats):
            results[key] = b.score(feats)

        in_service = np.full((1, 4), 1.0, np.float32)
        queued = np.full((1, 4), 2.0, np.float32)
        t1 = threading.Thread(target=call, args=("in_service", in_service))
        t1.start()
        time.sleep(0.1)  # worker took it and is wedged in score()
        t2 = threading.Thread(target=call, args=("queued", queued))
        t2.start()
        time.sleep(0.1)  # fills the single queue slot
        t_shed = time.monotonic()
        with pytest.raises(impl.BatcherSaturatedError, match="depth cap"):
            b.score(np.full((1, 4), 3.0, np.float32))
        shed_latency = time.monotonic() - t_shed
        scorer.release.set()
        t1.join(timeout=10)
        t2.join(timeout=10)
        stats = b.stats()
        b.close()
        # Fail-fast: the shed decision must not wait out the wedge.
        assert shed_latency < 1.0, shed_latency
        assert stats["sheds"] == 1
        assert stats["shed_rate"] > 0
        np.testing.assert_allclose(results["in_service"], [4.0])
        np.testing.assert_allclose(results["queued"], [8.0])

    def test_idle_traffic_never_sheds(self, impl):
        scorer = SlowScorer(delay=0.0)
        b = impl.MicroBatcher(scorer, lanes=2, queue_depth=2)
        for i in range(20):
            b.score(np.full((2, 4), float(i), np.float32))
        stats = b.stats()
        b.close()
        assert stats["sheds"] == 0

    def test_saturated_lane_sheds_while_others_serve(self, impl):
        """The acceptance-criteria proof at the batcher level: wedge
        lane 0 (first dispatch blocks), fill its queue, and every
        request round-robined to lane 0 sheds while lane 1 keeps
        serving. No spill: a stuck lane must not back-pressure healthy
        ones."""
        scorer = GatedScorer(gate_first_only=True)
        b = impl.MicroBatcher(scorer, lanes=2, queue_depth=1,
                         lane_grow_depth=0)
        results: dict = {}

        def call(key, feats):
            results[key] = b.score(feats)

        # RR#0 → lane 0: dispatched, wedged in the scorer's gate.
        t_wedged = threading.Thread(
            target=call, args=("wedged", np.full((1, 4), 9.0, np.float32)))
        t_wedged.start()
        time.sleep(0.1)
        # RR#1 → lane 1: serves fine while lane 0 is stuck.
        np.testing.assert_allclose(
            b.score(np.full((1, 4), 1.0, np.float32)), [4.0])
        # RR#2 → lane 0: occupies its single queue slot.
        t_queued = threading.Thread(
            target=call, args=("queued", np.full((1, 4), 5.0, np.float32)))
        t_queued.start()
        time.sleep(0.1)
        # RR#3 → lane 1: still serving.
        np.testing.assert_allclose(
            b.score(np.full((1, 4), 2.0, np.float32)), [8.0])
        # RR#4 → lane 0: full → shed, instantly.
        with pytest.raises(impl.BatcherSaturatedError):
            b.score(np.full((1, 4), 3.0, np.float32))
        # RR#5 → lane 1: the shed next door changed nothing here.
        np.testing.assert_allclose(
            b.score(np.full((1, 4), 4.0, np.float32)), [16.0])
        stats = b.stats()
        scorer.release.set()
        t_wedged.join(timeout=10)
        t_queued.join(timeout=10)
        b.close()
        per_lane = {s["lane"]: s for s in stats["per_lane"]}
        assert per_lane[0]["sheds"] == 1, stats
        assert per_lane[1]["sheds"] == 0, stats
        assert per_lane[1]["coalesced_requests"] >= 3, stats
        np.testing.assert_allclose(results["wedged"], [36.0])
        np.testing.assert_allclose(results["queued"], [20.0])

    def test_close_drains_all_lanes(self, impl):
        """close() must serve everything already queued on EVERY lane —
        callers racing a model reload never hang or lose requests."""
        scorer = SlowScorer(delay=0.01)
        b = impl.MicroBatcher(scorer, lanes=4, queue_depth=16,
                         lane_grow_depth=0)
        results: dict = {}
        errors: list = []

        def call(i):
            try:
                results[i] = b.score(
                    np.full((2, 4), float(i), np.float32))
            except Exception as exc:  # noqa: BLE001
                errors.append(exc)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        time.sleep(0.05)  # let every request reach its lane queue
        b.close()
        for t in threads:
            t.join(timeout=30)
        assert not errors
        assert len(results) == 16
        for i in range(16):
            np.testing.assert_allclose(results[i], [4.0 * i] * 2)

    def test_lane_and_depth_validation(self, impl):
        with pytest.raises(ValueError, match="lanes"):
            impl.MicroBatcher(SlowScorer(), lanes=0)
        with pytest.raises(ValueError, match="queue_depth"):
            impl.MicroBatcher(SlowScorer(), queue_depth=-1)

    def test_lane_activation_grows_under_backlog_and_reconsolidates(self, impl):
        """Load-aware activation: a lone lane serves light traffic (no
        fragmentation of coalescing), a backlog past lane_grow_depth
        activates more lanes, and a sustained idle run shrinks the
        active set back to one."""
        scorer = GatedScorer()
        b = impl.MicroBatcher(scorer, lanes=4, queue_depth=0,
                         lane_grow_depth=2)
        assert b.stats()["active_lanes"] == 1
        results: dict = {}

        def call(i):
            results[i] = b.score(np.full((1, 4), float(i), np.float32))

        # Wedge lane 0's worker, then build a backlog on lane 0: the
        # 3rd queued request sees depth ≥ 2 and activates lane 1.
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
            time.sleep(0.05)
        stats_loaded = b.stats()
        scorer.release.set()
        for t in threads:
            t.join(timeout=10)
        assert stats_loaded["active_lanes"] > 1, stats_loaded
        assert stats_loaded["lane_activations"] >= 1
        for i in range(6):
            np.testing.assert_allclose(results[i], [4.0 * i])
        # Sustained idle traffic re-consolidates to one lane (the
        # shrink threshold is SHRINK_AFTER_IDLE_ADMITS consecutive
        # empty-queue admissions per step down).
        for _ in range(3 * impl.MicroBatcher.SHRINK_AFTER_IDLE_ADMITS + 3):
            b.score(np.ones((1, 4), np.float32))
        assert b.stats()["active_lanes"] == 1
        b.close()

    def test_shed_fallback_counted_by_ml_evaluator(self, impl):
        """The acceptance-criteria proof at the evaluator level: a
        saturated lane degrades THAT decision to rule-based fallback
        (counted as a shed, not logged as a failure) while decisions
        landing on healthy lanes keep getting model-ranked."""
        from tests.test_inference import FakeHost, FakePeer

        child = FakePeer("child", FakeHost(idc="a"))
        parents = [
            FakePeer(f"p{i}", FakeHost(idc="a", upload_count=10 * i),
                     _finished=i + 1)
            for i in range(6)
        ]
        scorer = GatedScorer(gate_first_only=True)
        scorer.max_batch = 64
        batcher = impl.MicroBatcher(scorer, lanes=2, queue_depth=1,
                               lane_grow_depth=0)
        evaluator = impl.MLEvaluator(batcher)
        done: dict = {}

        def rank(key):
            done[key] = evaluator.evaluate_parents(parents, child, 10)

        # RR#0 → lane 0: wedged on the gate.
        t_wedged = threading.Thread(target=rank, args=("wedged",))
        t_wedged.start()
        time.sleep(0.1)
        # RR#1 → lane 1: model-ranked.
        ranked = evaluator.evaluate_parents(parents, child, 10)
        assert sorted(p.id for p in ranked) == sorted(p.id for p in parents)
        assert evaluator.scored_count == 1
        # RR#2 → lane 0: fills the queue slot.
        t_queued = threading.Thread(target=rank, args=("queued",))
        t_queued.start()
        time.sleep(0.1)
        # RR#3 → lane 1: still model-ranked.
        evaluator.evaluate_parents(parents, child, 10)
        assert evaluator.scored_count == 2
        # RR#4 → lane 0: shed → rule-based fallback, counted.
        ranked_fallback = evaluator.evaluate_parents(parents, child, 10)
        assert sorted(p.id for p in ranked_fallback) == sorted(
            p.id for p in parents)
        assert evaluator.shed_count == 1
        assert evaluator.fallback_count == 1
        # RR#5 → lane 1: the healthy lane never noticed.
        evaluator.evaluate_parents(parents, child, 10)
        assert evaluator.scored_count == 3
        scorer.release.set()
        t_wedged.join(timeout=10)
        t_queued.join(timeout=10)
        assert len(done) == 2
        evaluator.close()


class TestLoadgenLanes:
    def test_measure_colocated_reports_lane_and_shed_stats(self, impl):
        """The ladder harness must carry the lane/admission story:
        per-lane counters, shed counts, and the activation state —
        and shed requests must never pollute the latency samples."""
        result = impl.measure_colocated(
            SlowScorer(delay=0.001), threads=4, rows_per_request=2,
            duration_s=0.4, lanes=2, queue_depth=8, shed_fallback_s=0.0)
        for key in ("lanes", "active_lanes", "lane_activations",
                    "queue_depth_cap", "sheds", "shed_rate", "per_lane",
                    "p99_ms", "coalesce_factor"):
            assert key in result, key
        assert result["lanes"] == 2
        assert result["queue_depth_cap"] == 8
        assert result["requests"] > 0
        assert len(result["per_lane"]) == 2




# -- both implementations, one script: the same stats() keys and counts --------


def test_stats_keys_and_counts_match_jax():
    """One deterministic single-caller script (three requests of 3, 9
    and 20 rows, then a shed on a wedged one-slot lane) through both
    batchers: the same stats() keys, per-lane keys and counts."""
    snaps = {}
    for name, mod in IMPLS.items():
        b = mod.MicroBatcher(AsyncScorer(device_s=0.0), lanes=2,
                             queue_depth=4, lane_grow_depth=0)
        for n in (3, 9, 20):
            b.score(np.ones((n, 4), np.float32))
        stats = b.stats()
        b.close()
        wedged = GatedScorer()
        w = mod.MicroBatcher(wedged, lanes=1, queue_depth=1)
        threads = [threading.Thread(target=w.score,
                                    args=(np.ones((1, 4), np.float32),))
                   for _ in range(2)]
        threads[0].start()
        time.sleep(0.1)
        threads[1].start()
        time.sleep(0.1)
        with pytest.raises(mod.BatcherSaturatedError):
            w.score(np.ones((1, 4), np.float32))
        wedged.release.set()
        for t in threads:
            t.join(timeout=10)
            assert not t.is_alive()
        shed_stats = w.stats()
        w.close()
        snaps[name] = (stats, shed_stats)
    counts = ("lanes", "active_lanes", "lane_activations", "lane_grow_depth",
              "queue_depth_cap", "dispatches", "coalesced_requests",
              "coalesce_factor", "sheds", "shed_rate", "bucket_hits")
    for i in range(2):
        ref, got = snaps["jax"][i], snaps["port"][i]
        assert sorted(got) == sorted(ref)
        assert [sorted(lane) for lane in got["per_lane"]] == [
            sorted(lane) for lane in ref["per_lane"]]
        assert {k: got[k] for k in counts} == {k: ref[k] for k in counts}
        assert [lane["dispatches"] for lane in got["per_lane"]] == [
            lane["dispatches"] for lane in ref["per_lane"]]
    assert snaps["port"][0]["bucket_hits"] == {8: 1, 16: 1, 32: 1}
    assert snaps["port"][1]["sheds"] == 1


# -- the inference service's batcher path -----------------------------------


class TestSidecarMicroBatch:
    def test_model_infer_through_batcher(self):
        service = InferenceService(micro_batch=True)
        service.install_scorer("mlp", SlowScorer(delay=0.0))
        model = service._models["mlp"]
        assert model.batcher is not None
        feats = np.ones((4, FEATURE_DIM), np.float32)
        np.testing.assert_allclose(model.score(feats),
                                   np.full(4, FEATURE_DIM, np.float32))
        stats = service.batcher_stats()
        assert stats["mlp"]["dispatches"] >= 1
        assert stats["mlp"]["coalesced_requests"] >= 1
        # Reinstall grace-closes the old batcher and builds a fresh one.
        old_batcher = model.batcher
        service.install_scorer("mlp", SlowScorer(delay=0.0), version="v2")
        assert service._models["mlp"].batcher is not old_batcher
        service.stop()

    def test_max_rows_validation_uses_effective_batcher_limit(self):
        service = InferenceService(micro_batch=True, batch_max_rows=8)
        service.install_scorer("mlp", SlowScorer(delay=0.0))
        try:
            req = ModelInferRequest(
                model_name="mlp",
                inputs=np.ones((16, FEATURE_DIM), np.float32))
            with pytest.raises(RpcAbort) as exc_info:
                service.ModelInfer(req, CallContext())
            assert exc_info.value.code == StatusCode.INVALID_ARGUMENT
            assert "exceeds max 8" in exc_info.value.details
            ok = service.ModelInfer(
                ModelInferRequest(
                    model_name="mlp",
                    inputs=np.ones((8, FEATURE_DIM), np.float32)),
                CallContext())
            assert ok.outputs.shape == (8,)
        finally:
            service.stop()

    def test_saturation_maps_to_resource_exhausted(self):
        gated = GatedScorer()
        service = InferenceService(micro_batch=True, batch_lanes=1,
                                   batch_queue_depth=1)
        service.install_scorer("mlp", gated)
        results: list = []

        def infer():
            results.append(service.ModelInfer(
                ModelInferRequest(
                    model_name="mlp",
                    inputs=np.ones((2, FEATURE_DIM), np.float32)),
                CallContext()))

        try:
            t1 = threading.Thread(target=infer)
            t1.start()
            time.sleep(0.1)  # worker wedged on the gate
            t2 = threading.Thread(target=infer)
            t2.start()
            time.sleep(0.1)  # queue slot filled
            with pytest.raises(RpcAbort) as exc_info:
                service.ModelInfer(
                    ModelInferRequest(
                        model_name="mlp",
                        inputs=np.ones((2, FEATURE_DIM), np.float32)),
                    CallContext())
            assert exc_info.value.code == StatusCode.RESOURCE_EXHAUSTED
            gated.release.set()
            t1.join(timeout=10)
            t2.join(timeout=10)
            assert len(results) == 2
            assert service.batcher_stats()["mlp"]["sheds"] == 1
        finally:
            gated.release.set()
            service.stop()

    def test_grace_timers_pruned_on_install(self):
        service = InferenceService(micro_batch=True)
        try:
            service.install_scorer("mlp", SlowScorer(delay=0.0), version="v1")
            assert len(service._grace_timers) == 0
            service.install_scorer("mlp", SlowScorer(delay=0.0), version="v2")
            assert len(service._grace_timers) == 1
            for t in service._grace_timers:
                t.cancel()
            service.install_scorer("mlp", SlowScorer(delay=0.0), version="v3")
            assert len(service._grace_timers) == 1
            assert not service._grace_timers[0].finished.is_set()
        finally:
            service.stop()

    def test_grace_close_drains_and_flips_health(self):
        """A replaced batcher keeps serving through its grace window
        (health NOT_SERVING meanwhile), then closes; SERVING returns when
        the last window closes."""
        from dragonfly2_tpu_torch.rpc.health import (
            NOT_SERVING,
            SERVING,
            HealthCheckRequest,
            HealthService,
        )

        health = HealthService()
        service = InferenceService(micro_batch=True, reload_grace_s=0.3)
        service.set_health(health)
        try:
            service.install_scorer("mlp", SlowScorer(delay=0.0), "v1")
            old = service._models["mlp"].batcher
            service.install_scorer("mlp", SlowScorer(delay=0.0), "v2")
            assert health.Check(HealthCheckRequest()).status == NOT_SERVING
            np.testing.assert_allclose(
                old.score(np.ones((2, 4), np.float32)), [4.0, 4.0])
            deadline = time.monotonic() + 10
            while (health.Check(HealthCheckRequest()).status != SERVING
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            assert health.Check(HealthCheckRequest()).status == SERVING
            with pytest.raises(RuntimeError, match="closed"):
                old.score(np.ones((2, 4), np.float32))
            assert health.Check(HealthCheckRequest("other")).status == \
                "SERVICE_UNKNOWN"
        finally:
            service.stop()
        assert health.Check(HealthCheckRequest()).status == NOT_SERVING


# -- the same seeded MLP behind both packages' scorer + batcher --------------


@pytest.fixture(scope="module")
def distilled_mlp():
    from dragonfly2_tpu.inference.guardbench import train_rule_distilled_mlp

    return train_rule_distilled_mlp(seed=3, samples=768)


def port_f32_scorer(result, **kw):
    from dragonfly2_tpu_torch.models.mlp import (
        MLPBandwidthPredictor,
        Normalizer,
    )
    from dragonfly2_tpu_torch.train.checkpoint import mlp_state_dict_from_flax

    model = MLPBandwidthPredictor(hidden=DISTILLED_HIDDEN,
                                  dtype=torch.float32)
    model.load_state_dict(mlp_state_dict_from_flax(result.params))
    return scorer.ParentScorer(
        model, Normalizer(result.normalizer.mean, result.normalizer.std),
        Normalizer(result.target_norm.mean, result.target_norm.std),
        device="cpu", **kw)


def test_batched_mlp_matches_solo_and_jax(distilled_mlp):
    """8 threads × 50 seeded requests of 1-16 rows through each
    package's MicroBatcher (2 lanes): every port reply is bit-identical
    to the port scorer's solo ``score`` of the same rows, whatever it was
    coalesced with, and within F32_TOL of the JAX package's reply."""
    from dragonfly2_tpu.models.mlp import MLPBandwidthPredictor as JaxMLP

    result = distilled_mlp
    port = port_f32_scorer(result)
    ref = jax_scorer.ParentScorer(
        JaxMLP(hidden=DISTILLED_HIDDEN, dtype=jnp.float32),
        result.params, result.normalizer, result.target_norm)
    batchers = {
        "port": batcher.MicroBatcher(port, lanes=2, adaptive_wait_s=0.0005),
        "jax": jax_batcher.MicroBatcher(ref, lanes=2,
                                        adaptive_wait_s=0.0005),
    }
    rng = np.random.default_rng(5)
    requests = [[rng.uniform(0, 100, (int(rng.integers(1, 17)),
                                      FEATURE_DIM)).astype(np.float32)
                 for _ in range(50)] for _ in range(8)]
    replies = {name: [[None] * 50 for _ in range(8)] for name in batchers}
    errors = []

    def drive(name, tid):
        try:
            for i, req in enumerate(requests[tid]):
                replies[name][tid][i] = batchers[name].score(req)
        except Exception as exc:  # noqa: BLE001 — collected
            errors.append(exc)

    for name in batchers:
        threads = [threading.Thread(target=drive, args=(name, t))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    stats = batchers["port"].stats()
    for b in batchers.values():
        b.close()
    assert not errors
    assert stats["coalesced_requests"] == 400
    assert stats["dispatches"] < 400  # requests did share dispatches
    for tid in range(8):
        for i, req in enumerate(requests[tid]):
            got = replies["port"][tid][i]
            np.testing.assert_array_equal(got, port.score(req))
            np.testing.assert_allclose(got, replies["jax"][tid][i],
                                       rtol=0, atol=F32_TOL)


def test_score_handle_on_cpu_is_the_result():
    """On the CPU a handle carries the computed result and no event."""
    from dragonfly2_tpu_torch.models.mlp import (
        MLPBandwidthPredictor,
        Normalizer,
    )

    x = np.random.default_rng(0).uniform(0, 9, (20, FEATURE_DIM)).astype(
        np.float32)
    s = scorer.ParentScorer(
        MLPBandwidthPredictor(hidden=(8,), dtype=torch.float32,
                              generator=torch.Generator().manual_seed(0)),
        Normalizer.fit(x), Normalizer(np.zeros(1), np.ones(1)),
        device="cpu", max_batch=32)
    handle = s.score_async(x[:5])
    assert handle._event is None and handle.bucket == 32
    np.testing.assert_array_equal(handle.materialize(), s.score(x[:5]))
    assert handle.materialize().shape == (5,)


# -- new_evaluator(micro_batch=True): sheds counted as in JAX ----------------


def test_new_evaluator_micro_batch_shed_parity():
    """The same wedged-lane script (lanes 2, queue depth 1, load-aware
    activation) through both packages' ``new_evaluator("ml",
    micro_batch=True)``: the same scored, shed and fallback counts,
    orders and ServingStats."""
    from tests.test_inference import FakeHost, FakePeer

    child = FakePeer("child", FakeHost(idc="a"))
    parents = [FakePeer(f"p{i}", FakeHost(idc="a", upload_count=10 * i),
                        _finished=i + 1) for i in range(6)]
    out = {}
    for name, make, stats in (("jax", jax_new_evaluator, JaxServingStats()),
                              ("port", new_evaluator, ServingStats())):
        gated = GatedScorer(gate_first_only=True)
        evaluator = make("ml", scorer=gated, micro_batch=True,
                         batch_lanes=2, batch_queue_depth=1, stats=stats)
        assert isinstance(evaluator._scorer, (batcher.MicroBatcher,
                                              jax_batcher.MicroBatcher))
        done: dict = {}

        def rank(key, ev=evaluator, sink=done):
            sink[key] = ev.evaluate_parents(parents, child, 10)

        t_wedged = threading.Thread(target=rank, args=("wedged",))
        t_wedged.start()
        time.sleep(0.1)
        t_queued = threading.Thread(target=rank, args=("queued",))
        t_queued.start()
        time.sleep(0.1)
        orders = [[p.id for p in evaluator.evaluate_parents(
            parents, child, 10)] for _ in range(4)]
        counts = (evaluator.scored_count, evaluator.shed_count,
                  evaluator.fallback_count)
        gated.release.set()
        for t in (t_wedged, t_queued):
            t.join(timeout=10)
            assert not t.is_alive()
        evaluator.close()
        out[name] = {"counts": counts, "orders": orders,
                     "stats": stats.snapshot(), "done": sorted(done)}
    assert out["port"] == out["jax"]
    assert out["port"]["counts"][1] > 0
    assert out["port"]["stats"]["ml_sheds"] == out["port"]["counts"][1]
