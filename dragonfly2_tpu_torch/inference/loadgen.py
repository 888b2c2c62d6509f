"""Concurrent-load latency measurement — port of
``dragonfly2_tpu/inference/loadgen.py``.

:func:`measure_colocated` drives N threads of parent-selection requests
through a :class:`~dragonfly2_tpu_torch.inference.batcher.MicroBatcher`
around a scorer — a scheduler process colocated with its inference
service — and reports per-request latency percentiles and throughput
beside the batcher's pipeline counters (coalesce factor, in-flight
depth, stage/dispatch overlap, adaptive-window opens, bucket hits and
the per-lane breakdown), so a load ladder shows where the coalescing
ceiling sits and which lanes shed.

A request shed with
:class:`~dragonfly2_tpu_torch.inference.batcher.BatcherSaturatedError`
is counted, never folded into the latency distribution, and its thread
pays ``shed_fallback_s`` before its next request: the rule scoring a
scheduler runs for that decision instead.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

import numpy as np

from dragonfly2_tpu_torch.inference.batcher import (
    BatcherSaturatedError,
    MicroBatcher,
)
from dragonfly2_tpu_torch.scheduler.evaluator.scoring import FEATURE_DIM
from dragonfly2_tpu_torch.utils.percentile import percentile as _percentile


def measure_colocated(
    scorer,
    *,
    threads: int = 8,
    rows_per_request: int = 16,
    duration_s: float = 3.0,
    max_rows: int | None = None,
    max_wait_s: float = 0.0,
    adaptive_wait_s: float = 0.0,
    lanes: int = 1,
    queue_depth: int = 0,
    lane_grow_depth: int | None = None,
    shed_fallback_s: float = 0.0005,
    requests: np.ndarray | None = None,
) -> Dict[str, float]:
    """Drive ``threads`` concurrent request loops through a MicroBatcher
    wrapped around ``scorer`` for ``duration_s`` and return latency and
    throughput stats (milliseconds).

    ``max_wait_s`` / ``adaptive_wait_s`` are the batcher's batch-window
    knobs, ``lanes`` / ``queue_depth`` its sharding and admission knobs,
    all passed through verbatim. ``shed_fallback_s`` is the simulated
    cost of the rule-based fallback a shed request degrades to.
    ``requests`` (``[threads, rows_per_request, ...]``, one request per
    thread, sent again and again) replaces the default seeded
    standard-normal feature rows — host-index pairs for a pair scorer.
    """
    batcher = MicroBatcher(scorer, max_rows=max_rows,
                           max_wait_s=max_wait_s,
                           adaptive_wait_s=adaptive_wait_s,
                           lanes=lanes, queue_depth=queue_depth,
                           lane_grow_depth=lane_grow_depth)
    if requests is None:
        rng = np.random.default_rng(0)
        requests = rng.standard_normal(
            (threads, rows_per_request, FEATURE_DIM)).astype(np.float32)
    features = requests

    # One request before the clock starts: the lane workers' first call.
    batcher.score(features[0])

    latencies: List[List[float]] = [[] for _ in range(threads)]
    shed_counts = [0] * threads
    stop = threading.Event()
    start_barrier = threading.Barrier(threads + 1)

    def loop(tid: int) -> None:
        mine = features[tid]
        out = latencies[tid]
        start_barrier.wait()
        while not stop.is_set():
            t = time.perf_counter()
            try:
                batcher.score(mine)
            except BatcherSaturatedError:
                # Shed: this decision degrades to rule scoring — model
                # its cost, count it, and keep offering load. The shed
                # request is NOT a served latency sample.
                shed_counts[tid] += 1
                if shed_fallback_s > 0:
                    time.sleep(shed_fallback_s)
                continue
            out.append((time.perf_counter() - t) * 1e3)

    workers = [threading.Thread(target=loop, args=(i,), daemon=True)
               for i in range(threads)]
    for w in workers:
        w.start()
    start_barrier.wait()
    t_start = time.perf_counter()
    time.sleep(duration_s)
    stop.set()
    for w in workers:
        w.join(timeout=10)
    wall = time.perf_counter() - t_start
    batcher.close()

    merged = sorted(x for sub in latencies for x in sub)
    n = len(merged)
    sheds = sum(shed_counts)
    offered = n + sheds
    pipeline = batcher.stats()
    p50 = _percentile(merged, 0.50)
    p95 = _percentile(merged, 0.95)
    p99 = _percentile(merged, 0.99)
    return {
        "threads": threads,
        "requests": n,
        "requests_per_sec": round(n / wall, 1) if wall > 0 else 0.0,
        "p50_ms": round(p50, 4),
        "p95_ms": round(p95, 4),
        "p99_ms": round(p99, 4),
        "coalesce_factor": pipeline["coalesce_factor"],
        "dispatches": pipeline["dispatches"],
        "inflight_depth_avg": pipeline["inflight_depth_avg"],
        "overlap_ratio": pipeline["overlap_ratio"],
        "adaptive_opens": pipeline["adaptive_opens"],
        "max_queue_depth": pipeline["max_queue_depth"],
        "lanes": pipeline["lanes"],
        "active_lanes": pipeline["active_lanes"],
        "lane_activations": pipeline["lane_activations"],
        "queue_depth_cap": pipeline["queue_depth_cap"],
        "sheds": sheds,
        "shed_rate": round(sheds / offered, 4) if offered else 0.0,
        "per_lane": pipeline["per_lane"],
        "bucket_hits": {str(k): v
                        for k, v in pipeline["bucket_hits"].items()},
    }
