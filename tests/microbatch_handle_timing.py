#!/usr/bin/env python3
"""Times the micro-batcher ladder rungs of the config #1 MLP scorer on
one CUDA card: ``measure_colocated`` at the inference service's default
knobs (2 lanes, queue depth 32, adaptive window 0.5 ms, max_batch 64),
16-row requests, beside one thread calling ``score`` directly.

    python3 tests/microbatch_handle_timing.py [--root DIR]
        [--threads 8,32] [--seconds 2]

``--root`` names the repository root whose ``dragonfly2_tpu_torch`` is
timed (default: this one), for example a copy of the tree with another
``ScoreHandle`` unpacked into a directory that ``.gitignore`` lists.
Compare two trees on one card by running the script on each in turns
(A, B, B, A) in one command. The weights are seeded (hidden
(128, 128, 64), bf16): the rungs time the serving path, not the model.
Prints one JSON line a rung and the card line from ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--threads", default="8,32")
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from dragonfly2_tpu_torch.inference import scorer as scorer_mod
    from dragonfly2_tpu_torch.inference.loadgen import measure_colocated
    from dragonfly2_tpu_torch.models.mlp import (
        FEATURE_DIM,
        MLPBandwidthPredictor,
        Normalizer,
    )

    if not scorer_mod.__file__.startswith(root):
        raise RuntimeError(f"imported {scorer_mod.__file__}, not from {root}")
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 100, (4096, FEATURE_DIM)).astype(np.float32)
    model = MLPBandwidthPredictor(
        generator=torch.Generator().manual_seed(0))
    scorer = scorer_mod.ParentScorer(
        model, Normalizer.fit(x),
        Normalizer(np.array([2.5], np.float32), np.array([0.7], np.float32)))
    solo = scorer.benchmark(batch=16, iters=500)
    print(json.dumps({"root": root, "solo_score_16_rows": solo}),
          flush=True)
    for threads in (int(t) for t in args.threads.split(",")):
        t0 = time.perf_counter()
        rung = measure_colocated(
            scorer, threads=threads, rows_per_request=16,
            duration_s=args.seconds, adaptive_wait_s=0.0005, lanes=2,
            queue_depth=32)
        rung.pop("per_lane")
        print(json.dumps({"root": root, "wall_s": time.perf_counter() - t0,
                          **rung}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
