"""Whether a recorded swarm corpus could replace ``chip_smoke.py``'s
stand-in cost corpus: the best correlation any cost model can reach on
the corpus ``run_replay_ab`` records (``run_swarm_bench(600, workers=4,
cost_profile="profiled")`` through the recorder), and what the trained
cost model reaches.

A candidate's realized cost is its host's seeded cost factor times the
base piece cost; the features see the factor only through the host's
upload-failure count (an integer), so the best predictor is the mean
realized cost of the examples that share a feature row. The script
prints the Pearson correlation of that conditional mean with the
realized cost (raw seconds, log1p and log), the same for ``train_cost``
at ``run_replay_ab``'s settings (hidden (32, 16), 25 epochs, batch 512)
scored through the loaded ``cost`` artifact, and chip_smoke's stand-in
bound for comparison.

    python3 tests/recorded_cost_ceiling.py [--device cpu|cuda] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def correlations(pred, cost) -> dict:
    import numpy as np

    pred = np.asarray(pred, np.float64)
    cost = np.asarray(cost, np.float64)
    return {
        "raw": float(np.corrcoef(pred, cost)[0, 1]),
        "log1p": float(np.corrcoef(np.log1p(pred), np.log1p(cost))[0, 1]),
        "log": float(np.corrcoef(np.log(np.maximum(pred, 1e-9)),
                                 np.log(cost))[0, 1]),
    }


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np

    import chip_smoke
    from dragonfly2_tpu_torch.inference.sidecar import (
        _cost_scorer_from_artifact,
    )
    from dragonfly2_tpu_torch.scheduler import replay
    from dragonfly2_tpu_torch.scheduler.loadbench import run_swarm_bench
    from dragonfly2_tpu_torch.scheduler.replaylog import ReplayRecorder
    from dragonfly2_tpu_torch.scheduler.storage.storage import (
        Storage,
        StorageConfig,
    )
    from dragonfly2_tpu_torch.train.cost_trainer import (
        CostTrainConfig,
        cost_examples_from_corpus,
        cost_tree,
        train_cost,
    )

    tmp = tempfile.mkdtemp(prefix="recorded-cost-")
    try:
        storage = Storage(os.path.join(tmp, "sched"),
                          StorageConfig(max_size=256 * 1024, buffer_size=25))
        recorder = ReplayRecorder(storage)
        rung = run_swarm_bench(chip_smoke.RECORD_PEERS,
                               workers=chip_smoke.RECORD_WORKERS,
                               recorder=recorder, cost_profile="profiled",
                               profile_seed=args.seed)
        recorder.close()
        corpus = replay.corpus_from_storage(storage)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    X, y = cost_examples_from_corpus(corpus)
    rows, inverse = np.unique(X, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    group_mean = (np.bincount(inverse, weights=y.astype(np.float64))
                  / np.bincount(inverse))[inverse]
    result = train_cost(X, y, CostTrainConfig(hidden=(32, 16), epochs=25,
                                              batch_size=512,
                                              seed=args.seed), args.device)
    artifact = chip_smoke.mlp_artifact(
        cost_tree(result), "cost", result.config.hidden,
        {"mse": result.mse, "mae": result.mae})
    scorer = _cost_scorer_from_artifact(artifact, device=args.device)
    pred = np.concatenate([scorer.predict_cost_s(X[i:i + 64])
                           for i in range(0, len(X), 64)])
    print(json.dumps({
        "device": args.device, "seed": args.seed,
        "decisions": len(corpus), "swarm_errors": rung["errors"],
        "examples": int(len(X)), "distinct_feature_rows": int(len(rows)),
        "cost_s": {"min": float(y.min()), "median": float(np.median(y)),
                   "max": float(y.max())},
        "ceiling": correlations(group_mean, y),
        "trained": correlations(pred, y),
        "standin_ceiling": chip_smoke.COST_CORR_CEILING,
        "standin_bound": chip_smoke.COST_CORR_MIN,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
