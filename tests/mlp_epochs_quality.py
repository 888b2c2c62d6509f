"""How many epochs config #1's MLP needs: trains it at chip_smoke's
settings (``chip_smoke.MLP_CFG``) for each (epochs, seed) asked and
prints the eval MAE beside predicting the train split's mean, the eval
MSE and the loss of every epoch.

    python3 tests/mlp_epochs_quality.py [--epochs 1,2,3,4,5,6] [--seeds 0,1,2]

Needs one CUDA card. The seed is the trainer's (initial weights, split,
batch order); the data is chip_smoke's. The run's schedule (warmup,
cosine decay) follows the epochs, so each (epochs, seed) is its own run.
Prints one JSON line a run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--epochs", default="1,2,3,4,5,6")
    parser.add_argument("--seeds", default="0,1,2")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("mlp_epochs_quality: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import chip_smoke
    from dragonfly2_tpu_torch.data import ArrayDataset, SyntheticCluster
    from dragonfly2_tpu_torch.train.mlp_trainer import (
        MLPTrainConfig,
        train_mlp,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    X, y = SyntheticCluster(n_hosts=chip_smoke.MLP_HOSTS,
                            seed=chip_smoke.SEED).pair_example_columns(
        chip_smoke.MLP_ROWS)
    card = chip_smoke.nvidia_smi()
    for epochs in (int(e) for e in args.epochs.split(",")):
        for seed in (int(s) for s in args.seeds.split(",")):
            cfg = MLPTrainConfig(**dict(chip_smoke.MLP_CFG, epochs=epochs,
                                        seed=seed, max_seconds=None))
            train, held = ArrayDataset(X, y).split(cfg.eval_fraction, seed)
            mean_mae = float(np.abs(held.arrays[1]
                                    - train.arrays[1].mean()).mean())
            t0 = time.perf_counter()
            result = train_mlp(X, y, cfg)
            print(json.dumps({
                "epochs": epochs, "seed": seed, "eval_mae": result.mae,
                "predict_mean_mae": mean_mae, "eval_mse": result.mse,
                "history": result.history,
                "samples_per_sec": result.samples_per_sec,
                "seconds": time.perf_counter() - t0, "card": card}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
