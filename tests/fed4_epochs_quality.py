"""How many local epochs and rounds config #4 needs: runs chip_smoke's
"federated_config4" federation (``chip_smoke.FED4_*``: three band
clusters of ~100 000 examples, locals at config #1's widths and batch,
FedAvg at quorum 3, no registry) for each (epochs, rounds, seed) asked
and prints the global's pooled-holdout MAE beside the train-mean
predictor's, each round's holdout MAE, the local fits' steps and the
run's seconds.

    python3 tests/fed4_epochs_quality.py [--epochs 1,2,4,8] [--rounds 3]
        [--seeds 0,1,2] [--device cuda]

Runs on the card by default (``--device cpu`` rehearses it). The seed is
the corpora's and the locals' (initial weights, carve, split, batch
order). Prints one JSON line a run, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--epochs", default="1,2,4,8")
    parser.add_argument("--rounds", default="3")
    parser.add_argument("--seeds", default="0,1,2")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("fed4_epochs_quality: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np

    import chip_smoke
    from dragonfly2_tpu_torch.train.fedbench import synth_cluster_corpora
    from dragonfly2_tpu_torch.train.federated import (
        FederatedConfig,
        cluster_datasets_from_corpora,
    )
    from dragonfly2_tpu_torch.train.mlp_trainer import MLPTrainConfig
    from dragonfly2_tpu_torch.trainer.federation import (
        FederationConfig,
        FederationCoordinator,
        LocalClusterEndpoint,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        datasets = cluster_datasets_from_corpora(synth_cluster_corpora(
            chip_smoke.FED4_CLUSTERS, chip_smoke.FED4_DECISIONS, seed=seed))
        for epochs in (int(e) for e in args.epochs.split(",")):
            for rounds in (int(r) for r in args.rounds.split(",")):
                local = MLPTrainConfig(**dict(chip_smoke.FED4_LOCAL_CFG,
                                              epochs=epochs, seed=seed))
                with tempfile.TemporaryDirectory() as journal:
                    coord = FederationCoordinator(
                        [LocalClusterEndpoint(ds, local, args.device)
                         for ds in datasets], journal,
                        FederationConfig(fed=FederatedConfig(
                            local=local, rounds=rounds),
                            quorum=len(datasets)), device=args.device)
                    t0 = time.perf_counter()
                    maes = []
                    for _ in range(rounds):
                        coord.run_round()
                        maes.append(coord.result().mae)
                    seconds = time.perf_counter() - t0
                train_y = np.concatenate([ep._train_y
                                          for ep in coord.endpoints])
                hold_y = coord.holdout[1]
                n_fit = min(len(ep._train_y) for ep in coord.endpoints)
                n_fit -= int(n_fit * local.eval_fraction)
                print(json.dumps({
                    "epochs": epochs, "rounds": rounds, "seed": seed,
                    "holdout_mae": maes[-1], "round_maes": maes,
                    "train_mean_mae": float(np.abs(
                        hold_y - train_y.mean()).mean()),
                    "steps_per_fit": epochs * max(
                        n_fit // min(local.batch_size, n_fit), 1),
                    "seconds": seconds}), flush=True)
    if args.device == "cuda":
        print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
