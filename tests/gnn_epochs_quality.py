"""How many epochs config #2's GraphSAGE needs: trains it at chip_smoke's
settings (``chip_smoke.GNN_CFG``) for each (epochs, seed) asked and
prints F1, precision, recall, accuracy and the loss of every epoch.

    python3 tests/gnn_epochs_quality.py [--epochs 1,2,3,4] [--seeds 0,1,2]

Needs one CUDA card. The run's schedule (warmup, cosine decay) follows
the epochs, so each (epochs, seed) is its own run. Prints one JSON line
a run.
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
    parser.add_argument("--epochs", default="1,2,3,4")
    parser.add_argument("--seeds", default="0,1,2")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gnn_epochs_quality: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from dragonfly2_tpu_torch.data import SyntheticCluster
    from dragonfly2_tpu_torch.train.gnn_trainer import (
        GNNTrainConfig,
        train_gnn,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    graph = SyntheticCluster(n_hosts=chip_smoke.GNN_HOSTS,
                             seed=chip_smoke.SEED).probe_graph(
        chip_smoke.GNN_EDGES)
    card = chip_smoke.nvidia_smi()
    for epochs in (int(e) for e in args.epochs.split(",")):
        for seed in (int(s) for s in args.seeds.split(",")):
            cfg = GNNTrainConfig(**dict(chip_smoke.GNN_CFG, epochs=epochs,
                                        seed=seed, max_seconds=None))
            t0 = time.perf_counter()
            result = train_gnn(graph, cfg)
            print(json.dumps({
                "epochs": epochs, "seed": seed, "f1": result.f1,
                "precision": result.precision, "recall": result.recall,
                "accuracy": result.accuracy, "history": result.history,
                "samples_per_sec": result.samples_per_sec,
                "seconds": time.perf_counter() - t0, "card": card}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
