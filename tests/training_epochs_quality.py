"""How many epochs the training phase's graph jobs and MLP need on its
own data: builds ``chip_smoke.training_records()`` (the records the
phase writes as CSV segments), turns them into the probe graph and the
pair examples as ``Training`` does, and trains config #2's GraphSAGE,
config #3's GraphTransformer (blocks mode) and config #1's MLP at
chip_smoke's ``TRAINING_*_CFG`` for each (epochs, seed) asked. Prints
F1 (the graph jobs) or the eval MAE beside predicting the train split's
mean (the MLP), one JSON line a run.

    python3 tests/training_epochs_quality.py [--jobs gnn,gat,mlp]
        [--epochs 1,2,4,8] [--seeds 0,1,2] [--device cpu]

Runs on the CPU by default (the kernels' plain twins), or on the card
with ``--device cuda``. The schedule (warmup, cosine decay) follows the
epochs, so each (job, epochs, seed) is its own run.
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
    parser.add_argument("--jobs", default="gnn,gat,mlp")
    parser.add_argument("--epochs", default="1,2,4,8")
    parser.add_argument("--seeds", default="0,1,2")
    parser.add_argument("--device", default="cpu")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np

    import chip_smoke
    from dragonfly2_tpu_torch.data import ArrayDataset
    from dragonfly2_tpu_torch.data.features import (
        graph_from_table,
        pair_examples_from_table,
    )
    from dragonfly2_tpu_torch.schema import Download, NetworkTopology
    from dragonfly2_tpu_torch.schema.io import records_to_table
    from dragonfly2_tpu_torch.train.gat_trainer import (
        GATTrainConfig,
        train_gat,
    )
    from dragonfly2_tpu_torch.train.gnn_trainer import (
        GNNTrainConfig,
        train_gnn,
    )
    from dragonfly2_tpu_torch.train.mlp_trainer import (
        MLPTrainConfig,
        train_mlp,
    )

    card = None
    if args.device != "cpu":
        import torch

        # As chip_smoke runs the phase: no TF32 products.
        torch.backends.cuda.matmul.allow_tf32 = False
        card = chip_smoke.nvidia_smi()
    topology, downloads = chip_smoke.training_records()
    graph = graph_from_table(records_to_table(NetworkTopology, topology))
    X, y = pair_examples_from_table(records_to_table(Download, downloads))
    print(json.dumps({"n_nodes": graph.n_nodes, "n_edges": graph.n_edges,
                      "pair_examples": len(X)}), flush=True)
    jobs = {
        "gnn": (GNNTrainConfig, chip_smoke.TRAINING_GNN_CFG,
                lambda cfg: train_gnn(graph, cfg, args.device)),
        "gat": (GATTrainConfig, chip_smoke.TRAINING_GAT_CFG,
                lambda cfg: train_gat(graph, cfg, args.device)),
        "mlp": (MLPTrainConfig, chip_smoke.TRAINING_MLP_CFG,
                lambda cfg: train_mlp(X, y, cfg, args.device)),
    }
    for job in args.jobs.split(","):
        config_cls, base, train = jobs[job]
        for epochs in (int(e) for e in args.epochs.split(",")):
            for seed in (int(s) for s in args.seeds.split(",")):
                cfg = config_cls(**dict(base, epochs=epochs, seed=seed))
                t0 = time.perf_counter()
                result = train(cfg)
                line = {"job": job, "epochs": epochs, "seed": seed,
                        "history": result.history,
                        "seconds": time.perf_counter() - t0,
                        "device": args.device, "card": card}
                if job == "mlp":
                    train_ds, held = ArrayDataset(X, y).split(
                        cfg.eval_fraction, seed)
                    line |= {"mae": result.mae, "mse": result.mse,
                             "mean_mae": float(np.abs(
                                 held.arrays[1]
                                 - train_ds.arrays[1].mean()).mean())}
                else:
                    line |= {"f1": result.f1, "precision": result.precision,
                             "recall": result.recall,
                             "accuracy": result.accuracy}
                print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
