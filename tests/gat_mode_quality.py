"""Where config #3's training leaves its plateaus, by attention mode: trains
the GraphTransformer at chip_smoke's train settings in gather and blocks
mode for each (epochs, seed) asked and prints F1, accuracy and the loss
of every epoch.

    python3 tests/gat_mode_quality.py [--epochs 2,4,8] [--seeds 0]

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
    parser.add_argument("--epochs", default="2,4,8")
    parser.add_argument("--seeds", default="0")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gat_mode_quality: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from dragonfly2_tpu_torch.data import SyntheticCluster
    from dragonfly2_tpu_torch.train.gat_trainer import (
        GATTrainConfig,
        GATTrainer,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    graph = SyntheticCluster(n_hosts=chip_smoke.N_HOSTS,
                             seed=chip_smoke.SEED).probe_graph(
        chip_smoke.N_EDGES)
    for epochs in (int(e) for e in args.epochs.split(",")):
        for seed in (int(s) for s in args.seeds.split(",")):
            for mode in ("gather", "blocks"):
                cfg = GATTrainConfig(**dict(
                    chip_smoke.TRAIN_CFG, epochs=epochs, seed=seed,
                    max_seconds=None), attention=mode)
                t0 = time.perf_counter()
                result = GATTrainer(graph, cfg).fit()
                print(json.dumps({
                    "epochs": epochs, "seed": seed, "mode": mode,
                    "f1": result.f1, "accuracy": result.accuracy,
                    "history": result.history,
                    "seconds": time.perf_counter() - t0,
                    "card": chip_smoke.nvidia_smi()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
