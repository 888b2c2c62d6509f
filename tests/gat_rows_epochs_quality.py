"""Does the training phase's GraphTransformer job leave the majority
plateau as soon with its rows sharded over ranks as in a world of one?
Builds ``chip_smoke.training_records()``'s probe graph as ``Training``
does and trains chip_smoke's ``TRAINING_GAT_CFG`` (config #3's widths,
blocks mode) for each (epochs, seed) asked, in this process (a world of
one) and on ``--ranks`` gloo ranks sharing the card (the rows sharded
over them, as the dp_train phase's ``Training`` runs it). Prints one
JSON line a run: F1, accuracy and the per-epoch losses.

    python3 tests/gat_rows_epochs_quality.py [--epochs 16,24,32]
        [--seeds 0,1,2] [--ranks 2]

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def graph():
    import chip_smoke
    from dragonfly2_tpu_torch.data.features import graph_from_table
    from dragonfly2_tpu_torch.schema import NetworkTopology
    from dragonfly2_tpu_torch.schema.io import records_to_table

    topology, _ = chip_smoke.training_records()
    return graph_from_table(records_to_table(NetworkTopology, topology))


def fit(epochs: int, seed: int) -> dict:
    import chip_smoke
    from dragonfly2_tpu_torch.train.gat_trainer import (
        GATTrainConfig,
        train_gat,
    )

    t0 = time.perf_counter()
    result = train_gat(graph(), GATTrainConfig(
        **dict(chip_smoke.TRAINING_GAT_CFG, epochs=epochs, seed=seed)))
    return {"f1": result.f1, "accuracy": result.accuracy,
            "history": result.history, "steps": len(result.step_losses),
            "seconds": time.perf_counter() - t0}


def rank_main(rank: int, world: int, address: str, runs, out_dir: str):
    """One gloo rank: every (epochs, seed) run over the default group."""
    import torch

    from dragonfly2_tpu_torch.parallel.multihost import init_multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    init_multihost(address, world, rank, backend="gloo")
    out = [dict(fit(epochs, seed), epochs=epochs, seed=seed)
           for epochs, seed in runs]
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--epochs", default="16,24,32")
    parser.add_argument("--seeds", default="0,1,2")
    parser.add_argument("--ranks", type=int, default=2)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gat_rows_epochs_quality: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.nvidia_smi(), flush=True)
    runs = [(int(e), int(s)) for s in args.seeds.split(",")
            for e in args.epochs.split(",")]
    for epochs, seed in runs:
        print(json.dumps(dict(fit(epochs, seed), world=1, epochs=epochs,
                              seed=seed)), flush=True)
    chip_smoke.release_card_memory(torch)
    with tempfile.TemporaryDirectory() as out_dir:
        address = f"localhost:{chip_smoke.free_port()}"
        chip_smoke.join_processes(chip_smoke.start_processes(
            [(rank_main, (rank, args.ranks, address, runs, out_dir))
             for rank in range(args.ranks)]), 1800, out_dir)
        with open(os.path.join(out_dir, "rank0.json")) as fh:
            for run in json.load(fh):
                print(json.dumps(dict(run, world=args.ranks)), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
