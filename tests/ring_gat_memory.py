"""One GraphTransformer train step's peak memory on the CPU, ring mode
with the rows sharded over two gloo ranks against gather mode's two
data-parallel ranks (each of which holds the whole graph): the port's
counterpart of tests/test_gat.py::TestScale::test_ring_memory_below_gather.

    python3 tests/ring_gat_memory.py [--hosts 8000] [--probes 200000]

Each rank builds the trainer at config #3's widths (hidden 128, embed
64, 2 layers, 4 heads, neighbor cap 64, chunk 1024, batch 8192, bf16),
takes one step to warm up, then one step under ``torch.profiler`` with
``profile_memory``; the step's peak is the largest "Total Allocated" of
the profiler's memory events above the allocation at the step's start.
Prints one JSON line a mode with each rank's peak in MB.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2


def _peak_above_start(trace_path: str) -> float:
    """Bytes: the largest "Total Allocated" in the trace's memory events
    above the first one's."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    totals = [e["args"]["Total Allocated"] for e in sorted(
        (e for e in events if e.get("name") == "[memory]"),
        key=lambda e: e["ts"])]
    return float(max(totals) - totals[0]) if totals else 0.0


def _rank(rank: int, mode: str, hosts: int, probes: int, store: str,
          out: str) -> None:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from dragonfly2_tpu_torch.data import SyntheticCluster
    from dragonfly2_tpu_torch.train.gat_trainer import (
        GATTrainConfig,
        GATTrainer,
    )

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=WORLD, rank=rank)
    try:
        graph = SyntheticCluster(n_hosts=hosts, seed=0).probe_graph(probes)
        trainer = GATTrainer(graph, GATTrainConfig(
            hidden=128, embed=64, layers=2, heads=4, neighbor_cap=64,
            chunk=1024, edge_batch_size=8192, eval_fraction=0.02, epochs=1,
            attention=mode), "cpu")
        order = np.random.default_rng(0).permutation(trainer.train_ids)
        trainer.step(order[:trainer.batch])
        with profile(activities=[ProfilerActivity.CPU],
                     profile_memory=True) as prof:
            trainer.step(order[trainer.batch:2 * trainer.batch])
        trace = f"{out}.trace.json"
        prof.export_chrome_trace(trace)
        peak = _peak_above_start(trace)
        os.remove(trace)
        with open(out, "w") as fh:
            json.dump({"rank": rank, "rows": int(trainer.g_nbr.shape[0]),
                       "peak_mb": peak / 1e6}, fh)
    finally:
        dist.destroy_process_group()


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--hosts", type=int, default=8000)
    parser.add_argument("--probes", type=int, default=200_000)
    args = parser.parse_args()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        for mode in ("ring", "gather"):
            store = os.path.join(tmp, f"{mode}.store")
            outs = [os.path.join(tmp, f"{mode}{r}.json")
                    for r in range(WORLD)]
            procs = [ctx.Process(target=_rank, args=(
                r, mode, args.hosts, args.probes, store, outs[r]))
                for r in range(WORLD)]
            for proc in procs:
                proc.start()
            for proc in procs:
                proc.join(1800)
            if any(proc.exitcode != 0 for proc in procs):
                print(f"{mode}: a rank failed", file=sys.stderr)
                return 1
            ranks = [json.load(open(path)) for path in outs]
            print(json.dumps({"mode": mode, "hosts": args.hosts,
                              "probes": args.probes, "world": WORLD,
                              "device": "cpu", "ranks": ranks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
