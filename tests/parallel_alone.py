"""The sequence, pipeline and expert parallelism phases of
``chip_smoke.py`` on the card without the rest of it: ring_gat_ranks,
ring_attention, pipeline_moe and parallel_nccl_cards, through the
script's own functions, on config #3's graph.

    python3 tests/parallel_alone.py

Needs one CUDA card (several for parallel_nccl_cards). Prints each
phase's JSON line, the launch counts of the three paths, their seconds,
and the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("parallel_alone: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    from dragonfly2_tpu_torch.data import SyntheticCluster

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smoke.nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    graph = SyntheticCluster(n_hosts=smoke.N_HOSTS,
                             seed=smoke.SEED).probe_graph(smoke.N_EDGES)
    print("graph seconds", time.perf_counter() - t0, flush=True)
    t0 = time.perf_counter()
    launches = smoke.run_parallel(torch, graph)
    print("parallel seconds", time.perf_counter() - t0, flush=True)
    print(json.dumps({"launches": launches}), flush=True)
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
