"""The tensor-parallel phases of ``chip_smoke.py`` on the card without the
rest of it: tp_world_one, tp_grid (1 x 2 and 2 x 2 gloo grids on the one
card), tp_kernels, tp_nccl_cards and hbm_sink_sharded, through the
script's own functions, on config #3's graph.

    python3 tests/tp_alone.py

Needs one CUDA card (4 for tp_nccl_cards). Prints each phase's JSON
line, the tp_kernels figures and rank 0's launches of the 2 x 2 grid,
the seconds, and the card's name and power limit.
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
        print("tp_alone: no CUDA device", file=sys.stderr)
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
    rows = [{"name": name} for name in (
        "table_gather", "graph_flash_attention", "table_scatter_add",
        "graph_flash_attention_backward")]
    t0 = time.perf_counter()
    launches = smoke.run_tensor_parallel(torch, graph, rows)
    smoke.run_hbm_sink_sharded(torch, torch.device("cuda", 0))
    print("tensor parallel seconds", time.perf_counter() - t0, flush=True)
    print(json.dumps({"launches": launches, "kernels": rows}), flush=True)
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
