"""Counts the work of K1 (``graph_flash_attention``) on the serving path's
graph, on the CPU: how many neighbor slots a row holds, the bytes of K and
V rows one launch gathers, and how many of the ids in a block of 64 rows
are distinct (the reuse a tiled design could exploit).

    python3 tests/k1_gather_traffic.py [--launch-ms 0.1077]

The graph is config #3's (``SyntheticCluster(20_000, seed=0)
.probe_graph(500_000)``, neighbor cap 64) and the layout the serving
path's [N, 4, 32] bf16 K and V; ``--launch-ms`` (a K1 time measured on the
card) turns the gathered bytes into a rate. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_HOSTS, N_EDGES, CAP = 20_000, 500_000, 64   # chip_smoke.py's config #3
HEADS, HEAD_DIM, ELEMENT_BYTES = 4, 32, 2
BLOCK_ROWS = 64


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--launch-ms", type=float, default=None)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    from dragonfly2_tpu_torch.data import SyntheticCluster
    from dragonfly2_tpu_torch.models.graph_transformer import (
        build_neighbor_lists,
    )

    graph = SyntheticCluster(n_hosts=N_HOSTS, seed=0).probe_graph(N_EDGES)
    nbr, _ = build_neighbor_lists(graph.n_nodes, graph.edge_src,
                                  graph.edge_dst, graph.edge_rtt_ns, cap=CAP)
    valid = (nbr >= 0) & (nbr < graph.n_nodes)
    slots = valid.sum(1)
    row_bytes = HEADS * HEAD_DIM * ELEMENT_BYTES
    gathered = int(slots.sum()) * 2 * row_bytes          # a K and a V row
    distinct, total = 0, 0
    for start in range(0, nbr.shape[0], BLOCK_ROWS):
        ids = nbr[start:start + BLOCK_ROWS][valid[start:start + BLOCK_ROWS]]
        distinct += len(np.unique(ids))
        total += len(ids)
    out = {"rows": int(nbr.shape[0]), "cap": CAP,
           "slots_mean": float(slots.mean()),
           "slots_p5_p95": [float(np.percentile(slots, 5)),
                            float(np.percentile(slots, 95))],
           "gathered_kv_bytes": gathered,
           "distinct_ids_in_64_row_blocks": distinct / total}
    if args.launch_ms:
        out["gathered_bytes_per_s"] = gathered / (args.launch_ms * 1e-3)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
