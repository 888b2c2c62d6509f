#!/usr/bin/env python3
"""Is the GraphTransformer pair scorer's edge head row-stable across
request buckets? A coalesced micro-batcher dispatch can land in a larger
bucket than the same request alone, so a pair's logit must not depend
on the bucket it is padded to.

For config #3's model (20 000 hosts, hidden 128, embed 64, 2 layers, 4
heads; seeded weights, bf16) in gather mode, 4096 seeded (src, dst)
pairs are scored through ``GATParentScorer._forward`` zero-padded to
every bucket 8, 16, 32, 64 (and 1 … 64 rows a request), and each
bucket's logits are compared with the same pairs at 64 rows: how many
pairs differ, and the largest difference. Also the p50 of a 12-row
``score`` at max_batch 16 and at 64 (the cost of one shape).

Prints one JSON line. Run on the card from the repository root:

    python3 tests/gat_bucket_stability.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_HOSTS, N_EDGES = 20_000, 500_000
PAIRS = 4096


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from dragonfly2_tpu_torch.data import SyntheticCluster
    from dragonfly2_tpu_torch.inference.scorer import GATParentScorer
    from dragonfly2_tpu_torch.models.graph_transformer import (
        GraphTransformer,
        build_neighbor_lists,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    graph = SyntheticCluster(n_hosts=N_HOSTS, seed=0).probe_graph(N_EDGES)
    nbr, val = build_neighbor_lists(graph.n_nodes, graph.edge_src,
                                    graph.edge_dst, graph.edge_rtt_ns,
                                    cap=64)
    model = GraphTransformer(hidden=128, embed=64, layers=2, heads=4,
                             chunk=1024, attention="gather",
                             generator=torch.Generator().manual_seed(0))
    report = {"device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "pairs": PAIRS}
    for max_batch in (64, 16):
        scorer = GATParentScorer(model, graph.node_features, nbr, val,
                                 max_batch=max_batch)
        feats = np.random.default_rng(0).integers(
            0, N_HOSTS, (12, 2)).astype(np.int32)
        scorer.score(feats)
        times = []
        for _ in range(300):
            t0 = time.perf_counter()
            scorer.score(feats)
            times.append((time.perf_counter() - t0) * 1e3)
        report[f"score_12_rows_p50_ms_max_batch_{max_batch}"] = sorted(
            times)[150]
    scorer = GATParentScorer(model, graph.node_features, nbr, val,
                             max_batch=64)
    pairs = torch.from_numpy(np.random.default_rng(1).integers(
        0, N_HOSTS, (PAIRS, 2)).astype(np.int32))

    def logits(m: int) -> torch.Tensor:
        pad = torch.zeros((-PAIRS) % m, 2, dtype=torch.int32)
        p = torch.cat([pairs, pad])
        out = torch.cat([scorer._forward(p[s:s + m, 0].contiguous(),
                                         p[s:s + m, 1].contiguous())
                         for s in range(0, len(p), m)])[:PAIRS]
        return out.float().cpu()

    with torch.no_grad():
        ref = logits(64)
        by_bucket = {}
        for m in (1, 2, 4, 8, 12, 16, 24, 32, 48, 64):
            got = logits(m)
            by_bucket[m] = {"pairs_differing": int((got != ref).sum()),
                            "max_abs_diff": float((got - ref).abs().max())}
    report["vs_64_rows"] = by_bucket
    report["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
