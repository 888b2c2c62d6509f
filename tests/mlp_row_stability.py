#!/usr/bin/env python3
"""Is the MLP forward row-stable? Row i's output must not depend on the
batch shape or on the rows beside it: ``ParentScorer.score_corpus``
promises each row bit-identical to ``score`` on any sub-batch.

For config #1's model (hidden (128, 128, 64), seeded weights) and
300 000 seeded feature rows, at every row count M in 8, 16, …, 4096 (the
JAX package's request buckets and corpus chunks), in bf16 and f32:

- each Dense layer alone (``F.linear`` on the layer's real inputs) and
  the whole model: how many rows differ from the same rows computed at
  M = 4096;
- ``ParentScorer``, whose every forward runs at ``max_batch`` rows: how
  many rows of ``score`` on sub-batches of each request size, and of
  ``score_corpus`` on the shuffled corpus, differ from ``score_corpus``;
  and the p50 of a 15-row ``score`` at max_batch 16 (the smallest block
  holding it: what a bucketed scorer would run) and 64 (the default),
  host clock, the cost of the one shape.

Prints one JSON line. Run on the card from the repository root:

    python3 tests/mlp_row_stability.py            # cuda
    python3 tests/mlp_row_stability.py --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 300_000
ROW_COUNTS = [8 << i for i in range(10)]       # 8 … 4096
REQUEST_ROWS = (1, 8, 15, 16, 17, 32, 33, 64)


def differing_rows(torch, fn, x, m: int, ref) -> int:
    """Rows of fn over x in pieces of m rows (the tail zero-padded to m)
    that differ anywhere from ref."""
    n = len(x)
    pad = torch.zeros((-n) % m, *x.shape[1:], dtype=x.dtype,
                      device=x.device)
    xs = torch.cat([x, pad])
    out = torch.cat([fn(xs[s:s + m]) for s in range(0, len(xs), m)])[:n]
    return int((out != ref).reshape(n, -1).any(1).sum())


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--rows", type=int, default=ROWS)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import torch.nn.functional as F

    from dragonfly2_tpu_torch.data import SyntheticCluster
    from dragonfly2_tpu_torch.inference.scorer import ParentScorer
    from dragonfly2_tpu_torch.models.mlp import (
        MLPBandwidthPredictor,
        Normalizer,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    X, y = SyntheticCluster(n_hosts=2000, seed=0).pair_example_columns(
        args.rows)
    norm = Normalizer.fit(X)
    target = Normalizer.fit(np.log1p(y)[:, None])
    report = {"device": (torch.cuda.get_device_name(0)
                         if dev.type == "cuda" else "cpu"),
              "torch": torch.__version__, "rows": args.rows}
    for dtype in (torch.bfloat16, torch.float32):
        model = MLPBandwidthPredictor(
            dtype=dtype, generator=torch.Generator().manual_seed(0)).to(dev)
        name = str(dtype).split(".")[-1]
        with torch.no_grad():
            h = torch.from_numpy(norm(X)).to(dev)
            layers = {}
            for i in range(model.n_layers):
                dense = getattr(model, f"Dense_{i}")
                fn = (lambda d: lambda a: F.linear(
                    a, d.weight.to(dtype), d.bias.to(dtype)))(dense)
                inp = h.to(dtype)
                ref = fn(inp)
                layers[f"Dense_{i}"] = {
                    m: differing_rows(torch, fn, inp, m, ref)
                    for m in ROW_COUNTS}
                h = ref if i == model.n_layers - 1 else F.gelu(
                    ref, approximate="tanh")
            x = torch.from_numpy(norm(X)).to(dev)
            whole_ref = torch.cat([model(x[s:s + 4096])
                                   for s in range(0, len(x), 4096)])
            whole = {m: differing_rows(torch, model, x, m, whole_ref)
                     for m in ROW_COUNTS}
        scorer = ParentScorer(model, norm, target, device=dev)
        rng = np.random.default_rng(1)
        corpus = scorer.score_corpus(X)
        perm = rng.permutation(args.rows)
        rows_diff = {"corpus_shuffled": int(
            (scorer.score_corpus(X[perm]) != corpus[perm]).sum())}
        sample = perm[:1024]
        for n in REQUEST_ROWS:
            got = np.concatenate([scorer.score(X[sample[s:s + n]])
                                  for s in range(0, len(sample), n)])
            rows_diff[f"score_{n}_rows"] = int((got != corpus[sample]).sum())
        p50 = {}
        for block in (16, 64):
            small = ParentScorer(model, norm, target, max_batch=block,
                                 device=dev)
            p50[block] = small.benchmark(batch=15, iters=500)["p50_ms"]
        report[name] = {"layer_rows_differing_vs_4096": layers,
                        "model_rows_differing_vs_4096": whole,
                        "scorer_rows_differing": rows_diff,
                        "score_15_rows_p50_ms_by_block": p50}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
