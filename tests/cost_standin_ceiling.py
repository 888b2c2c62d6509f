"""The best correlation any cost model can reach on chip_smoke's
stand-in cost corpus (``chip_smoke.cost_corpus``).

The stand-in's realized cost is ``PIECE_MB`` over one draw of the pair's
bandwidth, which carries a lognormal congestion factor (σ 0.35) that the
features do not see. This script replays ``pair_example_columns`` with
the same seed, keeping each pair's bandwidth before the congestion draw,
checks that the rows and labels are bit-identical to the port's, and
prints the Pearson correlation of the noiseless cost (the best
predictor, up to a constant factor) with the realized cost, on the raw
seconds scale, on log1p(seconds) (the scale the model regresses) and on
log(seconds) (the scale of the multiplicative noise, on which the
evaluator ranks and thresholds by ratios), over the corpus's examples.

    python3 tests/cost_standin_ceiling.py        # CPU, a few seconds
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np

    import chip_smoke
    from dragonfly2_tpu_torch.data import SyntheticCluster
    from dragonfly2_tpu_torch.data.synthetic import _LINK_BW
    from dragonfly2_tpu_torch.train.cost_trainer import (
        cost_examples_from_corpus,
    )

    class Recording(SyntheticCluster):
        def pair_bandwidth(self, parent, child):
            prox = self.hosts.proximity(child, parent)
            self.noiseless = np.minimum(self.hosts.upload_bw[parent],
                                        _LINK_BW[prox])
            return super().pair_bandwidth(parent, child)

    rec = Recording(n_hosts=chip_smoke.MLP_HOSTS, seed=chip_smoke.SEED)
    X, y = rec.pair_example_columns(chip_smoke.MLP_ROWS)
    X0, y0 = SyntheticCluster(n_hosts=chip_smoke.MLP_HOSTS,
                              seed=chip_smoke.SEED).pair_example_columns(
        chip_smoke.MLP_ROWS)
    if not (np.array_equal(X, X0) and np.array_equal(y, y0)):
        raise AssertionError("replayed rows differ from pair_example_columns")
    free, limit = X[:, 5].astype(np.float64), X[:, 6].astype(np.float64)
    best_mbps = rec.noiseless * np.clip(free / limit, 0.2, 1.0) / 1e6
    corpus = chip_smoke.cost_corpus(X, y)
    mask = (corpus.valid & (corpus.realized_n >= 1)
            & (corpus.realized_cost >= 0)).reshape(-1)
    cx, cost = cost_examples_from_corpus(corpus)
    best = (chip_smoke.PIECE_MB / best_mbps[:chip_smoke.COST_ROWS])[mask]
    print(json.dumps({
        "examples": len(cost),
        "ceiling_corr_raw": float(np.corrcoef(best, cost)[0, 1]),
        "ceiling_corr_log1p": float(np.corrcoef(np.log1p(best),
                                                np.log1p(cost))[0, 1]),
        "ceiling_corr_log": float(np.corrcoef(np.log(best),
                                              np.log(cost))[0, 1])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
