"""The learned evaluators' regret with JAX's trained weights, in both
packages, on the recorded A/B's corpus (``tests/test_torch_replay_ab.py``'s
runs: 300 profiled peers, one announce worker, no GC churn, seed 0): JAX's
own A/B in bf16, the port through the sidecar's loaders in bf16, and both
packages in f32, with each run's decision digest.

    JAX_PLATFORMS=cpu python3 tests/replay_ab_regret_gap.py   # CPU, ~40 s
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import conftest  # noqa: F401 — JAX on the CPU, as the tests run it
    import torch

    import test_torch_replay_ab as ab

    torch.set_num_threads(1)
    runs = ab.record_both()
    out, to_close = ab.replay_jax_models(runs)
    for evaluator in to_close:
        evaluator.close()
    report = {}
    for name in ("ml", "cost"):
        runs_of = {"jax_bf16": runs["want"]["ab"], "port_bf16": out["bf16"],
                   "jax_f32": out["jax_f32"], "port_f32": out["f32"]}
        report[name] = {
            key: {"regret_mean_s": ab_run["evaluators"][name]["regret_mean_s"],
                  "rank_agreement_mean":
                      ab_run["evaluators"][name]["rank_agreement_mean"],
                  "digest": ab_run["evaluators"][name]["digest"][:16]}
            for key, ab_run in runs_of.items()}
        bf16 = report[name]
        report[name]["bf16_regret_gap_rel"] = (
            abs(bf16["port_bf16"]["regret_mean_s"]
                - bf16["jax_bf16"]["regret_mean_s"])
            / bf16["jax_bf16"]["regret_mean_s"])
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
