"""The replay plane's recording-half phases of ``chip_smoke.py`` on the
card without the rest of the script: config #1's MLP and the cost model
trained as the script trains them (``run_train_mlp``,
``run_train_cost``), then swarm_record, replay_ab, swarm_ladder and
recorder_overhead, through the script's own functions.

    python3 tests/recording_alone.py

Needs one CUDA card. Prints each phase's JSON line and its seconds, the
replay_ab path's launch counts, and the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("recording_alone: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from dragonfly2_tpu_torch.data import SyntheticCluster
    from dragonfly2_tpu_torch.train.checkpoint import mlp_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"python": sys.version, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "cpus": os.cpu_count()}),
          flush=True)
    print(smoke.nvidia_smi(), flush=True)
    counts = smoke.Counts()
    mlp_x, mlp_y = SyntheticCluster(
        n_hosts=smoke.MLP_HOSTS, seed=smoke.SEED).pair_example_columns(
        smoke.MLP_ROWS)
    result = smoke.run_train_mlp(torch, mlp_x, mlp_y, counts)[1]
    mlp_artifact = smoke.mlp_artifact(
        mlp_tree(result.params, result.normalizer, result.target_norm),
        "mlp", result.config.hidden, {"mse": result.mse, "mae": result.mae})
    cost_artifact = smoke.run_train_cost(torch, mlp_x, mlp_y, counts)[0]
    tmp = tempfile.mkdtemp(prefix="recording-alone-")
    seconds = {}
    try:
        t0 = time.perf_counter()
        smoke.run_swarm_record(torch, tmp, mlp_artifact, cost_artifact,
                               counts)
        seconds["swarm_record"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        launches = smoke.run_replay_ab_phase(torch, counts)
        seconds["replay_ab"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        smoke.run_swarm_ladder_phase()
        seconds["swarm_ladder"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        smoke.run_recorder_overhead_phase()
        seconds["recorder_overhead"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"replay_ab_launches": launches, "seconds": seconds,
                      "total_seconds": sum(seconds.values())}), flush=True)
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
