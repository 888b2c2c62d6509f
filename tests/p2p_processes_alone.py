"""Config #5 as processes on the card without the rest of
``chip_smoke.py``: the inference child over the trained-shape MLP, then
hbm_fanout (in process) and p2p_processes (a ``cmd.scheduler``, two
``cmd.dfdaemon`` children and ``cmd.dfget``) through the script's own
functions, after a line on the machine (Python, torch, CUDA, free disk
under the temp dir and the checkout, CPUs).

    python3 tests/p2p_processes_alone.py [--skip-in-process]

Needs one CUDA card and about 25 GB of free disk under the temp dir.
Prints each phase's JSON line and its seconds, the launch counts of the
paths, and the card's name and power limit. The MLP is config #1's
width with seeded random weights (the script trains it; its scores are
not what this checks).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def seeded_mlp_artifact(smoke, torch) -> bytes:
    """Config #1's MLP (hidden 128, 128, 64) with seeded weights, fitted
    normalizers on seeded features, as a registry artifact."""
    import numpy as np

    from dragonfly2_tpu_torch.models.mlp import (
        FEATURE_DIM,
        MLPBandwidthPredictor,
        Normalizer,
    )
    from dragonfly2_tpu_torch.train.checkpoint import (
        ModelMetadata,
        flax_from_mlp_state_dict,
        mlp_tree,
        write_artifact,
    )

    rng = np.random.default_rng(smoke.SEED)
    features = rng.uniform(0, 100, (4096, FEATURE_DIM)).astype(np.float32)
    mlp = MLPBandwidthPredictor(
        generator=torch.Generator().manual_seed(smoke.SEED))
    return write_artifact(
        mlp_tree(flax_from_mlp_state_dict(mlp.state_dict()),
                 Normalizer.fit(features),
                 Normalizer(np.array([2.5], np.float32),
                            np.array([0.7], np.float32))),
        ModelMetadata(model_id="alone-mlp", model_type="mlp",
                      config={"hidden": [128, 128, 64]}))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--skip-in-process", action="store_true",
                        help="run p2p_processes without hbm_fanout first")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("p2p_processes_alone: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    smoke = load_smoke()
    print(json.dumps({
        "python": sys.version, "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "tmp_free": shutil.disk_usage(tempfile.gettempdir()).free,
        "root_free": shutil.disk_usage(ROOT).free,
        "cpus": os.cpu_count()}), flush=True)
    print(smoke.nvidia_smi(), flush=True)
    card = torch.device("cuda", 0)
    counts = smoke.Counts()
    origin = smoke.FanoutOrigin()
    sidecar = None
    out = {}
    try:
        sidecar = smoke.P2PSidecar(seeded_mlp_artifact(smoke, torch))
        if not args.skip_in_process:
            t0 = time.perf_counter()
            out["hbm_fanout"] = smoke.run_hbm_fanout(torch, counts, card,
                                                     origin)
            print("hbm_fanout seconds", time.perf_counter() - t0, flush=True)
        t0 = time.perf_counter()
        out["p2p_processes"] = smoke.run_p2p_processes(
            torch, counts, card, origin, sidecar)
        print("p2p_processes seconds", time.perf_counter() - t0, flush=True)
    finally:
        if sidecar is not None:
            sidecar.close()
        origin.close()
    print(json.dumps({"launches": out}), flush=True)
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
