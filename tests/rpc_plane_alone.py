"""The RPC-plane phase of ``chip_smoke.py`` (rpc_plane) on the card
without the rest of the script: the kernels built from
``dragonfly2_tpu_torch/ops/csrc/`` in parallel, the two serving commands
started as children, config #3's seeded gather- and blocks-mode
artifacts and the seeded MLP artifact made as the script's main path
makes them, then ``run_rpc_plane`` through the script's own function.
``--with-mlguard`` runs the script's mlguard phase (the guard rung over
the wire) after it.

    python3 tests/rpc_plane_alone.py [--with-mlguard]

Needs one CUDA card. Prints the build's seconds, the phases' JSON lines,
their launch counts and seconds, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from manager_plane_alone import load_smoke, smoke_artifacts


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--with-mlguard", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("rpc_plane_alone: no CUDA device", file=sys.stderr)
        return 2
    smoke = load_smoke()
    from dragonfly2_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"python": sys.version, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "cpus": os.cpu_count()}),
          flush=True)
    print(smoke.nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    children = smoke.ServingChildren()
    try:
        artifacts, mlp_artifact = smoke_artifacts(torch, smoke)
        t0 = time.perf_counter()
        launches = smoke.run_rpc_plane(torch, artifacts, mlp_artifact,
                                       smoke.Counts(), children)
        out = {"build_seconds": build_s, "rpc_plane_launches": launches,
               "seconds": time.perf_counter() - t0}
    finally:
        children.stop()
    if args.with_mlguard:
        t0 = time.perf_counter()
        out["mlguard_launches"] = smoke.run_mlguard(torch, smoke.Counts())
        out["mlguard_seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
