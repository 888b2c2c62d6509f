"""The edge phase of ``chip_smoke.py`` (edge) on the card without the
rest of the script: the kernels built from
``dragonfly2_tpu_torch/ops/csrc/`` in parallel, config #3's seeded
gather- and blocks-mode artifacts made as the script's main path makes
them, then ``run_edge`` through the script's own function.

    python3 tests/edge_alone.py

Needs one CUDA card. Prints the build's seconds, the phase's JSON line,
its launch counts and seconds, and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from manager_plane_alone import load_smoke, smoke_artifacts  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("edge_alone: no CUDA device", file=sys.stderr)
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
    artifacts = smoke_artifacts(torch, smoke)[0]
    t0 = time.perf_counter()
    launches = smoke.run_edge(torch, artifacts, smoke.Counts(),
                              torch.device("cuda", 0))
    print(json.dumps({"build_seconds": build_s, "edge_launches": launches,
                      "seconds": time.perf_counter() - t0}), flush=True)
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
