"""The ML loop's collection-half phase of ``chip_smoke.py`` (probe_loop)
on the card without the rest of the script: the kernels built from
``dragonfly2_tpu_torch/ops/csrc/`` in parallel, then ``run_probe_loop``
through the script's own function.

    python3 tests/probe_loop_alone.py

Needs one CUDA card. Prints the build's seconds, the phase's JSON line,
its launch counts and seconds, and the card's name and power limit.
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
        print("probe_loop_alone: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
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
    t0 = time.perf_counter()
    launches = smoke.run_probe_loop(torch, smoke.Counts())
    print(json.dumps({"build_seconds": build_s, "probe_loop_launches":
                      launches, "seconds": time.perf_counter() - t0}),
          flush=True)
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
