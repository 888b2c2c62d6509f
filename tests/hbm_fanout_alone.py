"""BASELINE config #5 on the card without the rest of ``chip_smoke.py``:
its two phases, hbm_sink_small and hbm_fanout, run through the script's
own functions, after a line on the machine (Python, torch, CUDA, g++,
free disk under the temp dir and the checkout, CPUs).

    python3 tests/hbm_fanout_alone.py

Needs one CUDA card and about 20 GB of free disk under the temp dir.
Prints each phase's JSON line and its seconds, the launch counts of the
fan-out's path, and the card's name and power limit.
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
        print("hbm_fanout_alone: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    print(json.dumps({
        "python": sys.version, "torch": torch.__version__,
        "cuda": torch.version.cuda, "gxx": shutil.which("g++"),
        "tmp_free": shutil.disk_usage(tempfile.gettempdir()).free,
        "root_free": shutil.disk_usage(ROOT).free,
        "cpus": os.cpu_count()}), flush=True)
    print(smoke.nvidia_smi(), flush=True)
    card = torch.device("cuda", 0)
    t0 = time.perf_counter()
    smoke.run_hbm_sink_small(torch, card)
    print("hbm_sink_small seconds", time.perf_counter() - t0, flush=True)
    t0 = time.perf_counter()
    launches = smoke.run_hbm_fanout(torch, smoke.Counts(), card)
    print("hbm_fanout seconds", time.perf_counter() - t0, flush=True)
    print(json.dumps({"hbm_fanout_launches": launches}), flush=True)
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
