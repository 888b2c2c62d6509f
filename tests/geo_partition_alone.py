"""The geo bench's site-partition chaos rung
(``client/geobench.py``: ``run_geo_partition_rung``) alone on the machine
that holds the card, outside ``chip_smoke.py``: the victim site's links
are partitioned mid-swarm, the surviving sites must finish every
download, and after the heal the victim must resume from its persisted
pieces within ``RESUME_BOUND_S`` (90 s) — a rung that may take that long
by design. No kernel runs in it.

    python3 tests/geo_partition_alone.py [--seed N]

Prints the rung's JSON report and its seconds, then the card's name and
power limit where ``nvidia-smi`` answers; exits 0 when the rung's
verdict holds, else 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    from dragonfly2_tpu_torch.client import geobench

    t0 = time.perf_counter()
    report = geobench.run_geo_partition_rung(seed=args.seed)
    print(json.dumps({"report": report,
                      "seconds": time.perf_counter() - t0}, default=str),
          flush=True)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(smi.stdout.strip() or "nvidia-smi: no card", flush=True)
    except OSError:
        print("nvidia-smi: not found", flush=True)
    return 0 if report.get("verdict_pass") else 1


if __name__ == "__main__":
    sys.exit(main())
