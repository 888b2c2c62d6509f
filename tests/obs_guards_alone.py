"""The observability stage's two overhead guards
(``client/obsbench.py``: ``run_tracing_overhead_guard``, the scheduler's
announce p99 with the tail-sampling tracer on against off, and
``run_loopback_overhead_guard``, the data plane's loopback MB/s with it
on against off), alone on the machine that holds the card, outside
``chip_smoke.py``: they are host benches in which no kernel runs, and
their bound (1.05 x) is a limit on the host.

    python3 tests/obs_guards_alone.py [--repeat N]

Prints each run's
JSON line with every repetition's p99 and MB/s, then the card's name
and power limit where ``nvidia-smi`` answers; exits 0 when every run
held both bounds, else 1.
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
    parser.add_argument("--repeat", type=int, default=1)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    from dragonfly2_tpu_torch.client import obsbench

    held = True
    for _ in range(args.repeat):
        t0 = time.perf_counter()
        announce = obsbench.run_tracing_overhead_guard()
        loopback = obsbench.run_loopback_overhead_guard()
        held = held and announce["within_bound"] and loopback["within_bound"]
        print(json.dumps({"cpus": os.cpu_count(),
                          "announce_guard": announce,
                          "loopback_guard": loopback,
                          "seconds": time.perf_counter() - t0}), flush=True)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(smi.stdout.strip() or "nvidia-smi: no card", flush=True)
    except OSError:
        print("nvidia-smi: not found", flush=True)
    return 0 if held else 1


if __name__ == "__main__":
    sys.exit(main())
