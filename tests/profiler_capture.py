"""Does ``torch.profiler`` record the first kernels of a profiling
window? Runs one K2a launch (``table_gather``) in 20 windows started
plainly and in 20 that begin with a warm-up step whose events are
discarded (``schedule(wait=0, warmup=1, active=1)``, as chip_smoke's
``profiled_kernel_launches`` does), with the card's activity alone and
with the host's too, and counts the windows whose events hold the
launch; then 200 launches in one plain window.

    python3 tests/profiler_capture.py

Needs one CUDA card (the K2a kernel builds at first use). Prints one
line a case, then the card's name and power limit.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profiler_capture: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile, schedule

    import chip_smoke
    from dragonfly2_tpu_torch.ops.table_gather import table_gather

    table = torch.zeros(64, 16, device="cuda")
    idx = torch.arange(32, device="cuda", dtype=torch.int32)

    def kernel_names(prof):
        return [e.name() for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA]

    def plain(acts) -> bool:
        with profile(activities=acts) as prof:
            table_gather(table, idx)
            torch.cuda.synchronize()
        return any("table_gather_kernel" in n for n in kernel_names(prof))

    def warmed(acts) -> bool:
        got = []
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: got.extend(kernel_names(p))
                     ) as prof:
            torch.mm(table, table.T)
            torch.cuda.synchronize()
            prof.step()
            table_gather(table, idx)
            torch.cuda.synchronize()
            prof.step()
        return any("table_gather_kernel" in n for n in got)

    for label, acts in (("cuda", [ProfilerActivity.CUDA]),
                        ("cpu+cuda", [ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA])):
        print(label, "plain windows holding the launch:",
              sum(plain(acts) for _ in range(20)), "/ 20", flush=True)
        print(label, "warmed windows holding the launch:",
              sum(warmed(acts) for _ in range(20)), "/ 20", flush=True)
        with profile(activities=acts) as prof:
            for _ in range(200):
                table_gather(table, idx)
            torch.cuda.synchronize()
        print(label, "of 200 launches in one plain window, recorded:",
              sum("table_gather_kernel" in n for n in kernel_names(prof)),
              flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
