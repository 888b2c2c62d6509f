"""Times K3's bf16 forward on the "mma" route (head_dim <= 32) on one
CUDA card, beside SDPA, at the long-context shapes [32768, 8, 8] and
[32768, 8, 32] causal; optionally for several exponential splits.

    python3 tests/k3_forward_timing.py [--root DIR] [--poly-blocks 0,2,3,4]
        [--rounds 3]

``--root`` names the repository root whose ``dragonfly2_tpu_torch`` is
timed (default: this one), for example a ``git archive`` of another
commit unpacked into a directory that ``.gitignore`` lists; its kernels
build into its own ``ops/.build``. Compare two trees on one card by
running the script on each in turns (A, B, B, A) in one command. ``--poly-blocks`` also
builds ``flash_attention.cu`` with ``kPolyBlocks`` (how many of a key
tile's blocks of 8 keys take the polynomial exp2) set to each value at
every head_dim, into a temporary directory with ``ops/_build``'s flags,
and times every build in turns. Each build's output is held against the plain version in
f32 row by row (chip_smoke's out limit) and must be bit-identical across
two launches. Prints one JSON line a (build, shape) with the per-round
times and their median and the registers and spills ptxas reported for
the forward kernels it built, the SM clock and power draw sampled while
the tree's forward runs, and the card line from ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((32_768, 8, 8), (32_768, 8, 32))
POLY_RE = re.compile(r"constexpr int kPolyBlocks = [^;]+;")


def ptxas_forward(report: str) -> dict:
    """{kernel: "registers, spills"} for the forward kernels in a ptxas
    -v report (entry names hold "fwd")."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1) if "fwd" in m.group(1) else None
        elif name and ("registers" in line or "spill" in line):
            out.setdefault(name, []).append(
                line.split("ptxas info    :")[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def sample_under_load(torch, fn, samples: int = 8) -> list:
    """``nvidia-smi``'s SM clock and power draw, sampled while ``fn`` runs
    back to back."""
    import threading

    out = []

    def sample():
        for _ in range(samples):
            out.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip())

    thread = threading.Thread(target=sample)
    thread.start()
    while thread.is_alive():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    return out


def build_variants(tmp: str, values, build) -> dict:
    """{value: (library path, ptxas report)} for flash_attention.cu with
    kPolyBlocks = value, every nvcc started together."""
    if not values:
        return {}
    text = (build.CSRC / "flash_attention.cu").read_text()
    if len(POLY_RE.findall(text)) != 1:
        raise ValueError("kPolyBlocks is not where this script expects")
    procs = {}
    for value in values:
        src = os.path.join(tmp, f"poly{value}")
        shutil.copytree(build.CSRC, src)
        path = os.path.join(src, "flash_attention.cu")
        with open(path, "w") as fh:
            fh.write(POLY_RE.sub(f"constexpr int kPolyBlocks = {value};",
                                 text))
        lib = os.path.join(tmp, f"poly{value}.so")
        procs[value] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for value, (lib, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"kPolyBlocks = {value}: nvcc failed\n{report}")
        out[value] = (lib, report)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--poly-blocks", default="")
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)

    import importlib

    import torch

    if not torch.cuda.is_available():
        print("k3_forward_timing: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from dragonfly2_tpu_torch.ops import _build

    fa = importlib.import_module("dragonfly2_tpu_torch.ops.flash_attention")
    if not fa.__file__.startswith(root):
        raise RuntimeError(f"imported {fa.__file__}, not from {root}")

    reports = _build.build_all()
    builds = {"tree": (fa._flash_lib(), reports.get("flash_attention", {})
                       .get("ptxas", ""))}
    values = [int(x) for x in args.poly_blocks.split(",") if x]
    tmp = tempfile.mkdtemp()
    try:
        for value, (lib, report) in build_variants(tmp, values,
                                                   _build).items():
            builds[f"poly_blocks={value}"] = (
                fa.bind_flash_library(_build.open_library(lib)), report)
        gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
        inputs = {shape: [torch.randn(*shape, generator=gen, device="cuda")
                          .to(torch.bfloat16) for _ in range(3)]
                  for shape in SHAPES}
        refs = {shape: fa.chunked_attention(*(x.float() for x in qkv), True,
                                            block=512)
                for shape, qkv in inputs.items()}
        sdpa = torch.nn.functional.scaled_dot_product_attention
        times = {(b, s): [] for b in list(builds) + ["sdpa"] for s in SHAPES}
        checks = {}
        names = list(builds)
        for rnd in range(args.rounds):
            order = names if rnd % 2 == 0 else names[::-1]
            for shape in SHAPES:
                q, k, v = inputs[shape]
                for name in order:
                    lib = builds[name][0]
                    fa._flash_lib = lambda lib=lib: lib
                    if (name, shape) not in checks:
                        out, lse = fa.flash_forward(q, k, v, True)
                        again = fa.flash_forward(q, k, v, True)
                        ref = refs[shape]
                        err = chip_smoke.row_err(
                            torch, out, ref, chip_smoke.rms_row_norm(ref))
                        checks[name, shape] = {
                            "out_row_err": err,
                            "bit_identical": bool(
                                torch.equal(out, again[0])
                                and torch.equal(lse, again[1]))}
                    times[name, shape].append(chip_smoke.cuda_ms(
                        torch, lambda: fa.flash_forward(q, k, v, True),
                        iters=10, warmup=2))
                qh, kh, vh = (x.permute(1, 0, 2)[None].contiguous()
                              for x in (q, k, v))
                with torch.no_grad():
                    times["sdpa", shape].append(chip_smoke.cuda_ms(
                        torch, lambda: sdpa(qh, kh, vh, is_causal=True),
                        iters=10, warmup=2))
        # The card's clock and power draw while the tree's forward runs
        # back to back at the first shape.
        fa._flash_lib = lambda lib=builds["tree"][0]: lib
        q, k, v = inputs[SHAPES[0]]
        print(json.dumps({"under_load": sample_under_load(
            torch, lambda: fa.flash_forward(q, k, v, True))}), flush=True)
        ok = True
        tol = chip_smoke.K3_TOL["bf16"]["out"]
        for (name, shape), ms in times.items():
            med = statistics.median(ms)
            line = {"build": name, "root": root, "shape": list(shape),
                    "ms": ms, "ms_median": med}
            if name != "sdpa":
                sdpa_med = statistics.median(times["sdpa", shape])
                check = checks[name, shape]
                ok &= check["bit_identical"] and check["out_row_err"] <= tol
                line |= {"x_sdpa": med / sdpa_med, **check, "out_tol": tol,
                         "ptxas_forward": ptxas_forward(builds[name][1])}
            print(json.dumps(line), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
