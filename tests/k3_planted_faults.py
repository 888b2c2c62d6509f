"""Planted faults in the K3 kernels: shows that ``chip_smoke.py``'s K3
check fails a kernel that is wrong far from the causal diagonal.

    python3 tests/k3_planted_faults.py

Needs one CUDA card and nvcc. Writes copies of ``ops/csrc`` into a
temporary directory, each with one fault planted in the bf16 kernels'
source text, builds them (and the unmodified source) with ``ops/_build``'s
flags, all nvcc runs at once, and runs each library through the K3
wrapper at the Ulysses main path's shape ([32768, 8, 8] bf16, causal)
against the plain version in f32, as ``chip_smoke.check_k3`` does. Prints
one JSON line a variant: chip_smoke's row errors and limits, and the max
|err| check (5e-2 on out, 2e-2 on max |err| / max(max |ref|, 1) for the
gradients) that the row check replaced. Exits 1 unless the unmodified
source passes and every fault fails the row check.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, HEADS, HEAD_DIM = 32_768, 8, 8

# (name, kernel whose body is changed, the loop head, the line added
# after it). The bf16 kernels tile by 64 rows: at T = 32k a causal row
# reads 512 key tiles.
FAULTS = (
    ("fwd_drops_middle_key_tile", "fwd_mma_kernel(",
     "for (int kt = 0; kt <= last; ++kt) {",
     "if (kt == n_k / 2 && kt < last) continue;"),
    ("dq_drops_middle_key_tile", "dq_mma_kernel(",
     "for (int kt = 0; kt <= last; ++kt) {",
     "if (kt == n_k / 2 && kt < last) continue;"),
    ("dkdv_drops_last_query_tile", "dkdv_mma_kernel(",
     "for (int qi = causal ? k0 / QN : 0; qi < n_q; ++qi) {",
     "if (qi == n_q - 1 && qi > k0 / QN + 4) continue;"),
)
# The causal bound one key late in every kernel (the diagonal tiles).
VISIBLE = "return k_pos < t_len && (!causal || q_pos >= k_pos);"
VISIBLE_LATE = "return k_pos < t_len && (!causal || q_pos + 1 >= k_pos);"
# The check the row errors replaced: max |err| on out, and on the
# gradients max |err| / max(max |ref|, 1).
OLD_TOL = {"out": 5e-2, "grad": 2e-2}


def plant(source: str, kernel: str, loop: str, line: str) -> str:
    """``source`` with ``line`` put first in ``kernel``'s first ``loop``."""
    at = source.index(loop, source.index(kernel)) + len(loop)
    return source[:at] + "\n    " + line + source[at:]


def variants(source: str) -> dict:
    out = {"unmodified": source}
    for name, kernel, loop, line in FAULTS:
        out[name] = plant(source, kernel, loop, line)
    if source.count(VISIBLE) != 1:
        raise ValueError("the causal test is not where this script expects")
    out["causal_one_key_late"] = source.replace(VISIBLE, VISIBLE_LATE)
    return out


def build(tmp: str, sources: dict) -> dict:
    """Build every variant at once; returns {name: library path}."""
    from dragonfly2_tpu_torch.ops import _build

    nvcc, procs = _build.nvcc_path(), {}
    for name, text in sources.items():
        src = os.path.join(tmp, name)
        shutil.copytree(_build.CSRC, src)
        with open(os.path.join(src, "flash_attention.cu"), "w") as fh:
            fh.write(text)
        lib = os.path.join(tmp, f"{name}.so")
        procs[name] = (subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", lib,
             os.path.join(src, "flash_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        libs[name] = lib
    return libs


def old_errors(torch, got, ref) -> dict:
    out = float((got[0].float() - ref[0]).abs().max())
    grad = max(float((a.float() - b).abs().max() / b.abs().max().clamp_min(1))
               for a, b in zip(got[1:], ref[1:]))
    return {"out": out, "grad": grad,
            "passes": out <= OLD_TOL["out"] and grad <= OLD_TOL["grad"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k3_planted_faults: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from dragonfly2_tpu_torch.ops import _build

    # The module: the package exports the function under the same name.
    fa = importlib.import_module("dragonfly2_tpu_torch.ops.flash_attention")

    source = (_build.CSRC / "flash_attention.cu").read_text()
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    q, k, v, dout = (torch.randn(T, HEADS, HEAD_DIM, generator=gen,
                                 device="cuda").to(torch.bfloat16)
                     for _ in range(4))

    def plain(*a):
        return fa.chunked_attention(*a, block=512)

    # The old check's reference: the plain version's own gradients.
    old_ref = chip_smoke.k3_grads(torch, plain, *(x.float() for x in (
        q, k, v)), True, dout.float())
    tol = chip_smoke.K3_TOL["bf16"]
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp, variants(source))
        for name, path in libs.items():
            fa._flash_lib = lambda lib=fa.bind_flash_library(
                _build.open_library(path)): lib
            got = chip_smoke.k3_grads(torch, fa.flash_attention, q, k, v,
                                      True, dout)
            ref = chip_smoke.k3_reference(torch, plain, q, k, v, True, dout,
                                          got[0])
            errs = chip_smoke.k3_errors(torch, got, ref)
            passes = chip_smoke.k3_within(errs, tol)
            ok &= passes == (name == "unmodified")
            print(json.dumps({
                "variant": name, "passes_row_check": passes,
                "row_errors": errs, "row_tol": tol,
                "old_check": old_errors(torch, got, old_ref),
                "old_tol": OLD_TOL}), flush=True)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
