"""Times the K1 backward on one CUDA card, pass by pass, at config #3's
blocks-mode shapes (the graph of ``tests/k1_planted_faults.py``: 20 480
rows, K = 64, [N, 4, 32] bf16, its inverse index), beside the K1 forward
with lse, and reports each pass's gathered-byte rate.

    python3 tests/k1_backward_timing.py [--root DIR] [--variants a,b]
        [--rounds 3]

``--root`` names the repository root whose ``dragonfly2_tpu_torch`` is
timed (default: this one), for example a ``git archive`` of another
commit unpacked into a directory that ``.gitignore`` lists. The script
drives the tree through ``graph_backward_scratch`` and
``launch_graph_backward(..., parts)``, so it times any tree that has
them. ``--variants`` also builds the tree's ``graph_flash_attention.cu``
with each named edit of ``VARIANTS`` planted, every nvcc at once, and
times every build in turns (tree, variants, then the reverse order).
The edits are experiments on the cost of one part of a pass; they may
give wrong gradients, so only the tree's build is held to the plain
twin (``chip_smoke.k1_backward_case``). An edit whose text is not in the
tree's source stops the script.

Gathered bytes: the forward and the dQ pass gather a k and a v row a
valid slot, the dK/dV pass a q and a dO row a position of the inverse
index (one a valid slot). Prints one JSON line a build with the
per-round times, their medians, the rates, and for the config #3
instances the registers ptxas reported and the static count of SASS
instructions by opcode (``cuobjdump``), then the card line from
``nvidia-smi`` and ``{"ok": ...}``.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = "graph_flash_attention.cu"

# variant: [(kernel whose body is changed, text there, its replacement)].
VARIANTS = {
    # The scratch design's dK/dV pass reads each position's p and ds from
    # the key row's own 16 bytes (L2-hot) instead of the position's.
    "scratch_reads_hot": [(
        "graph_flash_dkdv_kernel(",
        "        pp[u] = p_scr[pos * heads + head];\n"
        "        dd[u] = ds_scr[pos * heads + head];\n",
        "        pp[u] = p_scr[c * heads + head];\n"
        "        dd[u] = ds_scr[c * heads + head];\n")],
    # The scratch design's dK/dV pass finds a position's row with a 32-bit
    # division instead of a 64-bit one.
    "row_div_32bit": [(
        "graph_flash_dkdv_kernel(",
        "        const long long i = pos / kw;\n",
        "        const long long i = static_cast<unsigned>(pos) /\n"
        "                            static_cast<unsigned>(kw);\n")],
    # Positions (or slots) in flight a warp at 4 elements a lane: 16, not 8,
    # in every kernel.
    "unroll16": [(
        "constexpr int unroll()",
        "return E <= 4 ? 8 :", "return E <= 4 ? 16 :")],
    # Costs of the recomputing passes, each taken out (wrong gradients):
    # the split sums' shuffles, the exponential (both passes).
    "no_split_shuffles": [
        ("float split_sum(",
         "x[j] = keep + __shfl_xor_sync(kFull, give, off);",
         "x[j] = keep + give;"),
        ("float split_sum(",
         "sum += __shfl_xor_sync(kFull, sum, off);", "sum += sum;")],
    "no_exp": [(
        "void pair_terms(",
        "p = expf(__fmaf_rn(s, scale, bias) - lse);",
        "p = __fmaf_rn(s, scale, bias) - lse;")],
}
# The bf16 instances at 4 elements a lane (config #3's [N, 4, 32] rows),
# the backward's with 8 pairs a split sum.
CONFIG3_INSTANCE = re.compile(r"13__nv_bfloat16Li4E(Li8E)?E")


def registers(report: str) -> dict:
    """{kernel: ptxas's registers and spills line} for the config #3
    instances in a ptxas -v report."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1) if CONFIG3_INSTANCE.search(m.group(1)) else None
        elif name and ("registers" in line or "spill" in line):
            kernel = re.search(r"graph_flash_\w*?kernel", name).group(0)
            out.setdefault(kernel, []).append(
                line.split("ptxas info    :")[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def sass_opcodes(lib: str, nvcc: str) -> dict:
    """{kernel: {"total": n, opcode: n, ...}} for the config #3 instances
    of a built library, from ``cuobjdump -sass`` beside ``nvcc`` (empty
    without it)."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=120).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if CONFIG3_INSTANCE.search(m.group(1)) else None
            if name:
                name = re.search(r"graph_flash_\w*?kernel", name).group(0)
                out[name] = {"total": 0}
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     line)
        if name and m:
            op = m.group(1)
            out[name]["total"] += 1
            out[name][op] = out[name].get(op, 0) + 1
    return {k: dict(sorted(v.items(), key=lambda kv: -kv[1])[:14])
            for k, v in out.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--variants", default="")
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)
    sys.path.insert(2, os.path.join(HERE, "tests"))

    import torch

    if not torch.cuda.is_available():
        print("k1_backward_timing: no CUDA device", file=sys.stderr)
        return 2
    # This tree's chip_smoke (the --root tree's may be older).
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = chip_smoke
    spec.loader.exec_module(chip_smoke)
    import k1_planted_faults as faults
    from dragonfly2_tpu_torch.ops import _build

    fa = importlib.import_module("dragonfly2_tpu_torch.ops.flash_attention")
    if not fa.__file__.startswith(root):
        raise RuntimeError(f"imported {fa.__file__}, not from {root}")
    names = [x for x in args.variants.split(",") if x]
    source = (_build.CSRC / SOURCE).read_text()
    texts = {"tree": source}
    texts.update({name: faults.plant(source, VARIANTS[name])
                  for name in names})

    inputs, nbr, val, inv = faults.blocks_inputs(torch)
    q, k, v, dout = (t.to(torch.bfloat16) for t in inputs)
    n_valid = int(((nbr >= 0) & (nbr < k.shape[0])).sum())
    row_bytes = q.shape[1] * q.shape[2] * q.element_size()
    gathered = 2 * n_valid * row_bytes
    times = {name: {"fwd": [], "dq": [], "dkdv": [], "bwd": []}
             for name in texts}
    ok = True
    reports = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = faults.build(tmp, texts, reports)
        sass = {name: sass_opcodes(path, _build.nvcc_path())
                for name, path in paths.items()}
        libs = {name: fa.bind_graph_library(_build.open_library(path))
                for name, path in paths.items()}
        fa._lib = lambda: libs["tree"]
        errs, same, finite, _ = chip_smoke.k1_backward_case(
            torch, q, k, v, dout, nbr, val, inv)
        ok = same and finite and chip_smoke.k1_within(
            errs, chip_smoke.K1_TOL["bf16"])
        _, lse = fa.graph_flash_forward(q, k, v, nbr, val, True)
        grads = [torch.empty_like(t) for t in (q, k, v)]
        grads.append(torch.empty_like(val))
        try:
            scratch = fa.graph_backward_scratch(q)
        except TypeError:  # trees whose scratch is sized by nbr
            scratch = fa.graph_backward_scratch(q, nbr)
        order = list(texts)
        for rnd in range(args.rounds):
            for name in order if rnd % 2 == 0 else order[::-1]:
                fa._lib = lambda lib=libs[name]: lib
                for part, bits in (("dq", fa.GBWD_DQ), ("dkdv", fa.GBWD_KV),
                                   ("bwd", fa.GBWD_ALL)):
                    times[name][part].append(chip_smoke.cuda_ms(
                        torch, lambda b=bits: fa.launch_graph_backward(
                            q, k, v, nbr, val, lse, dout, inv, *grads,
                            scratch, b)))
                times[name]["fwd"].append(chip_smoke.cuda_ms(
                    torch, lambda: fa.graph_flash_forward(q, k, v, nbr, val,
                                                          True)))
    scratch_bytes = sum(t.numel() * t.element_size()
                        for t in scratch.values())
    for name, parts in times.items():
        med = {part: statistics.median(ms) for part, ms in parts.items()}
        line = {"build": name, "root": root, "ms": parts, "ms_median": med,
                "gathered_bytes_per_s": {
                    part: gathered / (med[part] * 1e-3)
                    for part in ("fwd", "dq", "dkdv")},
                "valid_slots": n_valid, "scratch_bytes": scratch_bytes,
                "ptxas": registers(reports[name]), "sass": sass[name]}
        if name == "tree":
            line |= {"row_errors": {n: errs[n] for n in chip_smoke.K1_GRADS},
                     "bit_identical": same, "finite": finite}
        print(json.dumps(line), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
