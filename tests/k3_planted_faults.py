"""Planted faults in the K3 kernels: shows that ``chip_smoke.py``'s K3
check fails a kernel that is wrong far from the causal diagonal, on both
bf16 routes.

    python3 tests/k3_planted_faults.py

Needs one CUDA card and nvcc. Writes copies of ``ops/csrc`` into a
temporary directory, each with one fault planted in the source text of
both K3 sources (``flash_attention_sm90.cu``, the TMA + wgmma route at
head_dim 128, and ``flash_attention.cu``, the mma.sync route with the
ring forward and the fused backward at head_dim 8), or of the one that
has the code at fault (the forward's polynomial exp2 exists only in
``flash_attention.cu``), builds them (and the unmodified sources)
with ``ops/_build``'s flags, four nvcc runs at a time, and runs each pair of
libraries through the K3 wrapper at [32768, 8, 8] and [32768, 4, 128]
(bf16, causal) against the plain version in f32, as
``chip_smoke.check_k3`` does. Prints one JSON line a (variant, shape):
chip_smoke's row errors and limits, and the max |err| check (5e-2 on
out, 2e-2 on max |err| / max(max |ref|, 1) for the gradients) that the
row check replaced. Exits 1 unless the unmodified sources pass at both
shapes and every fault fails the row check at each shape whose source
it was planted in (and passes at the other).
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
SHAPES = ((32_768, 8, 8), (32_768, 4, 128))
SM90, MMA = "flash_attention_sm90.cu", "flash_attention.cu"
# The source whose kernels take each shape: a variant must fail at a
# shape exactly when it plants a fault in that source.
SOURCE_OF = {SHAPES[0]: MMA, SHAPES[1]: SM90}

# variant: [(source, kernel whose body is changed, text there, its
# replacement)]. At T = 32k a causal row reads 256 key tiles of 128 rows
# (sm90 forward) or 512 of 64 (the rest). A consumer that skips a tile
# still releases its ring stage, and the fused block still takes its
# turn in dQ's order, so no fault hangs.
_SKIP_FWD = "    if (kt == n_k / 2 && kt < last) {{ bar_arrive(&empty[{s}]); continue; }}\n"
FAULTS = {
    "fwd_drops_middle_key_tile": [
        (SM90, "fwd_kernel(const __grid_constant__",
         "bar_wait(&full[s], (kt / kStages) & 1);\n",
         "bar_wait(&full[s], (kt / kStages) & 1);\n" + _SKIP_FWD.format(s="s")),
        (MMA, "fwd_ring_kernel(",
         "bar_wait(&full[st], (kt / kFwdStages) & 1);\n",
         "bar_wait(&full[st], (kt / kFwdStages) & 1);\n"
         "    if (kt == n_k / 2 && kt < last) { release(st); continue; }\n"),
    ],
    "dq_drops_middle_key_tile": [
        (SM90, "dq_kernel(const __grid_constant__",
         "bar_wait(&full[st], (kt / kStages) & 1);\n",
         "bar_wait(&full[st], (kt / kStages) & 1);\n"
         + _SKIP_FWD.format(s="st")),
        (MMA, "bwd_fused_kernel(", "  auto store_sum = [&](int qi) {\n",
         "  auto store_sum = [&](int qi) {\n"
         "    if (k_tile == n_t / 2 && k_tile < top_of(qi)) zero_acc(dq_part);\n"),
    ],
    "dkdv_drops_last_query_tile": [
        (SM90, "dkdv_kernel(const __grid_constant__",
         "bar_wait(&full[st], (n / kStages) & 1);\n",
         "bar_wait(&full[st], (n / kStages) & 1);\n"
         "    if (qi == n_q - 1 && qi > first + 4) { bar_arrive(&empty[st]); "
         "continue; }\n"),
        (MMA, "bwd_fused_kernel(",
         "mma_rows<D>(dv_acc, pa, dt, KP, kk * 16, lane);\n"
         "      mma_rows<D>(dk_acc, da, qt, KP, kk * 16, lane);",
         "if (!(qi == n_t - 1 && qi > first + 4)) {\n"
         "        mma_rows<D>(dv_acc, pa, dt, KP, kk * 16, lane);\n"
         "        mma_rows<D>(dk_acc, da, qt, KP, kk * 16, lane);\n      }"),
    ],
    # The pairs of the "mma" forward that take the FP32 polynomial get
    # an exponent one too high (p doubled); the sm90 kernels have none.
    "poly_pairs_wrong_exponent": [
        (MMA, "exp2_poly(float x)", "(__float_as_int(t) << 23)",
         "((__float_as_int(t) + 1) << 23)"),
    ],
}
# The causal bound one key late in every kernel (the diagonal tiles).
VISIBLE = "return k_pos < t_len && (!causal || q_pos >= k_pos);"
VISIBLE_LATE = "return k_pos < t_len && (!causal || q_pos + 1 >= k_pos);"
# The check the row errors replaced: max |err| on out, and on the
# gradients max |err| / max(max |ref|, 1).
OLD_TOL = {"out": 5e-2, "grad": 2e-2}


def plant(source: str, kernel: str, old: str, new: str) -> str:
    """``source`` with the first ``old`` after ``kernel`` made ``new``."""
    at = source.index(old, source.index(kernel))
    return source[:at] + new + source[at + len(old):]


def variants(sources: dict) -> dict:
    """{variant: {file name: text}} for the unmodified sources and every
    fault."""
    out = {"unmodified": dict(sources)}
    for name, plants in FAULTS.items():
        texts = dict(sources)
        for fname, kernel, old, new in plants:
            texts[fname] = plant(texts[fname], kernel, old, new)
        out[name] = texts
    for fname, text in sources.items():
        if text.count(VISIBLE) != 1:
            raise ValueError(f"the causal test is not where this script "
                             f"expects in {fname}")
    out["causal_one_key_late"] = {f: t.replace(VISIBLE, VISIBLE_LATE)
                                  for f, t in sources.items()}
    return out


# nvcc runs at once: each optimizes a source's kernels on every core
# (--split-compile=0) and takes a few GB, so ten at once could exhaust
# the machine's memory.
MAX_BUILDS = 4


def build(tmp: str, texts: dict) -> dict:
    """Build every variant's sources, MAX_BUILDS nvcc runs at a time;
    returns {variant: {file name: library path}}."""
    from dragonfly2_tpu_torch.ops import _build

    nvcc, jobs = _build.nvcc_path(), []
    for name, files in texts.items():
        src = os.path.join(tmp, name)
        shutil.copytree(_build.CSRC, src)
        for fname, text in files.items():
            with open(os.path.join(src, fname), "w") as fh:
                fh.write(text)
            jobs.append((name, fname, os.path.join(tmp, f"{name}-{fname}.so"),
                         os.path.join(src, fname)))
    libs, running = {}, []

    def finish(job):
        name, fname, lib, proc = job
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} {fname}: nvcc failed\n{out}")
        libs.setdefault(name, {})[fname] = lib

    for name, fname, lib, src in jobs:
        if len(running) == MAX_BUILDS:
            finish(running.pop(0))
        running.append((name, fname, lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for job in running:
        finish(job)
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

    sources = {f: (_build.CSRC / f).read_text() for f in (SM90, MMA)}
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    inputs = {shape: [torch.randn(*shape, generator=gen, device="cuda")
                      .to(torch.bfloat16) for _ in range(4)]
              for shape in SHAPES}

    def plain(*a):
        return fa.chunked_attention(*a, block=512)

    # The old check's reference: the plain version's own gradients.
    old_refs = {shape: chip_smoke.k3_grads(
        torch, plain, *(x.float() for x in x4[:3]), True, x4[3].float())
        for shape, x4 in inputs.items()}
    tol = chip_smoke.K3_TOL["bf16"]
    ok = True
    texts = variants(sources)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp, texts)
        for name, paths in libs.items():
            sm90 = fa.bind_sm90_library(_build.open_library(paths[SM90]))
            mma = fa.bind_flash_library(_build.open_library(paths[MMA]))
            fa._sm90_lib, fa._flash_lib = (lambda: sm90), (lambda: mma)
            for shape, (q, k, v, dout) in inputs.items():
                got = chip_smoke.k3_grads(torch, fa.flash_attention, q, k, v,
                                          True, dout)
                ref = chip_smoke.k3_reference(torch, plain, q, k, v, True,
                                              dout, got[0])
                errs = chip_smoke.k3_errors(torch, got, ref)
                passes = chip_smoke.k3_within(errs, tol)
                planted = (texts[name][SOURCE_OF[shape]]
                           != sources[SOURCE_OF[shape]])
                ok &= passes != planted
                print(json.dumps({
                    "variant": name, "shape": list(shape),
                    "planted_in_this_route": planted,
                    "route": fa.k3_route(q.dtype, shape[2],
                                         shape[1] * shape[2] * 2),
                    "passes_row_check": passes, "row_errors": errs,
                    "row_tol": tol,
                    "old_check": old_errors(torch, got, old_refs[shape]),
                    "old_tol": OLD_TOL}), flush=True)
                del got, ref
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
