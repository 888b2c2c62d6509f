"""Planted faults in the K1 backward: shows that ``chip_smoke.py``'s
"k1_backward" check fails a backward kernel that drops or bends one term
(in either pass, or in the statistics the dK/dV pass reads).

    python3 tests/k1_planted_faults.py

Needs one CUDA card and nvcc. Writes copies of ``ops/csrc`` into a
temporary directory, each with one fault planted in the source text of
``graph_flash_attention.cu``, builds them (and the unmodified source) with
``ops/_build``'s flags, all nvcc runs at once, and runs each library's
backward through ``chip_smoke.k1_backward_case`` at config #3's shapes
(the blocks-mode graph: 20 480 rows, K = 64, [N, 4, 32], its inverse
index; seeded random q, k, v and dO) in bf16 and f32, against the plain
twin in f32. Prints one JSON line a (variant, dtype): the row errors and
limits. Exits 1 unless the unmodified source passes in both dtypes and
every fault fails the check in both.
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
SOURCE = "graph_flash_attention.cu"

# variant: [(kernel whose body is changed, text there, its replacement)].
FAULTS = {
    # dQ misses each row's last valid slot (its ds·k term).
    "dq_drops_last_slot": [(
        "graph_flash_dq_kernel(",
        "          a[i] += pdj * kf;\n          b[i] += pj * kf;\n",
        "          a[i] += s0 + sb + j == nv - 1 ? 0.f : pdj * kf;\n"
        "          b[i] += s0 + sb + j == nv - 1 ? 0.f : pj * kf;\n")],
    # dK/dV misses each key row's last inverse-index entry.
    "dkdv_drops_last_position": [(
        "graph_flash_dkdv_kernel(",
        "__ballot_sync(kFull, live);",
        "__ballot_sync(kFull, live && base + lane + 1 < dmax &&\n"
        "        inv[c * dmax + base + lane + 1] >= 0);")],
    # ds = p·dp: delta taken as 0 (no shift r, no sum).
    "delta_zero": [
        ("graph_flash_dq_kernel(", "if (s0 + sb == 0) r =", "if (false) r ="),
        ("graph_flash_dq_kernel(", "        delta += pdj;\n",
         "        delta += 0.f * pdj;\n")],
    # dval sums head 0 only.
    "dval_one_head": [(
        "graph_flash_dkdv_kernel(",
        "for (int off = group; off < 32; off <<= 1) {",
        "for (int off = 32; off < 32; off <<= 1) {")],
    # The dK/dV pass forms ds without r: p (dp - delta).
    "dkdv_ds_without_r": [(
        "graph_flash_dkdv_kernel(",
        "const float ds = p * ((dp - st.y) - st.z);",
        "const float ds = p * (dp - st.z);")],
    # The dK/dV pass takes the next row's lse, r and delta.
    "dkdv_other_rows_stats": [(
        "graph_flash_dkdv_kernel(",
        "const float4 st = stats[i * heads + head];",
        "const float4 st = stats[((i + 1) % nq) * heads + head];")],
}


def plant(source: str, plants) -> str:
    """``source`` with, for each (kernel, old, new) of ``plants``, the
    first ``old`` after ``kernel`` made ``new``."""
    for kernel, old, new in plants:
        at = source.index(old, source.index(kernel))
        source = source[:at] + new + source[at + len(old):]
    return source


def build(tmp: str, texts: dict, reports: dict | None = None) -> dict:
    """Build every variant's source at once; returns {variant: library
    path}, and puts each variant's ptxas report into ``reports`` when
    given."""
    from dragonfly2_tpu_torch.ops import _build

    nvcc, procs = _build.nvcc_path(), {}
    for name, text in texts.items():
        src = os.path.join(tmp, name)
        shutil.copytree(_build.CSRC, src)
        with open(os.path.join(src, SOURCE), "w") as fh:
            fh.write(text)
        lib = os.path.join(tmp, f"{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", lib, os.path.join(src, SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        libs[name] = lib
        if reports is not None:
            reports[name] = out
    return libs


def blocks_inputs(torch):
    """Config #3's blocks-mode backward inputs on the card: seeded random
    f32 q, k, v and dO [20480, 4, 32], and the padded graph's nbr, val and
    inverse index."""
    import chip_smoke
    from dragonfly2_tpu_torch.data import SyntheticCluster
    from dragonfly2_tpu_torch.models.graph_transformer import (
        build_inverse_index,
        build_neighbor_lists,
        pad_graph_sparse,
        pad_multiple,
    )

    graph = SyntheticCluster(n_hosts=chip_smoke.N_HOSTS,
                             seed=chip_smoke.SEED).probe_graph(
        chip_smoke.N_EDGES)
    nbr, val = build_neighbor_lists(graph.n_nodes, graph.edge_src,
                                    graph.edge_dst, graph.edge_rtt_ns,
                                    cap=chip_smoke.NEIGHBOR_CAP)
    chunk = chip_smoke.GAT_CFG["chunk"]
    _, nbr, val, _ = pad_graph_sparse(graph.node_features, nbr, val,
                                      pad_multiple(1, chunk, graph.n_nodes))
    inv = torch.from_numpy(build_inverse_index(nbr)).cuda()
    nbr, val = torch.from_numpy(nbr).cuda(), torch.from_numpy(val).cuda()
    heads = chip_smoke.GAT_CFG["heads"]
    head_dim = chip_smoke.GAT_CFG["hidden"] // heads
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    inputs = [torch.randn(nbr.shape[0], heads, head_dim, generator=gen,
                          device="cuda") for _ in range(4)]
    return inputs, nbr, val, inv


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_planted_faults: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from dragonfly2_tpu_torch.ops import _build

    # The module: the package exports the K3 function under its name.
    fa = importlib.import_module("dragonfly2_tpu_torch.ops.flash_attention")
    inputs, nbr, val, inv = blocks_inputs(torch)

    source = (_build.CSRC / SOURCE).read_text()
    texts = {"unmodified": source}
    texts.update({name: plant(source, plants)
                  for name, plants in FAULTS.items()})
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        for name, path in build(tmp, texts).items():
            lib = fa.bind_graph_library(_build.open_library(path))
            fa._lib = lambda lib=lib: lib
            planted = name != "unmodified"
            for dname, dtype in (("bf16", torch.bfloat16),
                                 ("f32", torch.float32)):
                errs, same, finite, _ = chip_smoke.k1_backward_case(
                    torch, *(t.to(dtype) for t in inputs), nbr, val, inv)
                tol = chip_smoke.K1_TOL[dname]
                passes = same and finite and chip_smoke.k1_within(errs, tol)
                ok &= passes != planted
                print(json.dumps({
                    "variant": name, "dtype": dname, "planted": planted,
                    "passes_check": passes, "bit_identical": same,
                    "finite": finite,
                    "row_errors": {n: errs[n] for n in chip_smoke.K1_GRADS},
                    "row_tol": tol}), flush=True)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
