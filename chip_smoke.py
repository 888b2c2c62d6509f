#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: serve the GraphTransformer parent
scorer (BASELINE config #3) and the MLP scorer, and train the
GraphTransformer in gather mode and serve the result, on one NVIDIA H100
through ``dragonfly2_tpu_torch``, with the hand-written CUDA kernels.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits nonzero, before the final line):

1. the card: name and power limit from ``nvidia-smi``;
2. build every kernel from ``dragonfly2_tpu_torch/ops/csrc`` (nvcc, in
   parallel);
3. each kernel against its plain PyTorch version at the config #3 shapes
   (``table_gather`` bit-equal, ``graph_flash_attention`` within the
   stated tolerances, ``table_scatter_add`` on the trainer's inverse index
   and on its own derived transpose, bit-identical across launches — run
   after phase 6, when the trainer's index exists),
   timed with CUDA events beside the plain version, one PyTorch library
   call and the byte/operation bound; the flash kernel on every row
   layout it takes, with ragged and all-padding rows; the scatter-add on
   random indices with many duplicates and rows that receive nothing;
   and the whole model on a small graph, card against CPU, in f32:
   embeddings in both kernel-carrying modes, and every parameter's
   gradient of the training loss in gather mode, while the flash kernel
   must refuse to run under autograd;
4. the main path: config #3 (20k hosts, 500k probes, hidden 128, embed
   64, 2 layers, 4 heads, neighbor cap 64, chunk 1024, bf16 compute) with
   seeded random weights, written as a port artifact and loaded through
   ``_gat_scorer_from_artifact`` in gather mode and in blocks mode, both
   installed with a seeded MLP in an ``InferenceService`` that answers
   ModelInfer requests and refuses invalid ones with the right codes.
   Every kernel's launch count is set to 0 just before and read just
   after; each must have launched;
5. train: config #3 trained in gather mode (``GATTrainer.fit``, the body
   of ``train_gat``; 2 epochs, 60 s cap) with the launch counts set to 0
   just before and read just after — the gather and scatter-add kernels
   must both have launched, the loss must be finite and fall — then the
   steady step time (CUDA events), samples/s, F1, accuracy, peak memory,
   and a profile of 3 steps (device time by kernel, the device's busy
   share);
6. train_to_serve: the trained result as a port artifact, loaded through
   ``_gat_scorer_from_artifact`` and answering ModelInfer requests that
   must equal the trained model's own scores;
7. embedding-pass times and peak device memory.

Prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12                      # outside the tensor cores

SEED = 0
N_HOSTS, N_EDGES = 20_000, 500_000          # artifacts/gat_bench.py
GAT_CFG = dict(hidden=128, embed=64, layers=2, heads=4, chunk=1024)
NEIGHBOR_CAP = 64

# Kernel vs plain version on identical inputs. bf16: the plain version
# rounds scores to bf16 and rescales p per 1024-column key block, the
# kernel keeps f32 scores and one exact max, so p rounds to bf16 against
# a different reference — a few bf16 ulps of |out| ≤ ~4. f32: the same
# algebra in another order.
FLASH_TOL = {"bf16": 5e-2, "f32": 2e-5}
# Gather vs blocks embeddings (and scores) of the same model: the
# tolerance tests/test_gat.py holds the JAX package's modes to.
MODE_TOL = 6e-2
# Whole model, card kernels against the CPU plain path, f32 compute.
SMALL_F32_TOL = 1e-4
# MLP bf16 on the card against the same weights in f32 on the CPU.
MLP_TOL = 6e-2
# Scatter-add kernel against its plain version: both sum each row's terms
# in f32 in ascending position order and round once, so they should agree
# bit for bit; the tolerance allows one bf16 ulp (2^-8) of the largest
# entry, for a summation order that differs.
SCATTER_ULP = 2.0 ** -8
# Gradients of the training loss, card against CPU, f32: each leaf's max
# |error| over its max |grad|, floored at 1e-3 of the largest leaf's (the
# key bias's true gradient is 0 and holds rounding noise on both sides).
GRAD_F32_TOL = 1e-4
# The train phase: artifacts/gat_bench.py:36-43 with a short run.
TRAIN_CFG = dict(hidden=128, embed=64, layers=2, heads=4, neighbor_cap=64,
                 edge_batch_size=8192, eval_fraction=0.02, epochs=2,
                 max_seconds=60)


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_flops: float,
             peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_table_gather(torch, table, idx) -> dict:
    from dragonfly2_tpu_torch.ops import table_gather as _tg
    from dragonfly2_tpu_torch.ops.table_gather import (
        table_gather,
        table_gather_plain,
    )

    out = table_gather(table, idx)
    ref = table_gather_plain(table, idx)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError("table_gather differs from table[idx]")
    err = float((out.float() - ref.float()).abs().max())
    # The kernel alone, and through the wrapper, whose index range check
    # waits for the device once a call.
    lib, stream = _tg._lib("table_gather"), torch.cuda.current_stream()
    ms = cuda_ms(torch, lambda: lib.df2_table_gather(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
        table.shape[1] * table.element_size(), stream.cuda_stream))
    wrapper_ms = cuda_ms(torch, lambda: table_gather(table, idx))
    plain_ms = cuda_ms(torch, lambda: table_gather_plain(table, idx))
    library_ms = cuda_ms(torch, lambda: table.index_select(0, idx))
    b_ms, b_by = bound_ms(nbytes(table, idx, out), 0.0)
    row = dict(name="table_gather", route="cuda",
               source="dragonfly2_tpu_torch/ops/csrc/table_gather.cu",
               replaces="dragonfly2_tpu/ops/table_gather.py:66",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=library_ms)
    log("kernel", **row, wrapper_ms=wrapper_ms,
        shape={"table": list(table.shape), "idx": list(idx.shape)})
    return row


def scatter_err(torch, out, ref) -> tuple[float, float]:
    """(max |out − ref|, its tolerance) for a scatter-add result against
    the plain version's (on the CPU)."""
    err = float((out.cpu().float() - ref.float()).abs().max())
    return err, SCATTER_ULP * max(float(ref.float().abs().max()), 1.0)


def check_table_scatter_add(torch, ct, idx, inv, n_rows) -> dict:
    """The scatter-add kernel at the trainer's shapes: on the inverse
    index and on the transpose the wrapper derives from idx, against the
    plain version on a CPU copy, twice for bit-identity, timed beside the
    plain version on the card and ``index_add_`` into f32 zeros."""
    from dragonfly2_tpu_torch.ops import table_gather as _tg
    from dragonfly2_tpu_torch.ops.table_gather import (
        inverse_index_csr,
        table_scatter_add,
        table_scatter_add_plain,
    )

    cpu = [t.cpu() for t in (ct, idx, inv)]
    errs = {}
    for name, use_inv in (("inv", inv), ("derived", None)):
        out = table_scatter_add(ct, idx, n_rows, use_inv)
        again = table_scatter_add(ct, idx, n_rows, use_inv)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"table_scatter_add ({name}) differs "
                                 "between two launches")
        ref = table_scatter_add_plain(cpu[0], cpu[1], n_rows,
                                      None if use_inv is None else cpu[2])
        errs[name], tol = scatter_err(torch, out, ref)
        if not errs[name] <= tol:
            raise AssertionError(f"table_scatter_add ({name}): max abs err "
                                 f"{errs[name]} > {tol}")
        errs[f"{name}_bit_equal"] = torch.equal(out.cpu(), ref)
    del cpu

    d = ct.shape[1]
    row_bytes = d * ct.element_size()
    lib, stream = _tg._lib("table_scatter_add"), torch.cuda.current_stream()
    out = torch.empty((n_rows, d), dtype=ct.dtype, device=ct.device)
    ms = cuda_ms(torch, lambda: lib.df2_table_scatter_add(
        1, ct.data_ptr(), inv.data_ptr(), None, inv.shape[1], out.data_ptr(),
        n_rows, row_bytes, stream.cuda_stream))
    wrapper_ms = cuda_ms(torch, lambda: table_scatter_add(ct, idx, n_rows,
                                                          inv))
    derive_ms = cuda_ms(torch, lambda: inverse_index_csr(idx, n_rows))
    derived_ms = cuda_ms(torch, lambda: table_scatter_add(ct, idx, n_rows))
    plain_ms = cuda_ms(torch, lambda: table_scatter_add_plain(
        ct, idx, n_rows, inv), iters=5, warmup=1)
    # Library yardstick: one index_add_ (atomics, run-to-run order) into
    # f32 zeros; the f32 copy of ct and the int64 indices are made before
    # the clock starts. Timed only; the port never calls it.
    acc = torch.zeros((n_rows, d), dtype=torch.float32, device=ct.device)
    ct32, idx64 = ct.float(), idx.long()
    library_ms = cuda_ms(torch, lambda: acc.zero_().index_add_(0, idx64, ct32))
    del ct32, idx64, acc

    n_valid = int((inv >= 0).sum())
    b_ms, b_by = bound_ms(n_valid * row_bytes + nbytes(inv, out),
                          n_valid * d, PEAK_F32_FLOPS)
    row = dict(name="table_scatter_add", route="cuda",
               source="dragonfly2_tpu_torch/ops/csrc/table_scatter_add.cu",
               replaces="dragonfly2_tpu/ops/table_gather.py:105",
               max_abs_err=max(errs["inv"], errs["derived"]), ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=library_ms)
    log("kernel", **row, errors=errs, wrapper_ms=wrapper_ms,
        derive_ms=derive_ms, derived_wrapper_ms=derived_ms,
        valid_rows=n_valid, shape={"ct": list(ct.shape),
                                   "inv": list(inv.shape)})
    return row


def check_scatter_cases(torch) -> None:
    """The scatter-add kernel on random neighbor lists with many duplicate
    targets, padding and rows that receive nothing, on both transposes,
    in bf16 and f32 and at row widths of one, a half and three vectors a
    lane, against the plain version on the CPU."""
    import numpy as np

    from dragonfly2_tpu_torch.models.graph_transformer import (
        PAD_ID,
        build_inverse_index,
    )
    from dragonfly2_tpu_torch.ops.table_gather import (
        table_scatter_add,
        table_scatter_add_plain,
    )

    rng = np.random.default_rng(SEED)
    n, kw = 1000, 48
    nbr = rng.integers(0, 300, (n, kw)).astype(np.int32)  # rows ≥ 300 get 0
    nbr[rng.random((n, kw)) < 0.4] = PAD_ID
    nbr[11] = PAD_ID                                       # lists nobody
    inv = torch.from_numpy(build_inverse_index(nbr))
    idx = torch.from_numpy(np.where(nbr >= n, 0, nbr).reshape(-1))
    errs = {}
    for dtype, width in ((torch.bfloat16, 256), (torch.float32, 64),
                         (torch.float32, 384)):
        ct = torch.from_numpy(rng.standard_normal(
            (n * kw, width)).astype(np.float32)).to(dtype)
        for name, use_inv in (("inv", inv), ("derived", None)):
            ref = table_scatter_add_plain(ct, idx, n, use_inv)
            out = table_scatter_add(
                ct.cuda(), idx.cuda(),
                n, None if use_inv is None else use_inv.cuda())
            key = f"{str(dtype)[6:]}x{width}_{name}"
            errs[key], tol = scatter_err(torch, out, ref)
            if not errs[key] <= tol or out[300:].abs().max() != 0:
                raise AssertionError(f"table_scatter_add {key}: max abs err "
                                     f"{errs[key]} or a nonzero empty row")
    log("scatter_cases", max_abs_err=errs, tol_ulp=SCATTER_ULP)


def check_graph_flash(torch, q, k, v, nbr, val, block) -> dict:
    from dragonfly2_tpu_torch.ops.flash_attention import (
        graph_flash_attention,
        graph_flash_attention_plain,
    )

    errs = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        qd, kd, vd = (t.to(dtype) for t in (q, k, v))
        out = graph_flash_attention(qd, kd, vd, nbr, val)
        ref = graph_flash_attention_plain(qd, kd, vd, nbr, val, block)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"graph_flash_attention {name}: non-finite")
        errs[name] = float((out.float() - ref.float()).abs().max())
        if errs[name] > FLASH_TOL[name]:
            raise AssertionError(f"graph_flash_attention {name}: max abs err "
                                 f"{errs[name]} > {FLASH_TOL[name]}")
    out = graph_flash_attention(q, k, v, nbr, val)
    ms = cuda_ms(torch, lambda: graph_flash_attention(q, k, v, nbr, val))
    plain_ms = cuda_ms(torch, lambda: graph_flash_attention_plain(
        q, k, v, nbr, val, block), iters=5, warmup=1)

    # Library yardstick: SDPA over a materialized [N, N] bias mask (−inf
    # off the neighbor lists). Timed only; the port never calls it.
    n, heads, d = q.shape
    valid = (nbr >= 0) & (nbr < k.shape[0])
    rows = torch.arange(n, device=q.device)[:, None].expand_as(nbr)
    mask = torch.full((n, k.shape[0]), float("-inf"), dtype=q.dtype,
                      device=q.device)
    mask[rows[valid], nbr[valid].long()] = val[valid].to(q.dtype)
    qh, kh, vh = (t.permute(1, 0, 2)[None] for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(torch, lambda: sdpa(qh, kh, vh, attn_mask=mask),
                         iters=5, warmup=1)
    sdpa_err = float((sdpa(qh, kh, vh, attn_mask=mask)[0].permute(1, 0, 2)
                      .float() - out.float()).abs().max())
    del mask

    n_valid = int(valid.sum())
    flops = n_valid * heads * 4 * d          # q·k and p·v per valid slot
    b_ms, b_by = bound_ms(nbytes(q, k, v, nbr, val, out), flops)
    row = dict(name="graph_flash_attention", route="cuda",
               source="dragonfly2_tpu_torch/ops/csrc/graph_flash_attention.cu",
               replaces="dragonfly2_tpu/ops/flash_attention.py:249",
               max_abs_err=errs["bf16"], ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)
    log("kernel", **row, max_abs_err_f32=errs["f32"],
        sdpa_max_abs_diff=sdpa_err, valid_slots=n_valid,
        shape={"q": list(q.shape), "nbr": list(nbr.shape)})
    return row


def check_flash_shapes(torch) -> None:
    """The flash kernel on every row layout it takes (heads × head_dim
    spread 1, 2, 4 or 8 elements a lane), ragged neighbor counts, a row
    whose slots are all padding and K past one warp, in f32 against the
    plain version."""
    from dragonfly2_tpu_torch.models.graph_transformer import PAD_ID
    from dragonfly2_tpu_torch.ops.flash_attention import (
        graph_flash_attention,
        graph_flash_attention_plain,
    )

    gen = torch.Generator().manual_seed(SEED)
    n, kw = 300, 40
    errs = {}
    for heads, d in ((2, 16), (4, 16), (4, 32), (8, 32), (1, 64)):
        q, k, v = (torch.randn(n, heads, d, generator=gen) for _ in range(3))
        # Distinct neighbors per row (the dedup invariant), self slot
        # first, a ragged tail of PAD_ID, and row 7 all padding.
        order = torch.rand(n, n, generator=gen)
        order.fill_diagonal_(-1.0)
        nbr = torch.argsort(order, dim=1)[:, :kw].to(torch.int32)
        deg = torch.randint(1, kw + 1, (n, 1), generator=gen)
        nbr[torch.arange(kw)[None, :] >= deg] = int(PAD_ID)
        nbr[7] = int(PAD_ID)
        val = -torch.rand(n, kw, generator=gen)
        ref = graph_flash_attention_plain(q, k, v, nbr, val, 128)
        out = graph_flash_attention(*(t.cuda() for t in (q, k, v, nbr, val)))
        err = float((out.cpu() - ref).abs().max())
        errs[f"{heads}x{d}"] = err
        if not err <= FLASH_TOL["f32"] or out[7].abs().max() != 0:
            raise AssertionError(f"graph_flash_attention {heads}x{d}: max "
                                 f"abs err {err} or a nonzero padded row")
    log("flash_shapes", max_abs_err=errs, tol=FLASH_TOL["f32"])


def check_small_model(torch) -> None:
    """The whole model on a small graph: card kernels against the CPU
    plain path, f32 compute, both kernel-carrying modes; then gradients."""
    import numpy as np
    import torch.nn.functional as F

    from dragonfly2_tpu_torch.data import SyntheticCluster
    from dragonfly2_tpu_torch.models.graph_transformer import (
        GraphTransformer,
        build_inverse_index,
        build_neighbor_lists,
        pad_graph_sparse,
    )

    g = SyntheticCluster(n_hosts=60, seed=SEED).probe_graph(3000)
    nbr, val = build_neighbor_lists(g.n_nodes, g.edge_src, g.edge_dst,
                                    g.edge_rtt_ns, cap=16)
    feats, nbr, val, _ = pad_graph_sparse(g.node_features, nbr, val, 16)
    inputs = [torch.from_numpy(a) for a in (feats, nbr, val)]
    errs = {}
    for mode in ("gather", "blocks"):
        model = GraphTransformer(hidden=32, embed=16, layers=2, heads=4,
                                 chunk=16, attention=mode,
                                 dtype=torch.float32,
                                 generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            cpu = model.node_embeddings(*inputs)
            card = model.cuda().node_embeddings(*(t.cuda() for t in inputs))
        errs[mode] = float((card.cpu() - cpu).abs().max())
        if not errs[mode] <= SMALL_F32_TOL:
            raise AssertionError(f"small model {mode}: card vs CPU max abs "
                                 f"err {errs[mode]} > {SMALL_F32_TOL}")
        if mode == "blocks":
            try:
                model.node_embeddings(*(t.cuda() for t in inputs))
            except NotImplementedError:
                pass
            else:
                raise AssertionError("graph_flash_attention ran under "
                                     "autograd on the card")

    # Gradients of the training loss in gather mode: the card (gather and
    # scatter-add kernels) against the CPU (their plain versions), with
    # the trainer's inverse index and with the transpose derived on the
    # card.
    rng = np.random.default_rng(SEED)
    src, dst = (torch.from_numpy(rng.integers(0, g.n_nodes, 256).astype(
        np.int32)) for _ in range(2))
    y = torch.from_numpy((rng.random(256) < 0.5).astype(np.float32))
    inv = torch.from_numpy(build_inverse_index(nbr))
    grad_errs = {}
    for name, use_inv in (("inv", inv), ("derived", None)):
        grads = {}
        for dev in ("cpu", "cuda"):
            model = GraphTransformer(
                hidden=32, embed=16, layers=2, heads=4, chunk=16,
                dtype=torch.float32,
                generator=torch.Generator().manual_seed(1)).to(dev)
            args = [t.to(dev) for t in (*inputs, src, dst)]
            logits = model(*args, inv=None if use_inv is None
                           else use_inv.to(dev))
            F.binary_cross_entropy_with_logits(logits, y.to(dev)).backward()
            grads[dev] = {k: None if p.grad is None else p.grad.cpu()
                          for k, p in model.named_parameters()}
        missing = [k for k, v in grads["cuda"].items() if v is None]
        if missing:
            raise AssertionError(f"no gradient on the card for {missing}")
        floor = 1e-3 * max(float(v.abs().max())
                           for v in grads["cpu"].values())
        grad_errs[name] = max(
            float((grads["cuda"][k] - ref).abs().max())
            / max(float(ref.abs().max()), floor)
            for k, ref in grads["cpu"].items())
        if not grad_errs[name] <= GRAD_F32_TOL:
            raise AssertionError(f"gradients ({name}) card vs CPU: "
                                 f"{grad_errs[name]} > {GRAD_F32_TOL}")
    log("small_model", max_abs_err=errs, tol=SMALL_F32_TOL,
        grad_rel_err=grad_errs, grad_tol=GRAD_F32_TOL,
        flash_refuses_grad=True)


def expect_abort(service, request, code, context) -> None:
    from dragonfly2_tpu_torch.inference.sidecar import RpcAbort

    try:
        service.ModelInfer(request, context)
    except RpcAbort as exc:
        if exc.code != code:
            raise AssertionError(f"expected {code}, got {exc.code}") from exc
        return
    raise AssertionError(f"expected {code}, request was answered")


def p50_ms(fn, n: int = 50) -> float:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[n // 2]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import dragonfly2_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing: {exc}",
              file=sys.stderr)
        return 2
    import numpy as np

    from dragonfly2_tpu_torch.data import SyntheticCluster
    from dragonfly2_tpu_torch.inference.scorer import ParentScorer
    from dragonfly2_tpu_torch.inference.sidecar import (
        CallContext,
        InferenceService,
        ModelInferRequest,
        ModelReadyRequest,
        ServerReadyRequest,
        StatusCode,
        _gat_scorer_from_artifact,
        _scorer_from_artifact,
    )
    from dragonfly2_tpu_torch.models.graph_transformer import (
        GraphTransformer,
        _flash_block,
        build_neighbor_lists,
        pad_graph_sparse,
        pad_multiple,
    )
    from dragonfly2_tpu_torch.models.mlp import (
        FEATURE_DIM,
        MLPBandwidthPredictor,
        Normalizer,
    )
    from dragonfly2_tpu_torch.ops import _build
    from dragonfly2_tpu_torch.ops.flash_attention import graph_flash_attention
    from dragonfly2_tpu_torch.ops.table_gather import (
        table_gather,
        table_scatter_add,
    )
    from dragonfly2_tpu_torch.train.checkpoint import (
        ModelMetadata,
        flax_from_gat_state_dict,
        flax_from_mlp_state_dict,
        gat_artifact_from_result,
        gat_tree,
        mlp_tree,
        write_artifact,
    )
    from dragonfly2_tpu_torch.train.gat_trainer import (
        GATTrainConfig,
        GATTrainer,
    )
    from dragonfly2_tpu_torch.train.metrics import padded_chunks

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log("card", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)

    # -- phase 2: build ------------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build_all()
    log("build", seconds=time.perf_counter() - t0,
        ptxas={name: [ln.strip() for ln in rep.splitlines()
                      if "registers" in ln or "spill" in ln]
               for name, rep in reports.items()})

    # -- config #3 graph -------------------------------------------------------
    t0 = time.perf_counter()
    graph = SyntheticCluster(n_hosts=N_HOSTS, seed=SEED).probe_graph(N_EDGES)
    nbr, val = build_neighbor_lists(graph.n_nodes, graph.edge_src,
                                    graph.edge_dst, graph.edge_rtt_ns,
                                    cap=NEIGHBOR_CAP)
    # Gather mode trains unpadded on one device; blocks mode pads rows to
    # the 1024-row key blocks (gat_trainer: pad_multiple(n_data, chunk, N)).
    gather_graph = pad_graph_sparse(graph.node_features, nbr, val, 1)
    blocks_graph = pad_graph_sparse(
        graph.node_features, nbr, val,
        pad_multiple(1, GAT_CFG["chunk"], graph.n_nodes))
    log("graph", seconds=time.perf_counter() - t0, n_nodes=graph.n_nodes,
        n_edges=graph.n_edges, neighbor_width=int(nbr.shape[1]),
        blocks_rows=int(blocks_graph[0].shape[0]))

    # -- phase 3: kernels against their plain versions -------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    heads = GAT_CFG["heads"]
    head_dim = GAT_CFG["hidden"] // heads
    n_gather = gather_graph[0].shape[0]
    g_nbr = torch.from_numpy(gather_graph[1]).to(dev)
    kv_table = torch.randn(n_gather, 2 * heads * head_dim, generator=gen,
                           device=dev).to(torch.bfloat16)
    gather_idx = torch.where(g_nbr >= n_gather, 0, g_nbr).reshape(-1)
    rows = [check_table_gather(torch, kv_table, gather_idx)]

    n_blocks = blocks_graph[0].shape[0]
    q, k, v = (torch.randn(n_blocks, heads, head_dim, generator=gen,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    b_nbr = torch.from_numpy(blocks_graph[1]).to(dev)
    b_val = torch.from_numpy(blocks_graph[2]).to(dev)
    rows.append(check_graph_flash(
        torch, q, k, v, b_nbr, b_val,
        _flash_block(n_blocks, GAT_CFG["chunk"])))
    del kv_table, gather_idx, q, k, v
    check_flash_shapes(torch)
    check_scatter_cases(torch)
    check_small_model(torch)

    # -- phase 4: the main path ----------------------------------------------
    model = GraphTransformer(**GAT_CFG,
                             generator=torch.Generator().manual_seed(SEED))
    params = flax_from_gat_state_dict(model.state_dict())
    artifacts = {}
    for mode, (feats, m_nbr, m_val, _) in (("gather", gather_graph),
                                           ("blocks", blocks_graph)):
        artifacts[mode] = write_artifact(
            gat_tree(params, feats, m_nbr, m_val, node_ids=graph.node_ids),
            ModelMetadata(model_id=f"smoke-gat-{mode}", model_type="gat",
                          config=dict(GAT_CFG, attention=mode)))
    rng = np.random.default_rng(SEED)
    features = rng.uniform(0, 100, (4096, FEATURE_DIM)).astype(np.float32)
    mlp = MLPBandwidthPredictor(generator=torch.Generator().manual_seed(SEED))
    norm = Normalizer.fit(features)
    target = Normalizer(np.array([2.5], np.float32),
                        np.array([0.7], np.float32))
    mlp_artifact = write_artifact(
        mlp_tree(flax_from_mlp_state_dict(mlp.state_dict()), norm, target),
        ModelMetadata(model_id="smoke-mlp", model_type="mlp",
                      config={"hidden": [128, 128, 64]}))

    kernels = (table_gather, table_scatter_add, graph_flash_attention)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    scorers, load_s = {}, {}
    for mode in ("gather", "blocks"):
        t0 = time.perf_counter()
        scorers[mode] = _gat_scorer_from_artifact(artifacts[mode])
        torch.cuda.synchronize()
        load_s[mode] = time.perf_counter() - t0
    mlp_scorer = _scorer_from_artifact(mlp_artifact)

    service = InferenceService()
    ctx = CallContext()
    pairs = [rng.integers(0, N_HOSTS, (16, 2)) for _ in range(5)]
    answers = {}
    for mode in ("gather", "blocks"):
        service.install_scorer("gat", scorers[mode], version=mode)
        answers[mode] = [service.ModelInfer(
            ModelInferRequest("gat", p), ctx).outputs for p in pairs]
    service.install_scorer("mlp", mlp_scorer, version="smoke")
    mlp_out = [service.ModelInfer(
        ModelInferRequest("mlp", features[i * 15:(i + 1) * 15]), ctx).outputs
        for i in range(5)]
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log("main_path", launches=launches, load_seconds=load_s,
        peak_memory_gib=peak_gib)
    for name in ("table_gather", "graph_flash_attention"):
        if launches[name] < 1:
            raise AssertionError(f"{name} never launched on the main path")

    # What came out: shapes, finiteness, gather ≡ blocks, MLP ≡ f32 CPU.
    emb = {m: s.embeddings.float() for m, s in scorers.items()}
    if emb["gather"].shape != (N_HOSTS, GAT_CFG["embed"]) or emb[
            "blocks"].shape != (n_blocks, GAT_CFG["embed"]):
        raise AssertionError(f"embedding shapes {emb['gather'].shape}, "
                             f"{emb['blocks'].shape}")
    if not all(torch.isfinite(e).all() for e in emb.values()):
        raise AssertionError("non-finite embeddings")
    emb_err = float((emb["gather"] - emb["blocks"][:N_HOSTS]).abs().max())
    score_err = max(float(np.abs(a - b).max()) for a, b in
                    zip(answers["gather"], answers["blocks"]))
    if emb_err > MODE_TOL or score_err > MODE_TOL:
        raise AssertionError(f"gather vs blocks: embeddings {emb_err}, "
                             f"scores {score_err} > {MODE_TOL}")
    mlp_f32 = MLPBandwidthPredictor(dtype=torch.float32)
    mlp_f32.load_state_dict(mlp.state_dict())
    cpu_mlp = ParentScorer(mlp_f32, norm, target, device="cpu")
    mlp_err = max(float(np.abs(out - cpu_mlp.score(
        features[i * 15:(i + 1) * 15])).max())
        for i, out in enumerate(mlp_out))
    if not (all(np.isfinite(o).all() and o.shape == (16,)
                for a in answers.values() for o in a)
            and all(np.isfinite(o).all() and o.shape == (15,)
                    for o in mlp_out)):
        raise AssertionError("bad response shapes or values")
    if mlp_err > MLP_TOL:
        raise AssertionError(f"mlp card vs f32 CPU: {mlp_err} > {MLP_TOL}")
    log("outputs", embed_gather_vs_blocks=emb_err,
        score_gather_vs_blocks=score_err, mlp_vs_f32_cpu=mlp_err)

    expect_abort(service, ModelInferRequest("nope", features[:2]),
                 StatusCode.NOT_FOUND, ctx)
    expect_abort(service, ModelInferRequest("mlp", features[:2, :5]),
                 StatusCode.INVALID_ARGUMENT, ctx)
    expect_abort(service, ModelInferRequest("gat", np.zeros((2, 3))),
                 StatusCode.INVALID_ARGUMENT, ctx)
    expect_abort(service, ModelInferRequest("gat", np.array([[0, N_HOSTS]])),
                 StatusCode.INVALID_ARGUMENT, ctx)
    expect_abort(service, ModelInferRequest("mlp", features[:65]),
                 StatusCode.INVALID_ARGUMENT, ctx)
    if not (service.ModelReady(ModelReadyRequest("gat"), ctx).ready
            and service.ServerReady(ServerReadyRequest(), ctx).ready):
        raise AssertionError("service not ready")
    request_p50 = {
        "gat": p50_ms(lambda: service.ModelInfer(
            ModelInferRequest("gat", pairs[0]), ctx)),
        "mlp": p50_ms(lambda: service.ModelInfer(
            ModelInferRequest("mlp", features[:15]), ctx)),
    }
    log("requests", p50_ms=request_p50, rows={"gat": 16, "mlp": 15})

    # -- phase 5: train, the slice's main path --------------------------------
    cfg = GATTrainConfig(**TRAIN_CFG)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = GATTrainer(graph, cfg)
    result = trainer.fit()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = {fn.__name__: fn.launches for fn in kernels}
    train_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = len(result.step_losses)
    eval_chunks = len(list(padded_chunks(trainer.eval_ids, trainer.batch)))
    # One gather per layer in every forward (train steps and eval chunks),
    # one scatter-add per layer in every backward.
    expected = {"table_gather": cfg.layers * (steps + eval_chunks),
                "table_scatter_add": cfg.layers * steps}
    for name, count in expected.items():
        if train_launches[name] < 1 or train_launches[name] != count:
            raise AssertionError(f"{name}: {train_launches[name]} launches "
                                 f"on the train path, expected {count}")
    losses = np.asarray(result.step_losses)
    if len(losses) < 21 or not np.isfinite(losses).all():
        raise AssertionError(f"{len(losses)} steps, finite: "
                             f"{bool(np.isfinite(losses).all())}")
    early, late = float(losses[1:11].mean()), float(losses[-10:].mean())
    if not late < early:
        raise AssertionError(f"loss did not fall: steps 2-11 mean {early}, "
                             f"last 10 mean {late}")
    # Steady step time: 10 steps after 3 warm ones, CUDA events.
    order = np.random.default_rng(SEED + 1).permutation(trainer.train_ids)
    batches = order[:13 * trainer.batch].reshape(13, trainer.batch)
    for ids in batches[:3]:
        trainer.step(ids)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for ids in batches[3:]:
        trainer.step(ids)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / 10
    # Where a step's device time goes: kernels by name over 3 steps.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for ids in batches[:3]:
            trainer.step(ids)
        torch.cuda.synchronize()
    # Kernels only: a CPU op's entry, and a user annotation's range on the
    # device (the optimizer's step), repeat the time of the kernels inside.
    kernel_ms = sorted(((e.key, e.self_device_time_total / 3e3)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and not getattr(e, "is_user_annotation", False)
                        and e.self_device_time_total > 0),
                       key=lambda kv: -kv[1])
    device_ms = sum(ms for _, ms in kernel_ms)
    log("train_profile", device_ms_per_step=device_ms,
        busy_share=device_ms / step_ms, top_kernels_ms=kernel_ms[:15])
    log("train", seconds=train_s, steps=steps, launches=train_launches,
        expected_launches=expected, loss_first=float(losses[0]),
        loss_steps_2_11=early, loss_last_10=late, history=result.history,
        step_ms=step_ms, samples_per_sec=result.samples_per_sec,
        f1=result.f1, accuracy=result.accuracy, precision=result.precision,
        recall=result.recall, peak_memory_gib=train_peak_gib,
        inverse_index=list(trainer.g_inv.shape),
        train_edges=len(trainer.train_ids), eval_edges=len(trainer.eval_ids),
        batch=trainer.batch)

    # -- phase 6: the trained model served ------------------------------------
    t0 = time.perf_counter()
    trained = _gat_scorer_from_artifact(
        gat_artifact_from_result(result, graph, "smoke-gat-trained"))
    torch.cuda.synchronize()
    trained_load_s = time.perf_counter() - t0
    service.install_scorer("gat", trained, version="trained")
    served = [service.ModelInfer(ModelInferRequest("gat", p), ctx).outputs
              for p in pairs]
    own = result.model.to(dev).eval()
    with torch.no_grad():
        own_emb = own.node_embeddings(*(torch.from_numpy(a).to(dev) for a in (
            result.node_features, result.neighbors, result.neighbor_vals)))
        own_scores = [own.score_pairs(
            own_emb, *torch.from_numpy(p.astype(np.int32)).to(dev).T
        ).float().cpu().numpy() for p in pairs]
    if not all(np.isfinite(o).all() and o.shape == (16,) for o in served):
        raise AssertionError("trained model: bad response shapes or values")
    served_err = max(float(np.abs(a - b).max())
                     for a, b in zip(served, own_scores))
    if served_err > MODE_TOL:
        raise AssertionError(f"trained model served vs its own scores: "
                             f"{served_err} > {MODE_TOL}")
    log("train_to_serve", load_seconds=trained_load_s,
        max_abs_diff=served_err, tol=MODE_TOL, requests=len(served))
    del own, own_emb

    # -- the scatter-add kernel on the trainer's own inverse index ------------
    ct = torch.randn(trainer.nbr.size, 2 * heads * head_dim, generator=gen,
                     device=dev).to(torch.bfloat16)
    t_idx = torch.from_numpy(np.where(trainer.nbr >= trainer.nbr.shape[0], 0,
                                      trainer.nbr).reshape(-1)).to(dev)
    rows.append(check_table_scatter_add(torch, ct, t_idx, trainer.g_inv,
                                        trainer.nbr.shape[0]))
    del ct, t_idx, trainer
    for row in rows:
        by_path = {"serve": launches[row["name"]],
                   "train": train_launches[row["name"]]}
        # Each kernel counts on the path of the slice that ported it.
        row["launches"] = by_path["train" if row["name"] ==
                                  "table_scatter_add" else "serve"]
        row["launches_by_path"] = by_path

    # -- phase 7: embedding-pass times (launches here are not counted) -------
    pass_ms = {}
    for mode, (feats, m_nbr, m_val, _) in (("gather", gather_graph),
                                           ("blocks", blocks_graph)):
        gpu_model = scorers[mode]._model
        args = [torch.from_numpy(a).to(dev) for a in (feats, m_nbr, m_val)]
        with torch.no_grad():
            pass_ms[mode] = cuda_ms(
                torch, lambda: gpu_model.node_embeddings(*args),
                iters=5, warmup=1)
    log("embedding_pass", ms=pass_ms,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        total_seconds=time.perf_counter() - t_start)

    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
