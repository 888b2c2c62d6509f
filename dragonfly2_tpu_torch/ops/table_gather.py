"""Row gather ``table[idx]`` and its backward, the row scatter-add — port
of ``dragonfly2_tpu/ops/table_gather.py`` and of the GraphTransformer's
``neighbor_gather`` custom VJP.

On CUDA tensors :func:`table_gather` and :func:`table_scatter_add` launch
the hand-written kernels in ``csrc/table_gather.cu`` and
``csrc/table_scatter_add.cu`` (each notes what bounds it and how); on CPU
tensors they run their plain versions. :func:`neighbor_gather` joins the
two in a ``torch.autograd.Function``: the GraphTransformer's gather mode
calls it for its ``[k|v]`` neighbor gather, for serving and for training.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from dragonfly2_tpu_torch.ops._build import check, load_library


def table_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``table[idx]``: table [N, D], idx [M] → [M, D]."""
    return table[idx.long()]


def table_scatter_add_plain(ct: torch.Tensor, idx: torch.Tensor, n_rows: int,
                            inv: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch ``zeros([n_rows, D], f32).at[idx].add(ct)``, cast to
    ct's dtype: ct [M, D], idx [M]. With ``inv`` ([n_rows, D_max] flat
    positions, −1 padded, as :func:`build_inverse_index` gives) only the
    positions it lists are added, row by row in its order."""
    acc = torch.zeros((n_rows, ct.shape[1]), dtype=torch.float32,
                      device=ct.device)
    if inv is None:
        acc.index_add_(0, idx.long(), ct.float())
    else:
        rows, slots = torch.nonzero(inv >= 0, as_tuple=True)
        acc.index_add_(0, rows, ct[inv[rows, slots]].float())
    return acc.to(ct.dtype)


def inverse_index_csr(idx: torch.Tensor, n_rows: int):
    """The transpose of ``idx`` in CSR form: (positions, offsets), where
    output row j takes positions[offsets[j]:offsets[j + 1]], ascending.
    A stable sort plus a search for each row's first position."""
    sorted_idx, pos = torch.sort(idx, stable=True)
    bounds = torch.arange(n_rows + 1, dtype=idx.dtype, device=idx.device)
    return pos, torch.searchsorted(sorted_idx, bounds)


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    lib = load_library(name)
    if name == "table_gather":
        lib.df2_table_gather.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        lib.df2_table_gather.restype = ctypes.c_int
    else:
        lib.df2_table_scatter_add.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_void_p]
        lib.df2_table_scatter_add.restype = ctypes.c_int
    return lib


def _check_rows(t: torch.Tensor, what: str) -> int:
    """Row width in bytes of a 2-D tensor the kernels stream as 16-byte
    vectors; raises unless its rows are contiguous, 16-byte aligned and a
    multiple of 16 bytes wide."""
    row_bytes = t.shape[1] * t.element_size()
    if not t.is_contiguous() or row_bytes % 16 or t.data_ptr() % 16:
        raise ValueError(f"{what} rows must be contiguous, 16-byte aligned "
                         f"and a multiple of 16 bytes wide (row is "
                         f"{row_bytes} B)")
    return row_bytes


def _check_range(t: torch.Tensor, lo: int, hi: int, what: str) -> None:
    """Raise unless every entry of ``t`` lies in [lo, hi)."""
    if t.numel():
        t_lo, t_hi = torch.aminmax(t)
        if int(t_lo) < lo or int(t_hi) >= hi:
            raise IndexError(f"{what} out of range [{lo}, {hi}): "
                             f"min {int(t_lo)}, max {int(t_hi)}")


def table_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for table [N, D] and int32 idx [M] in [0, N).

    CPU tensors take :func:`table_gather_plain`. CUDA tensors launch the
    kernel (bit-identical to ``table.index_select(0, idx)``) or raise:
    rows must be contiguous, 16-byte aligned and a multiple of 16 bytes
    wide, and every index must lie in [0, N) — checked here, since the
    kernel reads whatever row an index names. The result carries no
    gradient, so a CUDA table that requires one is refused; use
    :func:`neighbor_gather`.
    """
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return table_gather_plain(table, idx)
    if table.device != idx.device or table.device.type != "cuda":
        raise ValueError(f"table on {table.device}, idx on {idx.device}: "
                         "both must be on one CUDA device")
    if torch.is_grad_enabled() and table.requires_grad:
        raise NotImplementedError(
            "table_gather has no backward; neighbor_gather is the "
            "differentiable gather")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"expected table [N, D] and idx [M], got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    n, d = table.shape
    row_bytes = _check_rows(table, "table")
    idx = idx.contiguous()
    m = idx.shape[0]
    _check_range(idx, 0, n, "gather index")
    out = torch.empty((m, d), dtype=table.dtype, device=table.device)
    lib = _lib("table_gather")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    check(lib, lib.df2_table_gather(table.data_ptr(), idx.data_ptr(),
                                    out.data_ptr(), m, row_bytes, stream),
          "table_gather launch")
    table_gather.launches += 1
    return out


table_gather.launches = 0


def table_scatter_add(ct: torch.Tensor, idx: torch.Tensor, n_rows: int,
                      inv: torch.Tensor | None = None) -> torch.Tensor:
    """``zeros([n_rows, D], f32).at[idx].add(ct)`` cast to ct's dtype, for
    ct [M, D] (bf16 or f32) and int32 idx [M] in [0, n_rows).

    With ``inv`` (int64 [n_rows, D_max], the −1-padded transpose of idx
    that :func:`build_inverse_index` builds once per graph) the sum runs
    over the positions ``inv`` lists; the GraphTransformer's pad slots
    are left out of it and carry zero cotangent, so that is exact there.
    Without it the transpose is derived here from idx
    (:func:`inverse_index_csr`) and every position counts.

    CPU tensors take :func:`table_scatter_add_plain`. CUDA tensors launch
    the kernel, deterministic and without atomics, or raise: ct rows as
    :func:`table_gather` takes them, every index in range.
    """
    tensors = (ct, idx) if inv is None else (ct, idx, inv)
    if all(t.device.type == "cpu" for t in tensors):
        return table_scatter_add_plain(ct, idx, n_rows, inv)
    if any(t.device != ct.device for t in tensors) or ct.device.type != "cuda":
        raise ValueError("ct, idx and inv must all be on one CUDA device")
    if ct.dim() != 2 or idx.shape != (ct.shape[0],):
        raise ValueError(f"expected ct [M, D] and idx [M], got "
                         f"{tuple(ct.shape)} and {tuple(idx.shape)}")
    if ct.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"ct must be bf16 or f32, got {ct.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    m, d = ct.shape
    row_bytes = _check_rows(ct, "ct")
    if inv is None:
        idx = idx.contiguous()
        _check_range(idx, 0, n_rows, "scatter index")
        pos, offsets = inverse_index_csr(idx, n_rows)
        stride, offsets_ptr = 0, offsets.data_ptr()
    else:
        if inv.dtype != torch.int64 or inv.dim() != 2 or inv.shape[0] != n_rows:
            raise ValueError(f"inv must be int64 [{n_rows}, D_max], got "
                             f"{inv.dtype} {tuple(inv.shape)}")
        pos = inv.contiguous()
        _check_range(pos, -1, m, "inverse index position")
        stride, offsets_ptr = pos.shape[1], None
    out = torch.empty((n_rows, d), dtype=ct.dtype, device=ct.device)
    lib = _lib("table_scatter_add")
    stream = torch.cuda.current_stream(ct.device).cuda_stream
    check(lib, lib.df2_table_scatter_add(
        int(ct.dtype == torch.bfloat16), ct.data_ptr(), pos.data_ptr(),
        offsets_ptr, stride, out.data_ptr(), n_rows, row_bytes, stream),
        "table_scatter_add launch")
    table_scatter_add.launches += 1
    return out


table_scatter_add.launches = 0


class NeighborGather(torch.autograd.Function):
    """``table[idx]`` for table [N, D] and int32 idx [N, K] → [N, K, D]:
    forward :func:`table_gather`, backward :func:`table_scatter_add` of
    the cotangent back onto the table's rows (through ``inv`` when
    given). idx and inv get no gradient."""

    @staticmethod
    def forward(ctx, table, idx, inv):
        ctx.save_for_backward(idx, inv)
        ctx.n_rows = table.shape[0]
        n, k = idx.shape
        return table_gather(table, idx.reshape(-1)).reshape(n, k, -1)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        idx, inv = ctx.saved_tensors
        n, k = idx.shape
        d_table = table_scatter_add(ct.reshape(n * k, -1).contiguous(),
                                    idx.reshape(-1), ctx.n_rows, inv)
        return d_table, None, None


def neighbor_gather(table: torch.Tensor, idx: torch.Tensor,
                    inv: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable ``table[idx]``: table [N, D], int32 idx [N, K] in
    [0, N), optional ``inv`` = :func:`build_inverse_index` of the neighbor
    lists idx came from. Returns [N, K, D]."""
    return NeighborGather.apply(table, idx, inv)
