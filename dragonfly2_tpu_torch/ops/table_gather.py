"""Row gather ``table[idx]`` — port of ``dragonfly2_tpu/ops/table_gather.py``.

On a CUDA tensor :func:`table_gather` launches the hand-written kernel in
``csrc/table_gather.cu`` (which notes what bounds it and how); on CPU
tensors it runs :func:`table_gather_plain`. The GraphTransformer's gather
mode calls it for its ``[k|v]`` neighbor gather.

The scatter-add (training backward, ``table_scatter_add``) is not ported
yet; see ROADMAP.md Queue 2.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dragonfly2_tpu_torch.ops._build import check, load_library


def table_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``table[idx]``: table [N, D], idx [M] → [M, D]."""
    return table[idx.long()]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("table_gather")
    lib.df2_table_gather.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    lib.df2_table_gather.restype = ctypes.c_int
    return lib


def table_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for table [N, D] and int32 idx [M] in [0, N).

    CPU tensors take :func:`table_gather_plain`. CUDA tensors launch the
    kernel (bit-identical to ``table.index_select(0, idx)``) or raise:
    rows must be contiguous, 16-byte aligned and a multiple of 16 bytes
    wide, and every index must lie in [0, N) — checked here, since the
    kernel reads whatever row an index names.
    """
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return table_gather_plain(table, idx)
    if table.device != idx.device or table.device.type != "cuda":
        raise ValueError(f"table on {table.device}, idx on {idx.device}: "
                         "both must be on one CUDA device")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"expected table [N, D] and idx [M], got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    n, d = table.shape
    row_bytes = d * table.element_size()
    if (not table.is_contiguous() or row_bytes % 16
            or table.data_ptr() % 16):
        raise ValueError("table rows must be contiguous, 16-byte aligned and "
                         f"a multiple of 16 bytes wide (row is {row_bytes} B)")
    idx = idx.contiguous()
    m = idx.shape[0]
    if m:
        lo, hi = torch.aminmax(idx)
        if int(lo) < 0 or int(hi) >= n:
            raise IndexError(f"gather index out of range [0, {n}): "
                             f"min {int(lo)}, max {int(hi)}")
    out = torch.empty((m, d), dtype=table.dtype, device=table.device)
    lib = _lib()
    stream = torch.cuda.current_stream(table.device).cuda_stream
    check(lib, lib.df2_table_gather(table.data_ptr(), idx.data_ptr(),
                                    out.data_ptr(), m, row_bytes, stream),
          "table_gather launch")
    table_gather.launches += 1
    return out


table_gather.launches = 0
