"""Neighbor-masked graph attention — port of ``graph_flash_attention``
(``dragonfly2_tpu/ops/flash_attention.py``).

On CUDA tensors :func:`graph_flash_attention` launches the hand-written
kernel in ``csrc/graph_flash_attention.cu`` (which notes what bounds it
and how); on CPU tensors it runs :func:`graph_flash_attention_plain`, the
port of ``sparse_graph_attention``. The GraphTransformer's blocks/flash
modes call it. The kernel is forward only: on the card it refuses to run
under autograd (blocks/flash-mode training there is a later slice,
ROADMAP.md Queue 1), while on the CPU the plain version trains through
PyTorch's autograd.

The plain ``flash_attention`` kernel (Ulysses local attention) is not
ported yet; see ROADMAP.md Queue 2.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from dragonfly2_tpu_torch.ops._build import check, load_library

# The kernel keeps a row's neighbor ids in shared memory and spreads the
# row's heads * d elements over one warp, the same number per lane, each
# head on its own power-of-two group of lanes (csrc/graph_flash_attention.cu).
MAX_SLOTS = 256
ROW_WIDTHS = (32, 64, 128, 256)


def graph_flash_attention_plain(q, k, v, nbr, val, block: int = 128):
    """Plain PyTorch twin: online softmax over key blocks of ``block``
    columns with f32 (m, l, acc), the [rows, block] bias and mask
    scattered from the neighbor lists per block — the algebra of
    ``sparse_graph_attention``. The last key block may be ragged (the
    TPU kernel pads instead; padded columns are unreachable either way).

    q [Nq, h, d], k/v [Nk, h, d]; nbr/val [Nq, K] with ids in k's index
    space (ids outside [0, Nk) are masked). Returns [Nq, h, d] in q's
    dtype; a row with no valid slot gives 0.
    """
    from dragonfly2_tpu_torch.models.graph_transformer import NEG_INF

    n_q, heads, d = q.shape
    n_k = k.shape[0]
    scale = 1.0 / math.sqrt(d)
    nbr = nbr.long()
    rows = torch.arange(n_q, device=q.device)[:, None].expand_as(nbr)
    m = torch.full((n_q, heads), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((n_q, heads, d), dtype=torch.float32, device=q.device)
    for start in range(0, n_k, block):
        kj, vj = k[start:start + block], v[start:start + block]
        width = kj.shape[0]
        in_range = (nbr >= start) & (nbr < start + width)
        col = (nbr - start).clamp(0, width - 1)
        # Scatter-add is exact: build_neighbor_lists dedups (row, col).
        bias = torch.zeros((n_q, width), dtype=torch.float32, device=q.device)
        bias.index_put_((rows, col), torch.where(in_range, val, 0.0),
                        accumulate=True)
        hits = torch.zeros_like(bias)
        hits.index_put_((rows, col), in_range.float(), accumulate=True)
        mask = (hits > 0)[:, None, :]
        s = torch.einsum("nhd,bhd->nhb", q, kj).float() * scale
        s = torch.where(mask, s + bias[:, None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        # The mask product guards fully masked rows: exp(NEG_INF − NEG_INF)
        # = 1 would otherwise pollute l.
        p = torch.exp(s - m_new[..., None]) * mask
        fold = torch.exp(m - m_new)
        l = l * fold + p.sum(-1)
        acc = acc * fold[..., None] + torch.einsum(
            "nhb,bhd->nhd", p.to(q.dtype), vj).float()
        m = m_new
    return (acc / l.clamp_min(1e-20)[..., None]).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = load_library("graph_flash_attention")
    lib.df2_graph_flash_attention.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p])
    lib.df2_graph_flash_attention.restype = ctypes.c_int
    return lib


def graph_flash_attention(q, k, v, nbr, val, block: int = 128):
    """Neighbor-masked attention: scores + RTT bias on listed neighbors,
    masked elsewhere, rows with no in-range neighbor give 0.

    q [Nq, h, d], k/v [Nk, h, d] (one floating dtype); nbr [Nq, K] int32,
    val [Nq, K] float32. CPU tensors take the plain version over key
    blocks of ``block`` columns; CUDA tensors launch the kernel (which
    needs no blocking) or raise, also when autograd would need a gradient
    through it. Returns [Nq, h, d] in q's dtype.
    """
    tensors = (q, k, v, nbr, val)
    if all(t.device.type == "cpu" for t in tensors):
        return graph_flash_attention_plain(q, k, v, nbr, val, block)
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError("q, k, v, nbr and val must all be on one CUDA device")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, val)):
        raise NotImplementedError(
            "graph_flash_attention has no backward on the card: blocks/"
            "flash-mode training is a later slice (ROADMAP.md Queue 1); "
            "train in gather mode")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"q/k/v must share bf16 or f32, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if nbr.dtype != torch.int32 or val.dtype != torch.float32:
        raise TypeError(f"nbr must be int32 and val float32, got "
                        f"{nbr.dtype} and {val.dtype}")
    n_q, heads, d = q.shape
    n_k = k.shape[0]
    kw = nbr.shape[1]
    if (k.shape != (n_k, heads, d) or v.shape != k.shape
            or nbr.shape != (n_q, kw) or val.shape != nbr.shape):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, nbr "
                         f"{tuple(nbr.shape)}, val {tuple(val.shape)}")
    if 32 % heads or heads * d not in ROW_WIDTHS or kw > MAX_SLOTS:
        raise ValueError(f"kernel takes heads dividing 32, heads * head_dim "
                         f"in {ROW_WIDTHS} and K <= {MAX_SLOTS}, got heads "
                         f"{heads}, head_dim {d}, K {kw}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, k, v, nbr and val must be contiguous")
    out = torch.empty_like(q)
    vec_bytes = heads * d // 32 * q.element_size()
    if any(t.data_ptr() % vec_bytes for t in (q, k, v, out)):
        raise ValueError(f"q, k, v and out must be {vec_bytes}-byte aligned")
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    check(lib, lib.df2_graph_flash_attention(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), nbr.data_ptr(), val.data_ptr(), out.data_ptr(),
        n_q, n_k, heads, d, kw, 1.0 / math.sqrt(d), stream),
        "graph_flash_attention launch")
    graph_flash_attention.launches += 1
    return out


graph_flash_attention.launches = 0
