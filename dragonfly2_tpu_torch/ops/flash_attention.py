"""Attention kernels — port of ``dragonfly2_tpu/ops/flash_attention.py``.

Two wrappers, each launching hand-written kernels on CUDA tensors (or
raising) and running their plain PyTorch twins on CPU tensors:

- :func:`graph_flash_attention` (K1, ``csrc/graph_flash_attention.cu``):
  neighbor-masked graph attention; its twin
  :func:`graph_flash_attention_plain` ports ``sparse_graph_attention``.
  The GraphTransformer's blocks, flash and ring modes call it. Under
  autograd it runs :class:`GraphFlashAttention`: the forward also writes
  the row statistics (lse), and the backward is a two-pass gradient — dQ
  and dval per query row, dK and dV per key row through the inverse index
  — whose twin is :func:`graph_flash_attention_backward_plain`.
- :func:`flash_attention` (K3, ``csrc/flash_attention_sm90.cu`` for bf16
  at head_dim 64 and 128, ``csrc/flash_attention.cu`` otherwise; see
  :func:`k3_route`): plain or
  causal softmax attention over ``[T, heads, head_dim]``, forward and a
  hand-written backward joined in :class:`FlashAttention`; its twin is
  :func:`chunked_attention`, which the JAX package's backward
  differentiates. Ulysses sequence parallelism
  (``dragonfly2_tpu_torch/parallel/ulysses.py``) runs it as each rank's
  local attention.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from dragonfly2_tpu_torch.ops._build import check, load_library
from dragonfly2_tpu_torch.ops.table_gather import build_inverse_index

NEG_INF = -1e9  # the mask value of both TPU kernels: finite, not -inf

# The K1 kernels keep a row's valid neighbor ids and biases in shared
# memory (8 bytes a slot for each of 8 warps: K <= 512 stays within
# 48 KB) and spread the row's heads * d elements over one warp, the same
# number per lane (1 to 16), each head on its own power-of-two group of
# lanes (csrc/graph_flash_attention.cu).
MAX_SLOTS = 512
ROW_WIDTHS = (32, 64, 128, 256, 512)
# The backward's launches (``parts`` of :func:`launch_graph_backward`).
GBWD_DQ, GBWD_KV = 1, 2
GBWD_ALL = GBWD_DQ | GBWD_KV


def graph_flash_attention_plain(q, k, v, nbr, val, block: int = 128,
                                return_lse: bool = False):
    """Plain PyTorch twin: online softmax over key blocks of ``block``
    columns with f32 scores and (m, l, acc), p rounded to q's dtype
    before P·V, the [rows, block] bias and mask scattered from the
    neighbor lists per block — the algebra of ``sparse_graph_attention``
    (which rounds bf16 scores before the f32 softmax; the kernel does
    not). The last key block may be ragged (the
    TPU kernel pads instead; padded columns are unreachable either way).

    q [Nq, h, d], k/v [Nk, h, d]; nbr/val [Nq, K] with ids in k's index
    space (ids outside [0, Nk) are masked). Returns [Nq, h, d] in q's
    dtype; a row with no valid slot gives 0. With ``return_lse`` also
    lse [Nq, h] f32 = m + log(l), −inf for a row with no valid slot.
    """
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
        # f32 scores, as the kernel keeps them (its backward recomputes p
        # from them against this lse).
        s = torch.einsum("nhd,bhd->nhb", q.float(), kj.float()) * scale
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
    out = (acc / l.clamp_min(1e-20)[..., None]).to(q.dtype)
    return (out, m + torch.log(l)) if return_lse else out


def graph_flash_attention_backward_plain(q, k, v, nbr, val, lse, dout, inv):
    """Plain twin of the K1 backward kernels' algorithm, in f32. Per
    slot (a gather of its k and v rows): p = exp(s − lse), 0 at masked
    slots, and d = dO·v − r, with r the row's first valid slot's dO·v.
    Per (row, head): delta = Σ p·d / Σ p, dq = scale·(Σ p·d·k − delta·
    Σ p·k); per slot ds = p·(d − delta), dval = Σ_heads ds. Then dk and
    dv summed per key row over ``inv`` ([Nk, D] int64 flat positions
    i·K + s, ascending, −1 padding; see ``build_inverse_index``) in
    position order. This is the exact gradient (delta = Σ p·dO·v), not
    FlashAttention-2's rowsum(dO ∘ out): out is rounded, and where a
    row's softmax is peaked that rounding is as large as the dp − delta
    it must cancel. Dividing by Σ p (1 up to lse's rounding) and the
    shift by r keep that cancellation exact (see the kernel's note).
    Returns (dq, dk, dv) in q's dtype and dval [Nq, K] f32."""
    n_q, heads, d = q.shape
    n_k, kw = k.shape[0], nbr.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    valid = (nbr >= 0) & (nbr < n_k)
    idx = torch.where(valid, nbr, 0).long()
    first = idx[torch.arange(n_q, device=q.device), valid.int().argmax(1)]
    r = (dof * vf[first]).sum(-1)                               # [Nq, h]
    p = torch.zeros((n_q, kw, heads), dtype=torch.float32, device=q.device)
    dp = torch.zeros_like(p)
    delta = torch.zeros((n_q, heads), dtype=torch.float32, device=q.device)
    psum = torch.zeros_like(delta)
    a, b = torch.zeros_like(qf), torch.zeros_like(qf)
    for s in range(kw):
        kc, vc = kf[idx[:, s]], vf[idx[:, s]]
        score = (qf * kc).sum(-1) * scale + val[:, s, None]
        p[:, s] = torch.where(valid[:, s, None], torch.exp(score - lse), 0.0)
        dp[:, s] = (dof * vc).sum(-1) - r
        pd = p[:, s] * dp[:, s]
        delta += pd
        psum += p[:, s]
        a += pd[..., None] * kc
        b += p[:, s, :, None] * kc
    delta = torch.where(psum > 0, delta / psum, 0.0)
    dq = a - delta[..., None] * b
    ds = p * (dp - delta[:, None])
    dval = ds.sum(-1)
    p, ds = p.view(-1, heads), ds.view(-1, heads)
    dk = torch.zeros((n_k, heads, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for j in range(inv.shape[1]):
        pos = inv[:, j]
        live = ((pos >= 0) & (pos < n_q * kw))[:, None]
        pos = torch.where(live[:, 0], pos, 0)
        rows = pos // kw
        dv += torch.where(live, p[pos], 0.0)[..., None] * dof[rows]
        dk += torch.where(live, ds[pos], 0.0)[..., None] * qf[rows]
    return ((dq * scale).to(q.dtype), (dk * scale).to(q.dtype),
            dv.to(q.dtype), dval)


def check_graph_flash_heads(heads: int, head_dim: int, kw: int = 1) -> None:
    """Raise unless the K1 kernels take ``heads`` heads of ``head_dim``
    and ``kw`` slots a row: heads dividing 32, heads · head_dim in
    :data:`ROW_WIDTHS`, K ≤ :data:`MAX_SLOTS`."""
    if (heads < 1 or 32 % heads or heads * head_dim not in ROW_WIDTHS
            or kw > MAX_SLOTS):
        raise ValueError(f"kernel takes heads dividing 32, heads * head_dim "
                         f"in {ROW_WIDTHS} and K <= {MAX_SLOTS}, got heads "
                         f"{heads}, head_dim {head_dim}, K {kw}")


def check_graph_flash_inputs(q, k, v, nbr, val) -> None:
    """Raise unless q/k/v/nbr/val are what the K1 kernels take, on any
    device: q [Nq, h, d] and k/v [Nk, h, d] of one dtype (bf16 or f32),
    nbr int32 and val float32 [Nq, K]; h dividing 32, h·d in
    :data:`ROW_WIDTHS` and K ≤ :data:`MAX_SLOTS`; contiguous, and q, k, v
    aligned to the h·d/32 elements a lane loads at once."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or nbr.dim() != 2:
        raise ValueError(f"expected q/k/v [N, heads, head_dim] and nbr/val "
                         f"[Nq, K], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(nbr.shape)}")
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
    check_graph_flash_heads(heads, d, kw)
    if not all(t.is_contiguous() for t in (q, k, v, nbr, val)):
        raise ValueError("q, k, v, nbr and val must be contiguous")
    vec_bytes = heads * d // 32 * q.element_size()
    if any(t.data_ptr() % vec_bytes for t in (q, k, v)):
        raise ValueError(f"q, k and v must be {vec_bytes}-byte aligned")


def check_inverse_index(inv, k) -> None:
    """Raise unless ``inv`` is an inverse index for k's rows: int64
    [Nk, D], contiguous, on k's device."""
    if (inv.dtype != torch.int64 or inv.dim() != 2
            or inv.shape[0] != k.shape[0] or not inv.is_contiguous()
            or inv.device != k.device):
        raise ValueError(f"inv must be a contiguous int64 [{k.shape[0]}, D] "
                         f"tensor on {k.device}, got {inv.dtype} "
                         f"{tuple(inv.shape)} on {inv.device}")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind_graph_library(load_library("graph_flash_attention"))


def bind_graph_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of ``csrc/graph_flash_attention.cu``."""
    lib.df2_graph_flash_attention.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p])
    lib.df2_graph_flash_attention_bwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.df2_graph_flash_attention.restype = ctypes.c_int
    lib.df2_graph_flash_attention_bwd.restype = ctypes.c_int
    return lib


def graph_flash_forward(q, k, v, nbr, val, with_lse: bool):
    """Launch the K1 forward on checked CUDA inputs: out like q and, with
    ``with_lse``, lse [Nq, h] f32 (else None). Counts a launch."""
    n_q, heads, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((n_q, heads), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    check(lib, lib.df2_graph_flash_attention(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), nbr.data_ptr(), val.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), n_q, k.shape[0], heads, d,
        nbr.shape[1], 1.0 / math.sqrt(d), stream),
        "graph_flash_attention launch")
    graph_flash_attention.launches += 1
    return out, lse


def graph_backward_scratch(q) -> dict:
    """The K1 backward's device scratch: "stats", f32 [Nq, h, 4], each
    (row, head)'s (lse, r, delta, unused) that the dQ pass leaves for the
    dK/dV pass. Nothing of size Nq·K: the dK/dV pass recomputes p and ds."""
    return {"stats": torch.empty((q.shape[0], q.shape[1], 4),
                                 dtype=torch.float32, device=q.device)}


def launch_graph_backward(q, k, v, nbr, val, lse, dout, inv, dq, dk, dv, dval,
                          scratch: dict, parts: int = GBWD_ALL) -> None:
    """Launch the K1 backward's ``parts`` (``GBWD_DQ``: dq, the scratch's
    stats and dval at masked slots; ``GBWD_KV``: dk, dv and dval at valid
    slots, from the stats) into dq, dk, dv and dval; counts nothing."""
    n_q, heads, d = q.shape
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [t.data_ptr() for t in (q, k, v, dout, lse, nbr, val, inv, dq,
                                   dk, dv, dval, scratch["stats"])]
    check(lib, lib.df2_graph_flash_attention_bwd(
        int(q.dtype == torch.bfloat16), *ptrs, n_q, k.shape[0], heads, d,
        nbr.shape[1], inv.shape[1], 1.0 / math.sqrt(d), parts, stream),
        "graph_flash_attention backward launch")


def graph_flash_backward(q, k, v, nbr, val, lse, dout, inv):
    """Launch the K1 backward (the dQ pass, then the dK/dV pass) for the
    forward that gave lse; dout like its out, contiguous. Returns dq, dk,
    dv like q and k, and dval [Nq, K] f32. Counts one backward."""
    vec_bytes = q.shape[1] * q.shape[2] // 32 * q.element_size()
    if dout.data_ptr() % vec_bytes:
        dout = dout.clone()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dval = torch.empty_like(val)
    launch_graph_backward(q, k, v, nbr, val, lse, dout, inv, dq, dk, dv, dval,
                          graph_backward_scratch(q))
    graph_flash_attention.backward_launches += 1
    return dq, dk, dv, dval


class GraphFlashAttention(torch.autograd.Function):
    """K1 under autograd. CUDA tensors: the forward kernel with lse, and
    the two backward kernels. CPU tensors: the plain twins, with the
    inverse index built from nbr when none is given."""

    @staticmethod
    def forward(ctx, q, k, v, nbr, val, inv, block):
        if q.device.type == "cpu":
            out, lse = graph_flash_attention_plain(q, k, v, nbr, val, block,
                                                   return_lse=True)
            if inv is None:
                inv = torch.from_numpy(build_inverse_index(nbr.numpy(),
                                                           k.shape[0]))
        else:
            out, lse = graph_flash_forward(q, k, v, nbr, val, with_lse=True)
        ctx.save_for_backward(q, k, v, nbr, val, lse, inv)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, nbr, val, lse, inv = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        backward = (graph_flash_attention_backward_plain
                    if q.device.type == "cpu" else graph_flash_backward)
        dq, dk, dv, dval = backward(q, k, v, nbr, val, lse, dout, inv)
        return dq, dk, dv, None, dval, None, None


def graph_flash_attention(q, k, v, nbr, val, block: int = 128, inv=None):
    """Neighbor-masked attention: scores + RTT bias on listed neighbors,
    masked elsewhere, rows with no in-range neighbor give 0.

    q [Nq, h, d], k/v [Nk, h, d] (one floating dtype); nbr [Nq, K] int32,
    val [Nq, K] float32; ``inv`` the inverse index of nbr over k's rows
    (``build_inverse_index``), which the backward walks. CPU tensors take
    the plain twins, the forward over key blocks of ``block`` columns (and
    build ``inv`` themselves when it is None). CUDA tensors launch the
    kernels (which need no blocking; see :func:`check_graph_flash_inputs`
    for what they take) or raise — also under autograd without ``inv``,
    which is never built on the device here. Whenever a gradient is
    needed the call goes through :class:`GraphFlashAttention`. Returns
    [Nq, h, d] in q's dtype.
    """
    tensors = (q, k, v, nbr, val)
    cpu = all(t.device.type == "cpu" for t in tensors)
    if not cpu:
        if (any(t.device != q.device for t in tensors)
                or q.device.type != "cuda"):
            raise ValueError("q, k, v, nbr and val must all be on one CUDA "
                             "device")
        check_graph_flash_inputs(*tensors)
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v, val))):
        if cpu:
            return graph_flash_attention_plain(q, k, v, nbr, val, block)
        return graph_flash_forward(q, k, v, nbr, val, with_lse=False)[0]
    if inv is None and not cpu:
        raise ValueError("graph_flash_attention needs the inverse index "
                         "under autograd on the card: pass inv = "
                         "build_inverse_index(nbr), placed on the device")
    if inv is not None:
        check_inverse_index(inv, k)
    return GraphFlashAttention.apply(q, k, v, nbr, val, inv, block)


graph_flash_attention.launches = 0
graph_flash_attention.backward_launches = 0


# ----------------------------------------------------------------------
# K3: plain or causal sequence attention

HEAD_DIMS = (4, 8, 16, 32, 64, 128)   # head widths the K3 kernels take
# The CPU scan's key block: the JAX backward's max(block_k, 512) at the
# JAX package's default blocks.
CPU_BLOCK = 512


def _chunk_step(q, kj, vj, m, l, acc, start: int, causal: bool,
                scale: float):
    """One key block of the online softmax: (m, l, acc) → the next."""
    t = q.shape[0]
    s = torch.einsum("nhd,mhd->hnm", q, kj).float() * scale
    k_pos = start + torch.arange(kj.shape[0], device=q.device)
    mask = (k_pos < t)[None, None, :]
    if causal:
        q_pos = torch.arange(t, device=q.device)
        mask = mask & (q_pos[:, None] >= k_pos[None, :])[None]
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None]) * mask
    fold = torch.exp(m - m_new)
    l = l * fold + p.sum(-1)
    acc = acc * fold.transpose(0, 1)[..., None] + torch.einsum(
        "hnm,mhd->nhd", p.to(q.dtype), vj).float()
    return m_new, l, acc


def chunked_attention(q, k, v, causal: bool = False, block: int = 512,
                      scale: float | None = None):
    """Key-blocked online-softmax attention in plain PyTorch (port of
    ``chunked_attention``): f32 (m, l, acc), p in q's dtype before P·V,
    out = acc / max(l, 1e-20); scores scaled by ``scale`` (default
    1/sqrt(head_dim)). The plain twin of the K3 kernel, forward
    and backward: under autograd each key block runs under
    ``torch.utils.checkpoint`` (``jax.checkpoint(step)``'s counterpart),
    so a backward keeps O(T·block) scores alive, not [T, T]. The last
    block may be ragged (a slice here does not clamp, so nothing is
    padded). q/k/v [T, h, d] → [T, h, d] in q's dtype."""
    chunked_attention.calls += 1
    t, heads, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    block = min(block, t)
    m = torch.full((heads, t), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((t, heads, d), dtype=torch.float32, device=q.device)
    grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    for start in range(0, t, block):
        args = (q, k[start:start + block], v[start:start + block], m, l, acc,
                start, causal, scale)
        m, l, acc = (checkpoint(_chunk_step, *args, use_reentrant=False)
                     if grad else _chunk_step(*args))
    denom = l.clamp_min(1e-20).transpose(0, 1)[..., None]
    return (acc / denom).to(q.dtype)


chunked_attention.calls = 0


def _tile_scores(q, k, q0: int, k0: int, t: int, causal: bool,
                 scale: float):
    """Scaled f32 scores [h, tq, tk] of a query tile (rows q0 ..) against
    a key tile (rows k0 ..) of length-t sequences, and the mask of visible
    pairs (keys past T absent; under causal no later key)."""
    s = torch.einsum("nhd,mhd->hnm", q.float(), k.float()) * scale
    q_pos = q0 + torch.arange(q.shape[0], device=q.device)
    k_pos = k0 + torch.arange(k.shape[0], device=q.device)
    mask = (k_pos < t)[None, :] & (q_pos < t)[:, None]
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])
    return s, mask[None]


# The bf16 forward kernel's tiling (csrc/flash_attention.cu,
# fwd_ring_kernel) by head_dim: (keys a tile, how many of its blocks of 8
# keys, the last ones, take the polynomial exp2 on the FP32 pipes; the
# rest take the SFU's ex2.approx). Other head_dims: 128-key tiles, no
# polynomial. EXP2_POLY: the cubic's coefficients (constant first) as
# float32, the minimax fit of relative error to 2^f on [0, 1) with
# p(0) = 1 (so p stays in [1, 2) and j lands in the exponent exactly):
# 8.6e-5 at most. EXP2_POLY_REL_ERR bounds it over [-126, 0].
FORWARD_TILING = {4: (128, 1), 8: (128, 1), 16: (128, 1), 32: (64, 1)}
EXP2_POLY = (1.0, 0.6951168, 0.22764485, 0.077067174)
EXP2_POLY_REL_ERR = 1e-4
LOG2E = 1.4426950408889634


def exp2_ftz(x):
    """2^x as ``ex2.approx.ftz`` gives it: results below 2^-126 (x below
    -126, a masked -inf too) flush to exactly 0."""
    return torch.where(x < -126, 0.0, torch.exp2(x))


def exp2_poly(x):
    """2^x as the kernel's ``exp2_poly`` computes it on f32 ``x``: 2^j ·
    p(f) with j = floor(x), f = x − j and p the cubic :data:`EXP2_POLY`,
    j added to p's exponent bits; exactly 0 below -126 (a masked -inf
    too), where ``ex2.approx.ftz`` gives 0."""
    zero = x < -126
    x = torch.where(zero, 0.0, x)
    j = torch.floor(x)
    f = x - j
    c0, c1, c2, c3 = (torch.tensor(c, dtype=torch.float32)
                      for c in EXP2_POLY)
    p = ((c3 * f + c2) * f + c1) * f + c0
    bits = p.view(torch.int32).long() + j.long() * (1 << 23)
    return torch.where(zero, 0.0, bits.int().view(torch.float32))


def forward_tiling(head_dim: int) -> tuple[int, int]:
    """(key tile, polynomial blocks) of the bf16 forward at head_dim."""
    return FORWARD_TILING.get(head_dim, (128, 0))


def poly_columns(tile: int, poly_blocks: int, device=None):
    """Which of a key tile's columns take :func:`exp2_poly`: the last
    ``poly_blocks`` blocks of 8."""
    return torch.arange(tile, device=device) // 8 >= tile // 8 - poly_blocks


def flash_forward_plain(q, k, v, causal: bool,
                        poly_blocks: int | None = None):
    """Plain twin of the K3 forward kernels' arithmetic, tile by tile:
    (out like q, lse [h, T] f32), online softmax over the bf16 kernel's
    key tiles (:func:`forward_tiling`) with f32 (m, l, acc) and p =
    2^(s·scale·log2e − m·scale·log2e), p rounded to q's dtype before P·V,
    lse = m + log(l). Of each tile's columns, the last ``poly_blocks``
    blocks of 8 take :func:`exp2_poly` and the rest :func:`exp2_ftz`, as
    the bf16 kernel splits them; ``None`` means the kernel's split for
    bf16 and none for f32 (the f32 kernel has no split)."""
    t, heads, d = q.shape
    scale = 1.0 / math.sqrt(d)
    scale2 = scale * LOG2E
    tile, kernel_poly = forward_tiling(d)
    if poly_blocks is None:
        poly_blocks = kernel_poly if q.dtype == torch.bfloat16 else 0
    poly = poly_columns(tile, poly_blocks, q.device)
    m = torch.full((heads, t), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((heads, t, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, t, tile):
        # Unscaled scores: m is kept in their units, as the kernel keeps it.
        s, mask = _tile_scores(q, k[k0:k0 + tile], 0, k0, t, causal, 1.0)
        m_new = torch.maximum(m, torch.where(mask, s, NEG_INF).amax(-1))
        x = torch.where(mask, s * scale2 - (m_new * scale2)[..., None],
                        -math.inf)
        cols = poly[:x.shape[-1]]
        p = torch.where(cols, exp2_poly(x), exp2_ftz(x))
        fold = exp2_ftz((m - m_new) * scale2)
        l = l * fold + p.sum(-1)
        acc = acc * fold[..., None] + torch.einsum(
            "hnm,mhd->hnd", p.to(q.dtype).float(), v[k0:k0 + tile].float())
        m = m_new
    out = (acc / l.clamp_min(1e-20)[..., None]).transpose(0, 1)
    return out.to(q.dtype), m * scale + torch.log(l)


def flash_backward_plain(q, k, v, out, dout, lse, causal: bool,
                         tile: int = 64):
    """Plain twin of the K3 backward kernels' order, tile by tile:
    delta = rowsum(dO ∘ O) from ``out`` as given (the kernel's rounded
    out); for each key tile from the last, for each query tile in
    ascending order, P once (p = exp(s − lse), masked) and dS = P ∘ (dP −
    delta), both rounded to q's dtype where a product takes them; dK and
    dV summed over the query tiles, dQ's terms added in descending
    key-tile order. Returns (dq, dk, dv) like q."""
    t, heads, d = q.shape
    scale = 1.0 / math.sqrt(d)
    delta = (dout.float() * out.float()).sum(-1).transpose(0, 1)  # [h, T]
    dq = torch.zeros((heads, t, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    for k0 in reversed(range(0, t, tile)):
        kj, vj = k[k0:k0 + tile], v[k0:k0 + tile]
        for q0 in range(k0 if causal else 0, t, tile):
            qi, doi = q[q0:q0 + tile], dout[q0:q0 + tile]
            s, mask = _tile_scores(qi, kj, q0, k0, t, causal, scale)
            p = torch.exp(s - lse[:, q0:q0 + tile, None]) * mask
            dp = torch.einsum("nhd,mhd->hnm", doi.float(), vj.float())
            ds = (p * (dp - delta[:, q0:q0 + tile, None])).to(q.dtype).float()
            p = p.to(q.dtype).float()
            dv[:, k0:k0 + tile] += torch.einsum("hnm,nhd->hmd", p,
                                                doi.float())
            dk[:, k0:k0 + tile] += torch.einsum("hnm,nhd->hmd", ds,
                                                qi.float())
            dq[:, q0:q0 + tile] += torch.einsum("hnm,mhd->hnd", ds,
                                                kj.float())
    return tuple((g * mul).transpose(0, 1).to(q.dtype)
                 for g, mul in ((dq, scale), (dk, scale), (dv, 1.0)))


def kernel_head_dim(d: int) -> int:
    """The head width the K3 kernels run a head_dim-``d`` input at: the
    least of :data:`HEAD_DIMS` that is at least d. Raises for d outside
    [1, 128]."""
    for width in HEAD_DIMS:
        if 1 <= d <= width:
            return width
    raise ValueError(f"K3 takes head_dim from 1 to {HEAD_DIMS[-1]}, got {d}")


def pad_head_dim(q, k, v):
    """q, k, v ([T, h, d]) zero-padded along head_dim to
    :func:`kernel_head_dim` (the same tensors when d is a width the
    kernels take). Exact when the scores keep d's scale: zero columns add
    nothing to q·k, and give zero output and gradient columns, which the
    caller slices off."""
    extra = kernel_head_dim(q.shape[-1]) - q.shape[-1]
    if extra == 0:
        return q, k, v
    return tuple(F.pad(x, (0, extra)) for x in (q, k, v))


def check_flash_inputs(q, k, v) -> None:
    """Raise unless q/k/v are what the K3 kernels take: one shape
    [T, h, d] with T, h >= 1 and d in :data:`HEAD_DIMS`, one dtype (bf16
    or f32), contiguous and 16-byte aligned (the bf16 kernels load 16-byte
    vectors). Devices are the caller's concern."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected q, k, v of one shape [T, heads, "
                         f"head_dim], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    t, heads, d = q.shape
    if t < 1 or heads < 1 or d not in HEAD_DIMS:
        raise ValueError(f"kernel takes T >= 1, heads >= 1 and head_dim in "
                         f"{HEAD_DIMS}, got {tuple(q.shape)}")
    if q.dtype not in (torch.bfloat16, torch.float32) or not (
            k.dtype == v.dtype == q.dtype):
        raise TypeError(f"q/k/v must share bf16 or f32, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not all(x.is_contiguous() for x in (q, k, v)):
        raise ValueError("q, k and v must be contiguous")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")


SM90_HEAD_DIMS = (64, 128)  # bf16 widths of csrc/flash_attention_sm90.cu
BWD_DELTA, BWD_KV, BWD_Q = 1, 2, 4   # the backward's launches (``parts``)
BWD_ALL = BWD_DELTA | BWD_KV | BWD_Q


def k3_route(dtype, head_dim: int, row_bytes: int) -> str:
    """Which K3 kernels take q/k/v of this dtype, head_dim and row stride
    (bytes from one position to the next, heads · head_dim · element
    size): ``"sm90"`` (TMA + wgmma, ``csrc/flash_attention_sm90.cu``) for
    bf16 at head_dim 64 or 128, where TMA's 16-byte global strides hold;
    ``"mma"`` (``mma.sync`` and ``cp.async``, ``csrc/flash_attention.cu``)
    for other bf16; ``"fma"`` (f32 FMAs, same file) for f32."""
    if dtype == torch.float32:
        return "fma"
    if head_dim in SM90_HEAD_DIMS and row_bytes % 16 == 0:
        return "sm90"
    return "mma"


def _route(q) -> str:
    _, heads, d = q.shape
    return k3_route(q.dtype, d, heads * d * q.element_size())


@functools.lru_cache(maxsize=None)
def _flash_lib() -> ctypes.CDLL:
    return bind_flash_library(load_library("flash_attention"))


@functools.lru_cache(maxsize=None)
def _sm90_lib() -> ctypes.CDLL:
    return bind_sm90_library(load_library("flash_attention_sm90"))


def bind_flash_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of ``csrc/flash_attention.cu``."""
    lib.df2_flash_attention_fwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p])
    lib.df2_flash_attention_bwd.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.df2_flash_attention_exp_split.argtypes = [
        ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
    lib.df2_flash_attention_fwd.restype = ctypes.c_int
    lib.df2_flash_attention_bwd.restype = ctypes.c_int
    lib.df2_flash_attention_exp_split.restype = ctypes.c_int
    return lib


def kernel_exp_split(head_dim: int) -> tuple[int, int]:
    """(key tile, polynomial blocks) as the built bf16 forward kernel has
    them at head_dim; the plain twin's are :func:`forward_tiling`'s.
    Builds the library."""
    tile, poly = ctypes.c_int(), ctypes.c_int()
    lib = _flash_lib()
    check(lib, lib.df2_flash_attention_exp_split(
        head_dim, ctypes.byref(tile), ctypes.byref(poly)),
          "flash_attention exp split")
    return tile.value, poly.value


def bind_sm90_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of ``csrc/flash_attention_sm90.cu``."""
    lib.df2_flash_attention_sm90_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p])
    lib.df2_flash_attention_sm90_bwd.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.df2_flash_attention_sm90_fwd.restype = ctypes.c_int
    lib.df2_flash_attention_sm90_bwd.restype = ctypes.c_int
    return lib


def backward_scratch(q) -> dict:
    """The backward's device scratch for q's shape and route: delta
    [h, T] f32; on the "mma" route also dQ's f32 sum [T, h, d] and its
    per-(head, 64-row query tile) turn counters, int32 zeros that the
    kernel leaves zero."""
    t, heads, d = q.shape
    scratch = {"delta": torch.empty((heads, t), dtype=torch.float32,
                                    device=q.device),
               "dq_acc": None, "dq_turn": None}
    if _route(q) == "mma":
        scratch["dq_acc"] = torch.empty((t, heads, d), dtype=torch.float32,
                                        device=q.device)
        scratch["dq_turn"] = torch.zeros((heads, -(-t // 64)),
                                         dtype=torch.int32, device=q.device)
    return scratch


def launch_backward(q, k, v, out, dout, lse, causal: bool, dq, dk, dv,
                    scratch: dict, parts: int = BWD_ALL,
                    scale: float | None = None) -> str:
    """Launch the K3 backward's ``parts`` (``BWD_DELTA``, ``BWD_KV``,
    ``BWD_Q``; later parts read delta from ``scratch``) into dq, dk and
    dv; counts nothing. On the "mma" route ``BWD_KV`` is the fused block
    that also gives dq, and ``BWD_Q`` launches nothing. ``scale``
    defaults to 1/sqrt(head_dim). Returns the route."""
    t, heads, d = q.shape
    route = _route(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), scratch["delta"].data_ptr()]
    grads = [dq.data_ptr(), dk.data_ptr(), dv.data_ptr()]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    if route == "sm90":
        lib = _sm90_lib()
        rc = lib.df2_flash_attention_sm90_bwd(
            *ptrs, *grads, t, heads, d, int(causal), scale, parts, stream)
    else:
        fused = [None if scratch[n] is None else scratch[n].data_ptr()
                 for n in ("dq_acc", "dq_turn")]
        lib = _flash_lib()
        rc = lib.df2_flash_attention_bwd(
            int(q.dtype == torch.bfloat16), *ptrs, *fused, *grads, t, heads,
            d, int(causal), scale, parts, stream)
    check(lib, rc, "flash_attention backward launch")
    return route


def flash_forward(q, k, v, causal: bool, scale: float | None = None):
    """Launch the K3 forward on checked CUDA q/k/v: returns out (like q)
    and lse [h, T] f32, the per-row log-sum-exp the backward needs.
    ``scale`` defaults to 1/sqrt(head_dim)."""
    t, heads, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    out = torch.empty_like(q)
    lse = torch.empty((heads, t), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr())
    if _route(q) == "sm90":
        lib = _sm90_lib()
        rc = lib.df2_flash_attention_sm90_fwd(
            *ptrs, t, heads, d, int(causal), scale, stream)
    else:
        lib = _flash_lib()
        rc = lib.df2_flash_attention_fwd(
            int(q.dtype == torch.bfloat16), *ptrs, t, heads, d, int(causal),
            scale, stream)
    check(lib, rc, "flash_attention launch")
    flash_attention.launches += 1
    return out, lse


def flash_backward(q, k, v, out, dout, lse, causal: bool,
                   scale: float | None = None):
    """Launch the K3 backward (delta, then dK/dV and dQ: two kernels on
    the "sm90" and "fma" routes, one fused on "mma") for the forward that
    gave out and lse; dout like out. Returns dq, dk, dv like q."""
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    launch_backward(q, k, v, out, dout, lse, causal, dq, dk, dv,
                    backward_scratch(q), scale=scale)
    flash_attention.backward_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K3 on the card: forward kernel, backward kernels under autograd."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out,
                                    dout.to(q.dtype).contiguous(), lse,
                                    ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False):
    """Softmax attention over q/k/v [T, heads, head_dim] (one floating
    dtype) → [T, heads, head_dim] in q's dtype; keys past T are absent
    and, under ``causal``, a query sees no later key.

    CPU tensors take :func:`chunked_attention` over key blocks of
    :data:`CPU_BLOCK` columns, with PyTorch's autograd. CUDA tensors
    launch the K3 kernels (forward, and the backward under autograd) or
    raise — see :func:`check_flash_inputs` for what they take. A head_dim
    up to 128 that is not one of :data:`HEAD_DIMS` runs zero-padded to the
    next (:func:`pad_head_dim`), with the scale of the true head_dim.
    Unlike the JAX function this takes no ``block_q``/``block_k``: the
    kernels pick their own tiles, and the CPU scan's block is fixed.
    """
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return chunked_attention(q, k, v, causal, block=CPU_BLOCK)
    if any(x.device != q.device for x in (k, v)) or q.device.type != "cuda":
        raise ValueError("q, k and v must all be on one CUDA device")
    d = q.shape[-1]
    if q.dim() == 3 and k.shape == v.shape == q.shape:
        q, k, v = pad_head_dim(q, k, v)
    check_flash_inputs(q, k, v)
    out = FlashAttention.apply(q, k, v, bool(causal), 1.0 / math.sqrt(d))
    return out if out.shape[-1] == d else out[..., :d]


flash_attention.launches = 0
flash_attention.backward_launches = 0
