"""All-to-all (Ulysses) sequence parallelism — port of
``dragonfly2_tpu/parallel/ulysses.py``.

Each rank holds a shard ``[T/d, H, D]`` of the sequence. An all-to-all
turns it into the full sequence for H/d of the heads, ``[T, H/d, D]``;
the rank runs ordinary attention over those heads; the inverse
all-to-all restores sequence sharding. Where JAX takes one global array
sharded over a mesh axis, PyTorch runs one process per device: the
caller passes this rank's shard and a process group, and gets this
rank's shard of the output back.

The local attention is K3 (:func:`~dragonfly2_tpu_torch.ops.flash_attention`,
the hand-written kernels, forward and backward) on CUDA tensors and the
chunked online-softmax scan on CPU tensors. Each exchange is a
``torch.autograd.Function`` whose backward is the other exchange: an
all-to-all is a permutation across ranks, and its transpose is the
inverse permutation.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from dragonfly2_tpu_torch.ops.flash_attention import (
    chunked_attention,
    flash_attention,
)
from dragonfly2_tpu_torch.parallel.mesh import group_size_rank


def _seq_to_heads(x, group, size: int):
    """[T/d, H, D] → [T, H/d, D]: head group i goes to rank i, and the
    rank-major blocks received are sequence order."""
    t_loc, heads, dim = x.shape
    send = x.reshape(t_loc, size, heads // size, dim).permute(
        1, 0, 2, 3).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.view(size * t_loc, heads // size, dim)


def _heads_to_seq(y, group, size: int):
    """[T, H/d, D] → [T/d, H, D], the inverse of :func:`_seq_to_heads`."""
    t, h_loc, dim = y.shape
    send = y.contiguous().view(size, t // size, h_loc, dim)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 0, 2, 3).reshape(t // size, size * h_loc, dim)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return _seq_to_heads(x, group, size)

    @staticmethod
    def backward(ctx, grad):
        return _heads_to_seq(grad, ctx.group, ctx.size), None, None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group, size):
        ctx.group, ctx.size = group, size
        return _heads_to_seq(y, group, size)

    @staticmethod
    def backward(ctx, grad):
        grad = _seq_to_heads(grad.contiguous(), ctx.group, ctx.size)
        return grad, None, None


def ulysses_attention(q, k, v, *, group=None, causal: bool = False,
                      chunk: int = 1024):
    """Softmax attention with the sequence sharded over ``group``'s ranks,
    computed by head partitioning.

    q/k/v: this rank's shard ``[T/d, H, D]`` (rank r holds rows
    r·T/d … (r+1)·T/d − 1), with ``H`` divisible by the group size d.
    ``group=None`` is the default process group, or a world of one (no
    exchange) when none is initialized. The tensors' device picks the
    local attention: CUDA tensors run the K3 kernels, CPU tensors
    :func:`chunked_attention` over key blocks of ``chunk``. Unlike the
    JAX function there is no ``use_flash``: the plain scan never runs on
    the card. Returns this rank's shard of the output, like q.
    """
    if q.ndim != 3:
        raise ValueError(f"expected [T, heads, head_dim], got "
                         f"{tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    size, _ = group_size_rank(group)
    heads = q.shape[1]
    if heads % size:
        raise ValueError(
            f"heads ({heads}) must be divisible by the process group's "
            f"size ({size}) — that is the Ulysses layout's constraint")
    if size > 1:
        q, k, v = (_SeqToHeads.apply(x, group, size) for x in (q, k, v))
    if q.device.type == "cpu":
        out = chunked_attention(q, k, v, causal, block=chunk)
    else:
        out = flash_attention(q, k, v, causal)
    if size > 1:
        out = _HeadsToSeq.apply(out, group, size)
    return out
