"""Ring attention — sequence parallelism over a process group, port of
``dragonfly2_tpu/parallel/ring_attention.py``.

Each rank holds T/d query rows and the same rows of K and V. The K/V
blocks travel around the ring (:func:`~.mesh.ring_shift`, one hop a
step, d steps) while an online softmax folds each visiting block into
running (max, sum, weighted-V) accumulators. A rank's score block is
[T/d, T/d] a head, never [T, T]. Where JAX takes one global array
sharded over a mesh axis, the caller passes this rank's shard and a
process group, and gets this rank's shard of the output back.

The algebra is the JAX function's: NEG_INF = -1e9, the block mask
multiplied into p (a fully masked block adds 0), the 1e-20 floor on the
sum, accumulation in f32 with P·V in the input dtype, and the global
positions of a block from its owner ``(rank − step) % d``. K, V and the
key-valid mask share one hop (JAX makes three ``ppermute`` s), and the
hop after the last step, which feeds nothing, is not made. The products
are ``torch.einsum``, as JAX computes them outside any Pallas kernel;
the backward is autograd's, through the hops' inverse hops.
"""

from __future__ import annotations

import math

import torch

from dragonfly2_tpu_torch.parallel.mesh import group_size_rank, ring_shift

NEG_INF = -1e9


def ring_attention(q, k, v, *, group=None, causal: bool = False,
                   kv_valid=None, scale: float | None = None):
    """Softmax attention with the sequence sharded over ``group``'s ranks.

    q/k/v: this rank's shard, ``[T/d, heads, head_dim]`` or ``[B, T/d,
    heads, head_dim]`` (rank r holds rows r·T/d … (r+1)·T/d − 1).
    ``kv_valid``: an optional ``[T/d]`` (or ``[B, T/d]``) bool mask of
    this rank's real key positions. ``group=None`` is the default
    process group, or a world of one when none is initialized. Returns
    this rank's shard of the output, shaped like q."""
    if q.ndim not in (3, 4):
        raise ValueError(f"expected [T,h,d] or [B,T,h,d], got "
                         f"{tuple(q.shape)}")
    batched = q.ndim == 4
    world, rank = group_size_rank(group)
    inv_scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if kv_valid is None:
        kv_valid = torch.ones(q.shape[:-2], dtype=torch.bool, device=q.device)

    qk = "bnhd,bmhd->bhnm" if batched else "nhd,mhd->hnm"
    pv = "bhnm,bmhd->bnhd" if batched else "hnm,mhd->nhd"
    t_loc = q.shape[-3]
    local = torch.arange(t_loc, device=q.device)
    q_pos = rank * t_loc + local                            # global rows

    # running max/sum indexed [(B,) heads, n] like the score blocks; the V
    # accumulator stays q-shaped [(B,) n, heads, d]
    m = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32,
                   device=q.device).transpose(-1, -2)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kb, vb, validb = k, v, kv_valid
    for step in range(world):
        k_pos = ((rank - step) % world) * t_loc + local     # global cols
        s = torch.einsum(qk, q, kb).float() * inv_scale
        # mask [(B,) 1, 1, m] against s [(B,) h, n, m]
        mask = validb[..., None, None, :] if batched else validb[None, None]
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        # multiply by the mask so fully masked blocks contribute 0
        # (exp(NEG_INF - NEG_INF) = 1 would otherwise pollute l)
        p = torch.exp(s - m_new[..., None]) * mask
        fold = torch.exp(m - m_new)
        l = l * fold + p.sum(-1)
        acc = acc * fold.transpose(-1, -2)[..., None] + torch.einsum(
            pv, p.to(q.dtype), vb).float()
        m = m_new
        # Free this block's scores before the next block's are made (under
        # no_grad nothing else holds them): one step's blocks at a time.
        del s, p, mask
        if step < world - 1:
            kb, vb, validb = ring_shift((kb, vb, validb), group)

    denom = torch.clamp_min(l, 1e-20).transpose(-1, -2)[..., None]
    return (acc / denom).to(q.dtype)
