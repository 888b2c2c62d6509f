"""GraphTransformer — port of ``dragonfly2_tpu/models/graph_transformer.py``
(BASELINE config #3) for one device.

Every host embedding is refined by multi-head attention restricted to its
probe neighbors, with the measured RTT added as an attention bias. The
graph lives in padded per-node neighbor lists — ``nbr [N, K]`` int32 ids
and ``val [N, K]`` float32 biases, pad slots ``PAD_ID`` — built host-side
by :func:`build_neighbor_lists` (bit-identical to the JAX package's).

Attention modes, all computing the same function:

- ``"gather"``: each row attends to its ≤K gathered neighbor rows; the
  ``[k|v]`` gather is ``neighbor_gather``, the ``table_gather`` kernel on
  the card with the ``table_scatter_add`` kernel as its backward.
- ``"blocks"`` and ``"flash"``: the ``graph_flash_attention`` kernel on
  the card (the plain key-block online softmax on the CPU). The kernel is
  forward only, so these modes train on the CPU alone.
- ``"ring"`` needs several devices and is not ported yet (ROADMAP.md
  Queue 1, parallel set).

Parameters keep flax's names (``Dense_i``, ``LayerNorm_i``,
``input_proj``...) so a flax tree maps onto the state dict key for key
(``train/checkpoint.py``); computation follows flax: f32 params cast to
the compute dtype (bf16 by default), LayerNorm statistics in f32 with
eps 1e-6, tanh GELU, an f32 output head. Training in gather mode passes
``inv`` = :func:`build_inverse_index` of the neighbor lists down to the
gather, whose backward then sums each table row's cotangent over the
positions ``inv`` lists (``train/gat_trainer.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dragonfly2_tpu_torch.ops.flash_attention import graph_flash_attention
from dragonfly2_tpu_torch.ops.table_gather import neighbor_gather

NEG_INF = -1e9
# Neighbor-list pad sentinel: never inside [0, N) for any padded N, so a
# pad slot is out of range of every key block and scatters nothing.
PAD_ID = np.int32(2**30)

NODE_FEATURE_DIM = 8
ATTENTION_MODES = ("gather", "blocks", "flash")


def build_neighbor_lists(
    n_nodes: int,
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    edge_rtt_ns: np.ndarray,
    cap: int = 128,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side: padded neighbor lists (nbr [N, K] int32, val [N, K] f32).

    ``val`` is −log1p(rtt_ms) for a probed edge. Both directions of each
    probe are added, repeated sightings of a pair keep the best RTT, every
    node carries a self slot (bias 0, the row max, so it survives any
    cap) and keeps its best-``cap`` neighbors by bias; pad slots are
    ``PAD_ID``. Each (row, col) appears at most once — the attention
    kernels rely on this.
    """
    rtt_ms = edge_rtt_ns.astype(np.float64) / 1e6
    value = -np.log1p(rtt_ms).astype(np.float32)
    src = edge_src.astype(np.int64)
    dst = edge_dst.astype(np.int64)
    idx = np.arange(n_nodes, dtype=np.int64)
    keys = np.concatenate([
        src * n_nodes + dst,
        dst * n_nodes + src,
        idx * n_nodes + idx,
    ])
    vals = np.concatenate([value, value, np.zeros(n_nodes, np.float32)])
    order = np.argsort(keys, kind="stable")
    k_sorted, v_sorted = keys[order], vals[order]
    starts = np.flatnonzero(np.r_[True, k_sorted[1:] != k_sorted[:-1]])
    uniq_key = k_sorted[starts]
    uniq_val = np.maximum.reduceat(v_sorted, starts)
    rows = (uniq_key // n_nodes).astype(np.int64)
    cols = (uniq_key % n_nodes).astype(np.int32)

    # Rank within each row by descending bias; keep rank < cap.
    by_row = np.lexsort((-uniq_val, rows))
    rows, cols, uniq_val = rows[by_row], cols[by_row], uniq_val[by_row]
    row_start = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]])
    rank = np.arange(len(rows)) - np.repeat(
        row_start, np.diff(np.r_[row_start, len(rows)]))
    keep = rank < cap
    rows, cols, uniq_val, rank = (
        rows[keep], cols[keep], uniq_val[keep], rank[keep])

    k_width = max(int(rank.max()) + 1 if len(rank) else 1, 1)
    nbr = np.full((n_nodes, k_width), PAD_ID, dtype=np.int32)
    val = np.zeros((n_nodes, k_width), dtype=np.float32)
    nbr[rows, rank] = cols
    val[rows, rank] = uniq_val
    return nbr, val


def pad_graph_sparse(
    node_features: np.ndarray,
    nbr: np.ndarray,
    val: np.ndarray,
    multiple: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Pad the node count up to ``multiple``. Phantom rows get a self slot
    (a nonzero softmax denominator) and no real row points at them."""
    n = node_features.shape[0]
    padded = ((n + multiple - 1) // multiple) * multiple
    if padded == n:
        return node_features, nbr, val, n
    extra = padded - n
    node_features = np.pad(node_features, ((0, extra), (0, 0)))
    pad_nbr = np.full((extra, nbr.shape[1]), PAD_ID, dtype=np.int32)
    pad_nbr[:, 0] = np.arange(n, padded, dtype=np.int32)
    nbr = np.concatenate([nbr, pad_nbr])
    val = np.concatenate([val, np.zeros((extra, val.shape[1]), np.float32)])
    return node_features, nbr, val, n


def pad_multiple(n_data: int, chunk: int, n_nodes: int) -> int:
    """Row-pad multiple: rows split evenly over ``n_data`` shards and, once
    the padded graph exceeds one key block, into ``chunk`` blocks."""
    padded = ((n_nodes + n_data - 1) // n_data) * n_data
    if padded <= chunk:
        return n_data
    return n_data * chunk // math.gcd(n_data, chunk)


def _divisor_block(n: int, chunk: int) -> int:
    """Largest divisor of ``n`` that is ≤ ``chunk`` (≥ 1)."""
    best = 1
    d = 1
    while d * d <= n:
        if n % d == 0:
            if d <= chunk:
                best = max(best, d)
            if n // d <= chunk:
                best = max(best, n // d)
        d += 1
    return best


def _flash_block(n: int, chunk: int) -> int:
    """Key-block width of the plain blocks path: ``chunk``, but no wider
    than ``n`` rounded up to 128."""
    return min(chunk, ((n + 127) // 128) * 128)


def build_inverse_index(nbr: np.ndarray) -> np.ndarray:
    """Host-side transpose of the neighbor lists: ``inv[j]`` lists the
    flat positions ``i*K + s`` with ``nbr[i, s] == j``, ascending, padded
    with -1 to the max in-degree (int64 [N, D_max]); pad slots are left
    out. Bit-identical to the JAX package's. The gather's backward sums
    each table row's cotangent over these positions."""
    n, k_width = nbr.shape
    rows, slots = np.nonzero(nbr != PAD_ID)
    cols = nbr[rows, slots]
    flat = (rows * k_width + slots).astype(np.int64)
    order = np.argsort(cols, kind="stable")
    cols, flat = cols[order], flat[order]
    start = np.flatnonzero(np.r_[True, cols[1:] != cols[:-1]])
    counts = np.diff(np.r_[start, len(cols)])
    d_max = max(int(counts.max()) if len(counts) else 1, 1)
    rank = np.arange(len(cols)) - np.repeat(start, counts)
    inv = np.full((n, d_max), -1, dtype=np.int64)
    inv[cols, rank] = flat
    return inv


def gather_graph_attention(q, k, v, nbr, val, inv=None):
    """Neighbor-gather attention: each row attends to exactly its ≤K
    listed neighbors. q/k/v [N, heads, d]; nbr/val [N, K]; ``inv``
    optional, see :func:`build_inverse_index`. One differentiable gather
    of the concatenated [k|v] table (``neighbor_gather``); PAD slots
    gather row 0 and are masked out of the softmax, so they carry zero
    cotangent and ``inv`` may leave them out."""
    n, heads, head_dim = q.shape
    scale = 1.0 / math.sqrt(head_dim)
    pad = nbr >= n                     # PAD_ID (and nothing else) is ≥ N
    idx = torch.where(pad, 0, nbr).to(torch.int32)
    kv = torch.cat([k, v], dim=-1).reshape(n, 2 * heads * head_dim)
    kvg = neighbor_gather(kv, idx, inv).reshape(n, -1, heads, 2 * head_dim)
    kg, vg = kvg[..., :head_dim], kvg[..., head_dim:]
    s = torch.einsum("nhd,nkhd->nhk", q, kg).float() * scale
    s = s + val[:, None, :]
    s = s.masked_fill(pad[:, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("nhk,nkhd->nhd", p, vg)


class Dense(nn.Module):
    """flax ``nn.Dense`` twin on one device (the JAX package's ``TPDense``
    without tensor parallelism): f32 ``weight [out, in]`` and ``bias``,
    cast with the input to ``dtype`` for the product. lecun-normal init
    (truncated normal, std √(1/fan_in) / .8796) from ``generator``."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        std = math.sqrt(1.0 / in_features) / 0.87962566103423978
        weight = torch.empty(out_features, in_features)
        nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` twin: statistics in f32 (E[x²] − E[x]²,
    clipped at 0), eps 1e-6, output in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.bfloat16,
                 eps: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean) * mul + self.bias).to(self.dtype)


class GraphAttentionBlock(nn.Module):
    """Pre-LN multi-head neighbor-masked attention + MLP, residual
    throughout. Submodule names are flax's."""

    def __init__(self, hidden: int, heads: int, chunk: int = 1024,
                 attention: str = "gather",
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        if attention == "ring":
            raise NotImplementedError(
                "attention='ring' needs several devices; it comes with the "
                "parallel set (ROADMAP.md Queue 1)")
        if attention not in ATTENTION_MODES:
            raise ValueError(f"unknown attention mode {attention!r}")
        self.hidden, self.heads = hidden, heads
        self.chunk, self.attention = chunk, attention
        self.LayerNorm_0 = LayerNorm(hidden, dtype)
        self.Dense_0 = Dense(hidden, hidden, dtype, generator)
        self.Dense_1 = Dense(hidden, hidden, dtype, generator)
        self.Dense_2 = Dense(hidden, hidden, dtype, generator)
        self.Dense_3 = Dense(hidden, hidden, dtype, generator)
        self.LayerNorm_1 = LayerNorm(hidden, dtype)
        self.Dense_4 = Dense(hidden, 2 * hidden, dtype, generator)
        self.Dense_5 = Dense(2 * hidden, hidden, dtype, generator)

    def forward(self, h, nbr, val, inv=None):
        head_dim = self.hidden // self.heads
        x = self.LayerNorm_0(h)

        def split(t):  # [N, H] -> [N, heads, head_dim]
            return t.reshape(-1, self.heads, head_dim)

        q, k, v = (split(dense(x)) for dense in
                   (self.Dense_0, self.Dense_1, self.Dense_2))
        if self.attention == "gather":
            out = gather_graph_attention(q, k, v, nbr, val, inv)
        else:
            out = graph_flash_attention(
                q, k, v, nbr, val, block=_flash_block(q.shape[0], self.chunk))
        h = h + self.Dense_3(out.reshape(-1, self.hidden))
        y = self.LayerNorm_1(h)
        y = F.gelu(self.Dense_4(y), approximate="tanh")
        return h + self.Dense_5(y)


class GraphTransformer(nn.Module):
    """L attention blocks over the full topology + an edge-scoring head.
    ``forward`` returns per-edge logits for (src, dst) index tensors."""

    def __init__(self, in_features: int = NODE_FEATURE_DIM, hidden: int = 128,
                 embed: int = 64, layers: int = 2, heads: int = 4,
                 chunk: int = 1024, attention: str = "gather",
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.input_proj = Dense(in_features, hidden, dtype, generator)
        self.blocks = nn.ModuleList(
            GraphAttentionBlock(hidden, heads, chunk, attention, dtype,
                                generator)
            for _ in range(layers))
        self.final_norm = LayerNorm(hidden, dtype)
        self.embed_proj = Dense(hidden, embed, dtype, generator)
        self.head_hidden = Dense(2 * embed, embed, dtype, generator)
        self.head_out = Dense(embed, 1, torch.float32, generator)

    def node_embeddings(self, node_features, nbr, val, inv=None):
        """[N, F] → [N, E]; run once at model load for serving. ``inv``
        (gather-mode training) = :func:`build_inverse_index` of ``nbr``."""
        h = self.input_proj(node_features)
        for block in self.blocks:
            h = block(h, nbr, val, inv)
        return self.embed_proj(self.final_norm(h))

    def score_pairs(self, emb, edge_src, edge_dst):
        """Edge logits from an already-computed embedding table: one
        gather + the small head."""
        pair = torch.cat([emb[edge_src.long()], emb[edge_dst.long()]], dim=-1)
        x = torch.relu(self.head_hidden(pair))
        return self.head_out(x)[..., 0]

    def forward(self, node_features, nbr, val, edge_src, edge_dst, inv=None):
        emb = self.node_embeddings(node_features, nbr, val, inv)
        return self.score_pairs(emb, edge_src, edge_dst)
