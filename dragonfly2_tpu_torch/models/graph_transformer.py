"""GraphTransformer — port of ``dragonfly2_tpu/models/graph_transformer.py``
(BASELINE config #3).

Every host embedding is refined by multi-head attention restricted to its
probe neighbors, with the measured RTT added as an attention bias. The
graph lives in padded per-node neighbor lists — ``nbr [N, K]`` int32 ids
and ``val [N, K]`` float32 biases, pad slots ``PAD_ID`` — built host-side
by :func:`build_neighbor_lists` (bit-identical to the JAX package's).

Attention modes, all computing the same function:

- ``"gather"``: each row attends to its ≤K gathered neighbor rows; the
  ``[k|v]`` gather is ``neighbor_gather``, the ``table_gather`` kernel on
  the card with the ``table_scatter_add`` kernel as its backward.
- ``"blocks"`` and ``"flash"``: ``graph_flash_attention`` (K1), the
  forward and backward kernels on the card (the plain key-block online
  softmax and its plain backward on the CPU).
- ``"ring"``: in a world of one the blocks math with the key block
  ``_divisor_block(N, chunk)``, the JAX package's fallback without a
  mesh — K1 on the card. With rows sharded (below) each rank's K/V
  blocks travel around the ring (:func:`ring_graph_attention`) instead
  of being all-gathered.

Placement over a ``(data, model)`` :class:`~dragonfly2_tpu_torch.parallel.mesh.Grid`
of ``torch.distributed`` ranks (``grid=``; ``group=`` alone is a grid
whose every rank is on the data axis), as the JAX package's trainer
places the model on its mesh:

- rows over ``data``: once the data axis has more than one rank, each
  rank passes its contiguous row shard of the node features and
  neighbor lists (``nbr`` holding global ids). Its queries stay local;
  in gather, blocks and flash mode the ``[k|v]`` of its head share is
  all-gathered over ``data`` (``all_gather_rows``, JAX's ``replicate``)
  before the attention, whose backward leaves each rank a partial dK/dV
  of every row that ``all_gather_rows``'s backward sums over ``data``
  in f32 (the partials come out of K2b and K1 rounded to the compute
  dtype). ``forward`` all-gathers the embeddings for the pair head.
- weights over ``model`` (Megatron, JAX's ``TPDense`` under
  ``tp_state_shardings``): each block runs ``heads / n_model`` heads;
  its q/k/v and MLP-up projections (``Dense_0, 1, 2, 4``) are column
  splits, its out and MLP-down projections (``Dense_3, 5``) row splits,
  one :func:`~dragonfly2_tpu_torch.parallel.mesh.copy_to_model` before
  each group of column splits and one
  :func:`~dragonfly2_tpu_torch.parallel.mesh.reduce_from_model` in each
  row split. Everything else replicates. Ring mode takes no model axis.

Parameters keep flax's names (``Dense_i``, ``LayerNorm_i``,
``input_proj``...) so a flax tree maps onto the state dict key for key
(``train/checkpoint.py``); computation follows flax: f32 params cast to
the compute dtype (bf16 by default), LayerNorm statistics in f32 with
eps 1e-6, tanh GELU, an f32 output head. Training passes ``inv`` =
:func:`build_inverse_index` of the (rank's) neighbor lists over every
key row down to the attention: the gather's backward (gather mode) and
K1's (the other modes) sum each key row's gradient over the positions
``inv`` lists (``train/gat_trainer.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dragonfly2_tpu_torch.ops.flash_attention import graph_flash_attention
from dragonfly2_tpu_torch.ops.table_gather import (  # noqa: F401 (re-export)
    build_inverse_index,
    neighbor_gather,
)
from dragonfly2_tpu_torch.parallel.mesh import (
    Grid,
    all_gather_rows,
    copy_to_model,
    group_size_rank,
    reduce_from_model,
    ring_shift,
)

NEG_INF = -1e9
# Neighbor-list pad sentinel: never inside [0, N) for any padded N, so a
# pad slot is out of range of every key block and scatters nothing.
PAD_ID = np.int32(2**30)

NODE_FEATURE_DIM = 8
ATTENTION_MODES = ("gather", "blocks", "flash", "ring")
# Megatron's split of a block's Dense layers over the model axis (JAX
# ``tp_state_shardings``): column splits, then row splits.
COLUMN, ROW = (0, 1, 2, 4), (3, 5)


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


def kv_gather_attention(q, kv, nbr, val, inv=None):
    """Neighbor-gather attention (the JAX package's
    ``gather_graph_attention``) on the concatenated ``kv`` table: each
    row attends to exactly its ≤K listed neighbors. q [Nq, heads, d], kv
    [Nk, heads, 2·d] (each head's k, then its v); nbr/val [Nq, K] with
    ids in kv's rows; ``inv`` optional, see :func:`build_inverse_index`.
    One differentiable gather of the table's rows (``neighbor_gather``);
    PAD slots gather row 0 and are masked out of the softmax, so they
    carry zero cotangent and ``inv`` may leave them out."""
    n, heads, head_dim = q.shape
    n_k = kv.shape[0]
    scale = 1.0 / math.sqrt(head_dim)
    pad = nbr >= n_k                   # PAD_ID (and nothing else) is ≥ Nk
    idx = torch.where(pad, 0, nbr).to(torch.int32)
    kv = kv.reshape(n_k, 2 * heads * head_dim)
    kvg = neighbor_gather(kv, idx, inv).reshape(n, -1, heads, 2 * head_dim)
    kg, vg = kvg[..., :head_dim], kvg[..., head_dim:]
    s = torch.einsum("nhd,nkhd->nhk", q, kg).float() * scale
    s = s + val[:, None, :]
    s = s.masked_fill(pad[:, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("nhk,nkhd->nhd", p, vg)


def _block_bias(nbr, val, start: int, block: int):
    """[rows, block] (bias, mask) for key columns [start, start + block),
    scattered from the neighbor lists. The scatter-add is exact because
    ``build_neighbor_lists`` dedups (row, col) pairs; an out-of-range slot
    (PAD_ID among them) adds 0 to a clamped column and sets no mask."""
    in_range = (nbr >= start) & (nbr < start + block)
    col = (nbr - start).clamp(0, block - 1).long()
    rows = torch.arange(nbr.shape[0], device=nbr.device)[:, None].expand_as(
        col)
    base = val.new_zeros(nbr.shape[0], block)
    bias = base.index_put((rows, col), torch.where(in_range, val, 0.0),
                          accumulate=True)
    hits = base.index_put((rows, col), in_range.to(val.dtype),
                          accumulate=True)
    return bias, hits > 0


def _ring_sub_block(q, kj, vj, nbr, val, start: int, m, l, acc):
    """One ``block``-column sub-block of a visiting K/V block folded into
    the online softmax's (m, l, acc)."""
    block = kj.shape[0]
    bias, mask = _block_bias(nbr, val, start, block)
    s = torch.einsum("nhd,bhd->nhb", q, kj).float() * (
        1.0 / math.sqrt(q.shape[-1]))
    s = s + bias[:, None, :]
    s = torch.where(mask[:, None, :], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    # the mask multiplication guards fully masked rows: exp(NEG_INF −
    # NEG_INF) = 1 would otherwise pollute l
    p = torch.exp(s - m_new[..., None]) * mask[:, None, :]
    fold = torch.exp(m - m_new)
    l = l * fold + p.sum(-1)
    acc = acc * fold[..., None] + torch.einsum(
        "nhb,bhd->nhd", p.to(q.dtype), vj).float()
    return m_new, l, acc


def ring_graph_attention(q, k, v, nbr, val, chunk: int, group=None):
    """Neighbor-masked attention with the rows sharded over ``group``'s
    ranks and each rank's K/V block travelling around the ring
    (:func:`~dragonfly2_tpu_torch.parallel.mesh.ring_shift`, one hop of
    K and V together a step, none after the last): no rank holds K/V of
    more than its own rows plus one visiting block.

    q/k/v: this rank's rows ``[n, heads, head_dim]``; nbr/val: its rows
    of the neighbor lists ``[n, K]``, ids global. Each visiting block is
    scanned in ``min(chunk, n)``-column sub-blocks (``n`` must divide
    into them), its bias and mask scattered at the block's global offset
    (``(rank − step) % world`` · n). The JAX function's algebra; the
    products are ``torch.einsum``. Each sub-block body is checkpointed
    (recomputed in the backward), which keeps the residents at one
    (m, l, acc) carry a sub-block; the hops stay outside the
    checkpoints, since a checkpointed collective would run again in the
    backward, where the ranks' hops would no longer pair up."""
    from torch.utils.checkpoint import checkpoint

    world, rank = group_size_rank(group)
    n_loc = q.shape[0]
    block = min(chunk, n_loc)
    if n_loc % block:
        raise ValueError(f"a rank's {n_loc} rows do not split into "
                         f"{block}-row key blocks")
    m = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32,
                   device=q.device)                          # [n, heads]
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    kb, vb = k, v
    for step in range(world):
        base = ((rank - step) % world) * n_loc               # block owner
        for j in range(0, n_loc, block):
            args = (q, kb[j:j + block], vb[j:j + block], nbr, val, base + j,
                    m, l, acc)
            m, l, acc = (checkpoint(_ring_sub_block, *args,
                                    use_reentrant=False)
                         if remat else _ring_sub_block(*args))
        if step < world - 1:
            kb, vb = ring_shift((kb, vb), group)
    return (acc / torch.clamp_min(l, 1e-20)[..., None]).to(q.dtype)


def check_tensor_parallel(attention: str, hidden: int, heads: int,
                          n_model: int) -> None:
    """The JAX trainer's refusals for a model axis above 1: ring mode
    (it shards rows only), and heads or 2·hidden that the axis does not
    divide."""
    if n_model == 1:
        return
    if attention == "ring":
        raise ValueError("ring attention shards rows only; use "
                         "attention='gather' or 'blocks' with a model axis")
    if heads % n_model or (2 * hidden) % n_model:
        raise ValueError(f"heads ({heads}) and 2*hidden ({2 * hidden}) must "
                         f"be divisible by the model axis ({n_model})")


def shard(n: int, parts: int, index: int) -> slice:
    """Part ``index`` of ``n`` split into ``parts`` equal contiguous
    parts."""
    size = n // parts
    return slice(index * size, (index + 1) * size)


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


class TPDense(Dense):
    """The JAX package's ``TPDense``: :class:`Dense` (its names, and its
    init drawn whole from ``generator``) split over ``grid``'s model axis
    as Megatron splits it, holding only this rank's slice.

    - no split, or a model axis of one: :class:`Dense`;
    - ``"column"``: ``weight[out_shard, :]`` and ``bias[out_shard]``, a
      plain product whose output features are this rank's shard. The
      caller passes the input through ``copy_to_model`` once for all the
      column splits that read it (Megatron's f before a fused QKV);
    - ``"row"``: ``weight[:, in_shard]`` and the whole bias: the product
      of this rank's input features without bias, summed over the model
      axis (``reduce_from_model``, Megatron's g), then the bias — JAX's
      ``y + bias`` after the reduce. The operands are cast to ``dtype``
      as everywhere, but the partial products, their sum and the bias
      stay f32 until one rounding to ``dtype``, as the one product of
      :class:`Dense` keeps them: a rounded partial would add a rounding
      a rank.
    """

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None,
                 grid: Grid | None = None, split: str | None = None):
        super().__init__(in_features, out_features, dtype, generator)
        if split not in (None, "column", "row"):
            raise ValueError(f"unknown split {split!r}")
        self.split = split if grid is not None and grid.n_model > 1 else None
        self.group = grid.model if self.split else None
        if self.split == "column":
            rows = shard(out_features, grid.n_model, grid.model_rank)
            self.weight = nn.Parameter(self.weight.detach()[rows].clone())
            self.bias = nn.Parameter(self.bias.detach()[rows].clone())
        elif self.split == "row":
            cols = shard(in_features, grid.n_model, grid.model_rank)
            self.weight = nn.Parameter(
                self.weight.detach()[:, cols].contiguous())

    def forward(self, x):
        if self.split != "row":
            return super().forward(x)
        y = F.linear(x.to(self.dtype).float(),
                     self.weight.to(self.dtype).float())
        y = reduce_from_model(y, self.group) + self.bias.to(self.dtype)
        return y.to(self.dtype)


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
    throughout. Submodule names are flax's. Over ``grid`` (the module
    docstring): rows over its data axis, the Dense layers split over its
    model axis."""

    def __init__(self, hidden: int, heads: int, chunk: int = 1024,
                 attention: str = "gather",
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None,
                 grid: Grid | None = None):
        super().__init__()
        if attention not in ATTENTION_MODES:
            raise ValueError(f"unknown attention mode {attention!r}")
        grid = Grid.of() if grid is None else grid
        check_tensor_parallel(attention, hidden, heads, grid.n_model)
        self.hidden, self.heads = hidden, heads
        self.chunk, self.attention = chunk, attention
        self.grid = grid
        self.sharded = grid.n_data > 1

        def dense(i, n_in, n_out):
            return TPDense(n_in, n_out, dtype, generator, grid,
                           "column" if i in COLUMN else "row")

        self.LayerNorm_0 = LayerNorm(hidden, dtype)
        self.Dense_0 = dense(0, hidden, hidden)
        self.Dense_1 = dense(1, hidden, hidden)
        self.Dense_2 = dense(2, hidden, hidden)
        self.Dense_3 = dense(3, hidden, hidden)
        self.LayerNorm_1 = LayerNorm(hidden, dtype)
        self.Dense_4 = dense(4, hidden, 2 * hidden)
        self.Dense_5 = dense(5, 2 * hidden, hidden)

    def forward(self, h, nbr, val, inv=None):
        head_dim = self.hidden // self.heads
        heads = self.heads // self.grid.n_model      # this rank's share
        x = copy_to_model(self.LayerNorm_0(h), self.grid.model)

        def split(t):  # [N, H / n_model] -> [N, heads, head_dim]
            return t.reshape(-1, heads, head_dim)

        q, k, v = (split(dense(x)) for dense in
                   (self.Dense_0, self.Dense_1, self.Dense_2))
        if self.attention == "ring" and self.sharded:
            # K/V blocks hop around the ring instead of being gathered.
            out = ring_graph_attention(q, k, v, nbr, val, self.chunk,
                                       self.grid.data)
        elif self.attention == "gather":
            kv = torch.cat([k, v], dim=-1)
            if self.sharded:
                # This rank's queries against every row's K/V.
                kv = all_gather_rows(kv, self.grid.data)
            out = kv_gather_attention(q, kv, nbr, val, inv)
        else:
            if self.sharded:
                kv = all_gather_rows(torch.cat([k, v], dim=-1),
                                     self.grid.data)
                k, v = (kv[..., :head_dim].contiguous(),
                        kv[..., head_dim:].contiguous())
            # The CPU's key block; the kernel takes none.
            n_k = k.shape[0]
            block = (_divisor_block(n_k, self.chunk)
                     if self.attention == "ring"
                     else _flash_block(n_k, self.chunk))
            out = graph_flash_attention(q, k, v, nbr, val, block, inv=inv)
        h = h + self.Dense_3(out.reshape(-1, heads * head_dim))
        y = copy_to_model(self.LayerNorm_1(h), self.grid.model)
        y = F.gelu(self.Dense_4(y), approximate="tanh")
        return h + self.Dense_5(y)


class GraphTransformer(nn.Module):
    """L attention blocks over the full topology + an edge-scoring head.
    ``forward`` returns per-edge logits for (src, dst) index tensors.

    ``grid``: the ``(data, model)`` grid of ranks the model is placed on
    (the module docstring). Without one, ``group`` is the data axis
    (``None``: the default group when one is initialized;
    ``parallel.mesh.LOCAL``: this process alone, as serving passes): in
    a world of one every call sees the whole graph.
    """

    def __init__(self, in_features: int = NODE_FEATURE_DIM, hidden: int = 128,
                 embed: int = 64, layers: int = 2, heads: int = 4,
                 chunk: int = 1024, attention: str = "gather",
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None, group=None,
                 grid: Grid | None = None):
        super().__init__()
        self.grid = Grid.of(group) if grid is None else grid
        self.sharded = self.grid.n_data > 1
        self.input_proj = Dense(in_features, hidden, dtype, generator)
        self.blocks = nn.ModuleList(
            GraphAttentionBlock(hidden, heads, chunk, attention, dtype,
                                generator, self.grid)
            for _ in range(layers))
        self.final_norm = LayerNorm(hidden, dtype)
        self.embed_proj = Dense(hidden, embed, dtype, generator)
        self.head_hidden = Dense(2 * embed, embed, dtype, generator)
        self.head_out = Dense(embed, 1, torch.float32, generator)

    def node_embeddings(self, node_features, nbr, val, inv=None):
        """[N, F] → [N, E]; run once at model load for serving. ``inv``
        (training; required under autograd on the card in every mode but
        gather and sharded ring) = :func:`build_inverse_index` of
        ``nbr`` over every key row. With rows sharded it takes and
        returns this rank's rows."""
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
        if self.sharded:
            # One all-gather of the (small) embedding table a forward; the
            # pair gathers then stay local.
            emb = all_gather_rows(emb, self.grid.data)
        return self.score_pairs(emb, edge_src, edge_dst)
