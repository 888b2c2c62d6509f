"""On-device neighbor sampling for GraphSAGE — port of
``dragonfly2_tpu/train/fused_sampling.py``.

The CSR adjacency and the node-feature table live on the device
(:class:`GraphTables`); a step ships only its edge ids. Fanout sampling
runs there with the JAX package's counter hash (``_hashed_bits``), so for
the same tables and salts it draws the same neighbors bit for bit, on
the CPU and on the card. The JAX package derives its two salts a step
from a threefry key; the port has no threefry, so its callers pass the
salts in (the trainer draws them from a seeded ``torch.Generator``).

The hash is keyed by the GLOBAL row-major position, as the JAX
package's (it partitions over any mesh with "identical results
regardless of device count"): a data-parallel rank that samples rows
``[r0, r0 + b)`` of a global edge batch passes ``row_offset=r0``, and its
neighbors are those rows of the whole batch's, bit for bit.

torch has no usable uint32, so the hash works in int64 on values kept in
[0, 2³²): every add and product is masked with ``0xFFFFFFFF``, and a
product with a 32-bit constant is taken in 16-bit halves
(:func:`_mul32`), so no intermediate reaches 2⁴⁸.

Every node-feature gather of a batch — centers, 1-hop and 2-hop samples
— goes through ``table_gather`` in one launch on one concatenated int32
index vector (:func:`gather_features`): the K2a kernel on the card, its
plain twin on the CPU. The features are inputs, not parameters, so the
gather has no backward.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from dragonfly2_tpu_torch.data.graph_sampler import CSRGraph
from dragonfly2_tpu_torch.ops.table_gather import table_gather

_MASK32 = 0xFFFFFFFF


class GraphTables(NamedTuple):
    """Device-resident graph state for on-device sampling."""

    indptr: torch.Tensor         # [N+1] int32 — CSR row starts
    indices: torch.Tensor        # [E] int32 — neighbor node ids
    edge_rtt: torch.Tensor       # [E] float32 — log1p(rtt_ms)
    node_features: torch.Tensor  # [N, F] float32


class EdgeTables(NamedTuple):
    """Device-resident target-edge split (train or eval)."""

    src: torch.Tensor     # [M] int32
    dst: torch.Tensor     # [M] int32
    labels: torch.Tensor  # [M] float32


def _put(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def put_graph_tables(csr: CSRGraph, device) -> GraphTables:
    # int32 row starts, as the JAX package narrows them.
    return GraphTables(_put(csr.indptr.astype(np.int32), device),
                       _put(csr.indices, device), _put(csr.edge_rtt, device),
                       _put(csr.node_features, device))


def put_edge_tables(src: np.ndarray, dst: np.ndarray, labels: np.ndarray,
                    device) -> EdgeTables:
    return EdgeTables(_put(src.astype(np.int32), device),
                      _put(dst.astype(np.int32), device),
                      _put(labels.astype(np.float32), device))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2³²`` for int64 ``x`` in [0, 2³²) and a 32-bit
    constant ``c``, in 16-bit halves of ``c``: each product stays below
    2⁴⁸."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _lowbias32(x: torch.Tensor) -> torch.Tensor:
    """32-bit avalanche hash (lowbias32) on int64 values in [0, 2³²)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _hashed_bits(salt: int, shape: tuple, device=None,
                 offset: int = 0) -> torch.Tensor:
    """Uniform 32-bit values (int64 in [0, 2³²)) from (``salt``, the
    global row-major position), bit-identical to the JAX package's
    ``_hashed_bits``: positions and sums wrap mod 2³². ``shape`` is this
    slice's and ``offset`` the global position of its first element, so
    a slice of a larger array hashes as that array's rows."""
    salt = int(salt) & _MASK32
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    idx = (idx + ((int(offset) + salt) & _MASK32)) & _MASK32
    return _lowbias32(_lowbias32(idx) ^ ((salt * 0x9E3779B9) & _MASK32))


def sample_neighbors(graph: GraphTables, nodes: torch.Tensor, fanout: int,
                     salt: int, row_offset: int = 0):
    """Fanout-sample WITH replacement for each node of int32 ``nodes``;
    returns (nbr_idx int32, rtt f32, mask f32), each ``nodes.shape +
    (fanout,)``. Padded slots (zero-degree nodes) carry index 0, rtt 0
    and mask 0; a node with out-edges fills all ``fanout`` slots.
    ``nodes`` are rows ``[row_offset, …)`` of a larger batch along the
    leading axis, and hash as those rows."""
    nodes = nodes.long()
    start = graph.indptr[nodes]
    deg = graph.indptr[nodes + 1] - start
    per_row = int(np.prod(nodes.shape[1:], dtype=np.int64)) * fanout
    bits = _hashed_bits(salt, tuple(nodes.shape) + (fanout,), nodes.device,
                        offset=row_offset * per_row)
    safe_deg = torch.clamp(deg, min=1).long()
    pos = start[..., None].long() + bits % safe_deg[..., None]
    # Zero-degree tail nodes point at indptr[-1] == E (out of bounds);
    # their mask is 0, so any in-bounds position works — clamp.
    pos = torch.clamp(pos, max=graph.indices.shape[0] - 1)
    mask = (deg > 0).float()[..., None].expand(pos.shape).contiguous()
    nbr = graph.indices[pos]
    return (torch.where(mask > 0, nbr, torch.zeros_like(nbr)),
            graph.edge_rtt[pos] * mask, mask)


def sample_indices(graph: GraphTables, src: torch.Tensor, dst: torch.Tensor,
                   salts: tuple[int, int], fanouts: tuple[int, int],
                   row_offset: int = 0):
    """The 2-hop neighborhood of each target edge's endpoints, sampled on
    the tensors' device with salts ``(s1, s2)`` for the two hops →
    (centers [B, 2], nbr1, rtt1, mask1 [B, 2, f1], nbr2, rtt2, mask2
    [B, 2, f1, f2]); ids int32, the 2-hop mask zero under padded 1-hop
    slots and the 2-hop rtt multiplied by it, as the JAX package's
    ``sample_and_apply`` feeds its model. The edges are rows
    ``[row_offset, …)`` of a global edge batch (a data-parallel rank's
    slice)."""
    f1, f2 = fanouts
    s1, s2 = salts
    centers = torch.stack([src, dst], dim=-1).to(torch.int32)
    nbr1, rtt1, mask1 = sample_neighbors(graph, centers, f1, s1, row_offset)
    nbr2, rtt2, mask2 = sample_neighbors(graph, nbr1, f2, s2, row_offset)
    mask2 = mask2 * mask1[..., None]
    return centers, nbr1, rtt1, mask1, nbr2, rtt2 * mask2, mask2


def gather_features(node_features: torch.Tensor, *ids: torch.Tensor):
    """``node_features[i]`` for each int32 id tensor in ``ids``, in ONE
    ``table_gather`` launch on their concatenation (one index range check
    a batch, not one a tensor), split afterwards."""
    flat = torch.cat([i.reshape(-1) for i in ids]).to(torch.int32)
    rows = table_gather(node_features, flat)
    out, offset = [], 0
    for i in ids:
        out.append(rows[offset:offset + i.numel()].reshape(
            *i.shape, node_features.shape[1]))
        offset += i.numel()
    return out


def apply_indexed(model, node_features: torch.Tensor, centers, nbr1, rtt1,
                  mask1, nbr2, rtt2, mask2) -> torch.Tensor:
    """The model's logits for a sampled index batch: the feature rows
    gathered on the tables' device (:func:`gather_features`), then the
    dense GraphSAGE."""
    c_feat, n1_feat, n2_feat = gather_features(node_features, centers, nbr1,
                                               nbr2)
    return model(c_feat, n1_feat, rtt1, mask1, n2_feat, rtt2, mask2)


def sample_and_apply(model, graph: GraphTables, src, dst,
                     salts: tuple[int, int], fanouts: tuple[int, int],
                     row_offset: int = 0):
    """Sample the 2-hop neighborhood on the device and run the forward
    pass → logits [B]."""
    centers, nbr1, rtt1, mask1, nbr2, rtt2, mask2 = sample_indices(
        graph, src, dst, salts, fanouts, row_offset)
    return apply_indexed(model, graph.node_features, centers, nbr1, rtt1,
                         mask1, nbr2, rtt2, mask2)


def train_step(optimizer, forward, lr: float, dp=None) -> torch.Tensor:
    """One AdamW step at learning rate ``lr`` on mean sigmoid BCE;
    ``forward()`` returns (logits, labels). With ``dp`` (a
    ``parallel.mesh.DataParallel``) the gradients and the loss are
    averaged over its group first. Returns the loss (a 0-d tensor on the
    device, not waited for)."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.zero_grad(set_to_none=True)
    loss = F.binary_cross_entropy_with_logits(*forward())
    loss.backward()
    if dp is not None:
        params = [p for g in optimizer.param_groups for p in g["params"]]
        loss = dp.allreduce_grads_(params, loss)
    optimizer.step()
    return loss.detach()
