"""Fixed-fanout neighbor sampling for GraphSAGE minibatches — port of
``dragonfly2_tpu/data/graph_sampler.py``, the host-sampling path of the
GraphSAGE trainer (``device_sample=False``).

Pure numpy, and the draws from the caller's ``np.random.Generator``
happen in the same order as in the JAX package, so one generator state
gives bit-identical batches in both packages. A batch of M nodes gets its
f neighbors by one random-offset gather into the CSR arrays, sampling
WITH replacement for every node that has at least one out-edge; only
zero-degree nodes get padded slots (mask 0).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from dragonfly2_tpu_torch.data.features import Graph


@dataclass
class CSRGraph:
    """Compressed adjacency (outgoing probe edges) + per-edge RTT."""

    indptr: np.ndarray     # [n_nodes + 1] int64
    indices: np.ndarray    # [n_edges] int32 — neighbor node ids
    edge_rtt: np.ndarray   # [n_edges] float32 — log1p(rtt_ms)
    node_features: np.ndarray  # [n_nodes, F] float32

    @property
    def n_nodes(self) -> int:
        return len(self.indptr) - 1

    @staticmethod
    def from_graph(g: Graph) -> "CSRGraph":
        order = np.argsort(g.edge_src, kind="stable")
        src = g.edge_src[order]
        counts = np.bincount(src, minlength=g.n_nodes)
        indptr = np.zeros(g.n_nodes + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSRGraph(
            indptr=indptr,
            indices=g.edge_dst[order].astype(np.int32),
            edge_rtt=np.log1p(g.edge_rtt_ns[order] / 1e6).astype(np.float32),
            node_features=g.node_features,
        )

    def sample_neighbors(
        self, nodes: np.ndarray, fanout: int, rng: np.random.Generator
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sample ``fanout`` neighbors for each node in the flat array.

        Returns (nbr_idx, rtt, mask), each ``nodes.shape + (fanout,)``;
        padded slots have index 0 and mask 0.
        """
        flat = nodes.reshape(-1)
        deg = (self.indptr[flat + 1] - self.indptr[flat]).astype(np.int64)
        offs = rng.integers(0, 1 << 31, size=(len(flat), fanout))
        safe_deg = np.maximum(deg, 1)[:, None]
        pos = self.indptr[flat][:, None] + offs % safe_deg
        # A zero-degree trailing node points at indptr[node] == n_edges,
        # out of bounds; its mask is 0, so any in-bounds position works.
        pos = np.minimum(pos, max(len(self.indices) - 1, 0))
        if len(self.indices):
            nbr, rtt = self.indices[pos], self.edge_rtt[pos]
        else:
            nbr = np.zeros_like(pos, np.int32)
            rtt = np.zeros_like(pos, np.float32)
        mask = (deg > 0)[:, None] * np.ones((1, fanout), np.float32)
        shape = nodes.shape + (fanout,)
        return (
            np.where(mask > 0, nbr, 0).astype(np.int32).reshape(shape),
            (rtt * mask).astype(np.float32).reshape(shape),
            mask.astype(np.float32).reshape(shape),
        )


@dataclass
class EdgeBatch:
    """One static-shape minibatch over B target edges with the node
    features gathered on the host (equivalence tests; the trainer ships
    :class:`IndexEdgeBatch` and gathers on the device)."""

    center_feat: np.ndarray  # [B, 2, F] float32 — (src, dst) features
    nbr1_feat: np.ndarray    # [B, 2, f1, F] float32
    nbr1_rtt: np.ndarray     # [B, 2, f1] float32
    nbr1_mask: np.ndarray    # [B, 2, f1] float32
    nbr2_feat: np.ndarray    # [B, 2, f1, f2, F] float32
    nbr2_rtt: np.ndarray     # [B, 2, f1, f2] float32
    nbr2_mask: np.ndarray    # [B, 2, f1, f2] float32
    labels: np.ndarray       # [B] float32

    def astuple(self) -> tuple:
        return (
            self.center_feat, self.nbr1_feat, self.nbr1_rtt, self.nbr1_mask,
            self.nbr2_feat, self.nbr2_rtt, self.nbr2_mask, self.labels,
        )


@dataclass
class IndexEdgeBatch:
    """The host pipeline's output: int32 node indices instead of gathered
    features; the device gathers the feature rows."""

    center_idx: np.ndarray   # [B, 2] int32
    nbr1_idx: np.ndarray     # [B, 2, f1] int32
    nbr1_rtt: np.ndarray     # [B, 2, f1] float32
    nbr1_mask: np.ndarray    # [B, 2, f1] float32
    nbr2_idx: np.ndarray     # [B, 2, f1, f2] int32
    nbr2_rtt: np.ndarray     # [B, 2, f1, f2] float32
    nbr2_mask: np.ndarray    # [B, 2, f1, f2] float32
    labels: np.ndarray       # [B] float32

    def astuple(self) -> tuple:
        return (
            self.center_idx, self.nbr1_idx, self.nbr1_rtt, self.nbr1_mask,
            self.nbr2_idx, self.nbr2_rtt, self.nbr2_mask, self.labels,
        )

    def to_features(self, node_features: np.ndarray) -> EdgeBatch:
        """Host-side gather: the arrays the device-side gather produces."""
        return EdgeBatch(
            center_feat=node_features[self.center_idx],
            nbr1_feat=node_features[self.nbr1_idx],
            nbr1_rtt=self.nbr1_rtt, nbr1_mask=self.nbr1_mask,
            nbr2_feat=node_features[self.nbr2_idx],
            nbr2_rtt=self.nbr2_rtt, nbr2_mask=self.nbr2_mask,
            labels=self.labels,
        )


class EdgeBatchSampler:
    """Samples 2-hop neighborhoods around target-edge endpoints for the
    task: is this src→dst path fast (probe RTT under the threshold)?"""

    def __init__(
        self,
        csr: CSRGraph,
        edge_src: np.ndarray,
        edge_dst: np.ndarray,
        labels: np.ndarray,
        fanouts: tuple[int, int] = (10, 5),
    ):
        self.csr = csr
        self.edge_src = edge_src
        self.edge_dst = edge_dst
        self.labels = labels.astype(np.float32)
        self.fanouts = fanouts

    @property
    def n_edges(self) -> int:
        return len(self.edge_src)

    def sample_indices(self, edge_ids: np.ndarray,
                       rng: np.random.Generator) -> IndexEdgeBatch:
        """Indices + edge signals for the edges ``edge_ids``."""
        f1, f2 = self.fanouts
        centers = np.stack(
            [self.edge_src[edge_ids], self.edge_dst[edge_ids]], axis=1
        ).astype(np.int32)
        nbr1, rtt1, mask1 = self.csr.sample_neighbors(centers, f1, rng)
        nbr2, rtt2, mask2 = self.csr.sample_neighbors(nbr1, f2, rng)
        # Mask out 2-hop samples hanging off padded 1-hop slots.
        mask2 = mask2 * mask1[..., None]
        return IndexEdgeBatch(
            center_idx=centers,
            nbr1_idx=nbr1, nbr1_rtt=rtt1, nbr1_mask=mask1,
            nbr2_idx=nbr2, nbr2_rtt=rtt2 * mask2, nbr2_mask=mask2,
            labels=self.labels[edge_ids],
        )

    def sample(self, edge_ids: np.ndarray,
               rng: np.random.Generator) -> EdgeBatch:
        return self.sample_indices(edge_ids, rng).to_features(
            self.csr.node_features)
