"""GraphSAGE topology model (BASELINE config #2) — port of
``dragonfly2_tpu/models/graphsage.py``.

Two mean-aggregating SAGE layers over a sampled 2-hop neighborhood of
each target edge's endpoints, and an edge head that classifies the
src→dst path as fast or not. Each neighbor's input row is its node
features with the probe's log-RTT appended.

Modules keep flax's names (``SageLayer_0/Dense_0``, ``Dense_0``…), so a
flax tree maps onto the state dict key for key
(``train/checkpoint.py``). Computation follows flax's casts: f32 params
cast to the compute dtype (bf16 by default) for each product; the masked
mean multiplies the bf16 rows by the f32 mask, so the sum, the mean and
the concatenation with the bf16 self rows are f32, cast to bf16 by the
next Dense; the logit comes out in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dragonfly2_tpu_torch.models.graph_transformer import (
    NODE_FEATURE_DIM,
    Dense,
)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the fanout axis (second-to-last of ``x``, last of
    ``mask``), counting only mask-1 slots. The result takes the promoted
    dtype of ``x`` and ``mask`` (f32 for bf16 rows and an f32 mask)."""
    total = (x * mask[..., None]).sum(-2)
    count = mask.sum(-1)[..., None]
    return total / torch.clamp(count, min=1.0)


class SageLayer(nn.Module):
    """One GraphSAGE-mean layer: relu(Dense([self, mean(neighbors)]))."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.Dense_0 = Dense(in_features, features, dtype, generator)

    def forward(self, h_self, h_nbrs, mask):
        # h_self [..., D]; h_nbrs [..., fanout, D']; mask [..., fanout]
        agg = masked_mean(h_nbrs, mask)
        return F.relu(self.Dense_0(torch.cat([h_self, agg], dim=-1)))


class GraphSAGE(nn.Module):
    """2-layer GraphSAGE with the edge-classification head.

    ``forward`` takes the gathered batch (``center_feat [B, 2, F]``,
    ``nbr1_feat [B, 2, f1, F]`` with its rtt and mask ``[B, 2, f1]``,
    ``nbr2_feat [B, 2, f1, f2, F]`` with ``[B, 2, f1, f2]``) and returns
    the f32 logit per target edge, ``[B]``. ``SageLayer_0`` serves both
    hops: the 1-hop neighbors aggregate their 2-hop samples, and the
    centers (a zero column appended for the missing RTT) their 1-hop
    samples."""

    def __init__(self, hidden: int = 128, embed: int = 64,
                 in_features: int = NODE_FEATURE_DIM,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        width = in_features + 1
        self.SageLayer_0 = SageLayer(2 * width, hidden, dtype, generator)
        self.SageLayer_1 = SageLayer(2 * hidden, embed, dtype, generator)
        self.Dense_0 = Dense(4 * embed, hidden, dtype, generator)
        self.Dense_1 = Dense(hidden, 1, dtype, generator)

    def forward(self, center_feat, nbr1_feat, nbr1_rtt, nbr1_mask,
                nbr2_feat, nbr2_rtt, nbr2_mask):
        dt = self.dtype

        def with_rtt(feats, rtt):
            return torch.cat([feats.to(dt), rtt[..., None].to(dt)], dim=-1)

        x_center = center_feat.to(dt)                     # [B, 2, F]
        x_nbr1 = with_rtt(nbr1_feat, nbr1_rtt)            # [B, 2, f1, F+1]
        x_nbr2 = with_rtt(nbr2_feat, nbr2_rtt)            # [B, 2, f1, f2, F+1]
        layer1 = self.SageLayer_0
        h1_nbr1 = layer1(x_nbr1, x_nbr2, nbr2_mask)       # [B, 2, f1, H]
        h1_center = layer1(
            torch.cat([x_center, x_center.new_zeros(
                x_center.shape[:-1] + (1,))], dim=-1),
            x_nbr1, nbr1_mask)                            # [B, 2, H]
        h2 = self.SageLayer_1(h1_center, h1_nbr1, nbr1_mask)  # [B, 2, E]
        h_src, h_dst = h2[..., 0, :], h2[..., 1, :]
        pair = torch.cat([h_src, h_dst, h_src * h_dst,
                          (h_src - h_dst).abs()], dim=-1)
        z = F.relu(self.Dense_0(pair))
        return self.Dense_1(z)[..., 0].float()            # [B]
