"""Probe graph in array form — port of ``Graph`` from
``dragonfly2_tpu/data/features.py``."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Graph:
    """A probe graph in array form. ``node_features`` rows are observable
    host features only; parent quality is the GNN's to infer."""

    node_ids: np.ndarray        # [n_nodes] str — host IDs
    node_features: np.ndarray   # [n_nodes, 8] float32
    edge_src: np.ndarray        # [n_edges] int32
    edge_dst: np.ndarray        # [n_edges] int32
    edge_rtt_ns: np.ndarray     # [n_edges] int64

    @property
    def n_nodes(self) -> int:
        return len(self.node_ids)

    @property
    def n_edges(self) -> int:
        return len(self.edge_src)
