"""Synthetic probe graphs and pair examples (numpy), bit-identical to
the JAX package's, and the epoch-batching dataset."""

from dragonfly2_tpu_torch.data.features import Graph
from dragonfly2_tpu_torch.data.pipeline import ArrayDataset
from dragonfly2_tpu_torch.data.synthetic import HostPool, SyntheticCluster

__all__ = ["ArrayDataset", "Graph", "HostPool", "SyntheticCluster"]
