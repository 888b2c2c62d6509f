"""Synthetic probe graphs (numpy), bit-identical to the JAX package's."""

from dragonfly2_tpu_torch.data.features import Graph
from dragonfly2_tpu_torch.data.synthetic import HostPool, SyntheticCluster

__all__ = ["Graph", "HostPool", "SyntheticCluster"]
