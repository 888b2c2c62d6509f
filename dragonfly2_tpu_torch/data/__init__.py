"""Synthetic probe graphs and pair examples (numpy), bit-identical to
the JAX package's, the epoch-batching dataset, and sharded parquet
datasets with a deterministic global shuffle."""

from dragonfly2_tpu_torch.data.features import Graph
from dragonfly2_tpu_torch.data.pipeline import ArrayDataset
from dragonfly2_tpu_torch.data.sharded import (
    ShardedParquetDataset,
    write_columns_sharded,
)
from dragonfly2_tpu_torch.data.synthetic import HostPool, SyntheticCluster

__all__ = ["ArrayDataset", "Graph", "HostPool", "ShardedParquetDataset",
           "SyntheticCluster", "write_columns_sharded"]
