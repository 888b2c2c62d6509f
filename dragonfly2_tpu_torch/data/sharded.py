"""Sharded columnar datasets with a deterministic global shuffle.

SURVEY §7 hard part: "streaming ingestion at 10M records — the
reference's CSV-with-rotation (scheduler/storage/storage.go:412-475) is
naive; we need sharded columnar files + deterministic global shuffle
under pjit data parallelism." This module is that layer: probe/download
records land in N parquet shards with fixed row groups, and training
streams them with a TWO-LEVEL deterministic shuffle —

  1. the epoch permutation orders (shard, row-group) tiles, and
  2. each tile's rows are permuted by a generator seeded from
     (seed, epoch, shard, group),

so every row appears exactly once per epoch, the order is a pure
function of (seed, epoch) (reproducible across restarts — the elastic-
resume prerequisite), and peak memory is a few row groups, never the
dataset. 10M rows stream in O(block) memory; nothing here scales with
total row count except the tile index.

Port of ``dragonfly2_tpu/data/sharded.py`` on the port's parquet codec
(``schema/parquet.py``) instead of pyarrow: the shards are the same
parquet files, and the tile index, the two-level shuffle, the carry and
the dropped remainder are the JAX module's own lines. A row group reads
as the port's table, ``{column: ndarray}``, so an extractor takes
``table["src"]`` where the JAX package's takes
``table.column("src").to_numpy()``.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterator, List, Sequence, Tuple

import numpy as np

from dragonfly2_tpu_torch.schema import parquet as pq

DEFAULT_ROW_GROUP = 262_144


def write_columns_sharded(
    columns: Dict[str, np.ndarray],
    out_dir: str,
    *,
    n_shards: int = 16,
    basename: str = "probes",
    row_group_rows: int = DEFAULT_ROW_GROUP,
) -> List[str]:
    """Split columnar data across ``n_shards`` parquet files with fixed
    row groups (the tile granularity the shuffled reader relies on).
    Returns the shard paths in index order."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(next(iter(columns.values())))
    bounds = np.linspace(0, n, n_shards + 1).astype(np.int64)
    paths = []
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        table = {k: v[lo:hi] for k, v in columns.items()}
        path = os.path.join(out_dir, f"{basename}-{s:05d}.parquet")
        pq.write_table(table, path, row_group_size=row_group_rows)
        paths.append(path)
    return paths


class ShardedParquetDataset:
    """Streaming batches over sharded parquet with deterministic global
    shuffle; see the module docstring for the two-level scheme.

    ``extractor(table) -> tuple[np.ndarray, ...]`` maps a row-group
    table to the training arrays (all length = group rows).
    """

    def __init__(self, paths: Sequence[str],
                 extractor: Callable[[Dict[str, np.ndarray]],
                                     Tuple[np.ndarray, ...]],
                 columns: Sequence[str] | None = None):
        self.paths = list(paths)
        self.extractor = extractor
        self.columns = list(columns) if columns else None
        # Tile index from parquet metadata only — no data reads.
        self._tiles: List[Tuple[int, int, int]] = []  # (shard, group, rows)
        self._n_rows = 0
        for s, path in enumerate(self.paths):
            meta = pq.ParquetFile(path).metadata
            for g in range(meta.num_row_groups):
                rows = meta.row_group(g).num_rows
                self._tiles.append((s, g, rows))
                self._n_rows += rows

    def __len__(self) -> int:
        return self._n_rows

    @property
    def n_tiles(self) -> int:
        return len(self._tiles)

    def _tile_arrays(self, shard: int, group: int) -> Tuple[np.ndarray, ...]:
        table = pq.ParquetFile(self.paths[shard]).read_row_group(
            group, columns=self.columns)
        return self.extractor(table)

    def batches(self, batch_size: int, *, seed: int = 0, epoch: int = 0,
                shuffle: bool = True) -> Iterator[Tuple[np.ndarray, ...]]:
        """Fixed-size batches (remainder dropped — static shapes for
        jit). Order is a pure function of (seed, epoch)."""
        if shuffle:
            tile_order = np.random.default_rng(
                (seed, epoch, 0xD1CE)).permutation(self.n_tiles)
        else:
            tile_order = np.arange(self.n_tiles)
        carry: List[Tuple[np.ndarray, ...]] = []
        carried = 0
        for t in tile_order:
            shard, group, _rows = self._tiles[t]
            arrays = self._tile_arrays(shard, group)
            if shuffle:
                perm = np.random.default_rng(
                    (seed, epoch, shard, group)).permutation(len(arrays[0]))
                arrays = tuple(a[perm] for a in arrays)
            carry.append(arrays)
            carried += len(arrays[0])
            if carried < batch_size:
                continue
            merged = tuple(
                np.concatenate([c[i] for c in carry])
                for i in range(len(arrays)))
            n_full = carried // batch_size
            for b in range(n_full):
                yield tuple(a[b * batch_size:(b + 1) * batch_size]
                            for a in merged)
            rest = carried - n_full * batch_size
            carry = ([tuple(a[-rest:] for a in merged)] if rest else [])
            carried = rest
        # Remainder (< batch_size) dropped: XLA recompiles on shape
        # change, so a short final batch is never worth it.

    def ingest_all(self, *, columns: Sequence[str] | None = None) -> float:
        """Sequentially read every row group (column-pruned); returns
        rows read. The scale-proof's ingestion-throughput measurement."""
        rows = 0
        cols = list(columns) if columns else self.columns
        for s, path in enumerate(self.paths):
            f = pq.ParquetFile(path)
            for g in range(f.metadata.num_row_groups):
                table = f.read_row_group(g, columns=cols)
                rows += len(next(iter(table.values()))) if table else 0
        return rows
