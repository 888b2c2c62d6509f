"""The port's sharded parquet datasets (``data/sharded.py`` on the port's
parquet codec) and ``data/pipeline.py``'s ``from_parquet_shards``, held
against the JAX package's on the same seeded probe edges: the same shard
files, the same tile index, and the same batches for every (seed, epoch).
JAX's ``tests/test_sharded_pipeline.py`` cases run over both packages."""

from __future__ import annotations

import numpy as np
import pyarrow.parquet as pq
import pytest

from dragonfly2_tpu.data import ShardedParquetDataset as JaxSharded
from dragonfly2_tpu.data import SyntheticCluster as JaxCluster
from dragonfly2_tpu.data import write_columns_sharded as jax_write
from dragonfly2_tpu.data.pipeline import from_parquet_shards as jax_from
from dragonfly2_tpu_torch.data import (
    ShardedParquetDataset,
    SyntheticCluster,
    write_columns_sharded,
)
from dragonfly2_tpu_torch.data.pipeline import from_parquet_shards

COLUMNS = ("src", "dst", "rtt_ns")


def jax_extractor(table):
    return tuple(table.column(c).to_numpy() for c in COLUMNS)


def port_extractor(table):
    return tuple(table[c] for c in COLUMNS)


PACKAGES = {
    "jax": (JaxCluster, jax_write, JaxSharded, jax_extractor),
    "port": (SyntheticCluster, write_columns_sharded, ShardedParquetDataset,
             port_extractor),
}


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """package → (columns, shard paths): JAX's test shape, 100 000 edges
    in 4 shards of 8192-row groups, written by each package."""
    out = {}
    for pkg, (cluster, write, _, _) in PACKAGES.items():
        root = tmp_path_factory.mktemp(f"shards-{pkg}")
        cols = cluster(n_hosts=200, seed=7).probe_edge_columns(100_000)
        out[pkg] = cols, write(cols, str(root), n_shards=4,
                               row_group_rows=8192)
    return out


def dataset(shards, pkg, **kw):
    _, _, cls, extractor = PACKAGES[pkg]
    return cls(shards[pkg][1], kw.pop("extractor", extractor), **kw)


def test_shards_are_the_same_files_to_pyarrow(shards):
    jax_cols, jax_paths = shards["jax"]
    port_cols, port_paths = shards["port"]
    for c in COLUMNS:
        np.testing.assert_array_equal(port_cols[c], jax_cols[c])
    assert [p.rsplit("/", 1)[1] for p in port_paths] == [
        p.rsplit("/", 1)[1] for p in jax_paths]
    for p, j in zip(port_paths, jax_paths):
        assert pq.read_table(p).equals(pq.read_table(j))


@pytest.mark.parametrize("seed,epoch,shuffle", [
    (0, 0, True), (5, 2, True), (11, 0, True), (3, 7, True), (0, 0, False)])
@pytest.mark.parametrize("batch", [1000, 4096])
def test_batches_equal_jax(shards, seed, epoch, shuffle, batch):
    port = dataset(shards, "port")
    ref = dataset(shards, "jax")
    assert len(port) == len(ref) and port.n_tiles == ref.n_tiles
    assert port._tiles == ref._tiles
    got = list(port.batches(batch, seed=seed, epoch=epoch, shuffle=shuffle))
    want = list(ref.batches(batch, seed=seed, epoch=epoch, shuffle=shuffle))
    assert len(got) == len(want) == 100_000 // batch
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_port_reads_jax_shards_as_jax_does(shards):
    """The port's dataset over the JAX package's shard files."""
    port = ShardedParquetDataset(shards["jax"][1], port_extractor)
    ref = dataset(shards, "jax")
    for g, w in zip(port.batches(2048, seed=1, epoch=1),
                    ref.batches(2048, seed=1, epoch=1)):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("columns", [None, ["src", "rtt_ns"]])
def test_ingest_all_equals_jax(shards, columns):
    assert dataset(shards, "port").ingest_all(columns=columns) == dataset(
        shards, "jax").ingest_all(columns=columns) == 100_000


def test_from_parquet_shards_equals_jax(shards):
    got = from_parquet_shards(shards["port"][1], port_extractor)
    want = jax_from(shards["jax"][1], jax_extractor)
    assert len(got) == len(want) == 100_000
    for a, b in zip(got.arrays, want.arrays):
        np.testing.assert_array_equal(a, b)
    for g, w in zip(got.batches(3000, seed=2), want.batches(3000, seed=2)):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------
# JAX's tests/test_sharded_pipeline.py, over both packages
# ----------------------------------------------------------------------


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
class TestShardedDataset:
    def test_index_covers_all_rows(self, shards, pkg):
        ds = dataset(shards, pkg)
        assert len(ds) == 100_000
        assert ds.n_tiles >= 4  # ≥1 row group per shard

    def test_every_row_exactly_once_per_epoch(self, shards, pkg):
        cols, _ = shards[pkg]
        ds = dataset(shards, pkg)
        seen_rtt = []
        for b in ds.batches(1000, seed=3, epoch=0):
            assert len(b[0]) == 1000  # fixed shapes, always
            seen_rtt.append(b[2])
        got = np.sort(np.concatenate(seen_rtt))
        np.testing.assert_array_equal(got, np.sort(cols["rtt_ns"]))

    def test_shuffle_is_deterministic_and_epoch_varies(self, shards, pkg):
        ds = dataset(shards, pkg)
        a1 = next(iter(ds.batches(1024, seed=5, epoch=2)))
        ds2 = dataset(shards, pkg)
        a2 = next(iter(ds2.batches(1024, seed=5, epoch=2)))
        for x, y in zip(a1, a2):
            np.testing.assert_array_equal(x, y)
        b1 = next(iter(ds.batches(1024, seed=5, epoch=3)))
        assert not np.array_equal(a1[2], b1[2])  # epoch reshuffles
        c1 = next(iter(ds.batches(1024, seed=6, epoch=2)))
        assert not np.array_equal(a1[2], c1[2])  # seed reshuffles

    def test_global_not_shardwise_shuffle(self, shards, pkg):
        ds = dataset(shards, pkg)
        first = next(iter(ds.batches(8192, seed=0, epoch=0)))
        order = np.random.default_rng((0, 0, 0xD1CE)).permutation(ds.n_tiles)
        shards_in_first_tiles = {ds._tiles[t][0] for t in order[:4]}
        assert len(shards_in_first_tiles) > 1
        assert len(first[0]) == 8192

    def test_column_pruned_ingestion(self, shards, pkg):
        def pruned_extractor(table):
            if pkg == "jax":
                assert table.num_columns == 2  # pruning reached the reader
                return (table.column("src").to_numpy(),
                        table.column("rtt_ns").to_numpy())
            assert list(table) == ["src", "rtt_ns"]
            return table["src"], table["rtt_ns"]

        ds = dataset(shards, pkg, extractor=pruned_extractor,
                     columns=["src", "rtt_ns"])
        assert ds.ingest_all() == 100_000
        pruned = next(iter(ds.batches(1024, shuffle=False)))
        assert len(pruned) == 2

    def test_unshuffled_order_is_file_order(self, shards, pkg):
        cols, _ = shards[pkg]
        ds = dataset(shards, pkg)
        first = next(iter(ds.batches(1000, shuffle=False)))
        np.testing.assert_array_equal(first[2], cols["rtt_ns"][:1000])
