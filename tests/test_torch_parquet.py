"""The port's parquet codec (``schema/parquet.py``) and the parquet half of
its ``schema/io.py``, held against pyarrow and the JAX package on the
same seeded columns and records: the port's files read in pyarrow as the
tables JAX writes, JAX's default-written files read in the port to the
same columns, and what the codec does not support raises ``ValueError``
naming the feature."""

from __future__ import annotations

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dragonfly2_tpu.data import SyntheticCluster as JaxCluster
from dragonfly2_tpu.schema import Download as JaxDownload
from dragonfly2_tpu.schema import io as jax_io
from dragonfly2_tpu.scheduler.storage.storage import Storage as JaxStorage
from dragonfly2_tpu.schema import flatten_record as jax_flatten
from dragonfly2_tpu_torch.schema import Download, unflatten_record
from dragonfly2_tpu_torch.schema import io as port_io
from dragonfly2_tpu_torch.schema import parquet as port_pq
from dragonfly2_tpu_torch.scheduler.storage.storage import Storage

WORDS = np.array(["héllo", "€uro", "", "日本語", "plain", "ß", "🙂 ok"])


def mixed_columns(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "i32": rng.integers(-2**31, 2**31, n).astype(np.int32),
        "i64": rng.integers(-2**62, 2**62, n),
        "f32": rng.standard_normal(n).astype(np.float32),
        "f64": rng.standard_normal(n),
        "flag": rng.random(n) < 0.3,
        "word": WORDS[rng.integers(0, len(WORDS), n)],
    }


def assert_columns_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype.kind == np.asarray(want[name]).dtype.kind
        if got[name].dtype.kind != "U":
            assert got[name].dtype == np.asarray(want[name]).dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def chunk_pages(path: str, group: int, column: str) -> list:
    """(page type, encoding, codec) of every page of one column chunk,
    read with the codec's own page parser."""
    meta = port_pq.read_metadata(path)
    cm = meta.row_group(group).columns[meta.columns.index(column)]
    start = cm.get(11) or cm[9]
    with open(path, "rb") as f:
        f.seek(start)
        data = f.read(cm[7])
    reader, pages = port_pq._Reader(data), []
    while reader.pos < len(data):
        header = reader.struct()
        reader.pos += header[3]
        if header[1] == port_pq.DICTIONARY_PAGE:
            pages.append(("dictionary", header[7][2], cm[4]))
        else:
            pages.append(("data", header[5][2], cm[4]))
    return pages


# ----------------------------------------------------------------------
# The port writes, pyarrow reads
# ----------------------------------------------------------------------


@pytest.mark.parametrize("n,row_group_size", [
    (1000, None), (1000, 300), (60, 1), (999, 1000), (0, None)])
def test_port_file_reads_in_pyarrow_as_the_jax_file(tmp_path, n,
                                                    row_group_size):
    cols = mixed_columns(n, seed=n)
    port_path, jax_path = str(tmp_path / "port.pq"), str(tmp_path / "jax.pq")
    port_pq.write_table(cols, port_path, row_group_size=row_group_size)
    pq.write_table(pa.table(cols), jax_path, row_group_size=row_group_size)
    got, want = pq.read_table(port_path), pq.read_table(jax_path)
    assert got.schema.equals(want.schema)
    assert [f.nullable for f in got.schema] == [True] * len(cols)
    assert got.equals(want)
    got_meta = pq.ParquetFile(port_path).metadata
    want_meta = pq.ParquetFile(jax_path).metadata
    assert got_meta.num_row_groups == want_meta.num_row_groups
    assert ([got_meta.row_group(g).num_rows
             for g in range(got_meta.num_row_groups)]
            == [want_meta.row_group(g).num_rows
                for g in range(want_meta.num_row_groups)])
    # One PLAIN v1 data page a chunk, uncompressed.
    assert chunk_pages(port_path, got_meta.num_row_groups - 1, "word") == [
        ("data", port_pq.PLAIN, port_pq.UNCOMPRESSED)]


def test_port_reads_its_own_file_from_the_footer(tmp_path):
    cols = mixed_columns(2500, seed=1)
    path = str(tmp_path / "t.pq")
    port_pq.write_table(cols, path, row_group_size=1000)
    f = port_pq.ParquetFile(path)
    assert f.metadata.num_row_groups == 3
    assert [f.metadata.row_group(g).num_rows for g in range(3)] == [
        1000, 1000, 500]
    assert f.metadata.num_rows == 2500
    assert_columns_equal(f.read(), cols)
    second = f.read_row_group(1, ["word", "i64"])
    assert list(second) == ["word", "i64"]
    np.testing.assert_array_equal(second["i64"], cols["i64"][1000:2000])
    with pytest.raises(KeyError):
        f.read_row_group(0, ["nope"])


# ----------------------------------------------------------------------
# pyarrow writes with its defaults (the JAX package's files), the port reads
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_default_file(tmp_path_factory):
    """300 000 rows written with pyarrow's defaults: SNAPPY, dictionary
    pages, a high-cardinality int64 column past the 1 MiB dictionary
    limit, several pages a chunk."""
    rng = np.random.default_rng(7)
    n = 300_000
    cols = mixed_columns(n, seed=7)
    cols["few"] = rng.integers(0, 5, n)  # low cardinality
    cols["many"] = rng.permutation(n).astype(np.int64) * 7919  # all distinct
    path = str(tmp_path_factory.mktemp("jax") / "defaults.parquet")
    pq.write_table(pa.table(cols), path)
    return path, cols


def test_jax_default_file_reads_in_the_port(jax_default_file):
    path, cols = jax_default_file
    assert_columns_equal(port_pq.ParquetFile(path).read(), cols)


def test_jax_default_file_has_the_pages_the_reader_must_decode(
        jax_default_file):
    path, _ = jax_default_file
    pages = chunk_pages(path, 0, "many")
    assert pages[0][0] == "dictionary"
    encodings = [enc for kind, enc, _ in pages if kind == "data"]
    # dictionary-encoded pages first, then the PLAIN fallback, one chunk
    assert encodings[0] == port_pq.RLE_DICTIONARY
    assert port_pq.PLAIN in encodings and len(encodings) > 2
    assert {codec for *_, codec in pages} == {port_pq.SNAPPY}
    few = chunk_pages(path, 0, "few")
    assert few[0][0] == "dictionary" and all(
        enc == port_pq.RLE_DICTIONARY for kind, enc, _ in few[1:])


@pytest.mark.parametrize("kwargs", [
    dict(row_group_size=70_000), dict(data_page_size=4096),
    dict(use_dictionary=False), dict(compression="none")])
def test_jax_files_with_other_writer_settings_read_in_the_port(
        tmp_path, kwargs):
    cols = mixed_columns(90_000, seed=3)
    path = str(tmp_path / "t.pq")
    pq.write_table(pa.table(cols), path, **kwargs)
    f = port_pq.ParquetFile(path)
    assert f.metadata.num_row_groups == pq.ParquetFile(
        path).metadata.num_row_groups
    assert_columns_equal(f.read(), cols)


def test_snappy_decoder_on_overlapping_copies():
    import struct

    # literal "ab", then a copy of 10 bytes at offset 2 (overlapping)
    block = bytes([12]) + bytes([1 << 2]) + b"ab" + bytes(
        [((10 - 1) << 2) | 2]) + struct.pack("<H", 2)
    assert port_pq.snappy_decompress(block) == b"ab" * 6


@pytest.mark.parametrize("case,feature", [
    ("zstd", "ZSTD"), ("v2", "v2"), ("null", "null"), ("gzip", "GZIP"),
    ("delta", "DELTA_BINARY_PACKED"), ("nested", "nested"),
    ("binary", "STRING")])
def test_unsupported_file_raises_naming_the_feature(tmp_path, case, feature):
    path = str(tmp_path / f"{case}.parquet")
    plain = pa.table({"a": np.arange(100)})
    if case == "zstd":
        pq.write_table(plain, path, compression="zstd")
    elif case == "gzip":
        pq.write_table(plain, path, compression="gzip")
    elif case == "v2":
        pq.write_table(plain, path, data_page_version="2.0")
    elif case == "null":
        pq.write_table(pa.table({"a": pa.array([1, None, 3])}), path)
    elif case == "delta":
        pq.write_table(plain, path, use_dictionary=False,
                       column_encoding={"a": "DELTA_BINARY_PACKED"})
    elif case == "nested":
        pq.write_table(pa.table({"a": pa.array([[1], [2, 3]])}), path)
    else:
        pq.write_table(pa.table({"a": pa.array([b"x", b"y"])}), path)
    with pytest.raises(ValueError, match=feature):
        port_pq.ParquetFile(path).read()


# ----------------------------------------------------------------------
# Random column sets, both ways
# ----------------------------------------------------------------------

_KINDS = ("int32", "int64", "float", "double", "bool", "string")


@st.composite
def column_sets(draw):
    n = draw(st.integers(0, 40))
    kinds = draw(st.lists(st.sampled_from(_KINDS), min_size=1, max_size=6))
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    cols = {}
    for i, kind in enumerate(kinds):
        if kind == "string":
            # No NUL: numpy's fixed-width strings drop trailing NULs and
            # pa.table() cuts a numpy string at its first.
            cols[f"c{i}"] = np.array(draw(st.lists(
                st.text(st.characters(blacklist_categories=("Cs",),
                                      blacklist_characters="\x00"),
                        max_size=8), min_size=n, max_size=n)), dtype=np.str_)
        elif kind == "bool":
            cols[f"c{i}"] = rng.random(n) < 0.5
        elif kind in ("float", "double"):
            cols[f"c{i}"] = rng.standard_normal(n).astype(
                np.float32 if kind == "float" else np.float64)
        else:
            cols[f"c{i}"] = rng.integers(-2**31, 2**31, n).astype(
                np.int32 if kind == "int32" else np.int64)
    return cols, draw(st.integers(1, 50))


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(column_sets())
def test_random_column_sets_round_trip(tmp_path, case):
    cols, row_group_size = case
    path = str(tmp_path / "r.pq")
    port_pq.write_table(cols, path, row_group_size=row_group_size)
    assert_columns_equal(port_pq.ParquetFile(path).read(), cols)
    assert pq.read_table(path).equals(pa.table(cols))
    back = str(tmp_path / "back.pq")
    pq.write_table(pa.table(cols), back, row_group_size=row_group_size)
    assert_columns_equal(port_pq.ParquetFile(back).read(), cols)


# ----------------------------------------------------------------------
# schema/io.py's parquet half against the JAX package's
# ----------------------------------------------------------------------


def same_downloads(n: int, seed: int) -> tuple:
    """(port records, JAX records): the JAX package's seeded Downloads
    (their ids are random UUIDs) and the same rows as the port's."""
    jax_recs = JaxCluster(n_hosts=30, seed=seed).downloads(n)
    return ([unflatten_record(Download, jax_flatten(r)) for r in jax_recs],
            jax_recs)


@pytest.fixture(scope="module")
def downloads():
    return same_downloads(60, seed=5)


def test_parquet_schema_is_the_arrow_schema():
    want = jax_io.arrow_schema(JaxDownload)
    got = port_io.parquet_schema(Download)
    names = {"int64": pa.int64(), "double": pa.float64(),
             "string": pa.string(), "bool": pa.bool_()}
    assert pa.schema([(n, names[t]) for n, t in got]).equals(want)


def test_write_parquet_reads_back_as_jax_writes_it(tmp_path, downloads):
    port_recs, jax_recs = downloads
    port_io.write_parquet(Download, port_recs, str(tmp_path / "p.pq"))
    jax_io.write_parquet(JaxDownload, jax_recs, str(tmp_path / "j.pq"))
    assert pq.read_table(str(tmp_path / "p.pq")).equals(
        pq.read_table(str(tmp_path / "j.pq")))
    for path in ("p.pq", "j.pq"):
        got = port_io.read_parquet_records(Download, str(tmp_path / path))
        assert got == port_recs
    assert jax_io.read_parquet_records(
        JaxDownload, str(tmp_path / "p.pq")) == jax_recs


def test_read_parquet_projects_columns(tmp_path, downloads):
    port_recs, _ = downloads
    path = str(tmp_path / "p.pq")
    port_io.write_parquet(Download, port_recs, path)
    cols = ["id", "task.content_length", "host.network.idc"]
    got = port_io.read_parquet(path, cols)
    want = jax_io.read_parquet(path, cols)
    assert list(got) == cols
    for c in cols:
        assert got[c].tolist() == want.column(c).to_pylist()


@pytest.mark.parametrize("header", [True, False])
def test_csv_to_parquet_streams_row_groups_as_jax(tmp_path, downloads,
                                                   header):
    port_recs, _ = downloads
    csv_path = str(tmp_path / "d.csv")
    with port_io.CsvRecordWriter(Download, csv_path,
                                 write_header=header) as w:
        for r in port_recs:
            w.write(r)
    port_n = port_io.csv_to_parquet(Download, csv_path,
                                    str(tmp_path / "p.pq"), batch_size=25)
    jax_n = jax_io.csv_to_parquet(JaxDownload, csv_path,
                                  str(tmp_path / "j.pq"), batch_size=25)
    assert port_n == jax_n == 60
    got, want = (pq.ParquetFile(str(tmp_path / p)) for p in ("p.pq", "j.pq"))
    assert got.metadata.num_row_groups == want.metadata.num_row_groups == 3
    assert got.read().equals(want.read())
    assert port_io.read_parquet_records(
        Download, str(tmp_path / "p.pq")) == port_recs


def test_concat_tables_as_jax(tmp_path, downloads):
    port_recs, _ = downloads
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"{i}.pq"))
        port_io.write_parquet(Download, port_recs[i * 20:(i + 1) * 20],
                              paths[-1])
    got = port_io.concat_tables(paths, ["id", "cost"])
    want = jax_io.concat_tables(paths, ["id", "cost"])
    assert {c: got[c].tolist() for c in got} == want.to_pydict()
    assert port_io.concat_tables([]) == {}


# ----------------------------------------------------------------------
# The scheduler storage's export
# ----------------------------------------------------------------------


def test_export_parquet_equals_jax(tmp_path):
    port_recs, jax_recs = same_downloads(150, seed=9)
    port_store = Storage(str(tmp_path / "port"))
    jax_store = JaxStorage(str(tmp_path / "jax"))
    for r in port_recs:
        port_store.create_download(r)
    for r in jax_recs:
        jax_store.create_download(r)
    port_files = port_store.download.export_parquet(str(tmp_path / "pe"))
    jax_files = jax_store.download.export_parquet(str(tmp_path / "je"))
    assert ([os.path.basename(p) for p in port_files]
            == [os.path.basename(p) for p in jax_files])
    assert len(port_files) == len(port_store.download.all_files())
    for p, j in zip(port_files, jax_files):
        assert pq.read_table(p).equals(pq.read_table(j))
        assert (port_io.read_parquet_records(Download, p)
                == port_io.read_parquet_records(Download, j))
        assert (jax_io.read_parquet_records(JaxDownload, p)
                == jax_io.read_parquet_records(JaxDownload, j))
    got = [r for p in port_files
           for r in port_io.read_parquet_records(Download, p)]
    assert got == port_recs
