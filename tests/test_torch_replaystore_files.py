"""Port parity for the ``.npc`` columnar store's file half
(``scheduler/replaystore.py``: ``write_columns``, ``open_corpus``,
``check_corpus``, ``ReplayStoreWriter``, ``open_dir``, ``pack_csv``) and
the replay corpus loaders (``scheduler/replay.py``), against the JAX
package, on the CPU.

The file format is shared: the same columns give the same bytes in both
packages, either package opens the other's files with equal columns,
and refusals and ``check_corpus`` reports are equal, message for
message. Nothing here has a tolerance.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct

import numpy as np
import pytest

from dragonfly2_tpu import schema as jax_schema
from dragonfly2_tpu.scheduler import replay as jax_replay
from dragonfly2_tpu.scheduler import replaybench as jax_bench
from dragonfly2_tpu.scheduler import replaystore as jax_store
from dragonfly2_tpu.scheduler.storage.storage import Storage as JaxStorage
from dragonfly2_tpu.scheduler.storage.storage import (
    StorageConfig as JaxStorageConfig,
)
from dragonfly2_tpu.train.cost_trainer import (
    cost_examples_from_corpus as jax_cost_examples,
)
from dragonfly2_tpu_torch import schema
from dragonfly2_tpu_torch.scheduler import replay, replaybench, replaystore
from dragonfly2_tpu_torch.scheduler.storage.storage import (
    Storage,
    StorageConfig,
)
from dragonfly2_tpu_torch.schema.io import CsvRecordWriter
from dragonfly2_tpu_torch.train.cost_trainer import cost_examples_from_corpus


def to_port(event):
    """A JAX ``ReplayDecision`` as the port's record, field for field."""
    fields = dataclasses.asdict(event)
    candidates = [schema.ReplayCandidate(**{
        **c, "features": schema.ReplayFeatureRow(**c["features"])})
        for c in fields.pop("candidates")]
    return schema.ReplayDecision(**fields, candidates=candidates)


def to_jax(event):
    """A port ``ReplayDecision`` as the JAX package's record."""
    fields = dataclasses.asdict(event)
    candidates = [jax_schema.ReplayCandidate(**{
        **c, "features": jax_schema.ReplayFeatureRow(**c["features"])})
        for c in fields.pop("candidates")]
    return jax_schema.ReplayDecision(**fields, candidates=candidates)


def assert_columns_equal(got: dict, want: dict):
    assert set(got) == set(want) == set(replaystore.ALL_COLUMNS)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def write_bytes(path: str, data: bytes) -> str:
    with open(path, "wb") as f:
        f.write(data)
    return path


CORPORA = {
    "synth_700": lambda: replaybench.synth_replay_corpus(700, seed=3),
    "synth_one": lambda: replaybench.synth_replay_corpus(1, seed=1),
    "empty": lambda: replaystore.ColumnarCorpus.from_events([]),
    "few_candidates": lambda: replaystore.ColumnarCorpus.from_events([
        schema.ReplayDecision(seq=s, verdict="parents", candidates=[
            schema.ReplayCandidate(id=f"c{s}-{j}", rank=j, realized_n=1,
                                   realized_cost=0.01 * (j + 1))
            for j in range(1 + s % 3)]) for s in range(5)]),
}


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_npc_bytes_equal_to_jax(tmp_path, corpus):
    cc = CORPORA[corpus]()
    got = str(tmp_path / "port.npc")
    want = str(tmp_path / "jax.npc")
    replaystore.write_columns(got, cc.columns())
    jax_store.write_columns(want, cc.columns())
    assert read(got) == read(want)
    assert not os.path.exists(got + ".tmp")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_opens_the_others_files(tmp_path, writer):
    cc = replaybench.synth_replay_corpus(900, seed=11)
    path = str(tmp_path / f"{writer}.npc")
    (replaystore if writer == "port" else jax_store).write_columns(
        path, cc.columns())
    got = replaystore.open_corpus(path)
    want = jax_store.open_corpus(path)
    assert_columns_equal(got.columns(), want.columns())
    assert_columns_equal(got.columns(), cc.columns())
    assert (got.n, got.k, got.path) == (want.n, want.k, want.path) == \
        (900, 16, path)
    assert got.to_events()[:50] == [to_port(e)
                                    for e in want.to_events()[:50]]
    assert replaystore.check_corpus(path) == jax_store.check_corpus(path)


def test_open_corpus_is_zero_copy_over_the_map(tmp_path):
    cc = replaybench.synth_replay_corpus(300, seed=2)
    path = str(tmp_path / "c.npc")
    replaystore.write_columns(path, cc.columns())
    opened = replaystore.open_corpus(path)
    for name in replaystore.ALL_COLUMNS:
        arr = getattr(opened, name)
        assert not arr.flags.owndata and not arr.flags.writeable, name
        assert arr.ctypes.data % replaystore.COLUMN_ALIGN == \
            np.frombuffer(opened._mmap, np.uint8).ctypes.data \
            % replaystore.COLUMN_ALIGN, name
    view = opened.slice(100, 120)
    assert view._mmap is opened._mmap and view.path == path
    assert np.shares_memory(view.features, opened.features)
    assert view.decision(0) == opened.decision(100)
    del view, arr
    opened.close()
    assert opened._mmap is None and opened.features is None


# -- refusals and checks ------------------------------------------------------


def _footer(data: bytes):
    tail = len(replaystore.TAIL_MAGIC)
    (flen,) = struct.unpack("<Q", data[-tail - 8:-tail])
    start = len(data) - tail - 8 - flen
    return start, json.loads(data[start:start + flen])


def _with_footer(data: bytes, edit) -> bytes:
    start, footer = _footer(data)
    edit(footer)
    body = json.dumps(footer, sort_keys=True).encode()
    return data[:start] + body + struct.pack("<Q", len(body)) + \
        replaystore.TAIL_MAGIC


def _set(*keys, value):
    def edit(footer):
        node = footer
        for key in keys[:-1]:
            node = node[key]
        node[keys[-1]] = value
    return edit


def _drop_column(footer):
    del footer["columns"]["rank"]


CORRUPTIONS = {
    "bad_magic": lambda d: b"X" + d[1:],
    "missing_tail": lambda d: d[:-3],
    "too_small": lambda d: d[:12],
    "footer_length_zero": lambda d: d[:-18] + struct.pack("<Q", 0) + d[-10:],
    "footer_length_huge": lambda d: d[:-18] + struct.pack("<Q", 1 << 40)
    + d[-10:],
    "footer_not_json": lambda d: _with_footer(d, lambda f: None).replace(
        b'"format"', b'"format\xff'),
    "unknown_format": lambda d: _with_footer(d, _set("format", value="x")),
    "schema_version": lambda d: _with_footer(
        d, _set("schema_version", value=2)),
    "feature_layout": lambda d: _with_footer(
        d, _set("feature_fields", value=["a"])),
    "missing_column": lambda d: _with_footer(d, _drop_column),
    "dtype_disagrees": lambda d: _with_footer(
        d, _set("columns", "features", "dtype", value="<f8")),
    "shape_disagrees": lambda d: _with_footer(
        d, _set("columns", "rank", "shape", value=[3, 3])),
    "extent_outside": lambda d: _with_footer(
        d, _set("columns", "seq", "offset", value=len(d))),
}


@pytest.mark.parametrize("kind", sorted(CORRUPTIONS))
def test_refusals_equal_to_jax(tmp_path, kind):
    good = str(tmp_path / "good.npc")
    replaystore.write_columns(
        good, replaybench.synth_replay_corpus(64, seed=5).columns())
    bad = write_bytes(str(tmp_path / "bad.npc"),
                      CORRUPTIONS[kind](read(good)))
    with pytest.raises(replaystore.ReplayStoreError) as got:
        replaystore.open_corpus(bad)
    with pytest.raises(jax_store.ReplayStoreError) as want:
        jax_store.open_corpus(bad)
    assert str(got.value) == str(want.value)
    report = replaystore.check_corpus(bad)
    assert report == jax_store.check_corpus(bad)
    assert report["ok"] is False and report["errors"] == [str(got.value)]


def test_check_corpus_of_a_missing_file_equal(tmp_path):
    path = str(tmp_path / "absent.npc")
    report = replaystore.check_corpus(path)
    assert report == jax_store.check_corpus(path) and not report["ok"]


def _dirty(name: str, cols: dict) -> dict:
    cols = {k: np.array(v) for k, v in cols.items()}
    if name == "dirty_padding":
        i, j = np.argwhere(~cols["valid"])[0]
        cols["features"][i, j, 0] = 1.0
        cols["rank"][i, j] = 2
    elif name == "seq_not_increasing":
        cols["seq"][3] = cols["seq"][2]
    elif name == "mask_not_prefix":
        i = int(np.flatnonzero(cols["n_candidates"] > 1)[0])
        cols["valid"][i, 0] = False
    elif name == "b2s_with_candidates":
        i = int(np.flatnonzero(cols["n_candidates"] > 0)[0])
        cols["verdict"][i] = 1
    elif name == "unknown_verdict":
        cols["verdict"][0] = 7
    elif name == "duplicate_ids":
        i = int(np.flatnonzero(cols["n_candidates"] > 1)[0])
        cols["cand_id"][i, 1] = cols["cand_id"][i, 0]
    elif name == "nonfinite_features":
        cols["features"][0, 0, 2] = np.inf
    elif name == "n_candidates_range":
        cols["n_candidates"][0] = 99
    return cols


@pytest.mark.parametrize("name", [
    "clean", "dirty_padding", "seq_not_increasing", "mask_not_prefix",
    "b2s_with_candidates", "unknown_verdict", "duplicate_ids",
    "nonfinite_features", "n_candidates_range"])
def test_check_corpus_reports_equal_to_jax(tmp_path, name):
    cols = _dirty(name, replaybench.synth_replay_corpus(200, seed=9).columns())
    path = str(tmp_path / f"{name}.npc")
    replaystore.write_columns(path, cols)
    report = replaystore.check_corpus(path)
    assert report == jax_store.check_corpus(path)
    assert report["ok"] is (name in ("clean", "duplicate_ids"))
    if name in ("clean", "duplicate_ids"):
        assert bool(report["warnings"]) is (name == "duplicate_ids")


# -- the writer and its directory ---------------------------------------------


@pytest.mark.parametrize("segment,max_segments", [(150, 16), (100, 3)])
def test_writer_rotation_and_open_dir_equal(tmp_path, segment, max_segments):
    cc = replaybench.synth_replay_corpus(620, seed=4)
    port_events = cc.to_events()
    jax_events = [to_jax(e) for e in port_events]
    dirs = {}
    for name, module, events in (("port", replaystore, port_events),
                                 ("jax", jax_store, jax_events)):
        base = str(tmp_path / name)
        writer = module.ReplayStoreWriter(base, segment_decisions=segment,
                                          max_segments=max_segments)
        for start in range(0, len(events), 70):
            writer.append_batch(events[start:start + 70])
        writer.append(events[0].__class__(seq=10_000, verdict="parents"))
        writer.close()
        writer.flush()  # empty: a no-op
        dirs[name] = base
    got = replaystore.list_segments(dirs["port"])
    want = jax_store.list_segments(dirs["jax"])
    # Flushes at 210, 210 and 200 buffered decisions, then the one
    # appended alone at close: four segments, the oldest pruned past
    # max_segments.
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert len(got) == min(4, max_segments)
    for a, b in zip(got, want):
        assert read(a) == read(b)
    assert_columns_equal(replaystore.open_dir(dirs["port"]).columns(),
                         jax_store.open_dir(dirs["jax"]).columns())


def test_writer_numbering_and_pruning_equal(tmp_path):
    events = replaybench.synth_replay_corpus(50, seed=6).to_events()
    names = {}
    for name, module, evs in (("port", replaystore, events),
                              ("jax", jax_store,
                               [to_jax(e) for e in events])):
        base = str(tmp_path / name)
        writer = module.ReplayStoreWriter(base, segment_decisions=10,
                                          max_segments=2)
        for e in evs:
            writer.append(e)
        writer.close()
        first = [os.path.basename(p) for p in writer.segments()]
        # A writer over an existing directory numbers on from the count
        # of the segments it finds.
        again = module.ReplayStoreWriter(base, segment_decisions=10)
        again.append_batch(evs[:3])
        again.flush()
        names[name] = first, [os.path.basename(p) for p in again.segments()]
    assert names["port"] == names["jax"]
    assert names["port"] == (
        ["replay-columnar-000004.npc", "replay-columnar-000005.npc"],
        ["replay-columnar-000003.npc", "replay-columnar-000004.npc",
         "replay-columnar-000005.npc"])
    with pytest.raises(ValueError):
        replaystore.ReplayStoreWriter(str(tmp_path / "w"),
                                      segment_decisions=0)
    assert replaystore.open_dir(str(tmp_path / "nothing")).n == 0


def test_writer_keeps_its_buffer_when_a_pack_fails(tmp_path):
    base = str(tmp_path / "w")
    writer = replaystore.ReplayStoreWriter(base, segment_decisions=100)
    bad = schema.ReplayDecision(seq=1, verdict="maybe")
    writer.append(bad)
    with pytest.raises(replaystore.ReplayStoreError):
        writer.flush()
    assert writer._buffer == [bad] and writer.segments() == []


# -- CSV migration and the loaders --------------------------------------------


def write_csv(path: str, events) -> str:
    with CsvRecordWriter(schema.ReplayDecision, path) as writer:
        for e in events:
            writer.write(e)
    return path


@pytest.fixture(scope="module")
def csv_corpus(tmp_path_factory):
    """A synthetic corpus written as two CSV files by the port's writer,
    and the port's events."""
    base = tmp_path_factory.mktemp("csv")
    events = replaybench.synth_replay_corpus(260, seed=8).to_events()
    paths = [write_csv(str(base / "replay-1.csv"), events[:130]),
             write_csv(str(base / "replay.csv"), events[130:])]
    return paths, events


def test_pack_csv_equal_to_jax(tmp_path, csv_corpus):
    paths, events = csv_corpus
    got = replaystore.pack_csv(paths, str(tmp_path / "port.npc"))
    want = jax_store.pack_csv(paths, str(tmp_path / "jax.npc"))
    assert read(got["path"]) == read(want["path"])
    for stats in (got, want):
        stats.pop("path")
        stats["check"].pop("path")
    assert got == want and got["decisions"] == 260
    assert_columns_equal(
        replaystore.open_corpus(str(tmp_path / "port.npc")).columns(),
        replaystore.ColumnarCorpus.from_events(events).columns())


def test_pack_csv_refuses_bad_events(tmp_path):
    path = write_csv(str(tmp_path / "replay.csv"), [
        schema.ReplayDecision(seq=1, verdict="parents", version=2)])
    with pytest.raises(replaystore.ReplayStoreError) as got:
        replaystore.pack_csv([path], str(tmp_path / "port.npc"))
    with pytest.raises(jax_store.ReplayStoreError) as want:
        jax_store.pack_csv([path], str(tmp_path / "jax.npc"))
    assert str(got.value) == str(want.value)


def test_corpus_loaders_equal_to_jax(tmp_path, csv_corpus):
    paths, events = csv_corpus
    npc = str(tmp_path / "more.npc")
    replaystore.write_columns(npc, replaystore.ColumnarCorpus.from_events(
        [dataclasses.replace(e, seq=e.seq + 1000)
         for e in events[:40]]).columns())
    mixed = [paths[0], npc, paths[1]]
    got = replay.corpus_from_files(mixed)
    want = jax_replay.corpus_from_files(mixed)
    assert got == [to_port(e) for e in want] and len(got) == 300
    assert [e.seq for e in got] == sorted(e.seq for e in got)
    for files in (mixed, [npc], paths):
        assert_columns_equal(replay.columnar_from_files(files).columns(),
                             jax_replay.columnar_from_files(files).columns())
    assert replay.columnar_from_files([npc]).path == npc
    cc = replay.as_columnar(got)
    assert replay.as_columnar(cc) is cc
    assert_columns_equal(cc.columns(),
                         jax_replay.as_columnar(want).columns())


def test_corpus_from_storage_equal_to_jax(tmp_path):
    events = replaybench.synth_replay_corpus(120, seed=12).to_events()
    got_storage = Storage(str(tmp_path / "port"),
                          StorageConfig(max_size=8 * 1024, buffer_size=7))
    want_storage = JaxStorage(str(tmp_path / "jax"),
                              JaxStorageConfig(max_size=8 * 1024,
                                               buffer_size=7))
    for e in events:
        got_storage.create_replay(e)
        want_storage.create_replay(to_jax(e))
    assert len(got_storage.open_replay()) > 2
    got = replay.corpus_from_storage(got_storage)
    want = jax_replay.corpus_from_storage(want_storage)
    assert got == [to_port(e) for e in want] and got
    assert all(a.seq < b.seq for a, b in zip(got, got[1:]))


def test_cost_examples_from_mmap_corpus_bit_equal(tmp_path):
    cc = replaybench.synth_replay_corpus(800, seed=13)
    path = str(tmp_path / "c.npc")
    replaystore.write_columns(path, cc.columns())
    opened = replaystore.open_corpus(path)
    X_mem, y_mem = cost_examples_from_corpus(cc)
    X_map, y_map = cost_examples_from_corpus(opened)
    X_seq, y_seq = cost_examples_from_corpus(opened.to_events())
    X_jax, y_jax = jax_cost_examples(jax_store.open_corpus(path))
    for X, y in ((X_map, y_map), (X_seq, y_seq), (X_jax, y_jax)):
        assert X.dtype == X_mem.dtype and y.dtype == y_mem.dtype
        np.testing.assert_array_equal(X, X_mem)
        np.testing.assert_array_equal(y, y_mem)
    assert len(X_mem) > 1000


def test_synth_corpus_passes_check_in_both_packages(tmp_path):
    cc = replaybench.synth_replay_corpus(500, seed=5)
    path = str(tmp_path / "synth.npc")
    replaystore.write_columns(path, cc.columns())
    report = replaystore.check_corpus(path)
    assert report == jax_store.check_corpus(path)
    assert report["ok"] and report["back_to_source"] > 0
    assert_columns_equal(
        cc.columns(), jax_bench.synth_replay_corpus(500, seed=5).columns())
