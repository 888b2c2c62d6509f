"""Port parity for the trainer slice: the record schemas, CSV datasets,
ids, feature extraction, segment storage and the ``Training``
orchestrator against the JAX package's, on the CPU.

Seeds and tolerances:

- records come from ``SyntheticCluster(seed=3)`` and ``seed=11`` of each
  package (one seed gives the same records in both, bar the ``uuid4``
  peer ids of downloads, which the byte tests mask); replay decisions
  from ``numpy.random.default_rng(5)``;
- schemas, CSV bytes, ids, columns, pair examples and graphs: exact
  (bit-identical arrays, byte-identical files);
- the whole slice (``slices``): the same segment directory copied twice,
  the JAX ``Training`` on a one-device mesh and the port's on the CPU,
  each trainer starting from the JAX trainer's flax init (the port's
  trainers take it as ``init_state``/``init_params``; see
  ``_jax_inits``). GraphSAGE samples on the host (``device_sample=False``,
  batches bit-identical to JAX's): F1 within ``F1_ATOL_GNN`` (0.05, as
  ``tests/test_torch_graphsage.py``); the GraphTransformer's F1 within
  ``F1_ATOL_GAT`` (0.1, as ``tests/test_torch_train.py``); the MLP's and
  the cost model's eval MSE and MAE within ``rtol=5e-2``
  (``tests/test_torch_mlp_train.py``).
"""

from __future__ import annotations

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu import schema as jax_schema
from dragonfly2_tpu.data import SyntheticCluster as JaxCluster
from dragonfly2_tpu.data import features as jax_features
from dragonfly2_tpu.data.features import Graph as JaxGraph
from dragonfly2_tpu.data.graph_sampler import CSRGraph as JaxCSR
from dragonfly2_tpu.data.graph_sampler import EdgeBatchSampler as JaxSampler
from dragonfly2_tpu.models.graph_transformer import GraphTransformer as JaxGT
from dragonfly2_tpu.models.graphsage import GraphSAGE as JaxSAGE
from dragonfly2_tpu.models.mlp import MLPBandwidthPredictor as JaxMLP
from dragonfly2_tpu.parallel import data_parallel_mesh
from dragonfly2_tpu.schema import io as jax_io
from dragonfly2_tpu.train import CostTrainConfig as JaxCostConfig
from dragonfly2_tpu.train import GATTrainConfig as JaxGATConfig
from dragonfly2_tpu.train import GNNTrainConfig as JaxGNNConfig
from dragonfly2_tpu.train import MLPTrainConfig as JaxMLPConfig
from dragonfly2_tpu.train import mlp_trainer as jax_mlp_trainer
from dragonfly2_tpu.train import train_gnn as jax_train_gnn
from dragonfly2_tpu.trainer import storage as jax_storage
from dragonfly2_tpu.trainer import training as jax_training
from dragonfly2_tpu.utils import idgen as jax_idgen
from dragonfly2_tpu_torch import schema as port_schema
from dragonfly2_tpu_torch.data import SyntheticCluster
from dragonfly2_tpu_torch.data import features as port_features
from dragonfly2_tpu_torch.inference.sidecar import (
    CallContext,
    InferenceService,
    ModelInferRequest,
    _gat_scorer_from_artifact,
    _scorer_from_artifact,
)
from dragonfly2_tpu_torch.manager import (
    Database,
    FilesystemObjectStore,
    ManagerService,
)
from dragonfly2_tpu_torch.manager.validation import ValidationConfig
from dragonfly2_tpu_torch.schema import io as port_io
from dragonfly2_tpu_torch.scheduler.evaluator.scoring import FEATURE_NAMES
from dragonfly2_tpu_torch.train import (
    cost_trainer,
    gat_trainer,
    gnn_trainer,
    mlp_trainer,
)
from dragonfly2_tpu_torch.train.checkpoint import (
    gat_state_dict_from_flax,
    gnn_state_dict_from_flax,
)
from dragonfly2_tpu_torch.trainer import storage as port_storage
from dragonfly2_tpu_torch.trainer import training as port_training
from dragonfly2_tpu_torch.utils import idgen as port_idgen

F1_ATOL_GNN = 0.05
F1_ATOL_GAT = 0.1
REGRESSION_RTOL = 5e-2
RECORD_SEEDS = (3, 11)
HOST_ID, IP, HOSTNAME, SCHEDULER_ID = "sched-host-1", "10.0.0.1", "sched1", 7
KINDS = {"download": "Download", "networktopology": "NetworkTopology",
         "replay": "ReplayDecision"}

# tests/test_trainer_service.py's TINY MLP; its TestGATJob's GAT at 3
# epochs and a GraphSAGE at 5 epochs, which leave the majority-class
# plateau on this data (at TINY's one epoch both packages stay at F1 0,
# and an F1 comparison would compare 0 with 0); the cost model's defaults.
SLICE_GNN = dict(hidden=16, embed=8, fanouts=(5, 3), epochs=5,
                 batch_size=64, learning_rate=1e-2, eval_fraction=0.25,
                 device_sample=False)
SLICE_MLP = dict(hidden=(8,), epochs=1, batch_size=16, eval_fraction=0.25)
SLICE_GAT = dict(hidden=8, embed=4, layers=1, heads=2, epochs=3,
                 edge_batch_size=16, eval_fraction=0.25)
TINY_GNN = dict(hidden=8, embed=4, fanouts=(3, 2), epochs=1, batch_size=16,
                eval_fraction=0.25)


def _config(pkg, train_gat_model=True):
    if pkg == "jax":
        return jax_training.TrainingConfig(
            gnn=JaxGNNConfig(**SLICE_GNN), mlp=JaxMLPConfig(**SLICE_MLP),
            gat=JaxGATConfig(**SLICE_GAT), cost=JaxCostConfig(),
            train_gat_model=train_gat_model)
    return port_training.TrainingConfig(
        gnn=gnn_trainer.GNNTrainConfig(**SLICE_GNN),
        mlp=mlp_trainer.MLPTrainConfig(**SLICE_MLP),
        gat=gat_trainer.GATTrainConfig(**SLICE_GAT),
        cost=cost_trainer.CostTrainConfig(), train_gat_model=train_gat_model)


# -- records ---------------------------------------------------------------------


def _mask_peer_ids(records):
    """Download records with their uuid4 peer ids replaced by fixed ones."""
    for i, rec in enumerate(records):
        rec.id = f"peer-{i}"
        for j, parent in enumerate(rec.parents):
            parent.id = f"peer-{i}-{j}"
    return records


def _replay_records(schema, seed=5, n=60, k=8):
    """Seeded ReplayDecision records: candidate feature rows (float32
    values), a tenth of the candidates without a realized cost."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        rows = rng.random((k, len(FEATURE_NAMES))).astype(np.float32)
        realized_n = rng.integers(0, 5, k)
        cost = rng.random(k).astype(np.float32)
        out.append(schema.ReplayDecision(
            seq=i, task_id=f"task-{i}", peer_id=f"peer-{i}",
            total_piece_count=64, verdict="parents", chosen="p0",
            outcome="Succeeded", outcome_cost=float(cost.sum()),
            candidates=[schema.ReplayCandidate(
                id=f"p{j}", rank=j,
                features=schema.ReplayFeatureRow(**{
                    name: float(v) for name, v in zip(FEATURE_NAMES, row)}),
                cost_n=int(realized_n[j]),
                realized_n=int(realized_n[j]),
                realized_cost=float(cost[j]) if realized_n[j] else -1.0)
                for j, row in enumerate(rows)]))
    return out


def _records(pkg, kind, seed=3):
    if kind == "replay":
        return _replay_records(jax_schema if pkg == "jax" else port_schema)
    cluster = (JaxCluster if pkg == "jax" else SyntheticCluster)(
        n_hosts=40, seed=seed)
    if kind == "download":
        return _mask_peer_ids(cluster.downloads(80))
    return cluster.topology(150)


def _write(io_mod, schema, kind, records, path, header=True):
    with io_mod.CsvRecordWriter(getattr(schema, KINDS[kind]), path,
                                write_header=header) as writer:
        for rec in records:
            writer.write(rec)
    return path


@pytest.mark.parametrize("name,n_columns", [
    ("Download", 1934), ("NetworkTopology", 72), ("ReplayDecision", 316)])
def test_column_spec_equal(name, n_columns):
    got = port_schema.column_spec(getattr(port_schema, name))
    want = jax_schema.column_spec(getattr(jax_schema, name))
    assert got == want and len(got) == n_columns
    for const in ("MAX_PARENTS", "MAX_PIECES_PER_PARENT", "MAX_DEST_HOSTS",
                  "MAX_REPLAY_CANDIDATES", "REPLAY_SCHEMA_VERSION"):
        assert getattr(port_schema, const) == getattr(jax_schema, const)


def test_replay_feature_row_is_feature_names():
    """The cost trainer reads a recorded row by ``FEATURE_NAMES``."""
    names = [f.name for f in dataclasses.fields(port_schema.ReplayFeatureRow)]
    assert tuple(names) == FEATURE_NAMES


@pytest.mark.parametrize("header", [True, False], ids=["header", "headerless"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_csv_bytes_identical(tmp_path, kind, header):
    """The same seeded records, each package's generator and writer:
    byte-identical files."""
    jax_file = _write(jax_io, jax_schema, kind, _records("jax", kind),
                      tmp_path / "jax.csv", header)
    port_file = _write(port_io, port_schema, kind, _records("port", kind),
                       tmp_path / "port.csv", header)
    assert port_file.read_bytes() == jax_file.read_bytes()
    assert port_file.stat().st_size > 1000


@pytest.mark.parametrize("header", [True, False], ids=["header", "headerless"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_csv_cross_read(tmp_path, kind, header):
    """Each package reads the other's file back to the writer's rows."""
    name = KINDS[kind]
    jax_recs, port_recs = _records("jax", kind), _records("port", kind)
    jax_file = _write(jax_io, jax_schema, kind, jax_recs,
                      str(tmp_path / "jax.csv"), header)
    port_file = _write(port_io, port_schema, kind, port_recs,
                       str(tmp_path / "port.csv"), header)
    got = [port_schema.flatten_record(r) for r in port_io.read_csv_records(
        getattr(port_schema, name), jax_file)]
    assert got == [jax_schema.flatten_record(r) for r in jax_recs]
    got = [jax_schema.flatten_record(r) for r in jax_io.read_csv_records(
        getattr(jax_schema, name), port_file)]
    assert got == [port_schema.flatten_record(r) for r in port_recs]
    assert len(got) == len(port_recs) > 0


def test_parse_cell_equal():
    """Empty int and float cells parse to 0; bools are True/true/1."""
    cases = [(int, ""), (int, "17"), (int, "-3"), (float, ""),
             (float, "2.5"), (float, "1e-07"), (bool, "True"),
             (bool, "true"), (bool, "1"), (bool, "False"), (bool, ""),
             (bool, "TRUE"), (str, ""), (str, "a,b")]
    for t, raw in cases:
        got = port_io._parse_cell(t, raw)
        assert got == jax_io._parse_cell(t, raw) and type(got) is type(
            jax_io._parse_cell(t, raw)), (t, raw)
    assert port_io._parse_cell(int, "") == 0
    assert port_io._parse_cell(float, "") == 0.0


def test_csv_empty_file_reads_nothing(tmp_path):
    path = tmp_path / "empty.csv"
    path.write_bytes(b"")
    assert list(port_io.read_csv_records(port_schema.Download,
                                         str(path))) == []


def test_ids_equal():
    urls = ["https://a.example.com/x?b=2&a=1&token=t", "http://h/p", ""]
    for url in urls:
        for params in (None, ["token"], ["a", "b"]):
            assert port_idgen.task_id_v2(
                url, "sha256:ab", "tag", "app", 4 << 20, params
            ) == jax_idgen.task_id_v2(url, "sha256:ab", "tag", "app",
                                      4 << 20, params)
    for ip, host in (("10.0.0.1", "sched1"), ("::1", "h-ü"), ("", "")):
        assert port_idgen.host_id_v2(ip, host) == jax_idgen.host_id_v2(
            ip, host)
        for fn in ("gnn_model_id_v1", "mlp_model_id_v1", "gat_model_id_v1",
                   "cost_model_id_v1"):
            assert getattr(port_idgen, fn)(ip, host) == getattr(
                jax_idgen, fn)(ip, host)
    assert port_idgen.host_id_v1("host-3", 8002) == jax_idgen.host_id_v1(
        "host-3", 8002)
    # The model id binds (ip, hostname) and the type: four distinct ids.
    assert len({getattr(port_idgen, f"{t}_model_id_v1")(IP, HOSTNAME)
                for t in ("gnn", "mlp", "gat", "cost")}) == 4


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_records_to_table_columns(kind):
    """One numpy column per spec entry, the arrow table's values, typed
    int64 / float64 / bool / unicode."""
    name = KINDS[kind]
    got = port_io.records_to_table(getattr(port_schema, name),
                                   _records("port", kind))
    want = jax_io.records_to_table(getattr(jax_schema, name),
                                   _records("jax", kind))
    spec = port_schema.column_spec(getattr(port_schema, name))
    assert list(got) == [c for c, _ in spec]
    kinds = {int: "i", float: "f", bool: "b", str: "U"}
    for column, t in spec:
        assert got[column].dtype.kind == kinds[t], column
        assert got[column].tolist() == want.column(column).to_pylist(), column


# -- features --------------------------------------------------------------------


def _read_both(kind, path):
    name = KINDS[kind]
    port_table = port_io.records_to_table(
        getattr(port_schema, name),
        list(port_io.read_csv_records(getattr(port_schema, name), path)))
    jax_table = jax_io.records_to_table(
        getattr(jax_schema, name),
        list(jax_io.read_csv_records(getattr(jax_schema, name), path)))
    return port_table, jax_table


def _assert_pairs_equal(port_table, jax_table):
    X, y = port_features.pair_examples_from_table(port_table)
    jX, jy = jax_features.pair_examples_from_table(jax_table)
    assert X.dtype == jX.dtype == y.dtype == jy.dtype == np.float32
    assert X.shape == jX.shape and y.shape == jy.shape
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)
    return X, y


def _assert_graphs_equal(port_table, jax_table):
    got = port_features.graph_from_table(port_table)
    want = jax_features.graph_from_table(jax_table)
    assert got.node_ids.tolist() == want.node_ids.tolist()
    assert got.node_ids.tolist() == sorted(got.node_ids.tolist())
    for field in ("node_features", "edge_src", "edge_dst", "edge_rtt_ns"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.edge_src.dtype == np.int32 and got.edge_rtt_ns.dtype == np.int64
    return got


@pytest.mark.parametrize("seed", RECORD_SEEDS)
def test_pair_examples_bit_identical(tmp_path, seed):
    path = _write(jax_io, jax_schema, "download",
                  JaxCluster(n_hosts=40, seed=seed).downloads(120),
                  str(tmp_path / "d.csv"))
    X, _ = _assert_pairs_equal(*_read_both("download", path))
    assert len(X) > 120


@pytest.mark.parametrize("seed", RECORD_SEEDS)
def test_graph_bit_identical(tmp_path, seed):
    path = _write(jax_io, jax_schema, "networktopology",
                  JaxCluster(n_hosts=40, seed=seed).topology(200),
                  str(tmp_path / "t.csv"))
    graph = _assert_graphs_equal(*_read_both("networktopology", path))
    assert graph.n_nodes == 40 and graph.n_edges > 200


def _edge_case_host(schema, i, idc, location, type_="normal"):
    return schema.Host(id=f"h{i}", type=type_, hostname=f"h{i}",
                       concurrent_upload_limit=10,
                       concurrent_upload_count=i % 4, upload_count=3 * i,
                       network=schema.Network(idc=idc, location=location))


def _edge_case_downloads(schema):
    """A parent with zero piece cost (no example), one with no pieces, a
    location of fewer than three parts, an empty child idc, upper-case
    idcs against lower-case, a seed parent not serving, a parent slot
    that no download fills past the third."""
    piece = schema.Piece
    rows = [
        ("IDC-A", "r1|z1", [("idc-a", "r1|z1|k1", "super", "Running",
                             [piece(4 << 20, 2_000_000)]),
                            ("idc-b", "r1", "normal", "Running",
                             [piece(4 << 20, 0), piece(1 << 20, 0)])]),
        ("", "r2", [("", "r2", "normal", "Pending",
                     [piece(1 << 20, 5_000_000)]),
                    ("IDC-C", "", "super", "Failed", [])]),
        ("idc-c", "r3|z3|k3|x", [("IDC-C", "r3|Z3|k3", "normal",
                                  "ReceivedNormal",
                                  [piece(4 << 20, 1_000_000),
                                   piece(4 << 20, 3_000_000)]),
                                 ("idc-c", "r3|z3|k3|x", "super", "Running",
                                  [piece(2 << 20, 7_000_000)]),
                                 ("x", "a|b|c", "normal", "Running",
                                  [piece(1, 1)])]),
    ]
    out = []
    for i, (idc, loc, parents) in enumerate(rows):
        out.append(schema.Download(
            id=f"d{i}", finished_piece_count=10 + i,
            task=schema.Task(total_piece_count=64 * (i + 1)),
            host=_edge_case_host(schema, 100 + i, idc, loc),
            parents=[schema.Parent(
                id=f"p{i}{j}", state=state, finished_piece_count=5 * j,
                host=_edge_case_host(schema, 10 * i + j, p_idc, p_loc, t),
                pieces=pieces)
                for j, (p_idc, p_loc, t, state, pieces) in
                enumerate(parents)]))
    return out


def _edge_case_topology(schema):
    """A host seen only as a destination, first as a seed (h9: slot 0 of
    t0, then slot 1 of t1 as a normal host), a source later seen as a
    destination with other features (h5), a location of one part, an
    empty idc, upper-case idcs, a record with no destination."""
    def dest(i, idc, loc, rtt, type_="normal"):
        return schema.DestHost(id=f"h{i}", type=type_,
                               network=schema.Network(idc=idc, location=loc),
                               probes=schema.Probes(average_rtt=rtt))

    def src(i, idc, loc, type_="normal"):
        return schema.SrcHost(id=f"h{i}", type=type_,
                              network=schema.Network(idc=idc, location=loc))

    return [
        schema.NetworkTopology(id="t0", host=src(5, "IDC-A", "r1|z1|k1"),
                               dest_hosts=[dest(9, "idc-b", "r2", 7_000_000,
                                                "super"),
                                           dest(1, "", "", 30_000_000)]),
        schema.NetworkTopology(id="t1", host=src(4, "IDC-X", "r9|z9|k9|e"),
                               dest_hosts=[dest(5, "idc-q", "r7", 100,
                                                "super"),
                                           dest(9, "IDC-X", "r9|z9", 50)]),
        schema.NetworkTopology(id="t2", host=src(2, "", "r1"),
                               dest_hosts=[]),
    ]


def test_features_edge_cases_bit_identical(tmp_path):
    d_path = _write(jax_io, jax_schema, "download",
                    _edge_case_downloads(jax_schema), str(tmp_path / "d.csv"))
    X, y = _assert_pairs_equal(*_read_both("download", d_path))
    # Slot 0: all three; slot 1: the costed parents of downloads 2 only
    # (0's costs are 0, 1's has no pieces); slot 2: download 2's.
    assert len(X) == 5 and (y > 0).all()
    # Both packages built the same tables from their own records.
    port_recs = _edge_case_downloads(port_schema)
    _assert_pairs_equal(
        port_io.records_to_table(port_schema.Download, port_recs),
        jax_io.records_to_table(jax_schema.Download,
                                _edge_case_downloads(jax_schema)))

    t_path = _write(jax_io, jax_schema, "networktopology",
                    _edge_case_topology(jax_schema), str(tmp_path / "t.csv"))
    graph = _assert_graphs_equal(*_read_both("networktopology", t_path))
    assert graph.node_ids.tolist() == ["h1", "h2", "h4", "h5", "h9"]
    # h9's first sighting is t0's first destination, a seed; h5's is
    # t0's source, a normal host.
    assert graph.node_features[4, 0] == 1.0
    assert graph.node_features[3, 0] == 0.0


# -- storage ---------------------------------------------------------------------


def _storage_script(storage_mod, base):
    """The same operations on either package's TrainerStorage; returns
    what each step observed (file names relative to ``base``)."""
    rel = lambda paths: [os.path.basename(p) for p in paths]  # noqa: E731
    st = storage_mod.TrainerStorage(str(base))
    seen = []
    a = st.append("download", "h1", b"head\n", new_file=True)
    st.append("download", "h1", b"row1\n", new_file=False)
    b = st.append("download", "h1", b"head\n", new_file=True)
    st.append("networktopology", "h1", b"nt\n", new_file=True)
    st.append("replay", "h2", b"r\n", new_file=True)
    seen.append(("open snapshot", [rel(x) for x in st.snapshot("h1")]))
    st.close_host("h1")
    seen.append(("closed snapshot", [rel(x) for x in st.snapshot("h1")],
                 st.has_closed_segments("h1"),
                 st.has_closed_segments("h2")))
    with open(a, "rb") as f:
        seen.append(("bytes", f.read()))
    # A training round deletes its snapshot; numbering stays monotonic.
    st.discard_files(st.snapshot("h1")[0])
    c = st.append("download", "h1", b"head\n", new_file=True)
    seen.append(("after discard", rel([a, b, c]),
                 rel(st.download_files("h1"))))
    # discard_files skips a path still open; a closed one goes.
    st.discard_files([c, "/nonexistent/x.csv"])
    seen.append(("open kept", rel(st.download_files("h1"))))
    st.close_host("h1")
    # A failed stream's rollback deletes exactly its segments.
    d = st.append("download", "h1", b"partial\n", new_file=True)
    st.close_host("h1")
    st.discard_files([d])
    seen.append(("rolled back", rel(st.download_files("h1"))))
    # A fresh storage over the same directory continues the numbering.
    again = storage_mod.TrainerStorage(str(base))
    e = again.append("download", "h1", b"head\n", new_file=True)
    again.close_host("h1")
    seen.append(("reopened", os.path.basename(e)))
    st.append("download", "a/../../evil:id", b"x", new_file=True)
    st.close_host("a/../../evil:id")
    seen.append(("sanitized", rel(st.download_files("a/../../evil:id"))))
    st.clear_host("h1")
    seen.append(("clear_host", rel(st.download_files("h1")),
                 rel(st.replay_files("h2"))))
    st.clear()
    seen.append(("clear", sorted(os.listdir(base))))
    return seen


def test_storage_semantics_match_jax(tmp_path):
    got = _storage_script(port_storage, tmp_path / "port")
    want = _storage_script(jax_storage, tmp_path / "jax")
    assert got == want
    steps = dict((s[0], s[1:]) for s in got)
    # A new segment closes the one before it; open ones stay out.
    assert steps["open snapshot"] == ([["download-h1.000000.csv"], [], []],)
    assert steps["after discard"][0] == [
        "download-h1.000000.csv", "download-h1.000001.csv",
        "download-h1.000002.csv"]
    assert steps["open kept"] == (["download-h1.000002.csv"],)
    assert steps["rolled back"] == (["download-h1.000002.csv"],)
    assert steps["clear"] == ([],)


# -- the whole slice ---------------------------------------------------------------


class Recorder:
    """A registry that records each upload (the artifact dir exists only
    during the call) and forwards it to ``inner`` when given."""

    def __init__(self, inner=None):
        self.inner = inner
        self.models = {}

    def create_model(self, model_id, model_type, host_id, ip, hostname,
                     evaluation, artifact_dir, scheduler_id=0):
        self.models[model_id] = {
            "type": model_type, "host_id": host_id, "ip": ip,
            "hostname": hostname, "scheduler_id": scheduler_id,
            "evaluation": dict(evaluation),
            "files": sorted(os.listdir(artifact_dir)),
            "dir": artifact_dir}
        if self.inner is not None:
            self.inner.create_model(model_id, model_type, host_id, ip,
                                    hostname, evaluation, artifact_dir,
                                    scheduler_id)


def _write_segments(base, seed=3):
    """The JAX package's records and writer, as TrainerStorage segments:
    two download, two topology and one replay segment, all closed."""
    cluster = JaxCluster(n_hosts=100, seed=seed)
    topology, downloads = cluster.topology(1500), cluster.downloads(200)
    st = jax_storage.TrainerStorage(str(base))
    parts = [("networktopology", "NetworkTopology", topology[:700]),
             ("networktopology", "NetworkTopology", topology[700:]),
             ("download", "Download", downloads[:120]),
             ("download", "Download", downloads[120:]),
             ("replay", "ReplayDecision", _replay_records(jax_schema))]
    for i, (prefix, name, recs) in enumerate(parts):
        path = _write(jax_io, jax_schema, prefix, recs,
                      str(base / f"tmp{i}.csv"))
        with open(path, "rb") as f:
            st.append(prefix, HOST_ID, f.read(), new_file=True)
        os.remove(path)
    st.close_host(HOST_ID)


def _jax_gnn_init(graph, config):
    """The JAX trainer's GraphSAGE init (its values depend on the seed and
    the shapes only) as a port state dict."""
    jg = JaxGraph(*(np.asarray(getattr(graph, f)) for f in (
        "node_ids", "node_features", "edge_src", "edge_dst", "edge_rtt_ns")))
    sampler = JaxSampler(JaxCSR.from_graph(jg), jg.edge_src, jg.edge_dst,
                         jg.edge_labels(), config.fanouts)
    dummy = sampler.sample(np.zeros(2, np.int64), np.random.default_rng(0))
    params = JaxSAGE(hidden=config.hidden, embed=config.embed).init(
        jax.random.key(config.seed), *map(jnp.asarray, dummy.astuple()[:-1]))
    return gnn_state_dict_from_flax(jax.device_get(params))


def _jax_gat_init(graph, config):
    n = 4
    params = JaxGT(hidden=config.hidden, embed=config.embed,
                   layers=config.layers, heads=config.heads,
                   chunk=config.chunk).init(
        jax.random.key(config.seed),
        jnp.zeros((n, graph.node_features.shape[1])),
        jnp.zeros((n, 2), jnp.int32), jnp.zeros((n, 2)),
        jnp.zeros(2, jnp.int32), jnp.zeros(2, jnp.int32))
    return gat_state_dict_from_flax(jax.device_get(params))


def _jax_inits(monkeypatch):
    """Start the port's GraphSAGE, GraphTransformer, MLP and cost jobs
    from the JAX trainers' flax inits, so the two runs share their
    trajectories' starting points (the port's own seeded init is another
    draw)."""
    def gnn(graph, config, device=None, group=None):
        return gnn_trainer.train_gnn(graph, config, device,
                                     init_state=_jax_gnn_init(graph, config),
                                     group=group)

    def gat(graph, config, device=None, group=None):
        return gat_trainer.train_gat(graph, config, device,
                                     init_state=_jax_gat_init(graph, config),
                                     group=group)

    def mlp(X, y, config, device=None, group=None):
        init = JaxMLP(hidden=tuple(config.hidden)).init(
            jax.random.key(config.seed), jnp.zeros((1, X.shape[1])))
        return mlp_trainer.train_mlp(X, y, config, device,
                                     init_params=jax.device_get(init),
                                     group=group)

    monkeypatch.setattr(port_training, "train_gnn", gnn)
    monkeypatch.setattr(port_training, "train_gat", gat)
    monkeypatch.setattr(port_training, "train_mlp", mlp)
    monkeypatch.setattr(cost_trainer, "train_mlp", mlp)


@pytest.fixture(scope="module")
def slices(tmp_path_factory):
    """The same segments trained by the JAX ``Training`` and the port's,
    each with an extra topology segment left open."""
    base = tmp_path_factory.mktemp("slice")
    _write_segments(base / "src")
    out = {}
    monkeypatch = pytest.MonkeyPatch()
    # The models are tiny: one intra-op thread each, so parallel test
    # workers do not oversubscribe the cores.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _jax_inits(monkeypatch)
        for pkg in ("jax", "port"):
            root = base / pkg
            shutil.copytree(base / "src", root)
            storage_mod = jax_storage if pkg == "jax" else port_storage
            st = storage_mod.TrainerStorage(str(root))
            closed = sorted(os.listdir(root))
            open_path = st.append("networktopology", HOST_ID, b"h,",
                                  new_file=True)
            if pkg == "jax":
                registry = Recorder()
                training = jax_training.Training(
                    st, registry, _config("jax"),
                    mesh=data_parallel_mesh(jax.devices()[:1]))
            else:
                manager = ManagerService(
                    Database(), FilesystemObjectStore(str(base / "store")),
                    validation=ValidationConfig(), device="cpu")
                registry = Recorder(manager)
                training = port_training.Training(st, registry,
                                                  _config("port"),
                                                  device="cpu")
                out["manager"] = manager
            outcome = training.train(IP, HOSTNAME, HOST_ID, SCHEDULER_ID)
            out[pkg] = {"outcome": outcome, "registry": registry,
                        "closed": closed, "open": open_path,
                        "left": sorted(os.listdir(root))}
            st.close_host(HOST_ID)
    finally:
        monkeypatch.undo()
        torch.set_num_threads(threads)
    return out


def test_training_matches_jax(slices):
    """Ids, jobs, registry uploads, evaluations and the deleted segments
    of the two runs."""
    got, want = slices["port"]["outcome"], slices["jax"]["outcome"]
    assert got.errors == want.errors == []
    for job in ("gnn", "mlp", "gat", "cost"):
        model_id = getattr(got, f"{job}_model_id")
        assert model_id is not None and model_id == getattr(
            want, f"{job}_model_id"), job
        assert model_id == getattr(port_idgen, f"{job}_model_id_v1")(
            IP, HOSTNAME)
        g_eval = getattr(got, f"{job}_evaluation")
        w_eval = getattr(want, f"{job}_evaluation")
        assert set(g_eval) == set(w_eval), job
        assert g_eval["n_samples"] == w_eval["n_samples"], job
    ports = slices["port"]["registry"].models
    jaxs = slices["jax"]["registry"].models
    assert set(ports) == set(jaxs)
    for model_id, model in ports.items():
        ref = jaxs[model_id]
        for key in ("type", "host_id", "ip", "hostname", "scheduler_id"):
            assert model[key] == ref[key], (model_id, key)
        assert model["scheduler_id"] == SCHEDULER_ID
        assert model["files"] == ["metadata.json", "tree.npz"]
        assert "metadata.json" in ref["files"]
        # The artifact dir is a temporary one, removed after the upload.
        assert not os.path.exists(model["dir"])
    assert got.gnn_evaluation["n_samples"] == 1500
    assert got.mlp_evaluation["n_samples"] > 200

    assert got.gnn_evaluation["f1"] > 0.5 and got.gat_evaluation["f1"] > 0.5
    assert abs(got.gnn_evaluation["f1"]
               - want.gnn_evaluation["f1"]) <= F1_ATOL_GNN
    assert abs(got.gat_evaluation["f1"]
               - want.gat_evaluation["f1"]) <= F1_ATOL_GAT
    for job in ("mlp", "cost"):
        g = getattr(got, f"{job}_evaluation")
        w = getattr(want, f"{job}_evaluation")
        np.testing.assert_allclose([g["mse"], g["mae"]], [w["mse"], w["mae"]],
                                   rtol=REGRESSION_RTOL, err_msg=job)

    # Every closed segment is gone after the round; the open one stays.
    for pkg in ("jax", "port"):
        run = slices[pkg]
        assert len(run["closed"]) == 5
        assert run["left"] == [os.path.basename(run["open"])], pkg


def test_registry_gate_and_serving(slices):
    """The port's ManagerService with the gate on the CPU takes the four
    artifacts and gives each a verdict; the port's loaders serve the
    ``gat`` and ``mlp`` ones, and the active ``gat`` version answers
    ModelInfer through ``reload_from_manager``."""
    manager = slices["manager"]
    rows = {r.type: r for r in manager.db.find(
        "models", scheduler_id=SCHEDULER_ID)}
    assert set(rows) == {"gnn", "mlp", "gat", "cost"}
    for row in rows.values():
        assert row.state in ("active", "quarantined"), row
        assert "validation" in row.evaluation
    assert rows["gnn"].state == "active"
    pairs = np.random.default_rng(1).integers(0, 100, (16, 2))
    for model_type, builder, inputs in (
            ("gat", _gat_scorer_from_artifact, pairs),
            ("mlp", _scorer_from_artifact,
             np.random.default_rng(2).random((15, 11)).astype(np.float32))):
        artifact = manager.store.get_object("models",
                                            rows[model_type].object_key)
        scores = builder(artifact, device="cpu").score(inputs)
        assert scores.shape == (len(inputs),) and np.isfinite(scores).all()
    if rows["gat"].state == "active":
        service = InferenceService(manager=manager,
                                   scheduler_id=SCHEDULER_ID,
                                   micro_batch=False, device="cpu")
        assert service.reload_from_manager()
        reply = service.ModelInfer(ModelInferRequest("gat", pairs),
                                   CallContext())
        assert reply.outputs.shape == (16,)
        assert np.isfinite(reply.outputs).all()
        service.stop()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_broken_topology_segment_is_isolated(tmp_path, pkg):
    """A topology segment that does not parse gives one ``topology:``
    error; the MLP job still trains and registers, and every trained
    segment is deleted."""
    io_mod, schema_mod, storage_mod = (
        (jax_io, jax_schema, jax_storage) if pkg == "jax"
        else (port_io, port_schema, port_storage))
    st = storage_mod.TrainerStorage(str(tmp_path / "t"))
    downloads = _write(io_mod, schema_mod, "download",
                       (JaxCluster if pkg == "jax" else SyntheticCluster)(
                           n_hosts=24, seed=3).downloads(60),
                       str(tmp_path / "d.csv"))
    with open(downloads, "rb") as f:
        st.append("download", HOST_ID, f.read(), new_file=True)
    st.append("networktopology", HOST_ID, b"not-an-id,x,y,z\nid,x\n",
              new_file=True)
    st.close_host(HOST_ID)
    registry = Recorder()
    if pkg == "jax":
        config = jax_training.TrainingConfig(
            gnn=JaxGNNConfig(**TINY_GNN), mlp=JaxMLPConfig(**SLICE_MLP))
        training = jax_training.Training(
            st, registry, config, mesh=data_parallel_mesh(jax.devices()[:1]))
    else:
        config = port_training.TrainingConfig(
            gnn=gnn_trainer.GNNTrainConfig(**TINY_GNN),
            mlp=mlp_trainer.MLPTrainConfig(**SLICE_MLP))
        training = port_training.Training(st, registry, config, device="cpu")
    outcome = training.train(IP, HOSTNAME, HOST_ID, SCHEDULER_ID)
    assert len(outcome.errors) == 1
    assert outcome.errors[0].startswith("topology: ")
    assert outcome.gnn_model_id is None
    assert outcome.mlp_model_id is not None
    assert [m["type"] for m in registry.models.values()] == ["mlp"]
    assert st.download_files(HOST_ID) == []
    assert st.network_topology_files(HOST_ID) == []


def test_gnn_callbacks_fire_as_often_as_jax():
    cfg = dict(hidden=8, embed=4, fanouts=(3, 2), batch_size=64, epochs=2,
               device_sample=False)
    graph = SyntheticCluster(n_hosts=48, seed=0).probe_graph(2000)
    jgraph = JaxCluster(n_hosts=48, seed=0).probe_graph(2000)
    calls = {"jax": [], "port": []}

    def hooks(pkg):
        return dict(progress_callback=lambda s, r: calls[pkg].append(
                        ("progress", s)),
                    compile_callback=lambda s: calls[pkg].append("compile"))

    jax_train_gnn(jgraph, JaxGNNConfig(**cfg, **hooks("jax")),
                  data_parallel_mesh(jax.devices()[:1]))
    gnn_trainer.train_gnn(graph, gnn_trainer.GNNTrainConfig(
        **cfg, **hooks("port")), device="cpu")
    assert calls["port"] == calls["jax"]
    assert calls["port"][0] == "compile" and len(calls["port"]) >= 2


def test_mlp_callbacks_fire_as_often_as_jax():
    X, y = SyntheticCluster(n_hosts=64, seed=0).pair_example_columns(8000)
    cfg = dict(hidden=(8,), epochs=2, batch_size=256)
    calls = {"jax": [], "port": []}

    def hooks(pkg):
        return dict(progress_callback=lambda s, r: calls[pkg].append(
                        ("progress", s)),
                    compile_callback=lambda s: calls[pkg].append("compile"))

    jax_mlp_trainer.train_mlp(X, y, JaxMLPConfig(**cfg, **hooks("jax")),
                              data_parallel_mesh(jax.devices()[:1]))
    mlp_trainer.train_mlp(X, y, mlp_trainer.MLPTrainConfig(
        **cfg, **hooks("port")), device="cpu")
    assert calls["port"] == calls["jax"]
    assert calls["port"][0] == "compile" and len(calls["port"]) >= 2


def test_training_defaults_to_the_card(tmp_path, monkeypatch):
    """``device=None`` is the card: without one the jobs raise (each job's
    error recorded), nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    st = port_storage.TrainerStorage(str(tmp_path))
    path = _write(port_io, port_schema, "download",
                  SyntheticCluster(n_hosts=24, seed=3).downloads(40),
                  str(tmp_path / "d.csv"))
    with open(path, "rb") as f:
        st.append("download", HOST_ID, f.read(), new_file=True)
    st.close_host(HOST_ID)
    registry = Recorder()
    outcome = port_training.Training(st, registry).train(
        IP, HOSTNAME, HOST_ID)
    assert registry.models == {}
    assert len(outcome.errors) == 1 and outcome.errors[0].startswith("mlp: ")
