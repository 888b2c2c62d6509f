"""Port parity for the ML loop's collection half: the scheduler's
``Announcer`` (``scheduler/announcer.py``) streaming its rotated CSV
datasets to the trainer's ``TrainerService`` (``trainer/service.py``),
which writes segments and runs ``Training``; against the JAX package's,
called in process (no gRPC server).

Seeds and tolerances:

- records: ``SyntheticCluster(n_hosts=24, seed=3)`` of each package, 300
  downloads (``uuid4`` peer ids masked as ``tests/test_torch_trainer.py``
  masks them) and 600 topology records, and the seeded replay decisions
  of that file (``numpy.random.default_rng(5)``), into a scheduler
  ``Storage`` at ``max_size=200_000`` so every dataset rotates;
- request sequences, scheduler files, trainer segments: exact (equal
  fields, byte-identical chunks and files);
- abort codes: equal by name (the port's ``StatusCode`` against grpc's);
- the loop's evaluations: each package's ``Training`` from the JAX
  trainers' flax inits at ``tests/test_torch_trainer.py``'s small
  configuration (the graph jobs at ``LOOP_EPOCHS``), F1 within
  ``F1_ATOL_GNN`` (0.05) and ``F1_ATOL_GAT`` (0.1), the MLP's and the
  cost model's MSE and MAE within ``REGRESSION_RTOL`` (5e-2).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import threading
import time

import jax
import numpy as np
import pytest
import torch

from dragonfly2_tpu import schema as jax_schema
from dragonfly2_tpu import trainer as jax_trainer
from dragonfly2_tpu.data import SyntheticCluster as JaxCluster
from dragonfly2_tpu.parallel import data_parallel_mesh
from dragonfly2_tpu.scheduler import announcer as jax_announcer
from dragonfly2_tpu.scheduler import storage as jax_sched_storage
from dragonfly2_tpu.train import GNNTrainConfig as JaxGNNConfig
from dragonfly2_tpu.train import MLPTrainConfig as JaxMLPConfig
from dragonfly2_tpu.trainer import training as jax_training
from dragonfly2_tpu_torch import schema as port_schema
from dragonfly2_tpu_torch import trainer as port_trainer
from dragonfly2_tpu_torch.data import SyntheticCluster
from dragonfly2_tpu_torch.rpc.status import CallContext, RpcAbort, StatusCode
from dragonfly2_tpu_torch.scheduler import announcer as port_announcer
from dragonfly2_tpu_torch.scheduler import storage as port_sched_storage
from dragonfly2_tpu_torch.train import gat_trainer, gnn_trainer, mlp_trainer
from dragonfly2_tpu_torch.trainer import training as port_training
from tests.test_torch_trainer import (
    F1_ATOL_GAT,
    F1_ATOL_GNN,
    REGRESSION_RTOL,
    Recorder,
    _config,
    _jax_inits,
    _mask_peer_ids,
    _replay_records,
)

PKGS = ("jax", "port")
HOST_ID, IP, HOSTNAME, PORT, SCHEDULER_ID = (
    "sched-host-1", "10.0.0.1", "sched1", 8002, 7)
KINDS = ("gnn", "mlp", "cost")
# tests/test_trainer_service.py's TINY.
TINY_GNN = dict(hidden=8, embed=4, fanouts=(3, 2), epochs=1, batch_size=16,
                eval_fraction=0.25)
TINY_MLP = dict(hidden=(8,), epochs=1, batch_size=16, eval_fraction=0.25)
# The graph jobs' epochs in the loop: on these 24 hosts at the small
# configuration's own (5 and 3) both packages stay on the majority-class
# plateau (F1 0, about 7 % of the edges are positive); at 12 both reach
# F1 1.0 (the GraphTransformer is apart at 8: 1.0 against 0.84).
LOOP_EPOCHS = {"gnn": 12, "gat": 12}


class Pkg:
    """One package's modules, by the names the tests use."""

    def __init__(self, name: str):
        jax_side = name == "jax"
        self.name = name
        self.schema = jax_schema if jax_side else port_schema
        self.cluster = JaxCluster if jax_side else SyntheticCluster
        self.sched = jax_sched_storage if jax_side else port_sched_storage
        self.announcer = jax_announcer if jax_side else port_announcer
        self.trainer = jax_trainer if jax_side else port_trainer

    def tiny(self):
        if self.name == "jax":
            return jax_training.TrainingConfig(
                gnn=JaxGNNConfig(**TINY_GNN), mlp=JaxMLPConfig(**TINY_MLP))
        return port_training.TrainingConfig(
            gnn=gnn_trainer.GNNTrainConfig(**TINY_GNN),
            mlp=mlp_trainer.MLPTrainConfig(**TINY_MLP))

    def training_for(self, storage, registry, config):
        if self.name == "jax":
            return jax_training.Training(
                storage, registry, config,
                mesh=data_parallel_mesh(jax.devices()[:1]))
        return port_training.Training(storage, registry, config,
                                      device="cpu")


PACKAGES = {name: Pkg(name) for name in PKGS}


def fill_storage(pkg: Pkg, root, max_size: int = 200_000):
    """The loop's records in ``pkg``'s scheduler ``Storage`` under
    ``root``."""
    storage = pkg.sched.Storage(str(root),
                                pkg.sched.StorageConfig(max_size=max_size))
    cluster = pkg.cluster(n_hosts=24, seed=3)
    for rec in _mask_peer_ids(cluster.downloads(300)):
        storage.create_download(rec)
    for rec in cluster.topology(600):
        storage.create_network_topology(rec)
    for rec in _replay_records(pkg.schema):
        storage.create_replay(rec)
    return storage


def counts(storage) -> tuple:
    return (storage.download_count(), storage.network_topology_count(),
            storage.replay_count())


def summary(request) -> tuple:
    """A ``TrainRequest``'s fields, its one dataset kind and chunk."""
    kinds = [k for k in KINDS if getattr(request, k) is not None]
    assert len(kinds) == 1, kinds
    chunk = getattr(request, kinds[0])
    return (request.host_id, request.ip, request.hostname,
            request.scheduler_id, kinds[0], chunk.new_file, chunk.dataset)


class CaptureClient:
    """A trainer client that keeps each request's summary and accepts."""

    def __init__(self, trainer_mod, fail: bool = False):
        self.trainer_mod = trainer_mod
        self.fail = fail
        self.requests = []

    def train(self, requests):
        for request in requests:
            self.requests.append(summary(request))
            if self.fail:
                raise RuntimeError("trainer unreachable")
        return self.trainer_mod.TrainResponse(
            host_id=HOST_ID,
            accepted_bytes=sum(len(s[-1]) for s in self.requests))


def announcer_for(pkg: Pkg, storage, client=None, manager=None, **config):
    return pkg.announcer.Announcer(
        host_id=HOST_ID, ip=IP, hostname=HOSTNAME, port=PORT,
        storage=storage, trainer_client=client, manager_client=manager,
        config=pkg.announcer.AnnouncerConfig(**config),
        scheduler_id=SCHEDULER_ID)


# -- the announcer ---------------------------------------------------------------


def test_announcer_constants_equal():
    assert (port_announcer.DEFAULT_UPLOAD_CHUNK
            == jax_announcer.DEFAULT_UPLOAD_CHUNK == 128 * 1024 * 1024)
    assert vars(port_announcer.AnnouncerConfig()) == vars(
        jax_announcer.AnnouncerConfig())


@pytest.mark.parametrize("chunk", [64 * 1024, 1 << 20], ids=["64KiB", "1MiB"])
def test_announcer_requests_equal(tmp_path, chunk):
    """The same records give the same request sequence; after the accept
    both storages are empty."""
    seen = {}
    for name in PKGS:
        pkg = PACKAGES[name]
        storage = fill_storage(pkg, tmp_path / name)
        n_files = len(storage.open_download())
        client = CaptureClient(pkg.trainer)
        response = announcer_for(pkg, storage, client,
                                 upload_chunk=chunk).train()
        assert response.accepted_bytes == sum(len(s[-1])
                                              for s in client.requests)
        assert counts(storage) == (0, 0, 0)
        assert storage.snapshot_download() == []
        seen[name] = (client.requests, n_files)
    (got, n_files), (want, _) = seen["port"], seen["jax"]
    assert n_files > 1  # the downloads rotated
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, i
    # Topology first, then downloads, then replay decisions; every file
    # opens with new_file and at 64 KiB the larger files split.
    order = [s[4] for s in got]
    assert order == sorted(order, key=["gnn", "mlp", "cost"].index)
    assert set(order) == {"gnn", "mlp", "cost"}
    assert all(s[:4] == (HOST_ID, IP, HOSTNAME, SCHEDULER_ID) for s in got)
    assert all(len(s[-1]) <= chunk for s in got)
    assert sum(s[5] for s in got) > 3
    if chunk == 64 * 1024:
        assert not all(s[5] for s in got)
    # Each file opens with its kind's CSV header.
    header = {"gnn": b"id,", "mlp": b"id,", "cost": b"version,seq,"}
    assert all(s[-1].startswith(header[s[4]]) for s in got if s[5])


@pytest.mark.parametrize("pkg", PKGS)
def test_announcer_failed_upload_keeps_snapshot(tmp_path, pkg):
    pkg = PACKAGES[pkg]
    storage = fill_storage(pkg, tmp_path)
    client = CaptureClient(pkg.trainer, fail=True)
    with pytest.raises(RuntimeError, match="unreachable"):
        announcer_for(pkg, storage, client, upload_chunk=64 * 1024).train()
    assert len(client.requests) == 1
    assert counts(storage) == (300, 600, 60)
    files = (storage.snapshot_download() + storage.snapshot_network_topology()
             + storage.snapshot_replay())
    assert files and all(os.path.exists(p) for p in files)


def test_announcer_without_datasets_uploads_nothing(tmp_path):
    for name in PKGS:
        pkg = PACKAGES[name]
        storage = pkg.sched.Storage(str(tmp_path / name))
        client = CaptureClient(pkg.trainer)
        assert announcer_for(pkg, storage, client).train() is None
        assert announcer_for(pkg, storage).train() is None
        assert client.requests == []


def test_keepalive_calls_manager_as_jax(tmp_path):
    calls = {}
    for name in PKGS:
        pkg = PACKAGES[name]
        seen = []
        ticks = threading.Event()

        class Manager:
            def update_scheduler(self, host_id, ip, hostname, port):
                seen.append(("update_scheduler", host_id, ip, hostname, port))

            def keepalive(self, host_id):
                seen.append(("keepalive", host_id))
                if len(seen) >= 4:
                    ticks.set()
                if len(seen) == 2:
                    raise RuntimeError("manager down")  # the loop survives

        announcer = announcer_for(
            pkg, pkg.sched.Storage(str(tmp_path / name)), manager=Manager(),
            keepalive_interval=0.01)
        announcer.serve()
        try:
            assert ticks.wait(timeout=5)
        finally:
            announcer.stop()
        n = len(seen)
        time.sleep(0.05)
        assert len(seen) == n  # stopped
        calls[name] = seen[:4]
    assert calls["port"] == calls["jax"] == [
        ("update_scheduler", HOST_ID, IP, HOSTNAME, PORT)] + [
        ("keepalive", HOST_ID)] * 3


# -- the trainer service --------------------------------------------------------


class StubContext:
    """A call context of either package: ``abort`` records its code's
    name and raises; ``active`` is what ``is_active`` answers."""

    def __init__(self, active: bool = True):
        self.active = active
        self.aborted = None

    def is_active(self):
        return self.active

    def abort(self, code, details):
        self.aborted = (code.name, details)
        raise RuntimeError(f"abort: {code.name}")


def service_for(pkg: Pkg, root, registry=None, training=None, **kwargs):
    storage = pkg.trainer.TrainerStorage(str(root))
    if training is None:
        training = pkg.training_for(storage, registry, pkg.tiny())
    return pkg.trainer.TrainerService(storage, training, train_async=False,
                                      **kwargs), storage


def mlp_request(pkg: Pkg, dataset: bytes, host_id: str = "h"):
    return pkg.trainer.TrainRequest(
        host_id=host_id, ip="1.1.1.1", hostname="h",
        mlp=pkg.trainer.TrainMlpRequest(dataset=dataset, new_file=True))


@pytest.mark.parametrize("case", ["empty", "no_host_id"])
def test_invalid_streams_abort_as_jax(tmp_path, case):
    aborted = {}
    for name in PKGS:
        pkg = PACKAGES[name]
        service, _ = service_for(pkg, tmp_path / name)
        requests = [] if case == "empty" else [pkg.trainer.TrainRequest(
            gnn=pkg.trainer.TrainGnnRequest(dataset=b"x"))]
        ctx = StubContext()
        with pytest.raises(RuntimeError, match="abort"):
            service.Train(iter(requests), ctx)
        aborted[name] = ctx.aborted
    assert aborted["port"] == aborted["jax"]
    assert aborted["port"][0] == "INVALID_ARGUMENT"


def test_port_call_context_raises_rpc_abort(tmp_path):
    service, _ = service_for(PACKAGES["port"], tmp_path)
    with pytest.raises(RpcAbort) as exc:
        service.Train(iter([]), CallContext())
    assert exc.value.code is StatusCode.INVALID_ARGUMENT
    assert exc.value.details == "empty Train stream"


def test_status_codes_match_grpc():
    import grpc

    assert {c.name: c.value for c in StatusCode} == {
        c.name: c.value[0] for c in grpc.StatusCode}
    # The sidecar re-exports the same objects.
    from dragonfly2_tpu_torch.inference import sidecar

    assert sidecar.StatusCode is StatusCode
    assert sidecar.CallContext is CallContext and sidecar.RpcAbort is RpcAbort


@pytest.mark.parametrize("pkg", PKGS)
def test_small_datasets_skip_training(tmp_path, pkg):
    pkg = PACKAGES[pkg]
    registry = Recorder()
    service, storage = service_for(pkg, tmp_path, registry)
    resp = service.Train(iter([mlp_request(pkg, b"not,even,csv\n")]),
                         StubContext())
    assert resp.accepted_bytes == len(b"not,even,csv\n")
    assert resp.host_id == "h"
    assert registry.models == {}
    assert storage.download_files("h") == []


@pytest.mark.parametrize("pkg", PKGS)
def test_records_during_upload_survive(tmp_path, pkg):
    pkg = PACKAGES[pkg]
    cluster = pkg.cluster(n_hosts=8, seed=11)
    st = pkg.sched.Storage(str(tmp_path),
                           pkg.sched.StorageConfig(max_size=10_000_000))
    for rec in cluster.downloads(50):
        st.create_download(rec)
    snap = st.snapshot_download()
    assert snap and st.download_count() == 50
    for rec in cluster.downloads(30):
        st.create_download(rec)
    st.remove_download_files(snap)
    assert st.download_count() == 30
    assert len(st.list_download()) == 30


@pytest.mark.parametrize("pkg", PKGS)
def test_failed_stream_rolls_back_segments(tmp_path, pkg):
    pkg = PACKAGES[pkg]
    service, storage = service_for(pkg, tmp_path)

    def dying_stream():
        yield mlp_request(pkg, b"id,chunk\n")
        yield mlp_request(pkg, b"row\n")
        raise RuntimeError("connection dropped")

    with pytest.raises(RuntimeError, match="connection dropped"):
        service.Train(dying_stream(), StubContext())
    assert storage.download_files("h") == []
    assert os.listdir(tmp_path) == []


def test_dead_context_rolls_back_as_jax(tmp_path):
    """A stream that ends cleanly on a call that is no longer active is
    rolled back and aborted CANCELLED."""
    aborted = {}
    for name in PKGS:
        pkg = PACKAGES[name]
        service, storage = service_for(pkg, tmp_path / name)
        ctx = StubContext(active=False)
        with pytest.raises(RuntimeError, match="abort"):
            service.Train(iter([mlp_request(pkg, b"id,chunk\n")]), ctx)
        assert storage.download_files("h") == []
        aborted[name] = ctx.aborted
    assert aborted["port"] == aborted["jax"] == (
        "CANCELLED", "Train stream terminated mid-upload")


def test_context_without_is_active_counts_as_live(tmp_path):
    """``_context_active`` takes a context with no ``is_active`` as live:
    the port's ``CallContext`` has none."""
    from dragonfly2_tpu.trainer.service import _context_active as jax_active
    from dragonfly2_tpu_torch.trainer.service import _context_active

    for ctx in (CallContext(), object(), StubContext(True),
                StubContext(False)):
        assert _context_active(ctx) == jax_active(ctx)
    assert _context_active(CallContext()) is True


class StubTraining:
    def __init__(self):
        self.calls = []

    def train(self, ip, hostname, host_id, scheduler_id=0):
        self.calls.append((ip, hostname, host_id, scheduler_id))

        class _Outcome:
            errors: list = []

        return _Outcome()


def metrics_for(pkg: Pkg):
    """The package's ``TrainerMetrics`` (JAX's on prometheus_client, the
    port's on ``utils/prom.py``)."""
    if pkg.name == "jax":
        from dragonfly2_tpu.trainer.metrics import TrainerMetrics
    else:
        from dragonfly2_tpu_torch.trainer.metrics import TrainerMetrics
    return TrainerMetrics()


def counter(metric) -> float:
    return metric.get() if hasattr(metric, "get") else metric._value.get()


def test_interval_cycle_trains_hosts_with_new_segments_as_jax(tmp_path):
    seen = {}
    for name in PKGS:
        pkg = PACKAGES[name]
        training, metrics = StubTraining(), metrics_for(pkg)
        service, ts = service_for(pkg, tmp_path / name, training=training,
                                  metrics=metrics)
        service._host_identities["h-data"] = ("1.1.1.1", "a", 7)
        service._host_identities["h-empty"] = ("1.1.1.2", "b", 8)
        ts.append("download", "h-data", b"id,chunk\n", new_file=True)
        ts.close_host("h-data")
        first = service.run_training_cycle()
        ts.clear_host("h-data")
        second = service.run_training_cycle()
        seen[name] = (first, second, training.calls,
                      counter(metrics.train_cycles),
                      counter(metrics.train_cycle_skips))
    assert seen["port"] == seen["jax"]
    first, second, calls, cycles, skips = seen["port"]
    assert first == {"trained": ["h-data"], "skipped": ["h-empty"]}
    assert sorted(second["skipped"]) == ["h-data", "h-empty"]
    assert calls == [("1.1.1.1", "a", "h-data", 7)]
    assert (cycles, skips) == (1, 3)


def test_train_counts_requests_and_bytes_as_jax(tmp_path):
    seen = {}
    for name in PKGS:
        pkg = PACKAGES[name]
        metrics = metrics_for(pkg)
        service, _ = service_for(pkg, tmp_path / name, training=StubTraining(),
                                 metrics=metrics)
        service.Train(iter([mlp_request(pkg, b"id,chunk\n")]), StubContext())
        with pytest.raises(RuntimeError):
            service.Train(iter([]), StubContext())

        def dying():
            yield mlp_request(pkg, b"x\n", host_id="h2")
            raise RuntimeError("drop")

        with pytest.raises(RuntimeError):
            service.Train(dying(), StubContext())
        seen[name] = (counter(metrics.train_request_count),
                      counter(metrics.train_request_failure),
                      counter(metrics.dataset_bytes.labels(type="mlp")))
    assert seen["port"] == seen["jax"] == (1, 1, len(b"id,chunk\nx\n"))


@pytest.mark.parametrize("pkg", PKGS)
def test_cycle_driver_thread_runs_cycles(tmp_path, pkg):
    pkg = PACKAGES[pkg]
    training = StubTraining()
    service, ts = service_for(pkg, tmp_path, training=training)
    service._host_identities["h"] = ("1.1.1.1", "a", 0)
    ts.append("replay", "h", b"x\n", new_file=True)
    ts.close_host("h")
    service.start_cycle_driver(0.05)
    try:
        deadline = time.monotonic() + 5.0
        while not training.calls and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        service.stop_cycle_driver()
    assert training.calls, "driver never ran a cycle"
    service.stop_cycle_driver()
    assert service._cycle_thread is None
    service.start_cycle_driver(0)  # a zero interval starts nothing
    assert service._cycle_thread is None


def test_federation_round_joins_the_cycle(tmp_path):
    """An attached coordinator's round runs after the per-host jobs; a
    round that raises is reported in the cycle, not raised."""
    class Report:
        screened = ["c2"]

        def to_dict(self):
            return {"round": 1}

    class Coordinator:
        def __init__(self, fail):
            self.fail = fail

        def run_round(self):
            if self.fail:
                raise RuntimeError("quorum lost")
            return Report()

    seen = {}
    for name in PKGS:
        pkg = PACKAGES[name]
        metrics = metrics_for(pkg)
        service, _ = service_for(pkg, tmp_path / name,
                                 training=StubTraining(), metrics=metrics)
        service.attach_federation(Coordinator(False))
        ok = service.run_training_cycle()
        service.attach_federation(Coordinator(True))
        failed = service.run_training_cycle()
        seen[name] = (ok, failed, counter(metrics.federated_rounds),
                      counter(metrics.federated_updates_screened))
    assert seen["port"] == seen["jax"] == (
        {"trained": [], "skipped": [], "federated": {"round": 1}},
        {"trained": [], "skipped": [],
         "federated": {"error": "quorum lost"}}, 1, 1)


@pytest.mark.parametrize("pkg", PKGS)
def test_cost_chunks_land_in_replay_segments(tmp_path, pkg):
    pkg = PACKAGES[pkg]
    service, ts = service_for(pkg, tmp_path, training=StubTraining())
    requests = iter([pkg.trainer.TrainRequest(
        host_id="h", ip="1.1.1.1", hostname="h",
        cost=pkg.trainer.TrainCostRequest(dataset=b"col\nrow\n",
                                          new_file=True))])
    resp = service.Train(requests, StubContext())
    assert resp.accepted_bytes == len(b"col\nrow\n")
    assert len(ts.replay_files("h")) == 1
    assert ts.has_closed_segments("h")


def test_async_train_runs_the_job_on_a_thread(tmp_path):
    training = StubTraining()
    storage = port_trainer.TrainerStorage(str(tmp_path))
    service = port_trainer.TrainerService(storage, training)
    resp = service.Train(iter([mlp_request(PACKAGES["port"], b"a\n")]),
                         CallContext())
    service.wait_idle(timeout=10)
    assert resp.accepted_bytes == 2
    assert training.calls == [("1.1.1.1", "h", "h", 0)]
    assert service._jobs == []


def _ingest_cluster_records(ts, host_id=HOST_ID):
    """A port cluster's CSV datasets straight into the trainer's
    per-host storage, as ``tests/test_trainer_service.py`` feeds the JAX
    one."""
    pkg = PACKAGES["port"]
    storage = pkg.sched.Storage(str(ts.base_dir) + "-sched")
    cluster = SyntheticCluster(n_hosts=24, seed=3)
    for rec in cluster.downloads(200):
        storage.create_download(rec)
    for rec in cluster.topology(400):
        storage.create_network_topology(rec)
    for kind, files in (("download", storage.snapshot_download()),
                        ("networktopology",
                         storage.snapshot_network_topology())):
        for path in files:
            with open(path, "rb") as f:
                ts.append(kind, host_id, f.read(), new_file=True)
    ts.close_host(host_id)


@pytest.mark.parametrize("gat", [True, False], ids=["opt_in", "default_off"])
def test_gat_job(tmp_path, gat):
    """Config #3 as the opt-in third job of the port's ``Training``: the
    same topology records, registered as type 'gat' only when asked."""
    ts = port_trainer.TrainerStorage(str(tmp_path / "trainer"))
    _ingest_cluster_records(ts)
    registry = Recorder()
    tiny = PACKAGES["port"].tiny()
    cfg = port_training.TrainingConfig(
        gnn=tiny.gnn, mlp=tiny.mlp,
        gat=gat_trainer.GATTrainConfig(hidden=8, embed=4, layers=1, heads=2,
                                       epochs=1, edge_batch_size=16,
                                       eval_fraction=0.25),
        train_gat_model=gat)
    outcome = port_training.Training(ts, registry, cfg, device="cpu").train(
        IP, HOST_ID, HOST_ID, scheduler_id=SCHEDULER_ID)
    types = sorted(m["type"] for m in registry.models.values())
    if not gat:
        assert outcome.gat_model_id is None and "gat" not in types
        return
    assert outcome.gat_model_id is not None, outcome.errors
    model = registry.models[outcome.gat_model_id]
    assert model["type"] == "gat" and types == ["gat", "gnn", "mlp"]
    assert set(outcome.gat_evaluation) == {"precision", "recall", "f1",
                                           "n_samples"}
    assert model["files"] == ["metadata.json", "tree.npz"]


# -- the whole loop ----------------------------------------------------------------


def loop_config(name: str):
    """``tests/test_torch_trainer.py``'s small configuration with the
    graph jobs' epochs raised to LOOP_EPOCHS, so that the F1 comparison
    compares models that left the plateau."""
    config = _config(name)
    return dataclasses.replace(
        config, gnn=dataclasses.replace(config.gnn,
                                        epochs=LOOP_EPOCHS["gnn"]),
        gat=dataclasses.replace(config.gat, epochs=LOOP_EPOCHS["gat"]))


class SegmentCopy:
    """``Training`` behind the service, keeping every segment's bytes as
    the service wrote them before the job deletes them."""

    def __init__(self, training, root):
        self.training = training
        self.root = root
        self.segments = None

    def train(self, ip, hostname, host_id, scheduler_id=0):
        self.segments = {}
        for name in sorted(os.listdir(self.root)):
            with open(os.path.join(self.root, name), "rb") as f:
                self.segments[name] = f.read()
        return self.training.train(ip, hostname, host_id, scheduler_id)


class InProcessClient:
    def __init__(self, service):
        self.service = service

    def train(self, requests):
        return self.service.Train(requests, StubContext())


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    """The same scheduler records through each package's announcer →
    trainer service → ``Training`` (the small configuration, the port's
    trainers from the JAX inits) → a recording registry."""
    base = tmp_path_factory.mktemp("probe-loop")
    out = {}
    monkeypatch = pytest.MonkeyPatch()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _jax_inits(monkeypatch)
        for name in PKGS:
            pkg = PACKAGES[name]
            storage = fill_storage(pkg, base / name / "sched")
            root = str(base / name / "trainer")
            trainer_storage = pkg.trainer.TrainerStorage(root)
            registry = Recorder()
            training = SegmentCopy(pkg.training_for(
                trainer_storage, registry, loop_config(name)), root)
            service = pkg.trainer.TrainerService(
                trainer_storage, training, train_async=False)
            announcer = announcer_for(pkg, storage, InProcessClient(service),
                                      upload_chunk=64 * 1024)
            response = announcer.train()
            out[name] = {
                "response": response, "segments": training.segments,
                "registry": registry.models, "left": sorted(os.listdir(root)),
                "sched_counts": counts(storage)}
    finally:
        monkeypatch.undo()
        torch.set_num_threads(threads)
        shutil.rmtree(base, ignore_errors=True)
    return out


def test_loop_matches_jax(loop):
    got, want = loop["port"], loop["jax"]
    # The upload: every byte accepted, the scheduler's datasets cleared.
    assert got["response"].host_id == want["response"].host_id == HOST_ID
    assert got["response"].accepted_bytes == want["response"].accepted_bytes
    assert got["response"].accepted_bytes == sum(
        len(b) for b in got["segments"].values())
    assert got["sched_counts"] == want["sched_counts"] == (0, 0, 0)
    # The segments each side wrote: same names, byte-identical.
    assert list(got["segments"]) == list(want["segments"])
    for seg, data in got["segments"].items():
        assert data == want["segments"][seg], seg
    kinds = {seg.split("-")[0] for seg in got["segments"]}
    assert kinds == {"download", "networktopology", "replay"}
    assert len(got["segments"]) > 3
    # Training deleted every segment.
    assert got["left"] == want["left"] == []
    # The registry.
    ports, jaxs = got["registry"], want["registry"]
    assert set(ports) == set(jaxs)
    assert {m["type"] for m in ports.values()} == {"gnn", "mlp", "gat",
                                                   "cost"}
    by_type = {}
    for model_id, model in ports.items():
        ref = jaxs[model_id]
        for key in ("type", "host_id", "ip", "hostname", "scheduler_id"):
            assert model[key] == ref[key], (model_id, key)
        assert model["host_id"] == HOST_ID
        assert model["scheduler_id"] == SCHEDULER_ID
        assert set(model["evaluation"]) == set(ref["evaluation"])
        assert model["evaluation"]["n_samples"] == ref["evaluation"][
            "n_samples"]
        by_type[model["type"]] = (model["evaluation"], ref["evaluation"])
    for job, atol in (("gnn", F1_ATOL_GNN), ("gat", F1_ATOL_GAT)):
        g, w = by_type[job]
        assert g["f1"] > 0.5, (job, g)  # off the plateau
        assert abs(g["f1"] - w["f1"]) <= atol, (job, g, w)
    for job in ("mlp", "cost"):
        g, w = by_type[job]
        np.testing.assert_allclose([g["mse"], g["mae"]], [w["mse"], w["mae"]],
                                   rtol=REGRESSION_RTOL, err_msg=job)
