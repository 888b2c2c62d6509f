"""Port parity for the P2P path of BASELINE config #5: the same scenarios
through the JAX package's in-process mesh and the port's (a scheduler
service with its resource model, scheduling core and dataset storage,
daemons whose upload servers speak real HTTP, an origin file server).

Each scenario runs once per package against one origin. Held equal:
the delivered bytes (or tensors, byte for byte), and the ``Download``
records in the scheduler's dataset storage field by field, ids, times,
costs and the host's live counters aside. Which parent served which
piece of a download with two parents depends on timing, so parents are
compared as a set and their pieces by length.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import os
import urllib.request

import numpy as np
import pytest

from dragonfly2_tpu.client import hbm_sink as jsink
from dragonfly2_tpu.client import piece as jpiece
from dragonfly2_tpu.utils.hosttypes import HostType as JaxHostType
from dragonfly2_tpu_torch.client import hbm_sink as psink
from dragonfly2_tpu_torch.client import piece as ppiece
from dragonfly2_tpu_torch.client.daemon import Daemon, DaemonConfig
from dragonfly2_tpu_torch.scheduler.evaluator.base import BaseEvaluator
from dragonfly2_tpu_torch.scheduler.resource.resource import Resource
from dragonfly2_tpu_torch.scheduler.scheduling.core import (
    Scheduling,
    SchedulingConfig,
)
from dragonfly2_tpu_torch.scheduler.service import SchedulerService
from dragonfly2_tpu_torch.scheduler.storage.storage import Storage
from dragonfly2_tpu_torch.utils.hosttypes import HostType
from tests import test_p2p_e2e as jmesh
from tests.fileserver import FileServer
from tests.test_torch_hbm_sink import assert_same, assert_same_as_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the port's mesh, built as tests/test_p2p_e2e.py builds the JAX one ----

def port_scheduler(root) -> SchedulerService:
    scheduling = Scheduling(
        BaseEvaluator(),
        SchedulingConfig(retry_interval=0.01, retry_back_to_source_limit=2),
    )
    return SchedulerService(
        resource=Resource(),
        scheduling=scheduling,
        storage=Storage(str(root / "datasets")),
    )


def port_daemon(scheduler, root, name: str, seed: bool = False) -> Daemon:
    daemon = Daemon(scheduler, DaemonConfig(
        storage_root=str(root / name), hostname=name,
        host_type=HostType.SUPER_SEED if seed else HostType.NORMAL,
    ))
    daemon.start()
    return daemon


def jax_daemon(scheduler, root, name: str, seed: bool = False):
    return jmesh.make_daemon(
        scheduler, root, name,
        JaxHostType.SUPER_SEED if seed else JaxHostType.NORMAL)


PACKAGES = {
    "jax": (jmesh.make_scheduler, jax_daemon),
    "port": (port_scheduler, port_daemon),
}
# Each package's sink module and the arguments that keep it on the CPU.
SINKS = {"jax": (jsink, {}), "port": (psink, {"device": "cpu"})}


class Mesh:
    """A scheduler, an optional seed daemon and named normal daemons of
    one package; stops every daemon on exit."""

    def __init__(self, package: str, root, seed: bool = False):
        root.mkdir()
        self._make_scheduler, self._make_daemon = PACKAGES[package]
        self.root = root
        self.scheduler = self._make_scheduler(root)
        self.daemons = []
        if seed:
            seeder = self.daemon("seed-1", seed=True)
            self.scheduler.seed_peer_client = seeder.seed_client()

    def daemon(self, name: str, seed: bool = False):
        daemon = self._make_daemon(self.scheduler, self.root, name, seed)
        self.daemons.append(daemon)
        return daemon

    def records(self) -> list:
        return sorted((normalized(r) for r in
                       self.scheduler.storage.list_download()),
                      key=lambda r: (r["host"]["hostname"], r["state"]))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for daemon in reversed(self.daemons):
            daemon.stop()


_HOST_FIELDS = ("type", "hostname", "ip", "os", "platform",
                "platform_family", "concurrent_upload_limit", "build")


def normalized(record) -> dict:
    """A ``Download`` record without its ids, times, costs and the host's
    live counters (ports, load, memory, disk, upload counts)."""
    d = dataclasses.asdict(record)
    task = {k: d["task"][k] for k in (
        "url", "type", "content_length", "total_piece_count",
        "back_to_source_limit", "back_to_source_peer_count", "state")}
    host = {k: d["host"][k] for k in _HOST_FIELDS}
    parents = sorted((p["host"]["hostname"], p["host"]["type"], p["state"],
                      p["finished_piece_count"], p["tag"], p["application"])
                     for p in d["parents"])
    piece_lengths = sorted(piece["length"] for p in d["parents"]
                           for piece in p["pieces"])
    return {"tag": d["tag"], "application": d["application"],
            "state": d["state"], "error": d["error"],
            "finished_piece_count": d["finished_piece_count"],
            "task": task, "host": host, "parents": parents,
            "piece_lengths": piece_lengths}


@pytest.fixture()
def origin(tmp_path):
    root = tmp_path / "origin"
    root.mkdir()
    with FileServer(str(root)) as fs:
        fs.root_dir = root
        yield fs


def content(origin, name: str, size: int, seed: int) -> bytes:
    data = np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    (origin.root_dir / name).write_bytes(data)
    return data


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class TestScenarios:
    def test_back_to_source_without_seed(self, tmp_path, origin):
        data = content(origin, "a.bin", 5 * 2**20 + 333, 0)
        got, records = {}, {}
        for package in PACKAGES:
            with Mesh(package, tmp_path / package) as mesh:
                result = mesh.daemon("peer-a").download_file(
                    origin.url("a.bin"))
                assert result.success, result.error
                got[package] = result.read_all()
                records[package] = mesh.records()
        assert sha(got["port"]) == sha(got["jax"]) == sha(data)
        assert records["port"] == records["jax"]
        assert records["port"][-1]["state"] == "Succeeded"
        assert records["port"][-1]["task"]["content_length"] == len(data)

    def test_seed_and_peer(self, tmp_path, origin):
        data = content(origin, "b.bin", 6 * 2**20 + 5, 1)
        got, records = {}, {}
        for package in PACKAGES:
            with Mesh(package, tmp_path / package, seed=True) as mesh:
                result = mesh.daemon("peer-a").download_file(
                    origin.url("b.bin"))
                assert result.success, result.error
                got[package] = result.read_all()
                records[package] = mesh.records()
        assert sha(got["port"]) == sha(got["jax"]) == sha(data)
        assert records["port"] == records["jax"]
        mine = [r for r in records["port"]
                if r["host"]["hostname"] == "peer-a"]
        assert mine[-1]["parents"], "pieces must have come from the seed"

    def test_reuse_path(self, tmp_path, origin):
        data = content(origin, "c.bin", 100_000, 2)
        got, records = {}, {}
        for package in PACKAGES:
            with Mesh(package, tmp_path / package) as mesh:
                peer = mesh.daemon("peer-a")
                first = peer.download_file(origin.url("c.bin"))
                second = peer.download_file(origin.url("c.bin"))
                assert first.success and second.success
                assert second.reused and second.peer_id == first.peer_id
                got[package] = second.read_all()
                records[package] = mesh.records()
        assert got["port"] == got["jax"] == data
        assert records["port"] == records["jax"]

    @pytest.mark.parametrize("window", ["2-9", "1000-3000999"])
    def test_ranged_download(self, tmp_path, origin, window):
        data = content(origin, "d.bin", 4 * 2**20 + 77, 3)
        start, end = (int(x) for x in window.split("-"))
        got, records = {}, {}
        for package in PACKAGES:
            with Mesh(package, tmp_path / package, seed=True) as mesh:
                result = mesh.daemon("peer-a").download_file(
                    origin.url("d.bin"), url_range=window)
                assert result.success, result.error
                got[package] = result.read_all()
                records[package] = mesh.records()
        assert got["port"] == got["jax"] == data[start:end + 1]
        assert records["port"] == records["jax"]

    def test_download_to_hbm_through_seed_and_peer(self, tmp_path, origin):
        """Config #5's topology: a seed, a warmed peer, and a third daemon
        whose ``download_to_hbm`` finds the pieces on both."""
        from tests.test_torch_hbm_sink import make_tensors

        tensors = make_tensors(seed=7)
        jsink.write_safetensors(str(origin.root_dir / "m.safetensors"),
                                tensors)
        url = origin.url("m.safetensors")
        got, records = {}, {}
        for package, (sink, kwargs) in SINKS.items():
            with Mesh(package, tmp_path / package, seed=True) as mesh:
                assert mesh.daemon("peer-warm").download_file(url).success
                got[package] = sink.download_to_hbm(
                    mesh.daemon("peer-hbm"), url, timeout=120, **kwargs)
                records[package] = mesh.records()
        assert_same_as_jax(got["port"], got["jax"])
        assert_same(got["port"], tensors)
        assert records["port"] == records["jax"]
        hbm = [r for r in records["port"]
               if r["host"]["hostname"] == "peer-hbm"]
        assert hbm and hbm[-1]["state"] == "Succeeded"

    def test_download_to_hbm_tiny_file(self, tmp_path, origin):
        """A file of at most 128 bytes (the TINY size scope) that another
        peer already holds. The in-process scheduler keeps no inline
        payload for it, so it comes through a store like any other file;
        ``tests/test_torch_hbm_sink.py`` drives the inline
        (``direct_bytes``) path with a stand-in daemon."""
        tensors = {"w": np.arange(4, dtype=np.uint8)}
        jsink.write_safetensors(str(origin.root_dir / "t.safetensors"),
                                tensors)
        assert (origin.root_dir / "t.safetensors").stat().st_size <= 128
        url = origin.url("t.safetensors")
        got = {}
        for package, (sink, kwargs) in SINKS.items():
            with Mesh(package, tmp_path / package) as mesh:
                assert mesh.daemon("peer-a").download_file(url).success
                got[package] = sink.download_to_hbm(
                    mesh.daemon("peer-b"), url, timeout=60, **kwargs)
        assert_same_as_jax(got["port"], got["jax"])
        assert_same(got["port"], tensors)


_LENGTHS = [-1, 0, 1, 128, 4 * 2**20, 200 * 2**20, 200 * 2**20 + 1,
            300 * 2**20, 2**30, 4_976_689_152, 4_976_691_200, 16 * 10**9,
            100 * 2**30]


@pytest.mark.parametrize("length", _LENGTHS)
def test_piece_size_and_count_agree(length):
    size = ppiece.compute_piece_size(length)
    assert size == jpiece.compute_piece_size(length)
    if length > 0:
        assert ppiece.compute_piece_count(length, size) == \
            jpiece.compute_piece_count(length, size)


# -- chip_smoke.py's origin server against tests/fileserver.py ---------------

def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_tests", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def fetch(url: str, method: str = "GET", header: str | None = None):
    req = urllib.request.Request(url, method=method)
    if header is not None:
        req.add_header("Range", header)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return (resp.status, resp.headers.get("Content-Range"),
                    resp.headers.get("Content-Length"), resp.read())
    except urllib.error.HTTPError as err:
        return err.code, None, None, b""


_RANGES = [None, "bytes=0-0", "bytes=0-99", "bytes=100-", "bytes=-37",
           "bytes=5000-999999999", "bytes=70000-70000", "bytes=70010-"]


def test_chip_smoke_origin_serves_as_fileserver(tmp_path):
    root = tmp_path / "files"
    root.mkdir()
    data = np.random.default_rng(4).integers(0, 256, 70_011,
                                             dtype=np.uint8).tobytes()
    (root / "f.bin").write_bytes(data)
    OriginServer = load_chip_smoke().OriginServer
    with FileServer(str(root)) as ref, OriginServer(str(root)) as ours:
        for name in ("f.bin", "missing.bin"):
            for method in ("GET", "HEAD"):
                for header in _RANGES if method == "GET" else [None]:
                    want = fetch(ref.url(name), method, header)
                    got = fetch(ours.url(name), method, header)
                    assert got == want, (name, method, header)
        assert fetch(ours.url("f.bin"))[3] == data
