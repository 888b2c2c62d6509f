"""The port's P2P cluster as processes on the CPU: a
``python -m dragonfly2_tpu_torch.cmd.scheduler`` child (``--algorithm
default``, ``--seed-peer``), a seed ``cmd.dfdaemon`` child (``--type
super``) and a peer ``cmd.dfdaemon`` child, driven by ``cmd.dfget``
children and peers in this process over the scheduler's wire — the
scenario of ``tests/test_p2p_multiproc.py`` — then stopped with SIGTERM.
A scheduler child at ``--algorithm cost --device cpu`` over a temporary
registry makes the decisions the in-process ``LearnedCostEvaluator``
makes on the same registry row.
"""

from __future__ import annotations

import collections
import hashlib
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from dragonfly2_tpu_torch.client.daemon import Daemon, DaemonConfig
from dragonfly2_tpu_torch.client.piece import parse_http_range
from dragonfly2_tpu_torch.client.rpcserver import RemoteDaemonClient
from dragonfly2_tpu_torch.scheduler.rpcserver import (
    BalancedSchedulerClient,
    GrpcSchedulerClient,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START_TIMEOUT_S = 120.0
CHILD_TIMEOUT_S = 180.0


def _env() -> dict:
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class CountingOrigin:
    """A directory over HTTP/1.1 with single ranges, counting each path's
    body bytes served."""

    def __init__(self, root: str):
        served = self.served = collections.Counter()
        lock = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_GET(self):  # noqa: N802
                path = os.path.join(root, self.path.lstrip("/"))
                if not os.path.isfile(path):
                    self.send_error(404)
                    return
                size = os.path.getsize(path)
                header = self.headers.get("Range")
                start, length = 0, size
                if header:
                    rng = parse_http_range(header, size)
                    start, length = rng.start, rng.length
                    self.send_response(206)
                    self.send_header("Content-Range",
                                     f"bytes {rng.start}-{rng.end}/{size}")
                else:
                    self.send_response(200)
                self.send_header("Content-Length", str(length))
                self.end_headers()
                with open(path, "rb") as f:
                    f.seek(start)
                    self.wfile.write(f.read(length))
                if header != "bytes=0-0":
                    with lock:
                        served[self.path] += length

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self._server.serve_forever, daemon=True,
                         name="origin").start()

    def url(self, name: str) -> str:
        return f"http://127.0.0.1:{self._server.server_address[1]}/{name}"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class Child:
    """A port command in a child process: stdout read until the line
    that says it serves, stderr kept in a file."""

    def __init__(self, name: str, module: str, args: list, tmp, expect: str):
        self.name = name
        self.err_path = os.path.join(tmp, f"{name}.err")
        with open(self.err_path, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", module, *map(str, args)], cwd=REPO,
                stdout=subprocess.PIPE, stderr=err, text=True, env=_env())
        watchdog = threading.Timer(START_TIMEOUT_S, self.proc.kill)
        watchdog.start()
        lines = []
        try:
            while True:
                line = self.proc.stdout.readline()
                if not line:
                    raise AssertionError(f"{name} did not start: {lines}\n"
                                         f"{self.stderr()}")
                lines.append(line)
                if line.startswith(expect):
                    break
        finally:
            watchdog.cancel()
        self.lines = lines
        self.target = lines[-1].rstrip().rsplit(" ", 1)[1]
        # Keep reading so the child never blocks on a full pipe.
        threading.Thread(target=self.proc.stdout.read, daemon=True).start()

    def stderr(self) -> str:
        with open(self.err_path) as f:
            return f.read()[-3000:]

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return self.proc.wait()


def dfget(*args) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "dragonfly2_tpu_torch.cmd.dfget",
         *map(str, args)], cwd=REPO, env=_env(), capture_output=True,
        text=True, timeout=CHILD_TIMEOUT_S)


class ReportingClient(GrpcSchedulerClient):
    """The scheduler's wire client, noting the parents each decision
    offers this peer and which parent supplied each piece it reports."""

    def __init__(self, target: str):
        super().__init__(target)
        self.piece_parents = collections.Counter()
        self.offered = []

    def register_peer(self, req, channel=None):
        if channel is not None:
            put = channel.decisions.put

            def noting_put(item, *args, **kwargs):
                if hasattr(item, "parents"):
                    self.offered.extend(p.peer_id for p in item.parents)
                return put(item, *args, **kwargs)

            channel.decisions.put = noting_put
        return super().register_peer(req, channel)

    def download_piece_finished(self, report) -> None:
        self.piece_parents[report.parent_id] += 1
        super().download_piece_finished(report)

    def download_pieces_finished(self, reports) -> None:
        reports = list(reports)
        for report in reports:
            self.piece_parents[report.parent_id] += 1
        super().download_pieces_finished(reports)


def by_process(peer_ids, children) -> dict:
    """A peer id is ``<ip>-<pid>-<uuid>``: child name → pieces."""
    names = {str(c.proc.pid): c.name for c in children}
    out = collections.Counter()
    for peer_id, n in peer_ids.items():
        out[names.get(peer_id.split("-")[1], peer_id or "origin")] += n
    return dict(out)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("p2p-processes")
    (tmp / "origin").mkdir()
    rng = np.random.default_rng(5)
    blobs = {"blob.bin": rng.bytes(24 * 1024 * 1024 + 217),
             "second.bin": rng.bytes(2 * 1024 * 1024 + 41)}
    for name, data in blobs.items():
        (tmp / "origin" / name).write_bytes(data)
    origin = CountingOrigin(str(tmp / "origin"))
    ports = {name: free_port() for name in ("scheduler", "seed", "peer")}
    children = []
    state = {"tmp": tmp, "origin": origin, "blobs": blobs, "ports": ports,
             "children": children, "codes": None}
    try:
        children.append(Child(
            "scheduler", "dragonfly2_tpu_torch.cmd.scheduler",
            ["--host", "127.0.0.1", "--port", ports["scheduler"],
             "--data-dir", tmp / "scheduler-data", "--algorithm", "default",
             "--seed-peer", f"127.0.0.1:{ports['seed']}"],
            tmp, "scheduler serving on "))
        for name, kind in (("seed", "super"), ("peer", "normal")):
            children.append(Child(
                name, "dragonfly2_tpu_torch.cmd.dfdaemon",
                ["--scheduler", f"127.0.0.1:{ports['scheduler']}",
                 "--rpc-port", ports[name], "--storage-dir", tmp / name,
                 "--hostname", f"{name}-1", "--type", kind],
                tmp, "daemon rpc on "))
        # The first download, seeded: every test after it finds the file
        # on both daemons, whichever worker process runs it.
        state["first"] = dfget(
            origin.url("blob.bin"), "-O", tmp / "first.bin", "--daemon",
            f"127.0.0.1:{ports['peer']}")
        state["first_served"] = origin.served["/blob.bin"]
        yield state
    finally:
        if state["codes"] is None:
            state["codes"] = [(c.name, c.stop(), c.stderr())
                              for c in reversed(children)]
        origin.close()


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def test_first_download_is_seeded_through_the_wire(cluster):
    """dfget → peer's daemon surface → the scheduler child → the seed's
    ``ObtainSeeds`` → the origin, once (the fixture's download)."""
    url = cluster["origin"].url("blob.bin")
    r = cluster["first"]
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "via daemon mesh" in r.stdout
    assert sha((cluster["tmp"] / "first.bin").read_bytes()) == sha(
        cluster["blobs"]["blob.bin"])
    assert cluster["first_served"] == len(cluster["blobs"]["blob.bin"])
    seed = RemoteDaemonClient(f"127.0.0.1:{cluster['ports']['seed']}")
    try:
        stat = seed.stat(url=url)
    finally:
        seed.close()
    assert stat.found and stat.content_length == len(
        cluster["blobs"]["blob.bin"])


def test_second_peer_downloads_peer_to_peer(cluster, tmp_path):
    """A peer in this process on the scheduler's wire: offered parents on
    both daemons, every piece from them, none from the origin."""
    client = ReportingClient(
        f"127.0.0.1:{cluster['ports']['scheduler']}")
    daemon = Daemon(client, DaemonConfig(storage_root=str(tmp_path / "b"),
                                         hostname="peer-b"))
    daemon.start()
    try:
        result = daemon.download_file(cluster["origin"].url("blob.bin"))
        data = result.read_all() if result.success else b""
    finally:
        daemon.stop()
    assert result.success, result.error
    assert sha(data) == sha(cluster["blobs"]["blob.bin"])
    offered = by_process(collections.Counter(client.offered),
                         cluster["children"])
    assert sorted(offered) == ["peer", "seed"], offered
    parents = by_process(client.piece_parents, cluster["children"])
    assert set(parents) <= {"seed", "peer"} and parents, parents
    assert sum(parents.values()) == result.storage.meta.total_pieces
    assert cluster["origin"].served["/blob.bin"] == len(
        cluster["blobs"]["blob.bin"])


def test_repeat_download_served_from_the_daemon_cache(cluster, tmp_path):
    out = tmp_path / "again.bin"
    r = dfget(cluster["origin"].url("blob.bin"), "-O", out, "--daemon",
              f"127.0.0.1:{cluster['ports']['peer']}")
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "via daemon cache" in r.stdout
    assert sha(out.read_bytes()) == sha(cluster["blobs"]["blob.bin"])


def test_ephemeral_peer_against_the_scheduler_wire(cluster, tmp_path):
    """dfget with only ``--scheduler``: its own peer in a fresh process,
    on ``BalancedSchedulerClient``."""
    out = tmp_path / "second.bin"
    r = dfget(cluster["origin"].url("second.bin"), "-O", out,
              "--scheduler", f"127.0.0.1:{cluster['ports']['scheduler']}")
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert sha(out.read_bytes()) == sha(cluster["blobs"]["second.bin"])


def test_scheduler_stats_over_the_wire(cluster):
    client = BalancedSchedulerClient(
        [f"127.0.0.1:{cluster['ports']['scheduler']}"])
    try:
        stats = client.stats_at(f"127.0.0.1:{cluster['ports']['scheduler']}")
    finally:
        client.close()
    assert stats.hosts >= 2 and stats.stats["decisions"] >= 1


def test_clean_shutdown(cluster):
    """SIGTERM every child, daemons first: each exits 0 without a
    traceback."""
    cluster["codes"] = [(c.name, c.stop(), c.stderr())
                        for c in reversed(cluster["children"])]
    for name, rc, err in cluster["codes"]:
        assert rc == 0, f"{name} exited {rc}:\n{err}"
        assert "Traceback" not in err, f"{name}:\n{err}"


# -- --algorithm cost --------------------------------------------------------


def cost_registry(tmp) -> tuple:
    """A registry under ``tmp`` whose active ``cost`` version is a small
    cost model trained here; (db, objects, the active row)."""
    from dragonfly2_tpu_torch.manager import (
        Database,
        FilesystemObjectStore,
        ManagerService,
    )
    from dragonfly2_tpu_torch.models.mlp import FEATURE_DIM
    from dragonfly2_tpu_torch.train.checkpoint import (
        ModelMetadata,
        save_model,
    )
    from dragonfly2_tpu_torch.train.cost_trainer import (
        CostTrainConfig,
        cost_tree,
        train_cost,
    )

    rng = np.random.default_rng(11)
    x = rng.uniform(0, 100, (512, FEATURE_DIM)).astype(np.float32)
    y = (0.01 + x[:, 3] / 400 + x[:, 9] / 50).astype(np.float32)
    result = train_cost(x, y, CostTrainConfig(hidden=(16, 8), epochs=3,
                                              batch_size=128), device="cpu")
    save_model(str(tmp / "cost-model"), cost_tree(result), ModelMetadata(
        model_id="cost", model_type="cost", config={"hidden": [16, 8]}))
    db, objects = str(tmp / "manager.db"), str(tmp / "objects")
    registry = ManagerService(Database(db), FilesystemObjectStore(objects),
                              device="cpu")
    row = registry.create_model(
        model_id="cost", model_type="cost", host_id="trainer", ip="127.0.0.1",
        hostname="trainer", evaluation={}, artifact_dir=str(tmp / "cost-model"))
    assert registry.get_active_model_version("cost") == row.version
    return db, objects, registry.get_active_model("cost")


def decide(api, tag: str) -> list:
    """Four parents of one task with different hosts and piece costs, then
    a child: the parents the scheduler offers the child, in its order."""
    from dragonfly2_tpu_torch.client.peer_task import (
        CandidateParents,
        QueueChannel,
    )
    from dragonfly2_tpu_torch.scheduler.resource.host import Host
    from dragonfly2_tpu_torch.scheduler.service import (
        PieceFinished,
        RegisterPeerRequest,
    )
    from dragonfly2_tpu_torch.schema.records import Network
    from dragonfly2_tpu_torch.utils.hosttypes import HostType

    task, url = f"task-{tag}", f"http://origin/{tag}"
    pieces, size = 8, 4 << 20
    for i in range(4):
        api.announce_host(Host(
            id=f"h{i}-{tag}", hostname=f"h{i}", ip="127.0.0.1",
            port=1000 + i, download_port=2000 + i,
            type=HostType.SUPER_SEED if i == 0 else HostType.NORMAL,
            concurrent_upload_limit=[50, 20, 80, 5][i],
            network=Network(idc=["a", "b", "a", "c"][i],
                            location=["r1|z1", "r1|z2", "r2", ""][i])))
        peer = f"p{i}-{tag}"
        api.register_peer(RegisterPeerRequest(
            host_id=f"h{i}-{tag}", task_id=task, peer_id=peer, url=url),
            QueueChannel())
        api.download_peer_back_to_source_started(peer)
        api.download_pieces_finished([PieceFinished(
            peer_id=peer, piece_number=n, parent_id="", offset=n * size,
            length=size, digest="md5:x", cost_ns=(i + 1) * 10_000_000 + n)
            for n in range(pieces)])
        api.download_peer_back_to_source_finished(
            peer, pieces * size, pieces, 1.0)
    # Over the wire each parent's reports ride its own stream: the
    # scheduler has taken them all once each stream's reader has seen
    # the server end it.
    readers = {f"announce-read-{f'p{i}-{tag}'[-8:]}" for i in range(4)}
    deadline = time.monotonic() + 30
    while any(t.name in readers for t in threading.enumerate()):
        assert time.monotonic() < deadline, "a parent's stream never ended"
        time.sleep(0.01)
    api.announce_host(Host(id=f"hc-{tag}", hostname="hc", ip="127.0.0.1",
                           port=3000, download_port=3001,
                           network=Network(idc="a", location="r1|z1")))
    channel = QueueChannel()
    api.register_peer(RegisterPeerRequest(
        host_id=f"hc-{tag}", task_id=task, peer_id=f"c-{tag}", url=url),
        channel)
    api.download_peer_started(f"c-{tag}")
    while True:
        decision = channel.decisions.get(timeout=30)
        if isinstance(decision, CandidateParents):
            return [p.peer_id for p in decision.parents]


def test_cost_algorithm_decides_as_the_in_process_evaluator(tmp_path):
    """``cmd.scheduler --algorithm cost --device cpu`` loads the active
    cost version of its registry; a child peer's parents come back in the
    order the in-process scheduler gives with ``LearnedCostEvaluator``
    over the same registry row."""
    from dragonfly2_tpu_torch.cmd.scheduler import _load_cost_evaluator
    from dragonfly2_tpu_torch.inference.scorer import LearnedCostEvaluator
    from dragonfly2_tpu_torch.manager import (
        Database,
        FilesystemObjectStore,
        ManagerService,
    )
    from dragonfly2_tpu_torch.scheduler.evaluator.base import BaseEvaluator
    from dragonfly2_tpu_torch.scheduler.resource.resource import Resource
    from dragonfly2_tpu_torch.scheduler.scheduling.core import Scheduling
    from dragonfly2_tpu_torch.scheduler.service import SchedulerService
    from dragonfly2_tpu_torch.scheduler.storage.storage import Storage

    db, objects, active = cost_registry(tmp_path)
    child = Child("cost-scheduler", "dragonfly2_tpu_torch.cmd.scheduler",
                  ["--host", "127.0.0.1", "--port", free_port(),
                   "--data-dir", tmp_path / "cost-data",
                   "--algorithm", "cost", "--device", "cpu",
                   "--cost-model-db", db, "--cost-object-dir", objects],
                  tmp_path, "scheduler serving on ")
    try:
        assert any(f"serving version {active.version}" in line
                   for line in child.lines), child.lines
        client = GrpcSchedulerClient(child.target)
        try:
            remote = decide(client, "wire")
            stats = client.stats().stats
        finally:
            client.close()
    finally:
        code = child.stop()
    evaluator = _load_cost_evaluator(
        ManagerService(Database(db), FilesystemObjectStore(objects),
                       device="cpu"), None, "cpu")
    assert isinstance(evaluator, LearnedCostEvaluator)
    assert evaluator.serving_version == active.version
    local = SchedulerService(resource=Resource(),
                             scheduling=Scheduling(evaluator),
                             storage=Storage(str(tmp_path / "local")))
    in_process = decide(local, "wire")
    assert remote == in_process and len(remote) >= 2, (remote, in_process)
    # Not the rule evaluator's order: the learned model decided.
    rules = SchedulerService(resource=Resource(),
                             scheduling=Scheduling(BaseEvaluator()),
                             storage=Storage(str(tmp_path / "rules")))
    assert decide(rules, "wire") != remote
    assert stats["cost_fallbacks"] == 0
    assert code == 0


def test_cost_algorithm_refuses_to_start_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the command would serve")
    out = subprocess.run(
        [sys.executable, "-m", "dragonfly2_tpu_torch.cmd.scheduler",
         "--port", "0", "--data-dir", str(tmp_path / "d"),
         "--algorithm", "cost", "--cost-model-db", str(tmp_path / "m.db"),
         "--cost-object-dir", str(tmp_path / "o")],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "DeviceFault" in out.stderr
    assert "serving on" not in out.stdout


def test_cost_registry_watcher_swaps_and_demotes(tmp_path):
    """``_watch_cost_registry``: a version promoted after start is hot
    swapped in, and a registry left with no active version demotes the
    scheduler to the rule evaluator, as JAX's watcher does."""

    from dragonfly2_tpu_torch.cmd.scheduler import _watch_cost_registry
    from dragonfly2_tpu_torch.manager import (
        Database,
        FilesystemObjectStore,
        ManagerService,
    )
    from dragonfly2_tpu_torch.scheduler.evaluator.base import BaseEvaluator
    from dragonfly2_tpu_torch.scheduler.resource.resource import Resource
    from dragonfly2_tpu_torch.scheduler.scheduling.core import Scheduling
    from dragonfly2_tpu_torch.scheduler.service import SchedulerService
    from dragonfly2_tpu_torch.scheduler.storage.storage import Storage

    service = SchedulerService(resource=Resource(),
                               scheduling=Scheduling(BaseEvaluator()),
                               storage=Storage(str(tmp_path / "data")))
    db, objects, active = cost_registry(tmp_path)
    registry = ManagerService(Database(db), FilesystemObjectStore(objects),
                              device="cpu")
    _watch_cost_registry(service, registry, interval_s=0.05, device="cpu")

    def serving():
        return getattr(service.scheduling.evaluator, "serving_version", None)

    deadline = time.monotonic() + 30
    while serving() != active.version and time.monotonic() < deadline:
        time.sleep(0.05)
    assert serving() == active.version
    # The serving version quarantined with no predecessor to restore.
    assert registry.quarantine_version("cost", active.version) is None
    deadline = time.monotonic() + 30
    while serving() is not None and time.monotonic() < deadline:
        time.sleep(0.05)
    assert type(service.scheduling.evaluator) is BaseEvaluator


def test_cost_algorithm_degrades_to_rules_on_a_bad_artifact(tmp_path):
    """An active cost version whose artifact does not load is not a fault
    of the card: the scheduler child logs it, serves with the rule
    evaluator (its decisions are the rules'), and stops cleanly."""
    from dragonfly2_tpu_torch.manager import (
        Database,
        FilesystemObjectStore,
        ManagerService,
    )
    from dragonfly2_tpu_torch.manager.service import MODELS_BUCKET
    from dragonfly2_tpu_torch.scheduler.evaluator.base import BaseEvaluator
    from dragonfly2_tpu_torch.scheduler.resource.resource import Resource
    from dragonfly2_tpu_torch.scheduler.scheduling.core import Scheduling
    from dragonfly2_tpu_torch.scheduler.service import SchedulerService
    from dragonfly2_tpu_torch.scheduler.storage.storage import Storage

    db, objects, active = cost_registry(tmp_path)
    registry = ManagerService(Database(db), FilesystemObjectStore(objects),
                              device="cpu")
    row = registry.db.find_one("models", type="cost", state="active")
    registry.store.put_object(MODELS_BUCKET, row.object_key, b"not a tar")
    child = Child("bad-cost", "dragonfly2_tpu_torch.cmd.scheduler",
                  ["--host", "127.0.0.1", "--port", free_port(),
                   "--data-dir", tmp_path / "bad-data",
                   "--algorithm", "cost", "--device", "cpu",
                   "--cost-model-db", db, "--cost-object-dir", objects],
                  tmp_path, "scheduler serving on ")
    try:
        client = GrpcSchedulerClient(child.target)
        try:
            remote = decide(client, "bad")
        finally:
            client.close()
    finally:
        code = child.stop()
    rules = SchedulerService(resource=Resource(),
                             scheduling=Scheduling(BaseEvaluator()),
                             storage=Storage(str(tmp_path / "rules")))
    assert remote == decide(rules, "bad")
    assert "degrading to rules" in child.stderr()
    assert code == 0
