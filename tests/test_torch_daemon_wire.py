"""The daemon's RPC surface (``client/rpcserver.py``: ``DAEMON_SPEC``,
``DaemonRpcService``, ``RemoteDaemonClient``, ``GrpcSeedPeerClient``)
over the port's wire, held to the JAX package's over grpc.

Each case runs once through each package's own stack — a scheduler
served over that package's transport, daemons on its
``BalancedSchedulerClient``, the daemon surface served with
``serve_daemon_rpc`` — and the outcomes must be equal: two CLIs sharing
one daemon cache, import / export / delete, errors, the scheduler
triggering a seed over the wire, task affinity across two replicas, and
a download that completes with one of two replicas dead.
"""

from __future__ import annotations

import hashlib
import importlib
import time

import numpy as np
import pytest

from dragonfly2_tpu.client import rpcserver as jax_daemon_rpc
from dragonfly2_tpu.rpc import codec as jax_codec
from dragonfly2_tpu_torch.client import rpcserver as daemon_rpc
from dragonfly2_tpu_torch.rpc import codec
from tests.fileserver import FileServer
from tests.test_torch_scheduler_wire import _messages, seeded_message

PKGS = {"port": "dragonfly2_tpu_torch", "jax": "dragonfly2_tpu"}


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


def wait_for(predicate, timeout: float = 10.0, interval: float = 0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def content(seed: int, size: int) -> bytes:
    return np.random.default_rng(seed).bytes(size)


# -- the spec and its messages ---------------------------------------------


def test_daemon_spec_equals_jax():
    spec, ref = daemon_rpc.DAEMON_SPEC, jax_daemon_rpc.DAEMON_SPEC
    assert spec.name == ref.name == "df2.dfdaemon.Daemon"
    assert {m: k.value for m, k in spec.methods.items()} == \
        {m: k.value for m, k in ref.methods.items()}
    assert sorted(spec.methods) == ["DeleteTask", "Download", "ExportTask",
                                    "ImportTask", "ObtainSeeds", "StatTask",
                                    "Version"]


DAEMON_TAGS = sorted(_messages(daemon_rpc))


def test_every_daemon_message_is_registered_under_jax_tag():
    assert DAEMON_TAGS == sorted(_messages(jax_daemon_rpc))
    assert len(DAEMON_TAGS) == 15


@pytest.mark.parametrize("tag", DAEMON_TAGS)
def test_daemon_message_bytes_equal_jax(tag):
    port_msg = seeded_message(_messages(daemon_rpc)[tag], daemon_rpc,
                              np.random.default_rng(5))
    jax_msg = seeded_message(_messages(jax_daemon_rpc)[tag], jax_daemon_rpc,
                             np.random.default_rng(5))
    assert codec.encode(port_msg) == jax_codec.encode(jax_msg)


# -- the stacks -----------------------------------------------------------------


class Cluster:
    """Package ``pkg``'s schedulers, daemons and origin under ``root``."""

    def __init__(self, pkg: str, root):
        self.pkg, self.root = pkg, root
        self.rpc = mod(pkg, "scheduler.rpcserver")
        self.drpc = mod(pkg, "client.rpcserver")
        self.closers = []
        (root / "origin").mkdir()
        self.origin = FileServer(str(root / "origin")).__enter__()
        self.closers.append(lambda: self.origin.__exit__(None, None, None))

    def scheduler(self, name: str):
        core = mod(self.pkg, "scheduler.scheduling.core")
        service = mod(self.pkg, "scheduler.service").SchedulerService(
            resource=mod(self.pkg, "scheduler.resource.resource").Resource(),
            scheduling=core.Scheduling(
                mod(self.pkg, "scheduler.evaluator.base").BaseEvaluator(),
                core.SchedulingConfig(retry_interval=0.01,
                                      retry_back_to_source_limit=2)),
            storage=mod(self.pkg, "scheduler.storage.storage").Storage(
                str(self.root / f"datasets-{name}")))
        server = mod(self.pkg, "rpc").serve(
            [(self.rpc.SCHEDULER_SPEC, self.rpc.SchedulerRpcService(service))])
        self.closers.append(server.stop)
        return service, server

    def daemon(self, name: str, targets, super_seed: bool = False):
        d = mod(self.pkg, "client.daemon")
        types = mod(self.pkg, "utils.hosttypes")
        balanced = self.rpc.BalancedSchedulerClient(list(targets))
        daemon = d.Daemon(balanced, d.DaemonConfig(
            storage_root=str(self.root / name), hostname=name,
            host_type=(types.HostType.SUPER_SEED if super_seed
                       else types.HostType.NORMAL)))
        daemon.start()
        self.closers.append(daemon.stop)
        return daemon

    def serve_daemon(self, daemon):
        server = self.drpc.serve_daemon_rpc(daemon)
        self.closers.append(server.stop)
        return server

    def client(self, target: str):
        return self.drpc.RemoteDaemonClient(target)

    def put(self, name: str, data: bytes) -> str:
        (self.root / "origin" / name).write_bytes(data)
        return self.origin.url(name)

    def close(self):
        for close in reversed(self.closers):
            close()


@pytest.fixture(scope="module")
def surfaces(tmp_path_factory):
    """Per package: a scheduler, daemon-a on it, and daemon-a's surface."""
    made = {}
    try:
        for pkg in PKGS:
            cluster = Cluster(pkg, tmp_path_factory.mktemp(f"surface-{pkg}"))
            made[pkg] = cluster
            _, server = cluster.scheduler("s1")
            cluster.daemon_a = cluster.daemon("daemon-a", [server.target])
            cluster.surface = cluster.serve_daemon(cluster.daemon_a)
        yield made
    finally:
        for cluster in made.values():
            cluster.close()


def _both(surfaces, case):
    return {pkg: case(cluster) for pkg, cluster in surfaces.items()}


def _shared_cache(c: Cluster) -> dict:
    data = content(21, 3 * 1024 * 1024 + 17)
    url = c.put("blob.bin", data)
    out = []
    for i in (1, 2):
        cli = c.client(c.surface.target)
        path = c.root / f"out{i}.bin"
        r = cli.download(url, str(path))
        cli.close()
        out.append({"success": r.success, "reused": r.reused,
                    "content_length": r.content_length, "task_id": r.task_id,
                    "same_bytes": path.read_bytes() == data})
    same_task = out[0].pop("task_id") == out[1].pop("task_id")
    return {"runs": out, "same_task": same_task}


def test_two_clients_share_one_daemon_cache_as_jax(surfaces):
    got = _both(surfaces, _shared_cache)
    assert got["port"] == got["jax"]
    assert [r["reused"] for r in got["port"]["runs"]] == [False, True]
    assert all(r["success"] and r["same_bytes"]
               for r in got["port"]["runs"])
    assert got["port"]["same_task"]


def _stat_and_version(c: Cluster) -> dict:
    url = c.put("s.bin", b"x" * 4096)
    cli = c.client(c.surface.target)
    try:
        version = cli.version()
        before = cli.stat(url=url)
        downloaded = cli.download(url, None).success
        after = cli.stat(url=url)
    finally:
        cli.close()
    return {"host_id_is_daemon": version.host_id == c.daemon_a.host_id,
            "version": bool(version.version), "before": before.found,
            "downloaded": downloaded,
            "after": (after.found, after.content_length, after.total_pieces,
                      bool(after.piece_md5_sign))}


def test_stat_by_url_and_version_as_jax(surfaces):
    got = _both(surfaces, _stat_and_version)
    assert got["port"] == got["jax"]
    assert got["port"]["host_id_is_daemon"]
    assert got["port"]["after"][:2] == (True, 4096)


def _import_export_delete(c: Cluster) -> dict:
    payload = content(22, 2 * 1024 * 1024 + 5)
    src = c.root / "import-src.bin"
    src.write_bytes(payload)
    out = c.root / "export-out.bin"
    cli = c.client(c.surface.target)
    try:
        task_id = cli.import_file(str(src), "cache-key-1", tag="t")
        stat = cli.stat(cid="cache-key-1", tag="t")
        exported = cli.export("cache-key-1", str(out), tag="t")
        same = out.read_bytes() == payload
        deleted = cli.delete("cache-key-1", tag="t")
        stat_after = cli.stat(cid="cache-key-1", tag="t")
        out.unlink()
        exported_after = cli.export("cache-key-1", str(out), tag="t")
    finally:
        cli.close()
    return {"task_id": task_id, "stat": (stat.found, stat.content_length,
                                         stat.total_pieces),
            "exported": exported, "same": same, "deleted": deleted,
            "found_after": stat_after.found,
            "exported_after": exported_after, "out_after": out.exists()}


def test_import_export_delete_round_trip_as_jax(surfaces):
    got = _both(surfaces, _import_export_delete)
    assert got["port"] == got["jax"]
    p = got["port"]
    assert p["stat"][:2] == (True, 2 * 1024 * 1024 + 5)
    assert p["exported"] and p["same"] and p["deleted"] > 0
    assert not (p["found_after"] or p["exported_after"] or p["out_after"])


def _errors(c: Cluster) -> dict:
    cli = c.client(c.surface.target)
    try:
        missing = cli.download(c.origin.url("missing.bin"),
                               str(c.root / "missing.out"))
        absent = cli.export("no-such-key", str(c.root / "absent.out"))
        try:
            cli.import_file(str(c.root / "no-such-file"), "k")
            import_error = ("OK", "")
        except Exception as exc:  # noqa: BLE001 — each stack's RpcError
            import_error = (exc.code().name, exc.details())
    finally:
        cli.close()
    return {"success": missing.success, "has_error": bool(missing.error),
            "partial_left": (c.root / "missing.out").exists(),
            "absent": absent, "absent_left": (c.root / "absent.out").exists(),
            "import_error": import_error}


def test_errors_propagate_as_jax(surfaces):
    got = _both(surfaces, _errors)
    assert got["port"] == got["jax"]
    assert got["port"]["has_error"] and not got["port"]["success"]
    # The request iterator's own error cancels the stream.
    assert got["port"]["import_error"] == ("UNKNOWN",
                                           "Exception iterating requests!")


def _unreachable_daemon(pkg: str) -> tuple:
    cli = mod(pkg, "client.rpcserver").RemoteDaemonClient("127.0.0.1:1")
    try:
        cli.version()
    except Exception as exc:  # noqa: BLE001 — each stack's RpcError
        return exc.code().name
    finally:
        cli.close()
    return "OK"


def test_unreachable_daemon_is_unavailable_as_jax():
    assert _unreachable_daemon("port") == _unreachable_daemon("jax") == \
        "UNAVAILABLE"


# -- the seed over the wire, and replicas --------------------------------------


def _seed_over_the_wire(c: Cluster) -> dict:
    service, server = c.scheduler("seeded")
    seed = c.daemon("seed-a", [server.target], super_seed=True)
    seed_rpc = c.serve_daemon(seed)
    service.seed_peer_client = c.drpc.GrpcSeedPeerClient([seed_rpc.target])
    peer = c.daemon("peer-a", [server.target])
    data = content(23, 4 * 1024 * 1024 + 11)
    url = c.put("seeded.bin", data)
    out = c.root / "seeded.out"
    result = peer.download_file(url, output_path=str(out))
    task_id = mod(c.pkg, "utils.idgen").task_id_v1(url)
    # Whether the peer found the seed's pieces or went to the origin
    # itself depends on timing in both packages: compare the outcome.
    recorded = wait_for(lambda: sorted(
        r.host.hostname for r in service.storage.list_download()
        if r.task.id == task_id) == ["peer-a", "seed-a"])
    return {"success": result.success, "same": out.read_bytes() == data,
            "seed_has_task": seed.storage.find_completed_task(task_id)
            is not None, "recorded": recorded}


def test_scheduler_triggers_the_seed_over_the_wire_as_jax(tmp_path):
    got = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
        cluster = Cluster(pkg, tmp_path / pkg)
        try:
            got[pkg] = _seed_over_the_wire(cluster)
        finally:
            cluster.close()
    assert got["port"] == got["jax"]
    assert got["port"]["success"] and got["port"]["same"]
    assert got["port"]["seed_has_task"] and got["port"]["recorded"]


def _affinity_and_dead_replica(c: Cluster) -> dict:
    s1, srv1 = c.scheduler("r1")
    s2, srv2 = c.scheduler("r2")
    idgen = mod(c.pkg, "utils.idgen")
    daemon = c.daemon("peer-r", [srv1.target, srv2.target])
    balanced = daemon.scheduler
    owners = []
    for i in range(4):
        url = c.put(f"f{i}.bin", content(30 + i, 64 * 1024))
        assert daemon.download_file(url).success
        task_id = idgen.task_id_v1(url)
        owner = s1 if balanced.ring.pick(task_id) == srv1.target else s2
        assert wait_for(lambda: any(r.task.id == task_id
                                    for r in owner.storage.list_download()))
        owners.append(owner is s1)
    srv1.stop()
    done = []
    for i in range(6):
        data = content(40 + i, 256 * 1024 + i)
        out = c.root / f"g{i}.bin"
        result = daemon.download_file(c.put(f"g{i}.bin", data),
                                      output_path=str(out))
        done.append(result.success and out.read_bytes() == data)
    on_live = wait_for(lambda: len([
        r for r in s2.storage.list_download()
        if r.task.url.endswith(tuple(f"/g{i}.bin" for i in range(6)))]) == 6)
    return {"owners_on_s1": owners, "done": done, "all_on_live": on_live}


def test_affinity_and_a_dead_replica_as_jax(tmp_path):
    """Tasks land on the replica the ring picks; with one of two replicas
    dead every download still completes and is recorded on the live
    one."""
    got = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
        cluster = Cluster(pkg, tmp_path / pkg)
        try:
            got[pkg] = _affinity_and_dead_replica(cluster)
        finally:
            cluster.close()
    assert got["port"]["done"] == got["jax"]["done"] == [True] * 6
    assert got["port"]["all_on_live"] and got["jax"]["all_on_live"]


def test_seed_client_reports_unavailable_seeds_as_false():
    class Task:
        id = "t" * 64
        url = "http://127.0.0.1:1/x"

    seeds = daemon_rpc.GrpcSeedPeerClient(["127.0.0.1:1"], timeout=5)
    try:
        assert seeds.trigger_task(Task()) is False
    finally:
        seeds.close()


def test_daemon_surface_digest_of_a_remote_download(surfaces):
    """The bytes a ``Download`` stream carries are the origin's."""
    c = surfaces["port"]
    data = content(24, 1_500_000)
    url = c.put("digest.bin", data)
    cli = c.client(c.surface.target)
    try:
        r = cli.download(url, str(c.root / "digest.out"))
    finally:
        cli.close()
    assert r.success
    assert hashlib.sha256((c.root / "digest.out").read_bytes()).digest() == \
        hashlib.sha256(data).digest()
