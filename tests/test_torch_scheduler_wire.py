"""The scheduler's RPC surface (``scheduler/rpcserver.py``) over the port's
wire, held to the JAX package's over grpc.

The two stacks do not talk to each other, so parity is held in two ways:
byte for byte for ``SCHEDULER_SPEC`` and every message of it, and by
running one scenario through each package's own stack — JAX's
``SchedulerRpcService`` served by grpc, the port's by ``rpc/service.py``,
each with daemons of its own package on ``GrpcSchedulerClient`` — and
comparing what comes out: the content's digest, which peer was whose
parent, the ``StatTask`` replies, the statuses and their details, and the
download records without their ids and times.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import threading
import time
import typing

import numpy as np
import pytest

from dragonfly2_tpu.rpc import codec as jax_codec
from dragonfly2_tpu.scheduler import rpcserver as jax_rpcserver
from dragonfly2_tpu_torch.rpc import codec
from dragonfly2_tpu_torch.scheduler import rpcserver
from tests.fileserver import FileServer

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


# -- the spec and its messages ---------------------------------------------


def test_scheduler_spec_equals_jax():
    spec, ref = rpcserver.SCHEDULER_SPEC, jax_rpcserver.SCHEDULER_SPEC
    assert spec.name == ref.name == "df2.scheduler.Scheduler"
    assert {m: k.value for m, k in spec.methods.items()} == \
        {m: k.value for m, k in ref.methods.items()}
    assert len(spec.methods) == 11


def _messages(module) -> dict:
    """registry tag → class, for every ``@message`` of ``module``."""
    out = {}
    for obj in vars(module).values():
        if not isinstance(obj, type) or obj.__module__ != module.__name__:
            continue
        tag = codec._TAGS.get(obj) or jax_codec._TAGS.get(obj)
        if tag is not None:
            out[tag] = obj
    return out


MESSAGE_TAGS = sorted(_messages(rpcserver))


def test_every_message_is_registered_under_jax_tag():
    assert MESSAGE_TAGS == sorted(_messages(jax_rpcserver))
    assert len(MESSAGE_TAGS) == 27


def seeded_message(cls, module, rng, depth: int = 0):
    """An instance of ``cls`` with a seeded value in every field, nested
    messages taken from ``module`` by name, so the same seed gives the
    same values for JAX's class and the port's."""
    hints = typing.get_type_hints(cls, vars(module))

    def value(tp):
        origin = typing.get_origin(tp)
        if tp is str:
            return "".join(chr(int(c)) for c in rng.integers(
                32, 0x2FA0, int(rng.integers(0, 10))))
        if tp is bool:
            return bool(rng.random() < 0.5)
        if tp is int:
            return int(rng.integers(-2**40, 2**40))
        if tp is float:
            return float(rng.standard_normal())
        if tp is bytes:
            return rng.bytes(int(rng.integers(0, 300)))
        if tp is dict or origin is dict:
            return {f"k{j}": int(rng.integers(0, 1000))
                    for j in range(int(rng.integers(0, 4)))}
        if tp is list or origin is list:
            (arg,) = typing.get_args(tp) or (str,)
            if dataclasses.is_dataclass(arg):
                return [seeded_message(getattr(module, arg.__name__), module,
                                       rng, depth + 1)
                        for _ in range(int(rng.integers(0, 3)))]
            return [value(arg) for _ in range(int(rng.integers(0, 4)))]
        raise TypeError(f"no seeded value for {tp!r}")

    return cls(**{f.name: value(hints[f.name])
                  for f in dataclasses.fields(cls)})


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("tag", MESSAGE_TAGS)
def test_message_bytes_equal_jax(tag, seed):
    port_cls = _messages(rpcserver)[tag]
    jax_cls = _messages(jax_rpcserver)[tag]
    port_msg = seeded_message(port_cls, rpcserver,
                              np.random.default_rng(seed))
    jax_msg = seeded_message(jax_cls, jax_rpcserver,
                             np.random.default_rng(seed))
    data = codec.encode(port_msg)
    assert data == jax_codec.encode(jax_msg)
    assert codec.encode(codec.decode(data)) == data


def _host(pkg: str, seed: int):
    """A host with seeded telemetry, from package ``pkg``'s classes."""
    records = mod(pkg, "schema.records")
    host_mod = mod(pkg, "scheduler.resource.host")
    types = mod(pkg, "utils.hosttypes")
    rng = np.random.default_rng(seed)
    return host_mod.Host(
        id=f"h-{seed}", hostname=f"host-{seed}", ip="10.0.0.7", port=65000,
        download_port=65001, type=types.HostType.SUPER_SEED,
        cluster_id="site-a", concurrent_upload_limit=77,
        network=records.Network(idc="idc-1", location="r1|z2",
                                tcp_connection_count=int(rng.integers(99)),
                                upload_tcp_connection_count=3),
        cpu=records.CPU(logical_count=8, physical_count=4,
                        percent=float(rng.random()),
                        times=records.CPUTimes(user=float(rng.random()))),
        memory=records.Memory(total=1 << 34, used_percent=12.5),
        disk=records.Disk(total=1 << 40, used_percent=3.25),
        build=records.Build(git_version="v2", git_commit="abc123"),
        os="linux", platform="ubuntu", kernel_version="6.1")


@pytest.mark.parametrize("seed", [0, 1])
def test_announce_host_request_from_and_to_host_equal_jax(seed):
    port_req = rpcserver.AnnounceHostRequest.from_host(_host("port", seed))
    jax_req = jax_rpcserver.AnnounceHostRequest.from_host(_host("jax", seed))
    assert codec.encode(port_req) == jax_codec.encode(jax_req)
    back, ref = port_req.to_host(), jax_req.to_host()
    for name in ("id", "hostname", "ip", "port", "download_port",
                 "cluster_id", "concurrent_upload_limit", "os", "platform",
                 "kernel_version"):
        assert getattr(back, name) == getattr(ref, name), name
    assert back.type.type_name == ref.type.type_name == "super"
    for part in ("network", "cpu", "memory", "disk", "build"):
        assert dataclasses.asdict(getattr(back, part)) == \
            dataclasses.asdict(getattr(ref, part)), part


# -- one scenario through each package's stack ------------------------------


class Stack:
    """Package ``pkg``'s scheduler service served over its own transport,
    an origin, and daemons on ``GrpcSchedulerClient``."""

    def __init__(self, pkg: str, root):
        self.pkg = pkg
        self.root = root
        service_mod = mod(pkg, "scheduler.service")
        core = mod(pkg, "scheduler.scheduling.core")
        topo = mod(pkg, "scheduler.networktopology.store")
        resource = mod(pkg, "scheduler.resource.resource").Resource()
        storage = mod(pkg, "scheduler.storage.storage").Storage(
            str(root / "datasets"))
        self.service = service_mod.SchedulerService(
            resource=resource,
            scheduling=core.Scheduling(
                mod(pkg, "scheduler.evaluator.base").BaseEvaluator(),
                core.SchedulingConfig(retry_interval=0.01,
                                      retry_back_to_source_limit=2)),
            storage=storage,
            network_topology=topo.NetworkTopologyStore(
                topo.NetworkTopologyConfig(), resource=resource,
                storage=storage))
        self.rpc = mod(pkg, "scheduler.rpcserver")
        self.server = mod(pkg, "rpc").serve(
            [(self.rpc.SCHEDULER_SPEC, self.rpc.SchedulerRpcService(
                self.service))])
        (root / "origin").mkdir()
        self.origin = FileServer(str(root / "origin")).__enter__()
        self.daemons = []

    def daemon(self, name: str, super_seed: bool = False):
        client_daemon = mod(self.pkg, "client.daemon")
        types = mod(self.pkg, "utils.hosttypes")
        daemon = client_daemon.Daemon(
            self.rpc.GrpcSchedulerClient(self.server.target),
            client_daemon.DaemonConfig(
                storage_root=str(self.root / name), hostname=name,
                host_type=(types.HostType.SUPER_SEED if super_seed
                           else types.HostType.NORMAL)))
        daemon.start()
        self.daemons.append(daemon)
        return daemon

    def put(self, name: str, content: bytes) -> str:
        (self.root / "origin" / name).write_bytes(content)
        return self.origin.url(name)

    def records(self, task_id: str) -> list:
        """The task's download records without ids and times, in
        hostname order."""
        out = []
        for r in self.service.storage.list_download():
            if r.task.id != task_id:
                continue
            out.append({
                "state": r.state, "error": r.error.code,
                "finished_piece_count": r.finished_piece_count,
                "task": (r.task.type, r.task.content_length,
                         r.task.total_piece_count, r.task.state,
                         r.task.back_to_source_limit),
                "host": (r.host.hostname, r.host.type),
                "parents": sorted((p.host.hostname, p.state)
                                  for p in r.parents),
            })
        return sorted(out, key=lambda r: r["host"])

    def close(self):
        for d in self.daemons:
            d.stop()
        self.server.stop()
        self.origin.__exit__(None, None, None)


def _stacks(make_dir):
    made = {}
    try:
        for pkg in PKGS:
            made[pkg] = Stack(pkg, make_dir(f"wire-{pkg}"))
        yield made
    finally:
        for stack in made.values():
            stack.close()


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    """One stack of each package, shared by the scenarios."""
    yield from _stacks(tmp_path_factory.mktemp)


@pytest.fixture()
def fresh_stacks(tmp_path):
    """One stack of each package for a scenario that needs the
    scheduler to know no other hosts."""
    def make_dir(name):
        path = tmp_path / name
        path.mkdir()
        return path

    yield from _stacks(make_dir)


def _content(seed: int, size: int) -> bytes:
    return np.random.default_rng(seed).bytes(size)


def _stat(peer, task_id: str) -> dict:
    """The ``StatTask`` reply without the task id (its URL's port differs
    between the stacks)."""
    stat = peer.scheduler.stat_task(task_id)
    assert stat.task_id == task_id
    return {"state": stat.state, "content_length": stat.content_length,
            "total_piece_count": stat.total_piece_count,
            "peer_count": stat.peer_count}


def _back_to_source_then_p2p(stack) -> dict:
    content = _content(11, 6 * 1024 * 1024 + 77)
    url = stack.put("a.bin", content)
    peer_a = stack.daemon("peer-a")
    peer_b = stack.daemon("peer-b")
    ra = peer_a.download_file(url)
    rb = peer_b.download_file(url)
    assert ra.success and rb.success, (ra.error, rb.error)
    assert wait_for(lambda: len(stack.records(ra.task_id)) == 2)
    records = stack.records(ra.task_id)
    b_record = [r for r in stack.service.storage.list_download()
                if r.task.id == ra.task_id and r.host.hostname == "peer-b"]
    return {
        "digests": [hashlib.sha256(r.read_all()).hexdigest()
                    for r in (ra, rb)],
        "b_parent_is_a": [p.id for p in b_record[0].parents] == [ra.peer_id],
        "stat": _stat(peer_b, ra.task_id),
        "records": records,
    }


def test_back_to_source_then_p2p_equals_jax(stacks):
    got = _back_to_source_then_p2p(stacks["port"])
    want = _back_to_source_then_p2p(stacks["jax"])
    assert got == want
    assert got["b_parent_is_a"]
    assert got["digests"][0] == got["digests"][1] == hashlib.sha256(
        _content(11, 6 * 1024 * 1024 + 77)).hexdigest()
    assert got["stat"]["content_length"] == 6 * 1024 * 1024 + 77
    assert [r["parents"] for r in got["records"]] == \
        [[], [("peer-a", "Succeeded")]]


def _concurrent_peers(stack) -> dict:
    content = _content(12, 3 * 1024 * 1024)
    url = stack.put("b.bin", content)
    seed = stack.daemon("seed", super_seed=True)
    stack.service.seed_peer_client = seed.seed_client()
    peers = [stack.daemon(f"c{i}") for i in range(3)]
    results = [None] * len(peers)

    def run(i):
        results[i] = peers[i].download_file(url)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(peers))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
    stack.service.seed_peer_client = None
    return {
        "ok": [r is not None and r.success for r in results],
        "digests": sorted({hashlib.sha256(r.read_all()).hexdigest()
                           for r in results if r is not None and r.success}),
        "seed_has_task": seed.storage.find_completed_task(
            results[0].task_id) is not None,
    }


def test_concurrent_peers_equal_jax(stacks):
    got = _concurrent_peers(stacks["port"])
    assert got == _concurrent_peers(stacks["jax"])
    assert got["ok"] == [True] * 3 and got["seed_has_task"]
    assert got["digests"] == [hashlib.sha256(
        _content(12, 3 * 1024 * 1024)).hexdigest()]


def test_stat_and_leave_equal_jax(stacks):
    outcome = {}
    for pkg, stack in stacks.items():
        content = _content(13, 100_000)
        url = stack.put("c.bin", content)
        peer = stack.daemon("peer-x")
        result = peer.download_file(url)
        assert result.success
        # The finished event rides the async announce stream.
        wait_for(lambda: peer.scheduler.stat_task(
            result.task_id).state == "Succeeded")
        stat = _stat(peer, result.task_id)
        peer.scheduler.leave_peer(result.peer_id)
        peers = stack.service.resource.peer_manager
        left = wait_for(lambda: peers.load(result.peer_id) is None
                        or peers.load(result.peer_id).fsm.current == "Leave")
        outcome[pkg] = (stat, left)
    assert outcome["port"] == outcome["jax"]
    assert outcome["port"][0]["state"] == "Succeeded"
    assert outcome["port"][0]["content_length"] == 100_000
    assert outcome["port"][1]


#: (method, request factory) → a call the service refuses.
REFUSED = {
    "stat_unknown_task": ("StatTask", lambda m: m.TaskID("f" * 64)),
    "leave_unknown_peer": ("LeavePeer", lambda m: m.PeerID("nope")),
    "leave_unknown_host": ("LeaveHost", lambda m: m.HostID("nope")),
    "announce_task_unknown_host": ("AnnounceTask", lambda m: m.WireAnnounceTask(
        host_id="nope", task_id="t", peer_id="p", url="http://x/y")),
    "announce_task_incomplete": ("AnnounceTask", lambda m: m.WireAnnounceTask(
        host_id="refusal-host", task_id="t", peer_id="p", url="http://x/y",
        content_length=10, total_piece_count=0)),
    "claim_unknown_peer": ("ClaimSource", lambda m: m.WireSourceClaim(
        peer_id="nope", task_id="t", total_pieces=4)),
}


def _refusal(stack, case: str) -> tuple:
    method, build = REFUSED[case]
    client = stack.rpc.GrpcSchedulerClient(stack.server.target)
    client._client.AnnounceHost(stack.rpc.AnnounceHostRequest(
        id="refusal-host", hostname="refusal-host", ip="127.0.0.1"))
    try:
        getattr(client._client, method)(build(stack.rpc), timeout=10)
    except Exception as exc:  # noqa: BLE001 — each stack's RpcError
        return exc.code().name, exc.details()
    finally:
        client.close()
    return "OK", ""


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusal_status_and_details_equal_jax(stacks, case):
    got = _refusal(stacks["port"], case)
    assert got == _refusal(stacks["jax"], case)
    assert got[0] == ("FAILED_PRECONDITION" if case ==
                      "announce_task_incomplete" else "NOT_FOUND")


def test_not_found_surfaces_as_rpc_error_from_the_client(stacks):
    from dragonfly2_tpu_torch.rpc.status import RpcError, StatusCode

    client = rpcserver.GrpcSchedulerClient(stacks["port"].server.target)
    try:
        with pytest.raises(RpcError) as info:
            client.stat_task("f" * 64)
        assert info.value.code() is StatusCode.NOT_FOUND
    finally:
        client.close()


def test_unknown_stream_request_is_invalid_argument(stacks):
    """A message the pump does not know comes back on the stream as a
    ``WireError("InvalidArgument", …)``, as JAX's does."""
    got = {}
    for pkg, stack in stacks.items():
        client = stack.rpc.GrpcSchedulerClient(stack.server.target)
        try:
            replies = client._client.AnnouncePeer(iter([
                stack.rpc.WireParent("p", "a:1")]))
            got[pkg] = [(r.code, r.message) for r in replies]
        finally:
            client.close()
    assert got["port"] == got["jax"] == [
        ("InvalidArgument", "unknown request WireParent")]


def _probes(stack) -> dict:
    """Three daemons; the first syncs a probe cycle through
    ``GrpcProbeSync`` (one ``SyncProbes`` stream)."""
    from_pkg = mod(stack.pkg, "client.networktopology")
    service_mod = mod(stack.pkg, "scheduler.service")
    daemons = [stack.daemon(f"probe-{i}") for i in range(3)]
    prober = daemons[0]
    offered = []

    def measure(targets):
        offered.extend(sorted(t.host_id for t in targets))
        return [service_mod.ProbeResult(t.host_id, 0.004)
                for t in targets], []

    sync = from_pkg.GrpcProbeSync(stack.server.target)
    try:
        reported = sync.sync(prober.host_id, measure)
    finally:
        sync.close()
    topo = stack.service.network_topology
    others = sorted(d.host_id for d in daemons[1:])
    return {
        "reported": reported,
        "offered_all_others": sorted(offered) == others,
        "rtts": [topo.average_rtt(prober.host_id, h) for h in others],
    }


def test_sync_probes_through_grpc_probe_sync_equals_jax(fresh_stacks):
    """``client/networktopology.GrpcProbeSync`` reaches the scheduler
    process now: started → candidates → finished, and the RTTs stored."""
    got = _probes(fresh_stacks["port"])
    assert got == _probes(fresh_stacks["jax"])
    assert got["reported"] == 2 and got["offered_all_others"]
    assert got["rtts"] == [pytest.approx(0.004)] * 2


def test_stats_and_list_hosts_over_the_wire(stacks):
    stack = stacks["port"]
    client = rpcserver.GrpcSchedulerClient(stack.server.target)
    try:
        stats = client.stats()
        hosts = client._client.ListHosts(rpcserver.Empty()).hosts
    finally:
        client.close()
    snap = stack.service.stats_snapshot()
    assert stats.hosts == snap["hosts"] == len(hosts) > 0
    assert set(stats.stats) == set(snap["stats"])
