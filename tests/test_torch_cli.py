"""The port's command lines — ``cmd.scheduler``, ``cmd.dfdaemon``,
``cmd.dfget``, ``cmd.dfcache`` and the chaos plane's ``scheduler.replica``
and ``client.daemon_proc`` — held to JAX's: the same options (the port's
scheduler adds ``--device``), ``_parse_whitelist``'s entries, and the
exit codes and outputs of dfget's and dfcache's flags run in process
against each package's own stack. Then each service command of the port
run in process with ``--metrics-port``: its ``/metrics`` carries its own
families and the debug-vars bridge, and ``cmd.scheduler --manager``
starts the job worker on its registered row's queue.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json

import numpy as np
import pytest

from tests.fileserver import FileServer

PKGS = {"port": "dragonfly2_tpu_torch", "jax": "dragonfly2_tpu"}

#: Options the port adds on purpose (ROADMAP.md, Queue 3).
PORT_ONLY = {"cmd.scheduler": {"--device"}}

COMMANDS = ["cmd.scheduler", "cmd.dfdaemon", "cmd.dfget", "cmd.dfcache",
            "scheduler.replica", "client.daemon_proc"]


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKGS[pkg]}.{name}")


class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__("parsed")
        self.parser = parser


def parser_of(pkg: str, command: str, monkeypatch) -> argparse.ArgumentParser:
    """The parser ``main`` builds (its ``prog`` is the command's
    ``df2-*`` name), caught as it parses; ``parse_with_config``'s first
    pass, which looks for ``--config`` alone, parses as usual."""
    original = argparse.ArgumentParser.parse_known_args

    def catch(self, args=None, namespace=None):
        if self.prog.startswith("df2-"):
            raise _Parsed(self)
        return original(self, args, namespace)

    with monkeypatch.context() as patch:
        patch.setattr(argparse.ArgumentParser, "parse_known_args", catch)
        argv = ["stat", "cid"] if command == "cmd.dfcache" else (
            ["http://o/f", "-O", "x"] if command == "cmd.dfget" else [])
        try:
            mod(pkg, command).main(argv)
        except _Parsed as parsed:
            assert len(parsed.parser._actions) > 5
            return parsed.parser
    raise AssertionError(f"{pkg} {command} never parsed its arguments")


def option_set(parser) -> dict:
    """flag → everything about the option but its help text."""
    out = {}
    for action in parser._actions:
        key = action.option_strings[0] if action.option_strings else \
            action.dest
        out[key] = (tuple(action.option_strings), action.dest,
                    repr(action.default), getattr(action.type, "__name__",
                                                  repr(action.type)),
                    type(action).__name__, repr(action.choices),
                    repr(action.nargs), action.required)
    return out


@pytest.mark.parametrize("command", COMMANDS)
def test_options_equal_jax(command, monkeypatch):
    port = option_set(parser_of("port", command, monkeypatch))
    ref = option_set(parser_of("jax", command, monkeypatch))
    extra = PORT_ONLY.get(command, set())
    assert set(port) - set(ref) == extra
    assert {k: v for k, v in port.items() if k not in extra} == ref
    if command == "cmd.scheduler":
        assert port["--device"][2] == repr("cuda")


@pytest.mark.parametrize("spec", [
    ":8080", r"foo\.example:80,443", r"foo\.example", "bare-host",
    r"(?:a|b)\.example:443", "host:notaport",
])
def test_parse_whitelist_equals_jax(spec):
    """``':8080'`` is any host on the listed ports, as JAX's (and the
    reference's) whitelist reads it."""
    entries = [mod(pkg, "cmd.dfdaemon")._parse_whitelist(spec)
               for pkg in ("port", "jax")]
    assert [(e.host, e.ports) for e in entries[:1]] == \
        [(e.host, e.ports) for e in entries[1:]]
    probes = [("anything.example", 8080), ("foo.example", 443),
              ("a.example", 443), ("bare-host", 1)]
    assert [entries[0].allows(h, p) for h, p in probes] == \
        [entries[1].allows(h, p) for h, p in probes]
    if spec == ":8080":
        assert entries[0].host == "" and entries[0].ports == ["8080"]
        assert entries[0].allows("anything.example", 8080)
        assert not entries[0].allows("anything.example", 80)


# -- dfget and dfcache in process -------------------------------------------


@pytest.fixture()
def origin(tmp_path):
    root = tmp_path / "origin"
    root.mkdir()
    with FileServer(str(root)) as fs:
        fs.root_dir = root
        yield fs


def _dfget(pkg: str, argv) -> int:
    return mod(pkg, "cmd.dfget").main([str(a) for a in argv])


def _digest_case(pkg, tmp, origin) -> list:
    data = b"digestme" * 100
    (origin.root_dir / "blob.bin").write_bytes(data)
    good = hashlib.sha256(data).hexdigest()
    out, bad = tmp / f"{pkg}-o.bin", tmp / f"{pkg}-o2.bin"
    rc_good = _dfget(pkg, [origin.url("blob.bin"), "-O", out,
                           "--digest", f"sha256:{good}"])
    rc_bad = _dfget(pkg, [origin.url("blob.bin"), "-O", bad,
                          "--digest", "md5:" + "0" * 32])
    return [rc_good, out.read_bytes() == data, rc_bad, bad.exists()]


def _offset_case(pkg, tmp, origin) -> list:
    data = bytes(range(256))
    (origin.root_dir / "blob.bin").write_bytes(data)
    out = tmp / f"{pkg}-whole.bin"
    rcs = [_dfget(pkg, [origin.url("blob.bin"), "-O", out, "--range", spec,
                        "--original-offset"])
           for spec in ("128-255", "0-127")]
    return [rcs, out.read_bytes() == data,
            sorted(p.name for p in tmp.glob(".df2-window-*"))]


def _list_case(pkg, tmp, origin, capsys) -> list:
    root = origin.root_dir / "dir"
    root.mkdir(exist_ok=True)
    for name, body in (("a.bin", b"a"), ("b.txt", b"b"), ("c.bin", b"c")):
        (root / name).write_bytes(body)
    capsys.readouterr()
    rc = _dfget(pkg, [f"file://{root}/", "-O", tmp / f"{pkg}-out",
                      "--recursive", "--list", "--accept-regex", r"\.bin$",
                      "--reject-regex", "c"])
    listed = capsys.readouterr().out.strip().splitlines()
    return [rc, [line.rsplit("/", 1)[-1] for line in listed]]


def _recursive_case(pkg, tmp, origin, capsys) -> list:
    root = origin.root_dir / "tree"
    (root / "sub").mkdir(parents=True, exist_ok=True)
    files = {"x.bin": b"x" * 1000, "sub/y.bin": b"y" * 3000}
    for rel, body in files.items():
        (root / rel).write_bytes(body)
    out = tmp / f"{pkg}-tree"
    rc = _dfget(pkg, [f"file://{root}/", "-O", out, "--recursive"])
    return [rc, {rel: (out / rel).read_bytes() == body
                 for rel, body in files.items()}]


@pytest.mark.parametrize("case", ["digest", "original_offset", "list",
                                  "recursive"])
def test_dfget_flags_as_jax(case, tmp_path, origin, capsys):
    run = {"digest": _digest_case, "original_offset": _offset_case,
           "list": _list_case, "recursive": _recursive_case}[case]
    args = (tmp_path, origin) + ((capsys,) if case in ("list", "recursive")
                                 else ())
    got = run("port", *args)
    assert got == run("jax", *args)
    want = {"digest": [0, True, 1, False],
            "original_offset": [[0, 0], True, []],
            "list": [0, ["a.bin"]],
            "recursive": [0, {"x.bin": True, "sub/y.bin": True}]}[case]
    assert got == want


@pytest.mark.parametrize("argv", [
    ["--original-offset"], ["--digest", "crc:1"], ["--list"],
    ["--range", "9"], ["--range", "0-9", "--recursive"],
    ["--priority", "7"],
])
def test_dfget_flag_preconditions_as_jax(argv, capsys):
    codes = []
    for pkg in ("port", "jax"):
        with pytest.raises(SystemExit) as info:
            _dfget(pkg, ["http://o/f", "-O", "/tmp/x", *argv])
        codes.append(info.value.code)
    assert codes == [2, 2]


@pytest.mark.parametrize("path", ["ephemeral", "daemon"])
def test_window_file_removed_when_download_raises(path, tmp_path, origin,
                                                   monkeypatch):
    """dfget's ``--original-offset`` window (``.df2-window-*``) does not
    outlive a download that raises — in the ephemeral peer and through a
    daemon — as in JAX."""
    (origin.root_dir / "blob.bin").write_bytes(b"x" * 64)
    out = tmp_path / "whole.bin"
    argv = [origin.url("blob.bin"), "-O", out, "--range", "0-31",
            "--original-offset"]
    for pkg in ("port", "jax"):
        if path == "ephemeral":
            def boom(self, *args, **kwargs):
                raise RuntimeError("simulated daemon crash")

            monkeypatch.setattr(mod(pkg, "client.daemon").Daemon,
                                "download_file", boom)
            rc = _dfget(pkg, argv)
        else:
            rc = _dfget(pkg, [*argv, "--daemon", "127.0.0.1:1"])
        assert rc == 1, pkg
        assert list(tmp_path.glob(".df2-window-*")) == [], pkg
        assert not out.exists()


def _live_daemon(pkg: str, root):
    """A daemon on an in-process scheduler, its surface served."""
    core = mod(pkg, "scheduler.scheduling.core")
    scheduler = mod(pkg, "scheduler.service").SchedulerService(
        resource=mod(pkg, "scheduler.resource.resource").Resource(),
        scheduling=core.Scheduling(
            mod(pkg, "scheduler.evaluator.base").BaseEvaluator(),
            core.SchedulingConfig(retry_interval=0.01,
                                  retry_back_to_source_limit=2)),
        storage=mod(pkg, "scheduler.storage.storage").Storage(
            str(root / "datasets")))
    d = mod(pkg, "client.daemon")
    daemon = d.Daemon(scheduler, d.DaemonConfig(
        storage_root=str(root / "daemon"), hostname="cli-daemon"))
    daemon.start()
    return daemon, mod(pkg, "client.rpcserver").serve_daemon_rpc(daemon)


def _dfcache_case(pkg: str, root, capsys) -> list:
    daemon, rpc = _live_daemon(pkg, root)
    main = mod(pkg, "cmd.dfcache").main
    payload = np.random.default_rng(7).bytes(3 * 1024 * 1024 + 41)
    src, out = root / "weights.bin", root / "roundtrip.bin"
    src.write_bytes(payload)
    steps = []
    try:
        capsys.readouterr()
        for argv in (["import", "ckpt-v1", "--path", src],
                     ["stat", "ckpt-v1"],
                     ["export", "ckpt-v1", "--path", out],
                     ["delete", "ckpt-v1"], ["stat", "ckpt-v1"],
                     ["export", "never-imported", "--path",
                      root / "x.bin"]):
            rc = main([str(a) for a in argv] + ["--daemon", rpc.target])
            printed = capsys.readouterr()
            steps.append((argv[0], rc, printed.out.strip(),
                          printed.err.strip()))
    finally:
        rpc.stop()
        daemon.stop()
    task_id = steps[0][2]
    stat = json.loads(steps[1][2])
    assert stat["taskId"] == task_id
    return [(name, rc, err) for name, rc, _, err in steps] + [
        stat["contentLength"], stat["totalPieces"],
        hashlib.md5(out.read_bytes()).hexdigest() ==
        hashlib.md5(payload).hexdigest(),
        (root / "x.bin").exists()]


def test_dfcache_round_trip_through_a_live_daemon_as_jax(tmp_path, capsys):
    got = []
    for pkg in ("port", "jax"):
        (tmp_path / pkg).mkdir()
        got.append(_dfcache_case(pkg, tmp_path / pkg, capsys))
    assert got[0] == got[1]
    assert [s[1] for s in got[0][:6]] == [0, 0, 0, 0, 1, 1]
    assert got[0][6] == 3 * 1024 * 1024 + 41
    assert got[0][8] is True and got[0][9] is False


def test_dfcache_offline_storage_dir_as_jax(tmp_path, capsys):
    got = []
    for pkg in ("port", "jax"):
        main = mod(pkg, "cmd.dfcache").main
        root = tmp_path / pkg
        root.mkdir()
        src = root / "in.bin"
        src.write_bytes(b"offline" * 1000)
        store = ["--storage-dir", str(root / "store")]
        rcs = [main(["import", "k", "--path", str(src), *store]),
               main(["export", "k", "--path", str(root / "out.bin"),
                     *store]),
               main(["delete", "k", *store]), main(["stat", "k", *store])]
        capsys.readouterr()
        got.append((rcs, (root / "out.bin").read_bytes() == src.read_bytes()))
    assert got[0] == got[1] == ([0, 0, 0, 1], True)


def test_dfget_through_a_daemon_as_jax(tmp_path, capsys):
    """``dfget --daemon``: the first invocation goes through the mesh,
    the second is served from the daemon's cache."""
    got = []
    for pkg in ("port", "jax"):
        root = tmp_path / pkg
        (root / "origin").mkdir(parents=True)
        data = np.random.default_rng(8).bytes(2 * 1024 * 1024 + 3)
        (root / "origin" / "m.bin").write_bytes(data)
        daemon, rpc = _live_daemon(pkg, root)
        try:
            with FileServer(str(root / "origin")) as fs:
                lines = []
                for i in (1, 2):
                    rc = _dfget(pkg, [fs.url("m.bin"), "-O",
                                      root / f"m{i}.bin", "--daemon",
                                      rpc.target])
                    printed = capsys.readouterr().out.strip()
                    lines.append((rc, printed.split(" via daemon ")[1]
                                  .split(" ")[0],
                                  (root / f"m{i}.bin").read_bytes() == data))
        finally:
            rpc.stop()
            daemon.stop()
        got.append(lines)
    assert got[0] == got[1] == [(0, "mesh", True), (0, "cache", True)]


# -- /metrics on every entry point, and the scheduler's job worker ----------

def _port_scheduler_wire(root):
    """The port's scheduler served over its wire in this process."""
    from dragonfly2_tpu_torch.rpc import serve
    from dragonfly2_tpu_torch.scheduler.rpcserver import (
        SCHEDULER_SPEC,
        SchedulerRpcService,
    )
    from tests.test_torch_p2p import port_scheduler

    return serve([(SCHEDULER_SPEC, SchedulerRpcService(
        port_scheduler(root)))])


def _port_manager_internal(root):
    """The port's manager with its job plane, its internal surface served
    in this process."""
    from dragonfly2_tpu_torch.manager import (
        Database,
        FilesystemObjectStore,
        ManagerService,
    )
    from dragonfly2_tpu_torch.manager.jobplane import DurableJobStore
    from dragonfly2_tpu_torch.manager.rest import ManagerHTTPServer, RestApi

    db = Database()
    api = RestApi(ManagerService(db, FilesystemObjectStore(
        str(root / "objects"))), jobstore=DurableJobStore(db))
    http = ManagerHTTPServer(api, host="127.0.0.1", port=0,
                             surface="internal")
    http.start()
    return http


#: entry point → (argv after the common ones, the family its /metrics
#: must carry, the helper server it needs)
ENTRY_POINTS = {
    "cmd.scheduler": (["--host", "127.0.0.1", "--data-dir", "{root}/s",
                       "--advertise-ip", "127.0.0.1",
                       "--job-poll-interval", "0.1", "--port", "{free}",
                       "--manager", "{manager}"],
                      "dragonfly_scheduler_resource_hosts", "manager"),
    "cmd.manager": (["--host", "127.0.0.1", "--port", "0",
                     "--internal-port", "0", "--db", "{root}/m.db",
                     "--object-store-dir", "{root}/objects"],
                    "dragonfly_manager_version", None),
    "cmd.trainer": (["--host", "127.0.0.1", "--port", "0", "--device",
                     "cpu", "--data-dir", "{root}/t"],
                    "dragonfly_trainer_version", None),
    "cmd.inference": (["--host", "127.0.0.1", "--port", "0", "--device",
                       "cpu", "--manager-db", "{root}/m.db",
                       "--object-store-dir", "{root}/objects"],
                      "df2_process_threads", None),
    "cmd.dfdaemon": (["--scheduler", "{scheduler}", "--rpc-port", "0",
                      "--storage-dir", "{root}/d", "--hostname", "cli-d"],
                     "dragonfly_dfdaemon_version", "scheduler"),
}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _get_metrics(port: int, timeout_s: float = 60.0) -> str:
    import time
    import urllib.request

    deadline = time.monotonic() + timeout_s
    while True:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=5) as resp:
                return resp.read().decode()
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


@pytest.mark.parametrize("command", list(ENTRY_POINTS))
def test_entry_point_serves_metrics(command, tmp_path, monkeypatch, capsys):
    """``main`` in a thread of this process with its shutdown wait on an
    event: ``--metrics-port`` serves the command's own families and the
    debug-vars bridge; ``cmd.scheduler --manager`` prints the job
    worker's queues, its registered row's among them."""
    import threading

    argv, family, helper = ENTRY_POINTS[command]
    stop = threading.Event()
    module = mod("port", command)
    monkeypatch.setattr(module, "wait_for_shutdown",
                        lambda event=None: stop.wait())
    if hasattr(module, "install_shutdown_handlers"):
        monkeypatch.setattr(module, "install_shutdown_handlers",
                            lambda: stop)
    server = None
    fill = {"root": str(tmp_path), "free": str(_free_port())}
    if helper == "manager":
        server = _port_manager_internal(tmp_path)
        fill["manager"] = f"127.0.0.1:{server.port}"
    elif helper == "scheduler":
        server = _port_scheduler_wire(tmp_path)
        fill["scheduler"] = server.target
    metrics_port = _free_port()
    args = [a.format(**fill) for a in argv] + [
        "--metrics-port", str(metrics_port)]
    box = {}
    thread = threading.Thread(
        target=lambda: box.update(rc=module.main(args)), daemon=True)
    thread.start()
    try:
        text = _get_metrics(metrics_port)
    finally:
        stop.set()
        thread.join(timeout=60)
        if server is not None:
            server.stop()
    out = capsys.readouterr().out
    assert box.get("rc") == 0 and not thread.is_alive()
    assert f"metrics on 0.0.0.0:{metrics_port}/metrics" in out
    assert f"\n{family}" in text and "# TYPE df2_process_threads gauge" in text
    if command == "cmd.scheduler":
        assert ("job worker polling queues ['global', 'schedulers', "
                "'scheduler_1']") in out
