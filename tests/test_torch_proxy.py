"""Port parity for the daemon's edge: ``dragonfly2_tpu_torch/client/
proxy.py`` (the rule ladder, the registry mirror, the CONNECT tunnel and
the whitelist), ``client/objectstorage_gateway.py`` and ``cmd/dfstore.py``
against the JAX package's.

The rule ladder's decision and final URL are compared over a seeded
table of URLs, methods and rule sets (``use_https``, host and regex
``redirect``, ``direct``, non-GET, mirror mode, hijacked hosts), and the
whitelist's verdicts over a table of hosts and ports. The mirror, the
gateway and the CLI run end to end through each package's in-process
mesh (``tests/test_torch_p2p.py``'s ``Mesh``): bytes, status codes and
the scheduler's records must be equal. Tolerance: none.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import socket
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from dragonfly2_tpu.client import objectstorage_gateway as jgw
from dragonfly2_tpu.client import proxy as jproxy
from dragonfly2_tpu.manager import objectstore as jstore
from dragonfly2_tpu_torch.client import objectstorage_gateway as pgw
from dragonfly2_tpu_torch.client import proxy as pproxy
from dragonfly2_tpu_torch.manager import objectstore as pstore
from tests.fileserver import FileServer
from tests.test_preheat import write_registry
from tests.test_torch_p2p import Mesh

PROXIES = {"jax": jproxy, "port": pproxy}
GATEWAYS = {"jax": (jgw, jstore), "port": (pgw, pstore)}


def proxy_open(proxy_addr: str, url: str, method: str = "GET",
               headers: dict | None = None, data: bytes | None = None):
    req = urllib.request.Request(url, method=method, headers=headers or {},
                                 data=data)
    req.set_proxy(proxy_addr, "http")
    return urllib.request.urlopen(req, timeout=30)


# -- the rule ladder -------------------------------------------------------

RULE_POOL = [
    dict(regx=r"blobs/sha256.*"),
    dict(regx=r"\.bin$", use_https=True),
    dict(regx=r"^http://old/(.*)$", redirect=r"http://new/prefix/\1"),
    dict(regx=r"example\.com", redirect="mirror.example.com"),
    dict(regx=r"/direct/", direct=True),
    dict(regx=r"manifests", direct=True, use_https=True),
    dict(regx=r".*"),
]
URL_POOL = [
    "http://reg/v2/x/blobs/sha256:abc", "http://reg/v2/x/manifests/latest",
    "http://old/file.bin", "http://example.com/a/b.bin",
    "http://host:8080/direct/x.bin", "https://secure/blobs/sha256:f",
    "/v2/library/app/blobs/sha256:" + "c" * 64,
    "/v2/library/app/manifests/latest", "/other/path",
]


def ladder_cases(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(n):
        rules = [RULE_POOL[i] for i in rng.choice(
            len(RULE_POOL), int(rng.integers(0, 4)), replace=False)]
        mirror = (None if rng.random() < 0.5 else
                  dict(remote="https://index.docker.io",
                       direct=bool(rng.random() < 0.3)))
        cases.append(dict(
            rules=rules, mirror=mirror,
            path=URL_POOL[rng.integers(len(URL_POOL))],
            method=["GET", "GET", "HEAD", "POST"][rng.integers(4)],
            hijacked=("" if rng.random() < 0.8 else "registry.example:443")))
    return cases


def decide(mod, case: dict) -> tuple:
    cfg = mod.ProxyConfig(
        rules=[mod.ProxyRule(**r) for r in case["rules"]],
        registry_mirror=(mod.RegistryMirror(**case["mirror"])
                         if case["mirror"] else None))
    req = types.SimpleNamespace(path=case["path"], command=case["method"],
                                headers={"Host": "origin.example:80"})
    if case["hijacked"]:
        req.hijacked_host = case["hijacked"]
    url = mod.ProxyServer._target_url(None, req, cfg)
    return (url, *mod.ProxyServer._should_use_p2p(None, req, url, cfg))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rule_ladder_equals_jax(seed):
    decisions = {name: [decide(mod, c) for c in ladder_cases(seed, 200)]
                 for name, mod in PROXIES.items()}
    assert decisions["port"] == decisions["jax"]
    kinds = {use for _, use, _ in decisions["port"]}
    assert kinds == {True, False}


def test_rule_rewrites_equal_jax():
    urls = URL_POOL + ["http://old/a/b?c=d", "http://EXAMPLE.com/x"]
    got = {name: [(r["regx"], u, mod.ProxyRule(**r).match(u),
                   mod.ProxyRule(**r).rewrite(u))
                  for r in RULE_POOL for u in urls]
           for name, mod in PROXIES.items()}
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("entry", [
    dict(host=r"127\.0\.0\.1"), dict(host=r"Registry\.Example"),
    dict(host="", ports=["8080"]), dict(host=r"foo\.example",
                                        ports=["80", "443"]),
    dict(host="::1"), dict()])
def test_whitelist_verdicts_equal_jax(entry):
    targets = [(h, p) for h in ("127.0.0.1", "registry.example",
                                "REGISTRY.EXAMPLE", "foo.example", "::1",
                                "other.example")
               for p in (80, 443, 8080)]
    got = {name: [mod.WhiteListEntry(**entry).allows(h, p)
                  for h, p in targets] for name, mod in PROXIES.items()}
    assert got["port"] == got["jax"]


class _FakeConnectReq:
    """Enough of BaseHTTPRequestHandler for ``_tunnel``."""

    def __init__(self, path):
        self.path = path
        self.headers = {}
        self.responses = []

    def send_error(self, code, message=None):
        self.responses.append(code)

    def send_response(self, code, message=None):
        self.responses.append(code)

    def end_headers(self):
        pass


@pytest.mark.parametrize("path, whitelist, dialed, responses", [
    ("[::1]:443", [{"host": "::1"}], [("::1", 443)], [503]),
    ("[::1]:443", [{"host": r"allowed\.example"}], [], [403]),
    ("Allowed.Example:8443", [{"host": r"allowed\.example"}],
     [("Allowed.Example", 8443)], [503]),
    ("host:notaport", [], [], [400]),
])
def test_connect_target_and_whitelist(path, whitelist, dialed, responses,
                                      monkeypatch):
    """``tests/test_proxy_gateway_cli.py``'s CONNECT cases on the port:
    the IPv6 literal is dialed unbracketed, the whitelist refuses before
    any dial, matching ignores case, a bad port is a 400."""
    calls = []

    def fake_create_connection(addr, timeout=None):
        calls.append(addr)
        raise OSError("no upstream")

    monkeypatch.setattr(socket, "create_connection", fake_create_connection)
    proxy = pproxy.ProxyServer(None, pproxy.ProxyConfig(
        whitelist=[pproxy.WhiteListEntry(**w) for w in whitelist]))
    req = _FakeConnectReq(path)
    try:
        proxy._tunnel(req)
    finally:
        proxy._server.server_close()
    assert calls == dialed
    assert req.responses == responses


# -- end to end through the mesh ----------------------------------------------

@pytest.fixture()
def registry_origin(tmp_path):
    content = np.random.default_rng(4).integers(
        0, 256, 2 * 1024 * 1024 + 5, dtype=np.uint8).tobytes()
    digest = "sha256:" + hashlib.sha256(content).hexdigest()
    root = tmp_path / "registry"
    root.mkdir()
    name = write_registry(root, {digest: content})
    with FileServer(str(root)) as fs:
        yield fs, name, digest, content


def test_registry_mirror_through_two_daemons_equals_jax(tmp_path,
                                                         registry_origin):
    """A blob pulled through the mirror of daemon A, then of daemon B:
    both carry the task header and the digest's bytes, B's pull never
    reaches the origin, the manifest goes direct, and a ``direct`` rule
    sends an absolute-form request around the mesh."""
    fs, name, digest, content = registry_origin
    origin = f"http://127.0.0.1:{fs.port}"
    seen, records = {}, {}
    for pkg, mod in PROXIES.items():
        with Mesh(pkg, tmp_path / pkg) as mesh:
            proxies = []
            try:
                for host in ("mirror-a", "mirror-b"):
                    proxies.append(mod.ProxyServer(
                        mesh.daemon(host), mod.ProxyConfig(
                            registry_mirror=mod.RegistryMirror(
                                remote=origin),
                            rules=[mod.ProxyRule(regx=r"blobs/sha256",
                                                 direct=True)])))
                    proxies[-1].start()
                out = []
                for i, proxy in enumerate(proxies):
                    fs.reset_counters()
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{proxy.port}/v2/{name}"
                            f"/blobs/{digest}", timeout=60) as resp:
                        body = resp.read()
                        task = resp.headers.get(pproxy.HEADER_TASK_ID)
                    out.append((hashlib.sha256(body).hexdigest(),
                                bool(task), fs.request_count > 0))
                fs.reset_counters()
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{proxies[0].port}/v2/{name}"
                        "/manifests/latest", timeout=30) as resp:
                    out.append(("manifest", resp.status,
                                resp.headers.get(pproxy.HEADER_TASK_ID),
                                fs.request_count))
                fs.reset_counters()
                with proxy_open(f"127.0.0.1:{proxies[1].port}",
                                f"{origin}/v2/{name}/blobs/{digest}") as resp:
                    out.append(("direct", hashlib.sha256(
                        resp.read()).hexdigest(),
                        resp.headers.get(pproxy.HEADER_TASK_ID),
                        fs.request_count))
                seen[pkg] = out
                records[pkg] = mesh.records()
            finally:
                for proxy in proxies:
                    proxy.stop()
    assert seen["port"] == seen["jax"]
    want = hashlib.sha256(content).hexdigest()
    assert seen["port"][:2] == [(want, True, True), (want, True, False)]
    assert seen["port"][3] == ("direct", want, None, 1)
    assert records["port"] == records["jax"]
    b = [r for r in records["port"] if r["host"]["hostname"] == "mirror-b"]
    assert [p[0] for p in b[-1]["parents"]] == ["mirror-a"]


def test_connect_passthrough_carries_bytes_both_ways(tmp_path):
    echo = socket.socket()
    echo.bind(("127.0.0.1", 0))
    echo.listen(1)

    def serve():
        conn, _ = echo.accept()
        with conn:
            while data := conn.recv(65536):
                conn.sendall(data[::-1])

    threading.Thread(target=serve, daemon=True).start()
    proxy = pproxy.ProxyServer(None, pproxy.ProxyConfig(
        whitelist=[pproxy.WhiteListEntry(host=r"127\.0\.0\.1")]))
    proxy.start()
    try:
        target = f"127.0.0.1:{echo.getsockname()[1]}"
        raw = socket.create_connection(("127.0.0.1", proxy.port), timeout=30)
        raw.sendall(f"CONNECT {target} HTTP/1.1\r\nHost: {target}\r\n\r\n"
                    .encode())
        head = b""
        while b"\r\n\r\n" not in head:
            head += raw.recv(1)
        assert head.split()[1] == b"200"
        sent = np.random.default_rng(5).bytes(1 << 16)
        raw.sendall(sent)
        got = b""
        while len(got) < len(sent):
            got += raw.recv(65536)
        assert got == sent[::-1]
        raw.close()
        # A host outside the whitelist is refused with 403.
        with pytest.raises(urllib.error.HTTPError) as err:
            proxy_open(f"127.0.0.1:{proxy.port}", "http://example.org/x")
        assert err.value.code == 403
    finally:
        proxy.stop()
        echo.close()


# -- the object-storage gateway and df2-store --------------------------------

def gateway_script(pkg: str, mesh, root) -> list:
    gw_mod, store_mod = GATEWAYS[pkg]
    # One path for both packages' runs (emptied between them), so the
    # objects' file:// URLs, and with them the records, compare.
    shutil.rmtree(root / "objects", ignore_errors=True)
    backend = store_mod.FilesystemObjectStore(str(root / "objects"))
    gateways = [gw_mod.ObjectStorageGateway(mesh.daemon(h), backend)
                for h in ("gw-a", "gw-b")]
    for gw in gateways:
        gw.start()
    a, b = (gw_mod.DfstoreClient(f"http://127.0.0.1:{gw.port}")
            for gw in gateways)
    payload = np.random.default_rng(6).bytes(3 * 1024 * 1024 + 11)
    out = []

    def call(fn, *args):
        try:
            result = fn(*args)
            out.append(hashlib.sha256(result).hexdigest()
                       if isinstance(result, bytes) else result)
        except urllib.error.HTTPError as exc:
            out.append(("http", exc.code))

    try:
        call(a.put_object, "models", "llama/w.bin", payload)
        call(a.is_object_exist, "models", "llama/w.bin")
        call(a.get_object, "models", "llama/w.bin")
        call(b.get_object, "models", "llama/w.bin")
        call(b.is_object_exist, "models", "missing")
        call(b.get_object, "models", "missing")
        call(a.copy_object, "models", "llama/w.bin", "llama/w2.bin")
        call(b.get_object, "models", "llama/w2.bin")
        call(a.put_object, "models", "llama/w.bin", b"version-2!")
        call(b.get_object, "models", "llama/w.bin")
        call(a.delete_object, "models", "llama/w.bin")
        call(a.delete_object, "models", "llama/w.bin")
        call(a.is_object_exist, "models", "llama/w.bin")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{gateways[0].port}/nothing") as resp:
            out.append(resp.status)
    except urllib.error.HTTPError as exc:
        out.append(("http", exc.code))
    finally:
        for gw in gateways:
            gw.stop()
    return out


def test_gateway_equals_jax(tmp_path):
    got, records = {}, {}
    for pkg in GATEWAYS:
        with Mesh(pkg, tmp_path / pkg) as mesh:
            got[pkg] = gateway_script(pkg, mesh, tmp_path)
            records[pkg] = mesh.records()
    assert got["port"] == got["jax"]
    assert got["port"][5] == ("http", 404) and got["port"][-1] == ("http", 404)
    assert got["port"][9] == hashlib.sha256(b"version-2!").hexdigest()
    assert records["port"] == records["jax"]
    b = [r for r in records["port"] if r["host"]["hostname"] == "gw-b"]
    # B's first GET rode the mesh from A; the overwritten object is a new
    # task (its version tag changed) at the same file:// URL.
    assert [p[0] for p in b[0]["parents"]] == ["gw-a"]
    w = [r["task"]["content_length"] for r in b
         if r["task"]["url"].endswith("/llama/w.bin")]
    assert w == [3 * 1024 * 1024 + 11, len(b"version-2!")]


def test_dfstore_cli(tmp_path, capsysbinary):
    from dragonfly2_tpu_torch.cmd.dfstore import main

    with Mesh("port", tmp_path / "port") as mesh:
        gw = pgw.ObjectStorageGateway(
            mesh.daemon("cli-gw"),
            pstore.FilesystemObjectStore(str(tmp_path / "objects")))
        gw.start()
        try:
            ep = ["--endpoint", f"http://127.0.0.1:{gw.port}"]
            src = tmp_path / "in.bin"
            src.write_bytes(os.urandom(50_000))
            assert main(["put", "b", "k", "--path", str(src), *ep]) == 0
            assert main(["exist", "b", "k", *ep]) == 0
            out = tmp_path / "out.bin"
            assert main(["get", "b", "k", "--path", str(out), *ep]) == 0
            assert out.read_bytes() == src.read_bytes()
            assert main(["copy", "b", "k", "--dest-key", "k2", *ep]) == 0
            capsysbinary.readouterr()
            assert main(["get", "b", "k2", *ep]) == 0
            assert capsysbinary.readouterr().out == src.read_bytes()
            assert main(["delete", "b", "k", *ep]) == 0
            assert main(["exist", "b", "k", *ep]) == 1
        finally:
            gw.stop()
