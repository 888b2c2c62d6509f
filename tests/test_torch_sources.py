"""Port parity for the back-to-source clients of the cloud stores and
registries: ``dragonfly2_tpu_torch/client/source_{signedhttp,s3,oss,
hdfs,oras}.py`` and ``utils/registryauth.py`` against the JAX package's.

Each client runs one transcript of calls — content length, range
support, whole and ranged downloads, last-modified, expiry, listing, a
missing object and refused credentials — against the JAX package's own
fakes: ``tests/fake_s3.py`` (SigV4 checked), ``tests/test_oss_obs.py``'s
``_FakeGateway`` (OSS signatures checked), ``tests/test_source_hdfs.py``'s
WebHDFS namenode (here behind simple auth) and ``tests/test_jobplane.py``'s
``PrivateRegistry`` (the Bearer-token dance). Every status, byte and error
(class name and message) must be equal. Then ``s3://`` end to end: a
download through each package's daemon and ``download_to_hbm`` on the
CPU, whose bytes, tensors and scheduler records must be equal.
Tolerance: none; these are bytes.
"""

from __future__ import annotations

import hashlib
import threading
import urllib.parse
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from dragonfly2_tpu.client import piece as jpiece
from dragonfly2_tpu.client import source as jsource
from dragonfly2_tpu.client import source_hdfs as jhdfs
from dragonfly2_tpu.client import source_oras as joras
from dragonfly2_tpu.client import source_oss as joss
from dragonfly2_tpu.client import source_s3 as js3
from dragonfly2_tpu.client import source_signedhttp as jsigned
from dragonfly2_tpu_torch.client import piece as ppiece
from dragonfly2_tpu_torch.client import source as psource
from dragonfly2_tpu_torch.client import source_hdfs as phdfs
from dragonfly2_tpu_torch.client import source_oras as poras
from dragonfly2_tpu_torch.client import source_oss as poss
from dragonfly2_tpu_torch.client import source_s3 as ps3
from dragonfly2_tpu_torch.client import source_signedhttp as psigned
from dragonfly2_tpu_torch.manager.objectstore import S3ObjectStore
from tests.fake_s3 import FakeS3
from tests.test_jobplane import PrivateRegistry
from tests.test_oss_obs import _FakeGateway, _serve
from tests.test_preheat import write_registry
from tests.test_source_hdfs import _FakeWebHDFS

PACKAGES = {
    "jax": dict(source=jsource, piece=jpiece, s3=js3, oss=joss,
                hdfs=jhdfs, oras=joras, signed=jsigned),
    "port": dict(source=psource, piece=ppiece, s3=ps3, oss=poss,
                 hdfs=phdfs, oras=poras, signed=psigned),
}


def transcript(pkg: dict, client, ops) -> list:
    """Each op's result, or its error as (class name, message); a
    download as (status, content length, sha256 of the body)."""
    Request, Range = pkg["source"].Request, pkg["piece"].Range
    out = []
    for op, url, *args in ops:
        try:
            if op == "download":
                rng = (Range(start=args[0], length=args[1])
                       if args else None)
                resp = client.download(Request(url, rng=rng))
                try:
                    body = resp.body.read()
                finally:
                    resp.close()
                out.append((resp.status, resp.content_length,
                            hashlib.sha256(body).hexdigest()))
            elif op == "length":
                out.append(client.get_content_length(Request(url)))
            elif op == "range":
                out.append(client.is_support_range(Request(url)))
            elif op == "modified":
                out.append(client.get_last_modified(Request(url)))
            elif op == "expired":
                out.append(client.is_expired(Request(url), *args))
            elif op == "list":
                out.append(client.list(Request(url)))
        except Exception as exc:  # noqa: BLE001 — compared across packages
            out.append(("err", type(exc).__name__, str(exc)))
    return out


def object_ops(scheme: str, bucket: str, key: str, size: int) -> list:
    url = f"{scheme}://{bucket}/{key}"
    return [("length", url), ("range", url), ("download", url),
            ("download", url, 0, 1), ("download", url, 100, 1000),
            ("download", url, size - 7, 7), ("modified", url),
            ("expired", url, "", ""),
            ("expired", url, "Mon, 01 Jan 2024 00:00:00 GMT", ""),
            ("expired", url, "", '"deadbeef"'),
            ("list", f"{scheme}://{bucket}/dir"),
            ("length", f"{scheme}://{bucket}/missing"),
            ("download", f"{scheme}://{bucket}/missing"),
            ("download", f"{scheme}://nobucket/{key}"),
            ("length", f"{scheme}://{bucket}")]


def payload(size: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size, dtype=np.uint8).tobytes()


class TestS3Source:
    def test_transcript_equals_jax(self):
        data = payload(300_001, 0)
        got = {}
        with FakeS3(access_key="AK", secret_key="SK") as fake:
            store = S3ObjectStore(access_key="AK", secret_key="SK",
                                  endpoint_url=fake.endpoint)
            store.create_bucket("src")
            store.put_object("src", "dir/blob one+.bin", data)
            store.put_object("src", "dir/sub/b.bin", b"b" * 10)
            store.put_object("src", "directory/no.bin", b"n")
            for name, pkg in PACKAGES.items():
                ok = pkg["s3"].S3SourceClient(pkg["s3"].S3Config(
                    access_key="AK", secret_key="SK",
                    endpoint_url=fake.endpoint))
                bad = pkg["s3"].S3SourceClient(pkg["s3"].S3Config(
                    access_key="AK", secret_key="WRONG",
                    endpoint_url=fake.endpoint))
                quoted = urllib.parse.quote("dir/blob one+.bin")
                got[name] = (
                    transcript(pkg, ok, object_ops("s3", "src", quoted,
                                                   len(data)))
                    + transcript(pkg, bad, object_ops("s3", "src", quoted,
                                                      len(data))[:3]))
        assert got["port"] == got["jax"]
        whole = got["port"][2]
        assert whole == (200, len(data), hashlib.sha256(data).hexdigest())
        assert got["port"][4][0] == 206
        assert got["port"][-3][0] == "err" and "403" in got["port"][-3][2]


class TestOSSSource:
    def test_transcript_equals_jax(self):
        data = payload(70_000, 1)
        server, url = _serve(_FakeGateway)
        got = {}
        try:
            for name, pkg in PACKAGES.items():
                _FakeGateway.store.clear()
                _FakeGateway.store["models"] = {
                    "dir/w.bin": data, "dir/sub/x.bin": b"x" * 3,
                    "directory/n.bin": b"n"}
                ok = pkg["oss"].OSSSourceClient(pkg["oss"].OSSConfig(
                    access_key="LTAItest", secret_key="oss-secret-key",
                    endpoint_url=url))
                bad = pkg["oss"].OSSSourceClient(pkg["oss"].OSSConfig(
                    access_key="LTAItest", secret_key="wrong",
                    endpoint_url=url))
                ops = object_ops("oss", "models", "dir/w.bin", len(data))
                got[name] = (transcript(pkg, ok, ops)
                             + transcript(pkg, bad, ops[:3]))
        finally:
            server.shutdown()
        assert got["port"] == got["jax"]
        assert got["port"][2] == (200, len(data),
                                  hashlib.sha256(data).hexdigest())
        assert got["port"][-3][0] == "err" and "403" in got["port"][-3][2]


class _AuthWebHDFS(_FakeWebHDFS):
    """The fake namenode behind simple auth: ``user.name=df2`` or 401."""

    def do_GET(self):  # noqa: N802
        query = dict(urllib.parse.parse_qsl(
            urllib.parse.urlparse(self.path).query))
        if query.get("user.name") != "df2":
            return self.send_error(401, "user.name required")
        return super().do_GET()


class TestHDFSSource:
    def test_transcript_equals_jax(self):
        server = ThreadingHTTPServer(("127.0.0.1", 0), _AuthWebHDFS)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        nn = f"127.0.0.1:{server.server_address[1]}"
        url = f"hdfs://{nn}/data/readme.txt"
        ops = [("length", url), ("range", url), ("download", url),
               ("download", url, 6, 4), ("download", url, 0, 1),
               ("modified", url), ("expired", url, "", ""),
               ("expired", url, "Tue, 14 Nov 2023 22:13:20 GMT", ""),
               ("expired", url, "Tue, 14 Nov 2023 22:12:20 GMT", ""),
               ("list", f"hdfs://{nn}/data/train"),
               ("length", f"hdfs://{nn}/data/nope.bin"),
               ("download", f"hdfs://{nn}/data/nope.bin"),
               ("list", f"hdfs://{nn}/nowhere")]
        got = {}
        try:
            for name, pkg in PACKAGES.items():
                ok = pkg["hdfs"].HDFSSourceClient(
                    pkg["hdfs"].HDFSConfig(user="df2"))
                bad = pkg["hdfs"].HDFSSourceClient(
                    pkg["hdfs"].HDFSConfig(user="mallory"))
                got[name] = (transcript(pkg, ok, ops)
                             + transcript(pkg, bad, ops[:3]))
        finally:
            server.shutdown()
        assert got["port"] == got["jax"]
        assert got["port"][3] == (206, 4, hashlib.sha256(b"hdfs").hexdigest())
        assert got["port"][-1][0] == "err" and "401" in got["port"][-1][2]


class TestORASSource:
    def test_transcript_equals_jax(self, tmp_path):
        data = payload(512 * 1024 + 99, 2)
        digest = "sha256:" + hashlib.sha256(data).hexdigest()
        name = write_registry(tmp_path, {digest: data})
        reg = PrivateRegistry(str(tmp_path))
        url = f"oras://127.0.0.1:{reg.port}/{name}:latest"
        ops = [("length", url), ("range", url), ("download", url),
               ("download", url, 100, 200), ("download", url, 0, 1),
               ("expired", url, "", ""), ("modified", url),
               ("length", f"oras://127.0.0.1:{reg.port}/{name}:v9"),
               ("download", f"oras://127.0.0.1:{reg.port}/other/app"),
               ("length", f"oras://127.0.0.1:{reg.port}")]
        got = {}
        try:
            for pkg_name, pkg in PACKAGES.items():
                cfg = pkg["oras"].ORASConfig
                ok = pkg["oras"].ORASSourceClient(cfg(
                    username=reg.USER, password=reg.PASSWORD,
                    plain_http=True))
                bad = pkg["oras"].ORASSourceClient(cfg(
                    username=reg.USER, password="nope", plain_http=True))
                got[pkg_name] = (transcript(pkg, ok, ops)
                                 + transcript(pkg, bad, ops[:3]))
            reg.support_range = False
            for pkg_name, pkg in PACKAGES.items():
                client = pkg["oras"].ORASSourceClient(pkg["oras"].ORASConfig(
                    username=reg.USER, password=reg.PASSWORD,
                    plain_http=True))
                got[pkg_name] += transcript(pkg, client,
                                            [("download", url, 100, 200)])
        finally:
            reg.close()
        assert got["port"] == got["jax"]
        assert got["port"][2] == (200, len(data),
                                  hashlib.sha256(data).hexdigest())
        assert got["port"][3][0] == 206
        assert got["port"][-1][0] == "err"
        assert "ignored Range" in got["port"][-1][2]


def test_register_env_sources_equals_jax(monkeypatch):
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "ak")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "sk")
    monkeypatch.setenv("AWS_ENDPOINT_URL", "http://127.0.0.1:9")
    monkeypatch.setenv("OSS_ACCESS_KEY_ID", "oak")
    monkeypatch.setenv("DF2_HDFS_USER", "df2")
    views = {}
    for name, pkg in PACKAGES.items():
        clients = pkg["source"]._registry._clients
        saved = dict(clients)
        try:
            pkg["signed"].register_env_sources()
            views[name] = {scheme: (type(c).__name__,
                                    repr(getattr(c, "config", None)))
                           for scheme, c in clients.items()}
        finally:
            clients.clear()
            clients.update(saved)
    assert views["port"] == views["jax"]
    assert {"s3", "oss", "hdfs", "oras"} <= set(views["port"])


# -- s3:// end to end --------------------------------------------------------

@pytest.fixture()
def s3_registered():
    """FakeS3 with each package's s3 scheme registered against it."""
    with FakeS3(access_key="AK", secret_key="SK") as fake:
        for pkg in PACKAGES.values():
            pkg["s3"].register_s3(pkg["s3"].S3Config(
                access_key="AK", secret_key="SK",
                endpoint_url=fake.endpoint))
        try:
            yield fake, S3ObjectStore(access_key="AK", secret_key="SK",
                                      endpoint_url=fake.endpoint)
        finally:
            for pkg in PACKAGES.values():
                pkg["source"].unregister("s3")


def test_s3_download_through_daemons_equals_jax(tmp_path, s3_registered):
    from tests.test_torch_p2p import Mesh

    _, store = s3_registered
    data = payload(2 * 1024 * 1024 + 7, 3)
    store.create_bucket("artifacts")
    store.put_object("artifacts", "big/model.safetensors", data)
    got, records = {}, {}
    for name in PACKAGES:
        with Mesh(name, tmp_path / name, seed=True) as mesh:
            result = mesh.daemon("s3-peer").download_file(
                "s3://artifacts/big/model.safetensors")
            assert result.success, result.error
            got[name] = result.read_all()
            records[name] = mesh.records()
    assert got["port"] == got["jax"] == data
    assert records["port"] == records["jax"]
    peer = [r for r in records["port"] if r["host"]["hostname"] == "s3-peer"]
    assert peer[-1]["parents"], "the seed served the peer"


def test_s3_download_to_hbm_on_cpu_equals_jax(tmp_path, s3_registered):
    from dragonfly2_tpu.client import hbm_sink as jsink
    from tests.test_torch_hbm_sink import (
        assert_same,
        assert_same_as_jax,
        make_tensors,
    )
    from tests.test_torch_p2p import SINKS, Mesh

    _, store = s3_registered
    tensors = make_tensors(seed=11)
    path = tmp_path / "m.safetensors"
    jsink.write_safetensors(str(path), tensors)
    store.create_bucket("models")
    store.put_object("models", "layer0.safetensors", path.read_bytes())
    url = "s3://models/layer0.safetensors"
    got, records = {}, {}
    for name, (sink, kwargs) in SINKS.items():
        with Mesh(name, tmp_path / name, seed=True) as mesh:
            got[name] = sink.download_to_hbm(mesh.daemon("peer-hbm"), url,
                                             timeout=120, **kwargs)
            records[name] = mesh.records()
    assert_same_as_jax(got["port"], got["jax"])
    assert_same(got["port"], tensors)
    assert all(t.device.type == "cpu" for t in got["port"].values())
    assert records["port"] == records["jax"]
