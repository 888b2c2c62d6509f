"""HTTPS interception on the port: ``dragonfly2_tpu_torch/client/proxy.py``'s
CONNECT hijack and SNI listener with ``utils/certs.py``'s local CA —
``tests/test_proxy_https.py``'s cases, run through the port's proxy and
in-process mesh. An HTTPS pull through the hijack must traverse the mesh
(the task header, the scheduler's record, the exact bytes); passthrough
stays the default; the port's CA and the JAX package's read each other's
files. ``cryptography`` is needed only here, as in the JAX package.
"""

from __future__ import annotations

import base64
import os
import socket
import ssl

import pytest

pytest.importorskip("cryptography", reason="HTTPS interception needs the "
                    "optional cryptography package")

from dragonfly2_tpu.utils import certs as jax_certs  # noqa: E402
from dragonfly2_tpu_torch.client.proxy import (  # noqa: E402
    HEADER_TASK_ID,
    ProxyConfig,
    ProxyRule,
    ProxyServer,
    SNIProxyServer,
)
from dragonfly2_tpu_torch.utils.certs import CertAuthority  # noqa: E402
from tests.test_proxy_https import (  # noqa: E402,F401 — fixtures
    _read_http_response,
    _read_http_response_headers_only,
    https_origin,
    origin_ca,
)
from tests.test_torch_p2p import port_daemon, port_scheduler  # noqa: E402


@pytest.fixture()
def mesh(tmp_path):
    scheduler = port_scheduler(tmp_path)
    daemon = port_daemon(scheduler, tmp_path, "proxy-peer")
    yield {"scheduler": scheduler, "daemon": daemon}
    daemon.stop()


def connect(proxy, target: str, extra: str = ""):
    raw = socket.create_connection(("127.0.0.1", proxy.port), timeout=30)
    raw.sendall(f"CONNECT {target} HTTP/1.1\r\nHost: {target}\r\n{extra}\r\n"
                .encode())
    status, _, _ = _read_http_response_headers_only(raw)
    return raw, status


def get_over(tls, target: str, path: str) -> tuple:
    tls.sendall(f"GET {path} HTTP/1.1\r\nHost: {target}\r\n"
                "Connection: close\r\n\r\n".encode())
    out = _read_http_response(tls)
    tls.close()
    return out


class TestCertAuthority:
    def test_leaf_signed_by_ca_with_san(self, tmp_path):
        from cryptography import x509
        from cryptography.hazmat.primitives.asymmetric.ec import ECDSA
        from cryptography.hazmat.primitives.hashes import SHA256

        ca = CertAuthority(str(tmp_path / "ca"))
        cert_path, key_path = ca.cert_for("registry.example.com")
        leaf = x509.load_pem_x509_certificate(open(cert_path, "rb").read())
        san = leaf.extensions.get_extension_for_class(
            x509.SubjectAlternativeName).value
        assert "registry.example.com" in san.get_values_for_type(
            x509.DNSName)
        x509.load_pem_x509_certificate(ca.ca_pem).public_key().verify(
            leaf.signature, leaf.tbs_certificate_bytes, ECDSA(SHA256()))
        assert ca.cert_for("registry.example.com") == (cert_path, key_path)
        ip_leaf = x509.load_pem_x509_certificate(
            open(ca.cert_for("10.0.0.7")[0], "rb").read())
        assert [str(ip) for ip in ip_leaf.extensions.get_extension_for_class(
            x509.SubjectAlternativeName).value.get_values_for_type(
            x509.IPAddress)] == ["10.0.0.7"]

    def test_ca_files_shared_with_jax(self, tmp_path):
        port_dir, jax_dir = str(tmp_path / "p"), str(tmp_path / "j")
        assert jax_certs.CertAuthority(port_dir).ca_pem == CertAuthority(
            port_dir).ca_pem
        assert CertAuthority(jax_dir).ca_pem == jax_certs.CertAuthority(
            jax_dir).ca_pem


class TestHijack:
    def test_https_pull_traverses_mesh(self, tmp_path, https_origin, mesh):
        content = os.urandom(2 * 1024 * 1024 + 99)
        (https_origin.root_dir / "blob.bin").write_bytes(content)
        proxy = ProxyServer(mesh["daemon"], ProxyConfig(
            rules=[ProxyRule(regx=r".*blob\.bin")], hijack_https=True,
            ca_dir=str(tmp_path / "proxy-ca")))
        proxy.start()
        try:
            target = f"localhost:{https_origin.port}"
            raw, status = connect(proxy, target)
            assert status == 200
            tls = ssl.create_default_context(
                cafile=proxy.ca.ca_cert_path).wrap_socket(
                raw, server_hostname="localhost")
            status, headers, body = get_over(tls, target, "/blob.bin")
            assert status == 200 and body == content
            assert headers.get(HEADER_TASK_ID.lower())
            assert mesh["scheduler"].storage.download_count() >= 1
        finally:
            proxy.stop()

    def test_passthrough_remains_default(self, https_origin, mesh):
        content = b"q" * 65536
        (https_origin.root_dir / "p.bin").write_bytes(content)
        proxy = ProxyServer(mesh["daemon"], ProxyConfig(
            rules=[ProxyRule(regx=r".*")]))
        proxy.start()
        try:
            target = f"localhost:{https_origin.port}"
            raw, status = connect(proxy, target)
            assert status == 200
            tls = ssl.create_default_context(
                cafile=os.environ["SSL_CERT_FILE"]).wrap_socket(
                raw, server_hostname="localhost")
            status, headers, body = get_over(tls, target, "/p.bin")
            assert status == 200 and body == content
            assert HEADER_TASK_ID.lower() not in headers
        finally:
            proxy.stop()

    def test_inner_requests_skip_proxy_auth(self, tmp_path, https_origin,
                                            mesh):
        content = b"a" * 100_000
        (https_origin.root_dir / "auth.bin").write_bytes(content)
        proxy = ProxyServer(mesh["daemon"], ProxyConfig(
            rules=[ProxyRule(regx=r".*auth\.bin")], basic_auth=("u", "pw"),
            hijack_https=True, ca_dir=str(tmp_path / "proxy-ca")))
        proxy.start()
        try:
            target = f"localhost:{https_origin.port}"
            _, status = connect(proxy, target)
            assert status == 407
            cred = base64.b64encode(b"u:pw").decode()
            raw, status = connect(proxy, target,
                                  f"Proxy-Authorization: Basic {cred}\r\n")
            assert status == 200
            tls = ssl.create_default_context(
                cafile=proxy.ca.ca_cert_path).wrap_socket(
                raw, server_hostname="localhost")
            status, headers, body = get_over(tls, target, "/auth.bin")
            assert status == 200 and body == content
            assert headers.get(HEADER_TASK_ID.lower())
        finally:
            proxy.stop()


def test_sni_routed_pull_traverses_mesh(tmp_path, https_origin, mesh):
    proxy = ProxyServer(mesh["daemon"], ProxyConfig(
        rules=[ProxyRule(regx=r".*blob2\.bin")], hijack_https=True,
        ca_dir=str(tmp_path / "proxy-ca")))
    proxy.start()
    sni = SNIProxyServer(proxy, upstream_port=https_origin.port)
    sni.start()
    try:
        content = os.urandom(512 * 1024 + 3)
        (https_origin.root_dir / "blob2.bin").write_bytes(content)
        tls = ssl.create_default_context(
            cafile=proxy.ca.ca_cert_path).wrap_socket(
            socket.create_connection(("127.0.0.1", sni.port), timeout=30),
            server_hostname="localhost")
        status, headers, body = get_over(
            tls, f"localhost:{https_origin.port}", "/blob2.bin")
        assert status == 200 and body == content
        assert headers.get(HEADER_TASK_ID.lower())
        plain = ProxyServer(None, ProxyConfig())
        with pytest.raises(ValueError):
            SNIProxyServer(plain)
        plain._server.server_close()
    finally:
        # Wake the accept loop, which closing the socket alone does not,
        # so stop() joins it at once instead of after its 5 s timeout.
        sni._sock.shutdown(socket.SHUT_RDWR)
        sni.stop()
        proxy.stop()
