"""TLS plumbing for the data plane with no third-party dependencies.

:mod:`dragonfly2_tpu_torch.utils.certs` mints certificates with the
``cryptography`` package — the right tool for the MITM proxy's
per-host leaf cache, but an optional dependency this module must not
require: the data-plane TLS paths (upload serving, piece fetch,
metadata sync, HTTPS sources) only need *contexts* built from PEM
files the operator supplies, plus a way for tests and benches to mint
a throwaway CA when ``cryptography`` is absent. Cert minting here
shells out to the ``openssl`` CLI (present wherever libssl is), and
context construction is stdlib ``ssl`` only.

Also home to the kTLS capability probe: ``OP_ENABLE_KTLS`` tells the
kernel to encrypt on the socket, which lets ``sendfile(2)`` serve
file pages through a TLS stream with zero userspace copies. Whether
it actually engages depends on the OpenSSL build, the kernel ``tls``
module, and the negotiated cipher — so the capability is probed once
per server context with a real loopback handshake + ``os.sendfile``
round-trip, and callers fall back per-connection (never corrupting a
stream by optimistically writing plaintext file bytes into a TLS
session that is not kernel-offloaded).
"""

from __future__ import annotations

import os
import shutil
import socket
import ssl
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

_OPENSSL = shutil.which("openssl") or "/usr/bin/openssl"
_SUBJ_O = "dragonfly2-tpu"


def openssl_available() -> bool:
    return os.path.exists(_OPENSSL)


def _run(cmd, timeout=30.0) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"openssl failed: {' '.join(cmd)}\n{proc.stderr}")


def _is_ip(host: str) -> bool:
    try:
        socket.inet_aton(host)
        return True
    except OSError:
        return ":" in host  # crude IPv6 check is enough for SAN choice


def mint_ca(work_dir: str, name: str = "df2 data-plane test CA",
            days: int = 365) -> Tuple[str, str]:
    """(ca_cert_path, ca_key_path), minted once and reused from disk."""
    os.makedirs(work_dir, exist_ok=True)
    cert = os.path.join(work_dir, "ca.pem")
    key = os.path.join(work_dir, "ca.key")
    if os.path.exists(cert) and os.path.exists(key):
        return cert, key
    # Explicit minimal config: `-addext` on top of the system openssl.cnf
    # duplicates v3_ca's BasicConstraints, and a CA cert with duplicate
    # extensions is silently unusable for chain building.
    conf = ("[req]\ndistinguished_name=dn\nx509_extensions=ca\n"
            "prompt=no\n[dn]\n"
            f"O={_SUBJ_O}\nCN={name}\n[ca]\n"
            "basicConstraints=critical,CA:TRUE\n"
            "keyUsage=critical,keyCertSign,cRLSign\n"
            "subjectKeyIdentifier=hash\n")
    with tempfile.NamedTemporaryFile("w", suffix=".cnf", delete=False) as f:
        f.write(conf)
        conf_path = f.name
    try:
        _run([_OPENSSL, "req", "-x509", "-newkey", "ec",
              "-pkeyopt", "ec_paramgen_curve:P-256", "-nodes",
              "-keyout", key, "-out", cert, "-days", str(days),
              "-config", conf_path])
    finally:
        os.unlink(conf_path)
    os.chmod(key, 0o600)
    return cert, key


def mint_leaf(work_dir: str, host: str, ca_cert: str, ca_key: str,
              days: int = 365, client: bool = False) -> Tuple[str, str]:
    """(cert_path, key_path) for ``host`` signed by the CA, with an IP or
    DNS SAN as appropriate (clients connect to 127.0.0.1 in tests)."""
    os.makedirs(work_dir, exist_ok=True)
    safe = host.replace(":", "_").replace("/", "_")
    kind = "client" if client else "leaf"
    cert = os.path.join(work_dir, f"{kind}-{safe}.pem")
    key = os.path.join(work_dir, f"{kind}-{safe}.key")
    if os.path.exists(cert) and os.path.exists(key):
        return cert, key
    csr = os.path.join(work_dir, f"{kind}-{safe}.csr")
    _run([_OPENSSL, "req", "-newkey", "ec",
          "-pkeyopt", "ec_paramgen_curve:P-256", "-nodes",
          "-keyout", key, "-out", csr,
          "-subj", f"/O={_SUBJ_O}/CN={host}"])
    san = f"IP:{host}" if _is_ip(host) else f"DNS:{host}"
    eku = "clientAuth" if client else "serverAuth"
    with tempfile.NamedTemporaryFile("w", suffix=".ext", delete=False) as f:
        f.write(f"subjectAltName={san}\nextendedKeyUsage={eku}\n")
        ext = f.name
    try:
        _run([_OPENSSL, "x509", "-req", "-in", csr, "-CA", ca_cert,
              "-CAkey", ca_key, "-CAcreateserial", "-out", cert,
              "-days", str(days), "-extfile", ext])
    finally:
        os.unlink(ext)
        if os.path.exists(csr):
            os.unlink(csr)
    os.chmod(key, 0o600)
    return cert, key


def server_context(certfile: str, keyfile: str, *,
                   enable_ktls: bool = True) -> ssl.SSLContext:
    """Server context for the upload engine. Requests kTLS offload when
    this OpenSSL exposes it — whether the kernel actually engages is a
    separate question answered by :func:`ktls_probe`."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile, keyfile)
    if enable_ktls and hasattr(ssl, "OP_ENABLE_KTLS"):
        ctx.options |= ssl.OP_ENABLE_KTLS
    return ctx


def client_context(cafile: Optional[str] = None, *,
                   insecure: bool = False) -> ssl.SSLContext:
    """Client context for piece fetch / metadata sync / HTTPS sources.
    ``cafile`` pins a private CA (test fleets, minted parents);
    ``insecure`` disables verification (benches on loopback only)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    if insecure:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    elif cafile:
        ctx.load_verify_locations(cafile=cafile)
    else:
        ctx.load_default_certs()
    return ctx


# -- kTLS probe -------------------------------------------------------------

_probe_lock = threading.Lock()


def ktls_probe(ctx: ssl.SSLContext) -> Tuple[bool, str]:
    """(usable, fallback_reason) for serving file bytes with
    ``os.sendfile`` through sockets wrapped by ``ctx``.

    A positive verdict requires a real demonstration: loopback
    handshake under ``ctx``, then ``os.sendfile`` of known bytes
    through the wrapped socket arriving intact on the client. Anything
    less (an option bit, a module listing) risks writing plaintext
    into a TLS stream when the kernel quietly declines the offload.
    The verdict is cached on the context — one probe per server."""
    cached = getattr(ctx, "_df2_ktls_probe", None)
    if cached is not None:
        return cached
    with _probe_lock:
        cached = getattr(ctx, "_df2_ktls_probe", None)
        if cached is not None:
            return cached
        if not hasattr(ssl, "OP_ENABLE_KTLS"):
            verdict = (False, "no_openssl_ktls")
        elif not (ctx.options & ssl.OP_ENABLE_KTLS):
            verdict = (False, "ktls_disabled")
        else:
            verdict = ((True, "") if _ktls_self_test(ctx)
                       else (False, "ktls_probe_failed"))
        ctx._df2_ktls_probe = verdict
        return verdict


def _ktls_self_test(ctx: ssl.SSLContext) -> bool:
    payload = os.urandom(64 * 1024)
    # Real loopback TCP, not a socketpair: the kernel TLS ULP attaches
    # to TCP sockets only, so an AF_UNIX probe would always fail even
    # on hosts where the offload works.
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as lst:
        lst.bind(("127.0.0.1", 0))
        lst.listen(1)
        cli_raw = socket.create_connection(lst.getsockname(), timeout=10.0)
        srv_raw, _ = lst.accept()
    got = bytearray()
    cli_err = []

    def client() -> None:
        try:
            cctx = client_context(insecure=True)
            with cctx.wrap_socket(cli_raw, server_hostname="localhost") as c:
                while len(got) < len(payload):
                    chunk = c.recv(65536)
                    if not chunk:
                        break
                    got.extend(chunk)
        except Exception as exc:  # noqa: BLE001 — any failure fails the probe
            cli_err.append(exc)

    t = threading.Thread(target=client, daemon=True)
    t.start()
    try:
        with ctx.wrap_socket(srv_raw, server_side=True) as s:
            with tempfile.TemporaryFile() as f:
                f.write(payload)
                f.flush()
                sent = 0
                while sent < len(payload):
                    n = os.sendfile(s.fileno(), f.fileno(), sent,
                                    len(payload) - sent)
                    if n <= 0:
                        return False
                    sent += n
    except (OSError, ssl.SSLError, ValueError):
        return False
    finally:
        t.join(timeout=10.0)
    return not cli_err and bytes(got) == payload
