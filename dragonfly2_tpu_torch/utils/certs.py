"""Local CA + per-host leaf certificate minting for HTTPS interception.

Reference counterpart: client/daemon/proxy/proxy.go:298-372 (MITM with a
configured CA cert/key, leaf certs minted per hijacked host) and the cert
cache in pkg/cache. The reference uses a operator-supplied CA; here
:class:`CertAuthority` can also self-generate one (opt-in interception is
explicit either way), and leaves are cached in-memory + on disk so repeated
CONNECTs don't pay a key generation.

Keys are EC P-256 (fast minting, small handshakes — leaf generation is on
the CONNECT critical path).
"""

from __future__ import annotations

import datetime
import ipaddress
import os
import threading
from typing import Dict, Optional, Tuple

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import NameOID

_ONE_DAY = datetime.timedelta(days=1)


def _name(common_name: str) -> x509.Name:
    return x509.Name([
        x509.NameAttribute(NameOID.ORGANIZATION_NAME, "dragonfly2-tpu"),
        x509.NameAttribute(NameOID.COMMON_NAME, common_name),
    ])


def _san(host: str) -> x509.SubjectAlternativeName:
    try:
        return x509.SubjectAlternativeName(
            [x509.IPAddress(ipaddress.ip_address(host))])
    except ValueError:
        return x509.SubjectAlternativeName([x509.DNSName(host)])


class CertAuthority:
    """Self-contained CA that mints per-host leaf certs on demand."""

    def __init__(self, work_dir: str, ca_cert_path: str = "",
                 ca_key_path: str = "", valid_days: int = 365):
        from dragonfly2_tpu_torch.utils.ttlcache import TTLCache

        self.work_dir = work_dir
        self.valid_days = valid_days
        os.makedirs(work_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._leaf_paths: Dict[str, Tuple[str, str]] = {}
        # Leaf revalidation (parse + ECDSA verify) is file I/O on the TLS
        # handshake path — remember a positive verdict for a while
        # instead of re-verifying per CONNECT.
        self._validated = TTLCache(default_ttl=600.0)
        if ca_cert_path and ca_key_path:
            with open(ca_key_path, "rb") as f:
                self._ca_key = serialization.load_pem_private_key(
                    f.read(), password=None)
            with open(ca_cert_path, "rb") as f:
                self._ca_cert = x509.load_pem_x509_certificate(f.read())
            self.ca_cert_path = ca_cert_path
        else:
            self._ca_key, self._ca_cert = self._load_or_create_ca()
            self.ca_cert_path = os.path.join(self.work_dir, "ca.pem")

    # -- CA ----------------------------------------------------------------

    def _load_or_create_ca(self):
        cert_path = os.path.join(self.work_dir, "ca.pem")
        key_path = os.path.join(self.work_dir, "ca.key")
        if os.path.exists(cert_path) and os.path.exists(key_path):
            with open(key_path, "rb") as f:
                key = serialization.load_pem_private_key(f.read(), password=None)
            with open(cert_path, "rb") as f:
                return key, x509.load_pem_x509_certificate(f.read())
        key = ec.generate_private_key(ec.SECP256R1())
        now = datetime.datetime.now(datetime.timezone.utc)
        cert = (
            x509.CertificateBuilder()
            .subject_name(_name("dragonfly2-tpu proxy CA"))
            .issuer_name(_name("dragonfly2-tpu proxy CA"))
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - _ONE_DAY)
            .not_valid_after(now + _ONE_DAY * self.valid_days)
            .add_extension(x509.BasicConstraints(ca=True, path_length=0),
                           critical=True)
            .add_extension(
                x509.KeyUsage(
                    digital_signature=True, key_cert_sign=True, crl_sign=True,
                    content_commitment=False, key_encipherment=False,
                    data_encipherment=False, key_agreement=False,
                    encipher_only=False, decipher_only=False),
                critical=True)
            .sign(key, hashes.SHA256())
        )
        with open(key_path, "wb") as f:
            os.fchmod(f.fileno(), 0o600)
            f.write(key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption()))
        with open(cert_path, "wb") as f:
            f.write(cert.public_bytes(serialization.Encoding.PEM))
        return key, cert

    @property
    def ca_pem(self) -> bytes:
        return self._ca_cert.public_bytes(serialization.Encoding.PEM)

    # -- leaves ------------------------------------------------------------

    def cert_for(self, host: str) -> Tuple[str, str]:
        """(cert_path, key_path) for ``host``, minted once and cached.

        A cached/on-disk leaf is only reused while it is still valid AND
        issued by the current CA — a reused work_dir must never serve
        expired leaves or leaves from a replaced CA."""
        with self._lock:
            cached = self._leaf_paths.get(host)
            if (cached is not None and host in self._validated
                    and os.path.exists(cached[0])
                    and os.path.exists(cached[1])):
                # Existence stays on the fast path (cheap) so externally
                # removed leaves self-heal immediately; the expensive
                # parse+verify rides the TTL verdict.
                return cached
            safe = host.replace(":", "_").replace("/", "_")
            cert_path = os.path.join(self.work_dir, f"leaf-{safe}.pem")
            key_path = os.path.join(self.work_dir, f"leaf-{safe}.key")
            if not (os.path.exists(cert_path) and os.path.exists(key_path)
                    and self._leaf_usable(cert_path)):
                self._mint(host, cert_path, key_path)
            self._leaf_paths[host] = (cert_path, key_path)
            self._validated.set(host, True)
            return cert_path, key_path

    def _leaf_usable(self, cert_path: str) -> bool:
        try:
            with open(cert_path, "rb") as f:
                leaf = x509.load_pem_x509_certificate(f.read())
        except (OSError, ValueError):
            return False
        now = datetime.datetime.now(datetime.timezone.utc)
        # Freshness margin: re-mint a leaf nearing expiry, but never so
        # aggressively that short valid_days re-mint on every handshake.
        lifetime = _ONE_DAY * self.valid_days
        margin = min(_ONE_DAY, lifetime / 4)
        if not (leaf.not_valid_before_utc <= now
                < leaf.not_valid_after_utc - margin):
            return False
        if leaf.issuer != self._ca_cert.subject:
            return False
        try:
            self._ca_cert.public_key().verify(
                leaf.signature, leaf.tbs_certificate_bytes,
                ec.ECDSA(hashes.SHA256()))
        except Exception:  # noqa: BLE001 — any verify failure → re-mint
            return False
        return True

    def client_cert_for(self, name: str) -> Tuple[str, str]:
        """(cert_path, key_path) of a CLIENT_AUTH leaf for mTLS peers
        (pkg/rpc/credential.go's client identity role)."""
        safe = name.replace(":", "_").replace("/", "_")
        cert_path = os.path.join(self.work_dir, f"client-{safe}.pem")
        key_path = os.path.join(self.work_dir, f"client-{safe}.key")
        with self._lock:
            if not (os.path.exists(cert_path) and os.path.exists(key_path)
                    and self._leaf_usable(cert_path)):
                self._mint(name, cert_path, key_path, client=True)
        return cert_path, key_path

    def _mint(self, host: str, cert_path: str, key_path: str,
              client: bool = False) -> None:
        key = ec.generate_private_key(ec.SECP256R1())
        now = datetime.datetime.now(datetime.timezone.utc)
        eku = (x509.oid.ExtendedKeyUsageOID.CLIENT_AUTH if client
               else x509.oid.ExtendedKeyUsageOID.SERVER_AUTH)
        cert = (
            x509.CertificateBuilder()
            .subject_name(_name(host))
            .issuer_name(self._ca_cert.subject)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - _ONE_DAY)
            .not_valid_after(now + _ONE_DAY * self.valid_days)
            .add_extension(_san(host), critical=False)
            .add_extension(x509.ExtendedKeyUsage([eku]), critical=False)
            .sign(self._ca_key, hashes.SHA256())
        )
        with open(key_path, "wb") as f:
            os.fchmod(f.fileno(), 0o600)
            f.write(key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption()))
        with open(cert_path, "wb") as f:
            f.write(cert.public_bytes(serialization.Encoding.PEM))

    def server_context(self, default_host: str = "localhost",
                       on_sni=None):
        """TLS server context that re-mints by SNI at handshake time —
        CONNECT-by-IP clients still get a certificate for the name they
        actually asked for. ``on_sni(server_name)`` is called with the
        requested name (SNI routing, proxy_sni.go)."""
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        cert, key = self.cert_for(default_host)
        ctx.load_cert_chain(cert, key)

        def sni_cb(sock, server_name, _ctx):
            if server_name:
                if on_sni is not None:
                    on_sni(server_name)
                inner = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
                c, k = self.cert_for(server_name)
                inner.load_cert_chain(c, k)
                sock.context = inner
            return None

        ctx.sni_callback = sni_cb
        return ctx
