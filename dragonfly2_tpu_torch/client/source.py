"""Back-to-source protocol registry and HTTP resource client.

Reference counterpart: pkg/source — the ``ResourceClient`` interface
(source_client.go:102-121: GetContentLength / IsSupportRange / IsExpired /
Download / GetLastModified) with per-scheme registration (source_client.go:267)
and the HTTP implementation (pkg/source/clients/httpprotocol). ``file://`` is
added for hermetic tests (the reference's e2e fixtures use an HTTP
file-server pod; our single-process harness uses either).
"""

from __future__ import annotations

import base64
import email.utils
import http.client
import os
import threading
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, Optional, Tuple

from dragonfly2_tpu_torch.client.dataplane import HTTPConnectionPool
from dragonfly2_tpu_torch.client.piece import Range
from dragonfly2_tpu_torch.utils import faultplan

UNKNOWN_SOURCE_FILE_LEN = -2


class SourceError(Exception):
    pass


@dataclass
class Request:
    """A back-to-source request (pkg/source/request.go)."""

    url: str
    header: Dict[str, str] = field(default_factory=dict)
    rng: Optional[Range] = None

    @property
    def scheme(self) -> str:
        return urllib.parse.urlparse(self.url).scheme.lower()


@dataclass
class Response:
    body: BinaryIO
    content_length: int = -1
    status: int = 200
    header: Dict[str, str] = field(default_factory=dict)

    def close(self) -> None:
        try:
            self.body.close()
        except Exception:
            pass


class ResourceClient:
    """Per-scheme back-to-source client (source_client.go:102-121)."""

    def get_content_length(self, request: Request) -> int:
        raise NotImplementedError

    def is_support_range(self, request: Request) -> bool:
        raise NotImplementedError

    def is_expired(self, request: Request, last_modified: str, etag: str) -> bool:
        raise NotImplementedError

    def download(self, request: Request) -> Response:
        raise NotImplementedError

    def get_last_modified(self, request: Request) -> int:
        raise NotImplementedError

    def list(self, request: Request) -> list:
        """Child URLs under a directory-like URL (the reference's
        recursive-download listing; schemes without a listing concept —
        plain http — raise)."""
        raise SourceError(
            f"scheme {request.scheme!r} does not support listing")


class _Registry:
    """Scheme → client map with plugin-style registration
    (source_client.go Register/UnRegister)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._clients: Dict[str, ResourceClient] = {}

    def register(self, scheme: str, client: ResourceClient,
                 replace: bool = False) -> None:
        with self._lock:
            if scheme in self._clients and not replace:
                raise SourceError(f"scheme {scheme!r} already registered")
            self._clients[scheme.lower()] = client

    def unregister(self, scheme: str) -> None:
        with self._lock:
            self._clients.pop(scheme.lower(), None)

    def client(self, scheme: str) -> ResourceClient:
        with self._lock:
            try:
                return self._clients[scheme.lower()]
            except KeyError:
                raise SourceError(f"no source client for scheme {scheme!r}")


_registry = _Registry()
register = _registry.register
unregister = _registry.unregister


def client_for(request: Request) -> ResourceClient:
    return _registry.client(request.scheme)


def get_content_length(request: Request) -> int:
    return client_for(request).get_content_length(request)


def is_support_range(request: Request) -> bool:
    return client_for(request).is_support_range(request)


def download(request: Request) -> Response:
    return client_for(request).download(request)


def list_children(request: Request) -> list:
    return client_for(request).list(request)


class _PooledBody:
    """An ``http.client`` response bound to its pooled connection.

    Exposes the subset callers use (``status``/``headers``/``read``/
    ``close``/``isclosed``). ``close`` returns the connection to the
    pool when the body was fully consumed (draining a small bounded
    remainder first, so probe responses like ``Range: bytes=0-0`` don't
    cost the socket); an abandoned large body closes the connection —
    realigning a half-read keep-alive stream is never worth it.
    """

    DRAIN_LIMIT = 256 * 1024

    def __init__(self, pool: HTTPConnectionPool, key, conn, resp):
        self._pool = pool
        self._key = key
        self._conn = conn
        self._resp = resp
        self._done = False
        self.status = resp.status
        self.headers = resp.headers

    def read(self, amt: int | None = None) -> bytes:
        return self._resp.read(amt)

    def isclosed(self) -> bool:
        return self._resp.isclosed()

    def close(self) -> None:
        if self._done:
            return
        self._done = True
        limit = self.DRAIN_LIMIT
        try:
            while limit > 0 and not self._resp.isclosed():
                chunk = self._resp.read(min(64 * 1024, limit))
                if not chunk:
                    break
                limit -= len(chunk)
        except (OSError, http.client.HTTPException):
            self._conn.close()
            return
        if self._resp.will_close or not self._resp.isclosed():
            self._conn.close()
        else:
            self._pool.checkin(self._key, self._conn)


class HTTPSourceClient(ResourceClient):
    """HTTP(S) back-to-source (pkg/source/clients/httpprotocol).

    Requests ride a per-host keep-alive connection pool (the reference's
    pooled ``http.Client`` transport, source_client.go/httpprotocol) —
    back-to-source piece runs stop paying a TCP handshake each. Proxied
    and credentialed URLs ride the SAME pool: plain http through a proxy
    is an absolute-URI request at the proxy, https goes through a
    CONNECT tunnel (both keyed by proxy identity so sockets never mix),
    and URL userinfo becomes Basic auth — the legacy one-shot urllib
    path is gone. Content length and range support come from a GET with
    ``Range: bytes=0-0`` (falling back to plain GET), matching the
    reference's probe behavior; 206 ⇒ ranges supported.
    """

    MAX_REDIRECTS = 5

    def __init__(self, timeout: float = 30.0, pool_per_host: int = 4,
                 stats=None, pool_idle_ttl: float = 60.0,
                 pool_max_total: int = 256):
        self.timeout = timeout
        self.pool = HTTPConnectionPool(per_host=pool_per_host,
                                       timeout=timeout,
                                       idle_ttl=pool_idle_ttl,
                                       max_total=pool_max_total)
        if stats is None:
            from dragonfly2_tpu_torch.client.dataplane import STATS as stats
        self.stats = stats

    def close(self) -> None:
        self.pool.close()

    @staticmethod
    def _proxy_for(url: str) -> Optional[Tuple[str, str, int, Optional[str]]]:
        """``(mode, host, port, proxy_auth)`` for a URL the proxy env
        vars (``http_proxy``/``https_proxy`` minus ``no_proxy``) route
        through a proxy, else None — the exact selection semantics the
        legacy urllib path had (:func:`urllib.request.getproxies` +
        ``proxy_bypass``). ``mode`` is ``"absolute"`` for plain http
        (absolute-URI request straight at the proxy, as urllib sent) and
        ``"tunnel"`` for https (CONNECT, then TLS to the origin).
        Proxy-URL userinfo becomes the Basic ``Proxy-Authorization``
        value, again matching urllib."""
        parsed = urllib.parse.urlsplit(url)
        proxies = urllib.request.getproxies()
        proxy_url = proxies.get(parsed.scheme)
        if not proxy_url:
            return None
        try:
            if urllib.request.proxy_bypass(parsed.hostname or ""):
                return None
        except Exception:  # resolver hiccups in bypass lookups: use proxy
            pass
        p = urllib.parse.urlsplit(proxy_url)
        auth = None
        if p.username:
            userinfo = urllib.parse.unquote(p.username)
            if p.password is not None:
                userinfo += ":" + urllib.parse.unquote(p.password)
            auth = "Basic " + base64.b64encode(
                userinfo.encode("latin-1")).decode("ascii")
        mode = "tunnel" if parsed.scheme == "https" else "absolute"
        return (mode, p.hostname or "", p.port or 3128, auth)

    def _request(self, url: str, method: str,
                 headers: Dict[str, str]) -> _PooledBody:
        parsed = urllib.parse.urlsplit(url)
        if parsed.scheme not in ("http", "https"):
            raise SourceError(f"{url}: unsupported scheme for HTTP client")
        host = parsed.hostname or ""
        port = parsed.port or (443 if parsed.scheme == "https" else 80)
        headers = dict(headers)
        if parsed.username and not any(
                k.lower() == "authorization" for k in headers):
            # Userinfo credentials ride as Basic auth while the dial
            # target stays the bare hostname (urllib tried to RESOLVE
            # ``user:pass@host`` and failed; this is the working form).
            userinfo = urllib.parse.unquote(parsed.username)
            if parsed.password is not None:
                userinfo += ":" + urllib.parse.unquote(parsed.password)
            headers["Authorization"] = "Basic " + base64.b64encode(
                userinfo.encode("latin-1")).decode("ascii")
        path = parsed.path or "/"
        if parsed.query:
            path += "?" + parsed.query
        proxy = self._proxy_for(url)
        key: Tuple = (parsed.scheme, host, port)
        if proxy is not None:
            mode, phost, pport, pauth = proxy
            key = key + ((mode, phost, pport, pauth),)
            if mode == "absolute":
                # Absolute-URI request-target (userinfo stripped);
                # http.client derives the Host header from its netloc,
                # so the origin-facing headers match the legacy path.
                netloc = host if port == 80 else f"{host}:{port}"
                path = f"{parsed.scheme}://{netloc}{path}"
                if pauth and not any(k.lower() == "proxy-authorization"
                                     for k in headers):
                    headers["Proxy-Authorization"] = pauth
        try:
            conn, resp = self.pool.request(key, method, path, headers,
                                           stats=self.stats)
        except (OSError, http.client.HTTPException) as exc:
            raise SourceError(f"{url}: {exc}") from exc
        return _PooledBody(self.pool, key, conn, resp)

    def _open(self, request: Request, method: str = "GET",
              extra_header: Dict[str, str] | None = None):
        headers = dict(request.header)
        if extra_header:
            headers.update(extra_header)
        if request.rng is not None:
            # request.rng is authoritative: a caller-supplied Range header
            # (e.g. forwarded by the proxy) must never override the piece
            # range, or every piece fetch would return the client's range.
            for key in [k for k in headers if k.lower() == "range"]:
                del headers[key]
            headers["Range"] = request.rng.http_header()
        url = request.url
        for _hop in range(self.MAX_REDIRECTS + 1):
            resp = self._request(url, method, headers)
            if resp.status in (301, 302, 303, 307, 308):
                location = resp.headers.get("Location")
                resp.close()
                if not location:
                    raise SourceError(f"{url}: redirect without Location")
                url = urllib.parse.urljoin(url, location)
                if resp.status == 303:
                    method = "GET"
                continue
            if resp.status >= 400:
                code = resp.status
                resp.close()
                raise SourceError(f"{request.url}: HTTP {code}")
            return resp
        raise SourceError(f"{request.url}: too many redirects")

    def get_content_length(self, request: Request) -> int:
        probe = Request(request.url, dict(request.header))
        resp = self._open(probe, extra_header={"Range": "bytes=0-0"})
        try:
            if resp.status == 206:
                content_range = resp.headers.get("Content-Range", "")
                if "/" in content_range:
                    total = content_range.rsplit("/", 1)[1]
                    if total.isdigit():
                        return int(total)
            length = resp.headers.get("Content-Length")
            return int(length) if length is not None else UNKNOWN_SOURCE_FILE_LEN
        finally:
            resp.close()

    def is_support_range(self, request: Request) -> bool:
        probe = Request(request.url, dict(request.header))
        resp = self._open(probe, extra_header={"Range": "bytes=0-0"})
        try:
            return resp.status == 206
        finally:
            resp.close()

    def is_expired(self, request: Request, last_modified: str, etag: str) -> bool:
        headers = {}
        if last_modified:
            headers["If-Modified-Since"] = last_modified
        if etag:
            headers["If-None-Match"] = etag
        if not headers:
            return True
        try:
            resp = self._open(Request(request.url, dict(request.header)),
                              extra_header=headers)
            status = resp.status
            resp.close()
        except SourceError:
            return True
        return status != 304

    def download(self, request: Request) -> Response:
        resp = self._open(request)
        if request.rng is not None and resp.status != 206:
            # A server that ignores Range would hand back the whole body;
            # treating it as the requested slice silently corrupts pieces.
            resp.close()
            raise SourceError(
                f"{request.url}: server ignored Range (status {resp.status})"
            )
        length = resp.headers.get("Content-Length")
        body = resp
        plan = faultplan.ACTIVE
        if plan is not None:
            rule = plan.check("source.body", context=request.url)
            if rule is not None:
                body = faultplan.FaultingBody(resp, rule)
        return Response(
            body=body,
            content_length=int(length) if length is not None else -1,
            status=resp.status,
            header={k: v for k, v in resp.headers.items()},
        )

    def get_last_modified(self, request: Request) -> int:
        resp = self._open(request, method="HEAD")
        try:
            lm = resp.headers.get("Last-Modified")
            if not lm:
                return -1
            dt = email.utils.parsedate_to_datetime(lm)
            return int(dt.timestamp() * 1000)
        finally:
            resp.close()


class FileSourceClient(ResourceClient):
    """``file://`` source for hermetic tests."""

    @staticmethod
    def _path(request: Request) -> str:
        parsed = urllib.parse.urlparse(request.url)
        return urllib.request.url2pathname(parsed.path)

    def get_content_length(self, request: Request) -> int:
        try:
            return os.path.getsize(self._path(request))
        except OSError as exc:
            raise SourceError(str(exc)) from exc

    def is_support_range(self, request: Request) -> bool:
        return True

    def is_expired(self, request: Request, last_modified: str, etag: str) -> bool:
        return True

    def download(self, request: Request) -> Response:
        path = self._path(request)
        try:
            size = os.path.getsize(path)
            f = open(path, "rb")
        except OSError as exc:
            raise SourceError(str(exc)) from exc
        if request.rng is not None:
            f.seek(request.rng.start)
            data = f.read(request.rng.length)
            f.close()
            import io

            return Response(io.BytesIO(data), content_length=len(data), status=206)
        return Response(f, content_length=size)

    def get_last_modified(self, request: Request) -> int:
        try:
            return int(os.path.getmtime(self._path(request)) * 1000)
        except OSError:
            return -1

    def list(self, request: Request) -> list:
        base = self._path(request)
        if not os.path.isdir(base):
            raise SourceError(f"{request.url} is not a directory")
        out = []
        for dirpath, _, filenames in os.walk(base):
            for name in sorted(filenames):
                path = os.path.join(dirpath, name)
                out.append(
                    urllib.parse.urljoin("file:",
                                         urllib.request.pathname2url(path)))
        return sorted(out)


def register_defaults() -> None:
    """Install the built-in clients (pkg/source/clients registration)."""
    for scheme, client in (
        ("http", HTTPSourceClient()),
        ("https", HTTPSourceClient()),
        ("file", FileSourceClient()),
    ):
        try:
            _registry.register(scheme, client)
        except SourceError:
            pass


register_defaults()
