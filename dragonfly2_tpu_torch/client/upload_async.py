"""Event-loop piece upload server — the async zero-copy serving engine.

Replaces the thread-per-connection ``ThreadingHTTPServer`` upload server
(one OS thread parked per keep-alive peer) with a selector-based engine:
one acceptor thread plus a SMALL FIXED number of event-loop workers,
each multiplexing hundreds of non-blocking connections. Thread count is
``workers + 1`` — a constant, independent of how many children hold
keep-alive connections to this seed.

Serve-path ladder for ``/download`` (decision table in
docs/DATAPLANE.md):

1. **native sendfile** — ``native.send_file_range`` (pieceio.cpp):
   file pages go page-cache → socket inside one C call, GIL released.
   The C loop returns PARTIAL progress on ``EAGAIN`` so the event loop
   resumes from the same offset when the socket drains.
2. **pure-Python ``os.sendfile``** — the same zero-copy syscall without
   the toolchain dependency; returns partial counts and raises
   ``BlockingIOError`` on a full buffer, exactly what the loop needs.
3. **mmap-backed chunked writes** — TLS connections without kernel TLS
   offload (the record layer must see the bytes; with kTLS the
   zero-copy rungs above stay live) and platforms without ``sendfile``;
   the piece is never materialized as a Python ``bytes``, only windowed
   through a ``memoryview`` of the mapping.
4. **buffered** — ranges the span lookup can't resolve (clamped /
   out-of-extent reads on partial stores); the one remaining
   whole-``bytes`` path, counted separately so it is visible.

Rate limiting never blocks a worker: the limiter's ``reserve_n`` yields
a delay and the connection parks on the loop's timer wheel until its
tokens accrue. Upload metrics tick AFTER the body write completes — a
connection that dies mid-body counts aborted bytes, never a phantom
served piece (the count-before-write bug the threaded engine had on its
read-bytes path).

Admission: ``max_connections`` bounds concurrently open connections
(beyond it, new arrivals get a best-effort 503 and are closed) and
``backlog`` is handed to ``listen(2)``.

Stream admission (QoS): ``max_streams`` bounds concurrently SERVING
piece bodies — a request-time gate, distinct from the accept-time
connection cap, because the traffic class is only known once the
request head (``X-Df2-Class``) is parsed. Past the bound a piece
request PARKS (the connection stays read-interested so a vanishing
peer is detected) until a serving stream finishes; with a
:class:`~dragonfly2_tpu_torch.client.qos.QosPolicy` the parked queues are
per-class and drained weighted-fair with per-class floors, and a class
whose park queue exceeds the policy's shed limit gets a 503
(``X-Df2-Shed``) so a flooding tenant backs off instead of growing an
unbounded queue. Class-blind daemons keep a plain FIFO (or no gate at
all when ``max_streams`` is 0 — the zero-overhead default).
"""

from __future__ import annotations

import collections
import errno
import logging
import mmap
import os
import select
import selectors
import socket
import ssl
import threading
import time
import urllib.parse
from typing import Dict, List, Optional, Tuple

from dragonfly2_tpu_torch.client import qos as qos_mod
from dragonfly2_tpu_torch.client.piece import parse_http_range
from dragonfly2_tpu_torch.client.storage import StorageError, StorageManager
from dragonfly2_tpu_torch.utils.ratelimit import INF, Limiter

logger = logging.getLogger(__name__)

ROUTE_DOWNLOAD = "/download"
ROUTE_METADATA = "/metadata"
ROUTE_HEALTHY = "/healthy"

#: Fixed event-loop worker count (threads = DEFAULT_WORKERS + 1 acceptor).
DEFAULT_WORKERS = 2
#: Per-send window for mmap/buffered bodies (bounds one send syscall).
SEND_CHUNK = 256 * 1024
#: sendfile window per syscall — large; the kernel clips to buffer space.
SENDFILE_CHUNK = 4 * 1024 * 1024
#: A request head larger than this is a 431 (no piece GET comes close).
MAX_REQUEST_BYTES = 64 * 1024

_REASONS = {
    200: "OK", 206: "Partial Content", 400: "Bad Request", 404: "Not Found",
    405: "Method Not Allowed", 416: "Range Not Satisfiable",
    422: "Unprocessable Entity", 431: "Request Header Fields Too Large",
    500: "Internal Server Error", 503: "Service Unavailable",
}

# Connection states.
_HANDSHAKE = "handshake"
_READ = "read"
_WRITE = "write"
_DELAY = "delay"
_PARKED = "parked"  # stream-admission gate: waiting for a serving slot

#: Stream cap applied when a QoS policy is configured without an
#: explicit ``max_streams`` — admission must be finite for weighted-
#: fair dequeue to mean anything.
DEFAULT_QOS_MAX_STREAMS = 64

# Body kinds (also the stats split).
KIND_NATIVE = "native"
KIND_SENDFILE = "sendfile"
KIND_MMAP = "mmap"
KIND_BUFFERED = "buffered"
_NO_BODY = "none"

SERVE_PATHS = ("auto", KIND_NATIVE, KIND_SENDFILE, KIND_MMAP, KIND_BUFFERED)


class _Conn:
    """One peer connection's full state machine."""

    __slots__ = (
        "sock", "fd", "addr", "tls", "ktls", "state", "interest", "inbuf",
        "head", "head_off", "kind", "data", "data_off", "mm", "in_fd",
        "file_off", "remaining", "keep_alive", "resume_at", "count_piece",
        "reserved", "write_wants_read", "dispatching", "pump", "closed",
        "owner", "qos_class", "admitted_stream", "park_args", "park_at",
    )

    def __init__(self, sock, addr, tls: bool):
        self.sock = sock
        self.fd = sock.fileno()
        self.addr = addr
        self.tls = tls
        self.ktls = False
        self.state = _HANDSHAKE if tls else _READ
        self.interest = selectors.EVENT_READ
        self.inbuf = bytearray()
        self.resume_at = 0.0
        self.write_wants_read = False
        self.dispatching = False  # trampoline guard (see _try_dispatch)
        self.pump = False
        self.closed = False
        self.owner = None             # the _Worker whose loop runs this conn
        self.qos_class = ""           # from X-Df2-Class, per request
        self.admitted_stream = False  # holds one max_streams slot
        self.park_args = None         # (task_id, peer_id, rng) while parked
        self.park_at = 0.0
        self._reset_response()

    def _reset_response(self) -> None:
        self.head = b""
        self.head_off = 0
        self.kind = _NO_BODY
        self.data = None          # memoryview for mmap/buffered bodies
        self.data_off = 0
        self.mm = None            # mmap object keeping `data` alive
        self.in_fd = -1           # file fd for sendfile bodies
        self.file_off = 0
        self.remaining = 0
        self.keep_alive = True
        self.count_piece = 0      # bytes to count as served on completion
        self.reserved = 0.0       # rate-limiter tokens charged up front

    def body_left(self) -> int:
        if self.kind in (KIND_MMAP, KIND_BUFFERED):
            return len(self.data) - self.data_off
        if self.kind in (KIND_NATIVE, KIND_SENDFILE):
            return self.remaining
        return 0


class _Worker(threading.Thread):
    """One event loop owning a subset of the connections."""

    def __init__(self, server: "AsyncUploadServer", index: int):
        super().__init__(name=f"upload-loop-{index}", daemon=True)
        self.server = server
        self.selector = selectors.DefaultSelector()
        self.inbox: collections.deque = collections.deque()
        self.calls: collections.deque = collections.deque()
        self.delayed: set = set()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)

    def assign(self, conn: _Conn) -> None:
        conn.owner = self
        self.inbox.append(conn)
        self.wake()

    def call(self, fn) -> None:
        """Run ``fn()`` on this worker's loop — how another worker's
        stream-slot release resumes a connection parked here (all conn
        state is owned by exactly one loop)."""
        self.calls.append(fn)
        self.wake()

    def wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    # -- loop --------------------------------------------------------------

    def run(self) -> None:
        srv = self.server
        try:
            self.selector.register(self._wake_r, selectors.EVENT_READ, None)
            while not srv._stop.is_set():
                timeout = 0.5
                if self.delayed:
                    now = srv._clock()
                    soonest = min(c.resume_at for c in self.delayed)
                    timeout = min(timeout, max(soonest - now, 0.0))
                try:
                    events = self.selector.select(timeout)
                except OSError:
                    events = []
                for key, mask in events:
                    if key.data is None:  # wake pipe
                        try:
                            self._wake_r.recv(4096)
                        except OSError:
                            pass
                        continue
                    self._dispatch(key.data, mask)
                self._admit()
                self._resume_delayed()
                self._run_calls()
        finally:
            for key in list(self.selector.get_map().values()):
                if key.data is not None:
                    srv._close(self, key.data)
            while self.inbox:  # assigned but never registered
                srv._discard(self.inbox.popleft())
            self.calls.clear()
            self.selector.close()
            self._wake_r.close()
            self._wake_w.close()

    def _admit(self) -> None:
        while self.inbox:
            conn = self.inbox.popleft()
            try:
                self.selector.register(conn.sock, selectors.EVENT_READ, conn)
            except (ValueError, OSError):
                self.server._discard(conn)

    def _run_calls(self) -> None:
        while self.calls:
            fn = self.calls.popleft()
            try:
                fn()
            except Exception:  # noqa: BLE001 — one bad resume ≠ dead loop
                logger.exception("upload-loop call failed")

    def _resume_delayed(self) -> None:
        if not self.delayed:
            return
        now = self.server._clock()
        for conn in [c for c in self.delayed if c.resume_at <= now]:
            self.delayed.discard(conn)
            conn.state = _WRITE
            self.set_interest(conn, selectors.EVENT_WRITE)
            self.server._continue_write(self, conn)

    def set_interest(self, conn: _Conn, events: int) -> None:
        if conn.interest == events:
            return
        conn.interest = events
        try:
            self.selector.modify(conn.sock, events, conn)
        except (KeyError, ValueError, OSError):
            pass

    def _dispatch(self, conn: _Conn, mask: int) -> None:
        srv = self.server
        try:
            if conn.state == _HANDSHAKE:
                srv._continue_handshake(self, conn)
            elif conn.state == _WRITE:
                if conn.write_wants_read and mask & selectors.EVENT_READ:
                    srv._continue_write(self, conn)
                elif mask & selectors.EVENT_WRITE:
                    srv._continue_write(self, conn)
                elif mask & selectors.EVENT_READ:
                    srv._on_readable(self, conn)
            else:  # _READ, _DELAY or _PARKED: inbound data (or peer close)
                srv._on_readable(self, conn)
        except Exception:  # noqa: BLE001 — one bad conn must not kill the loop
            logger.debug("upload conn %s died", conn.addr, exc_info=True)
            srv._close(self, conn)


class AsyncUploadServer:
    """Drop-in successor of the threaded ``UploadServer``: same routes,
    same constructor surface (``storage``, ``host``, ``port``,
    ``rate_limit_bps``, ``metrics``, ``sendfile``), same ``start`` /
    ``stop`` / ``port`` / ``address`` / ``limiter`` API — but serving on
    an event loop with a constant thread count.

    ``serve_path`` pins the body path for tests/benches: ``auto`` (the
    documented ladder), ``native``, ``sendfile``, ``mmap`` or
    ``buffered``. The legacy ``sendfile=False`` maps to ``buffered``
    (the old read-bytes pin).
    """

    def __init__(self, storage: StorageManager, host: str = "127.0.0.1",
                 port: int = 0, rate_limit_bps: float = INF, metrics=None,
                 sendfile: bool = True, *, workers: int = 0,
                 backlog: int = 128, max_connections: int = 0,
                 max_streams: int = 0, qos_policy=None, qos_stats=None,
                 serve_path: str = "auto", ssl_context=None, stats=None):
        self.storage = storage
        self.metrics = metrics
        if serve_path not in SERVE_PATHS:
            raise ValueError(f"serve_path must be one of {SERVE_PATHS}")
        self.serve_path = serve_path if sendfile else KIND_BUFFERED
        self.limiter = Limiter(rate_limit_bps, burst=int(rate_limit_bps)
                               if rate_limit_bps != INF else None)
        if stats is None:
            from dragonfly2_tpu_torch.client.dataplane import STATS as stats
        self.stats = stats
        # -- stream-admission gate (request-time QoS) ----------------------
        self.qos_policy = qos_policy
        if qos_policy is not None and max_streams <= 0:
            max_streams = DEFAULT_QOS_MAX_STREAMS
        self.max_streams = max_streams
        self.qos_stats = (qos_stats or qos_mod.QOS) if qos_policy is not None \
            else qos_stats
        self._adm_lock = threading.Lock()
        self._streams = 0
        self._streams_by_class: Dict[str, int] = {}
        self._stream_parkq = (qos_mod.ClassQueues(
            qos_policy, bound=qos_policy.shed_limit)
            if qos_policy is not None else None)
        self._stream_fifo: collections.deque = collections.deque()
        self._stream_wait_ms = qos_mod.LatencyRing(2048)
        self._stream_park_peak = 0
        self.worker_count = workers if workers > 0 else DEFAULT_WORKERS
        self.backlog = backlog
        self.max_connections = max_connections
        self.ssl_context = ssl_context
        self._clock = time.monotonic
        self._stop = threading.Event()
        self._workers: List[_Worker] = []
        self._acceptor: Optional[threading.Thread] = None
        self._rr = 0
        self._open_lock = threading.Lock()
        self._open = 0
        self._open_peak = 0
        self._native_ok: Optional[bool] = None
        # Serialized metadata cache: task_id → (freshness key, body).
        self._meta_cache: Dict[str, Tuple[tuple, bytes]] = {}
        self._meta_cache_lock = threading.Lock()
        self.metadata_cache_hits = 0
        # Bind eagerly: daemons derive host_id from the port pre-start.
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))

    # -- lifecycle ---------------------------------------------------------

    @property
    def port(self) -> int:
        return self._listener.getsockname()[1]

    @property
    def address(self) -> str:
        host, port = self._listener.getsockname()[:2]
        return f"{host}:{port}"

    def start(self) -> None:
        if self._acceptor is not None and self._acceptor.is_alive():
            return
        self._stop.clear()
        # A blocked accept(2) is NOT woken by another thread closing the
        # listener fd on Linux — a pure-blocking acceptor would pin
        # stop() to its join timeout. Poll with a short accept timeout
        # instead: the loop re-checks _stop twice a second.
        self._listener.settimeout(0.5)
        self._listener.listen(self.backlog)
        self._workers = [_Worker(self, i) for i in range(self.worker_count)]
        for w in self._workers:
            w.start()
        self._acceptor = threading.Thread(
            target=self._accept_loop, name="upload-accept", daemon=True)
        self._acceptor.start()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        for w in self._workers:
            w.wake()
        if self._acceptor is not None:
            self._acceptor.join(timeout=5)
            self._acceptor = None
        for w in self._workers:
            w.join(timeout=5)
        self._workers = []

    def thread_count(self) -> int:
        """Live serving threads — the density bench's bounded quantity."""
        n = sum(1 for w in self._workers if w.is_alive())
        if self._acceptor is not None and self._acceptor.is_alive():
            n += 1
        return n

    def open_connections(self) -> int:
        with self._open_lock:
            return self._open

    def open_connections_peak(self) -> int:
        with self._open_lock:
            return self._open_peak

    # -- accept ------------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, addr = self._listener.accept()
            except socket.timeout:
                continue  # periodic _stop re-check
            except OSError:
                return  # listener closed (stop)
            with self._open_lock:
                admit = (self.max_connections <= 0
                         or self._open < self.max_connections)
                if admit:
                    self._open += 1
                    self._open_peak = max(self._open_peak, self._open)
            if not admit:
                self.stats.upload_rejected()
                try:  # best-effort 503 so the child backs off, not hangs
                    sock.settimeout(0.2)
                    sock.sendall(b"HTTP/1.1 503 Service Unavailable\r\n"
                                 b"Content-Length: 0\r\n"
                                 b"Connection: close\r\n\r\n")
                except OSError:
                    pass
                sock.close()
                continue
            self.stats.upload_conn(opened=True)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            sock.setblocking(False)
            tls = self.ssl_context is not None
            if tls:
                try:
                    sock = self.ssl_context.wrap_socket(
                        sock, server_side=True,
                        do_handshake_on_connect=False)
                except (OSError, ssl.SSLError):
                    self._dec_open()
                    sock.close()
                    continue
            conn = _Conn(sock, addr, tls)
            worker = self._workers[self._rr % len(self._workers)]
            self._rr += 1
            worker.assign(conn)

    def _dec_open(self) -> None:
        with self._open_lock:
            self._open -= 1
        self.stats.upload_conn(opened=False)

    def _discard(self, conn: _Conn) -> None:
        """Close a connection that never made it into a selector."""
        if conn.closed:
            return  # idempotent: a dispatch loop may close mid-pump
        conn.closed = True
        if conn.park_args is not None:
            self._abandon_parked(conn)
        self._release_stream(conn)
        if conn.count_piece and conn.reserved:
            # Response died before completing (a completed one resets
            # these first): refund the UNSENT fraction of the up-front
            # token charge, so a connect→request→vanish churn pattern
            # can't drive the bucket negative and starve honest peers.
            left = conn.body_left()
            self.limiter.return_n(conn.reserved * left / conn.count_piece)
        self._release_body(conn)
        try:
            conn.sock.close()
        except OSError:
            pass
        self._dec_open()

    def _close(self, worker: _Worker, conn: _Conn) -> None:
        worker.delayed.discard(conn)
        try:
            worker.selector.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        self._discard(conn)

    # -- TLS handshake -----------------------------------------------------

    def _continue_handshake(self, worker: _Worker, conn: _Conn) -> None:
        try:
            conn.sock.do_handshake()
        except ssl.SSLWantReadError:
            worker.set_interest(conn, selectors.EVENT_READ)
            return
        except ssl.SSLWantWriteError:
            worker.set_interest(conn, selectors.EVENT_WRITE)
            return
        except (OSError, ssl.SSLError):
            self._close(worker, conn)
            return
        self.stats.tls_handshake(server=True)
        # Per-connection serve-path verdict, not per-deployment: a
        # kernel-offloaded session keeps the zero-copy ladder (the
        # kernel encrypts what sendfile moves); otherwise only writes
        # through the SSL object are sound, and the reason is counted.
        from dragonfly2_tpu_torch.utils import tlsconf

        usable, reason = tlsconf.ktls_probe(self.ssl_context)
        conn.ktls = usable
        if not usable:
            self.stats.tls_fallback(reason)
        conn.state = _READ
        worker.set_interest(conn, selectors.EVENT_READ)
        if conn.sock.pending() > 0:
            # The handshake's last TCP segment can carry app-data records
            # (TLS 1.3 Finished + first request): that plaintext now sits
            # in the SSL object while the kernel fd is drained — the
            # selector would never fire for it.
            self._on_readable(worker, conn)

    # -- read / parse ------------------------------------------------------

    def _on_readable(self, worker: _Worker, conn: _Conn) -> None:
        while True:
            try:
                data = conn.sock.recv(65536)
            except (BlockingIOError, InterruptedError, ssl.SSLWantReadError):
                return
            except ssl.SSLWantWriteError:
                return
            except OSError:
                self._close(worker, conn)
                return
            if not data:
                self._close(worker, conn)  # peer went away (mid-delay too)
                return
            conn.inbuf += data
            # TLS: one recv can decrypt a record whose surplus plaintext
            # stays buffered in the SSL object with the kernel fd empty;
            # the selector can't see it — drain before selecting again.
            if not (conn.tls and conn.sock.pending() > 0):
                break
        if conn.state == _READ:
            self._try_dispatch(worker, conn)
        elif len(conn.inbuf) > MAX_REQUEST_BYTES:
            # Pipelining while a response is in flight is fine, but an
            # unbounded buffer is not.
            self._close(worker, conn)

    def _try_dispatch(self, worker: _Worker, conn: _Conn) -> None:
        """Drain buffered requests as a trampoline, not recursion: a
        synchronously-completed response re-enters here from
        _finish_response, and a client pipelining hundreds of small
        requests in one burst would otherwise grow the stack ~6 frames
        per response until RecursionError killed the connection."""
        if conn.dispatching:
            conn.pump = True  # the active loop below picks it up
            return
        conn.dispatching = True
        try:
            while True:
                conn.pump = False
                self._dispatch_one(worker, conn)
                if conn.closed or not conn.pump:
                    return
        finally:
            conn.dispatching = False

    def _dispatch_one(self, worker: _Worker, conn: _Conn) -> None:
        idx = conn.inbuf.find(b"\r\n\r\n")
        if idx < 0:
            if len(conn.inbuf) > MAX_REQUEST_BYTES:
                self._respond_error(worker, conn, 431, close=True)
            return
        head = bytes(conn.inbuf[:idx])
        del conn.inbuf[:idx + 4]
        try:
            method, target, version, headers = _parse_head(head)
        except ValueError:
            self._respond_error(worker, conn, 400, close=True)
            return
        conn.keep_alive = _keep_alive(version, headers)
        if method != "GET":
            self._respond_error(worker, conn, 405)
            return
        self._route(worker, conn, target, headers)

    # -- routing (same shapes as the threaded engine) ----------------------

    def _route(self, worker: _Worker, conn: _Conn, target: str,
               headers: Dict[str, str]) -> None:
        self.stats.upload_request()
        parsed = urllib.parse.urlsplit(target)
        path = parsed.path
        if path == ROUTE_HEALTHY:
            self._respond_bytes(worker, conn, 200, b'"OK"')
            return
        if path.startswith(ROUTE_METADATA + "/"):
            self._handle_metadata(worker, conn, parsed)
            return
        if not path.startswith(ROUTE_DOWNLOAD + "/"):
            self._respond_error(worker, conn, 404)
            return
        parts = path[len(ROUTE_DOWNLOAD) + 1:].split("/")
        if len(parts) != 2:  # task_prefix/task_id (upload_manager.go:184)
            self._respond_error(worker, conn, 422,
                                "expected /download/{prefix}/{task_id}")
            return
        task_id = parts[1]
        query = urllib.parse.parse_qs(parsed.query)
        peer_id = (query.get("peerId") or [""])[0]
        range_header = headers.get("range")
        if not range_header:
            self._respond_error(worker, conn, 400, "Range header required")
            return
        if range_header.startswith("bytes=-"):
            # Suffix ranges need the total length, which piece requests
            # never use; reject rather than resolve against a sentinel.
            self._respond_error(worker, conn, 400,
                                "suffix ranges not supported")
            return
        try:
            rng = parse_http_range(range_header, 1 << 62)
        except ValueError as exc:
            self._respond_error(worker, conn, 400, str(exc))
            return
        conn.qos_class = headers.get(qos_mod.CLASS_HEADER, "")
        self._serve_piece(worker, conn, task_id, peer_id, rng)

    def _serve_piece(self, worker: _Worker, conn: _Conn, task_id: str,
                     peer_id: str, rng) -> None:
        if self.max_streams > 0 and not conn.admitted_stream:
            if not self._admit_stream(worker, conn, (task_id, peer_id, rng)):
                return  # parked (response deferred) or shed (503 sent)
        self._serve_piece_body(worker, conn, task_id, peer_id, rng)

    # -- stream admission (QoS gate) ---------------------------------------

    def _admit_stream(self, worker: _Worker, conn: _Conn,
                      args: tuple) -> bool:
        """Claim a ``max_streams`` serving slot for this request, or park
        the connection (read-interested, so peer close is seen) until a
        slot frees, or shed with a 503 when the class's park queue is at
        the policy bound. True = admitted, proceed to the body."""
        policy = self.qos_policy
        klass = policy.normalize(conn.qos_class) if policy is not None else ""
        conn.qos_class = klass
        qstats = self.qos_stats
        with self._adm_lock:
            if self._stream_headroom(klass):
                self._stream_claim(klass)
                conn.admitted_stream = True
                if qstats is not None:
                    qstats.admission("upload", klass, "admitted")
                return True
            # Stamp BEFORE the push: the instant the conn is queued,
            # another worker's slot release may pick and resume it.
            conn.park_args = args
            conn.park_at = self._clock()
            conn.state = _PARKED
            if self._stream_parkq is not None:
                parked = self._stream_parkq.push(klass, conn)
            else:
                parked = True
                self._stream_fifo.append(conn)
            if parked:
                queued = (len(self._stream_parkq)
                          if self._stream_parkq is not None
                          else len(self._stream_fifo))
                self._stream_park_peak = max(self._stream_park_peak, queued)
        if not parked:
            conn.park_args = None
            conn.state = _READ
            if qstats is not None:
                qstats.admission("upload", klass, "shed")
            conn.keep_alive = False
            self._respond_bytes(worker, conn, 503, b"admission shed",
                                ("X-Df2-Shed: 1",))
            return False
        if qstats is not None:
            qstats.admission("upload", klass, "parked")
        worker.set_interest(conn, selectors.EVENT_READ)
        return False

    def _stream_headroom(self, klass: str) -> bool:
        """Caller holds ``_adm_lock``. FIFO order within a class is
        preserved: a class with backlog never admits a fresh arrival
        ahead of its parked queue."""
        if self._streams >= self.max_streams:
            return False
        if self._stream_parkq is not None:
            if self._stream_parkq.backlog(klass):
                return False
            return self._stream_parkq.headroom(
                klass, self._streams_by_class, self.max_streams)
        return not self._stream_fifo

    def _stream_claim(self, klass: str) -> None:
        self._streams += 1
        if self._stream_parkq is not None:
            self._streams_by_class[klass] = \
                self._streams_by_class.get(klass, 0) + 1

    def _release_stream(self, conn: _Conn) -> None:
        """Give back a serving slot and hand it to the weighted-fair
        pick over the parked queues (floor-deficit classes first). The
        resumed connection is driven on ITS owning worker's loop."""
        if not conn.admitted_stream:
            return
        conn.admitted_stream = False
        nxt = None
        with self._adm_lock:
            self._streams -= 1
            if self._stream_parkq is not None:
                klass = conn.qos_class
                left = self._streams_by_class.get(klass, 0) - 1
                if left > 0:
                    self._streams_by_class[klass] = left
                else:
                    self._streams_by_class.pop(klass, None)
                picked = self._stream_parkq.pick(
                    self._streams_by_class, self.max_streams)
                if picked is not None:
                    pk, nxt = picked
                    self._stream_claim(pk)
            elif self._stream_fifo and self._streams < self.max_streams:
                nxt = self._stream_fifo.popleft()
                self._stream_claim("")
        if nxt is None:
            return
        nxt.admitted_stream = True
        wait_ms = max(self._clock() - nxt.park_at, 0.0) * 1e3
        self._stream_wait_ms.add(wait_ms)
        if self.qos_stats is not None:
            self.qos_stats.observe_wait("upload", nxt.qos_class, wait_ms)
            self.qos_stats.admission("upload", nxt.qos_class, "admitted")
        nxt.owner.call(lambda: self._resume_parked(nxt))

    def _resume_parked(self, conn: _Conn) -> None:
        """Owning-worker callback: a parked request won its slot."""
        if conn.closed or conn.park_args is None:
            self._release_stream(conn)  # slot granted to a dead conn
            return
        args = conn.park_args
        conn.park_args = None
        conn.state = _READ
        try:
            self._serve_piece_body(conn.owner, conn, *args)
        except Exception:  # noqa: BLE001 — mirror _Worker._dispatch
            logger.debug("upload conn %s died on resume", conn.addr,
                         exc_info=True)
            self._close(conn.owner, conn)

    def _abandon_parked(self, conn: _Conn) -> None:
        """A parked connection died before admission: withdraw it."""
        if conn.park_args is None:
            return
        conn.park_args = None
        with self._adm_lock:
            if self._stream_parkq is not None:
                removed = self._stream_parkq.remove(conn.qos_class, conn)
            else:
                try:
                    self._stream_fifo.remove(conn)
                    removed = True
                except ValueError:
                    removed = False
        if removed and self.qos_stats is not None:
            self.qos_stats.admission("upload", conn.qos_class, "abandoned")

    def stream_admission(self) -> Dict[str, object]:
        """The upload gate's admission snapshot (mirrors the download
        engine's ``stream_admission`` shape)."""
        with self._adm_lock:
            inservice = self._streams
            by_class = dict(self._streams_by_class)
            queued = (len(self._stream_parkq)
                      if self._stream_parkq is not None
                      else len(self._stream_fifo))
            queued_by_class = (self._stream_parkq.counts()
                               if self._stream_parkq is not None else {})
            peak = self._stream_park_peak
        p50, p99 = self._stream_wait_ms.percentiles()
        out: Dict[str, object] = {
            "max_streams": self.max_streams,
            "inservice": inservice,
            "queued": queued,
            "queued_peak": peak,
            "queued_wait_ms_p50": round(p50, 3),
            "queued_wait_ms_p99": round(p99, 3),
            "queued_waits": self._stream_wait_ms.count,
        }
        if self.qos_policy is not None:
            out["inservice_by_class"] = by_class
            out["queued_by_class"] = queued_by_class
        return out

    def _serve_piece_body(self, worker: _Worker, conn: _Conn, task_id: str,
                          peer_id: str, rng) -> None:
        span = None
        if self.serve_path != KIND_BUFFERED:
            try:
                span = self.storage.piece_span_any(task_id, peer_id, rng)
            except StorageError:
                span = None
        length = 0
        if span is not None:
            path, offset, length = span
            kind = self._pick_span_kind(conn)
            try:
                if kind == KIND_MMAP:
                    fd = os.open(path, os.O_RDONLY)
                    try:
                        conn.mm = mmap.mmap(fd, 0, prot=mmap.PROT_READ)
                    finally:
                        os.close(fd)
                    conn.data = memoryview(conn.mm)[offset:offset + length]
                    conn.data_off = 0
                else:
                    conn.in_fd = os.open(path, os.O_RDONLY)
                    conn.file_off = offset
                    conn.remaining = length
                conn.kind = kind
            except (OSError, ValueError):
                self._release_body(conn)
                span = None  # fall through to the buffered path
        if span is None:
            try:
                data = self.storage.read_piece_any(task_id, peer_id, rng=rng)
            except StorageError as exc:
                self._respond_missing(worker, conn, task_id, peer_id,
                                      str(exc))
                return
            if not data:
                self._respond_missing(worker, conn, task_id, peer_id,
                                      "range past end of stored content")
                return
            length = len(data)
            conn.kind = KIND_BUFFERED
            conn.data = memoryview(data)
            conn.data_off = 0
        conn.count_piece = length
        conn.head = _head(
            206, length, conn.keep_alive,
            (f"Content-Range: bytes {rng.start}-"
             f"{rng.start + length - 1}/*",))
        conn.head_off = 0
        conn.reserved = min(length, self.limiter.burst)
        delay = self.limiter.reserve_n(conn.reserved)
        self._start_write(worker, conn, delay)

    def _respond_missing(self, worker: _Worker, conn: _Conn, task_id: str,
                         peer_id: str, detail: str) -> None:
        """A requested range is not serveable. Distinguish "not yet"
        from "never": a task the storage KNOWS about in a still-filling
        store answers 404 + ``X-Df2-Not-Ready`` — partial peers serve
        while downloading, and a child that raced ahead of this
        parent's landings must PARK the piece for its next metadata
        sync, not tick corruption/blacklist counters. An unknown task
        is a plain 404; a range beyond a COMPLETED replica is a real
        416 (it will never materialize)."""
        store = (self.storage.get(task_id, peer_id)
                 or self.storage.find_completed_task(task_id))
        if store is not None and not store.meta.done:
            self._respond_bytes(worker, conn, 404,
                                b"piece not yet available",
                                ("X-Df2-Not-Ready: 1",))
            return
        if store is None:
            self._respond_error(worker, conn, 404, detail)
        else:
            self._respond_error(worker, conn, 416, detail)

    def _pick_span_kind(self, conn: _Conn) -> str:
        if conn.tls and not conn.ktls:
            # Without kernel offload, raw-fd writes (native/sendfile)
            # would bypass the record layer and corrupt the stream.
            return KIND_MMAP
        mode = self.serve_path
        if mode == KIND_MMAP:
            return KIND_MMAP
        if mode in ("auto", KIND_NATIVE) and self._native_available():
            return KIND_NATIVE
        if mode in ("auto", KIND_NATIVE, KIND_SENDFILE) \
                and hasattr(os, "sendfile"):
            return KIND_SENDFILE
        return KIND_MMAP

    def _native_available(self) -> bool:
        if self._native_ok is None:
            from dragonfly2_tpu_torch import native

            self._native_ok = native.available()
        return self._native_ok

    # -- metadata (serialized-inventory cache) -----------------------------

    def _handle_metadata(self, worker: _Worker, conn: _Conn,
                         parsed) -> None:
        """``GET /metadata/{task_id}?peerId=`` — the parent's piece
        inventory (the SyncPieceTasks role over the piece-bytes server).
        Children poll this every ``metadata_poll_interval``; the
        serialized body is cached keyed on (store identity, piece count,
        done) so a metadata-poll storm against a stable seed re-serves
        one ``bytes`` instead of re-serializing the list per request."""
        task_id = parsed.path[len(ROUTE_METADATA) + 1:]
        query = urllib.parse.parse_qs(parsed.query)
        peer_id = (query.get("peerId") or [""])[0]
        store = self.storage.get(task_id, peer_id) if peer_id else None
        if store is None or not store.meta.pieces:
            # Prefer a completed replica, but a registered-and-still-empty
            # store (a seed mid-back-source) must answer 200 with an empty
            # piece list — 404 would trip the child's sync watchdog and
            # permanently block a healthy parent.
            store = self.storage.find_completed_task(task_id) or store
        if store is None:
            self._respond_error(worker, conn, 404,
                                f"task {task_id} unknown")
            return
        body = self._metadata_body(task_id, store)
        self._respond_bytes(worker, conn, 200, body,
                            ("Content-Type: application/json",))

    def _metadata_body(self, task_id: str, store) -> bytes:
        import json

        nums = store.existing_piece_nums()
        meta = store.meta
        key = (id(store), meta.peer_id, len(nums), meta.done)
        with self._meta_cache_lock:
            cached = self._meta_cache.get(task_id)
            if cached is not None and cached[0] == key:
                self.metadata_cache_hits += 1
                return cached[1]
        body = json.dumps({
            "taskId": task_id,
            "peerId": meta.peer_id,
            "contentLength": meta.content_length,
            "totalPieces": meta.total_pieces,
            "done": meta.done,
            "pieces": [
                {"num": p.num, "md5": p.md5, "offset": p.offset,
                 "start": p.start, "length": p.length}
                for p in (meta.pieces[n] for n in nums
                          if n in meta.pieces)
            ],
        }).encode()
        with self._meta_cache_lock:
            if len(self._meta_cache) > 1024:
                self._meta_cache.clear()
            self._meta_cache[task_id] = (key, body)
        return body

    # -- responses ---------------------------------------------------------

    def _respond_bytes(self, worker: _Worker, conn: _Conn, status: int,
                       body: bytes, extra: tuple = ()) -> None:
        conn.head = _head(status, len(body), conn.keep_alive, extra)
        conn.head_off = 0
        if body:
            conn.kind = KIND_BUFFERED
            conn.data = memoryview(body)
            conn.data_off = 0
        conn.count_piece = 0  # control responses are not served pieces
        self._start_write(worker, conn, 0.0)

    def _respond_error(self, worker: _Worker, conn: _Conn, status: int,
                       message: str = "", close: bool = False) -> None:
        if close:
            conn.keep_alive = False
        body = (message or _REASONS.get(status, "")).encode()
        self._respond_bytes(worker, conn, status, body)

    def _start_write(self, worker: _Worker, conn: _Conn,
                     delay: float) -> None:
        if delay > 0:
            conn.state = _DELAY
            conn.resume_at = self._clock() + delay
            worker.delayed.add(conn)
            # Stay read-interested while parked: a vanishing peer is
            # detected (recv → b"") instead of burning its tokens.
            worker.set_interest(conn, selectors.EVENT_READ)
            return
        conn.state = _WRITE
        worker.set_interest(conn, selectors.EVENT_WRITE)
        self._continue_write(worker, conn)

    # -- write -------------------------------------------------------------

    def _continue_write(self, worker: _Worker, conn: _Conn) -> None:
        conn.write_wants_read = False
        try:
            while conn.head_off < len(conn.head):
                n = conn.sock.send(
                    memoryview(conn.head)[conn.head_off:])
                conn.head_off += n
            kind = conn.kind
            if kind in (KIND_MMAP, KIND_BUFFERED):
                view = conn.data
                while conn.data_off < len(view):
                    n = conn.sock.send(
                        view[conn.data_off:conn.data_off + SEND_CHUNK])
                    conn.data_off += n
            elif kind == KIND_SENDFILE:
                while conn.remaining > 0:
                    n = os.sendfile(conn.fd, conn.in_fd, conn.file_off,
                                    min(conn.remaining, SENDFILE_CHUNK))
                    if n == 0:
                        raise OSError(errno.EIO, "sendfile EOF mid-span")
                    conn.file_off += n
                    conn.remaining -= n
            elif kind == KIND_NATIVE:
                from dragonfly2_tpu_torch import native

                while conn.remaining > 0:
                    sent = native.send_file_range(
                        conn.fd, conn.in_fd, conn.file_off, conn.remaining)
                    if sent == 0:
                        return  # socket full; resume on writable
                    conn.file_off += sent
                    conn.remaining -= sent
        except (BlockingIOError, InterruptedError, ssl.SSLWantWriteError):
            return  # stay write-interested; resume on writable
        except ssl.SSLWantReadError:
            conn.write_wants_read = True
            worker.set_interest(conn, selectors.EVENT_READ)
            return
        except OSError:
            self._abort_write(worker, conn)
            return
        self._finish_response(worker, conn)

    def _abort_write(self, worker: _Worker, conn: _Conn) -> None:
        """Peer died mid-body. Counts aborted bytes — NEVER a served
        piece (count-after-write contract on every serve path)."""
        if conn.count_piece:
            done = conn.count_piece - conn.body_left()
            self.stats.upload_abort(max(done, 0))
        self._close(worker, conn)

    def _finish_response(self, worker: _Worker, conn: _Conn) -> None:
        kind, served = conn.kind, conn.count_piece
        conn.count_piece = 0   # completed: the close path must not see a
        conn.reserved = 0.0    # live reservation to refund
        self._release_stream(conn)  # slot back before the next admit
        self._release_body(conn)
        if served:
            # Count AFTER the last body byte was handed to the kernel —
            # a failed write must never count phantom traffic.
            if self.metrics is not None:
                self.metrics.upload_piece_count.inc()
                self.metrics.upload_traffic.inc(served)
            self.stats.upload_served(kind, served, tls=conn.tls)
        if not conn.keep_alive:
            self._close(worker, conn)
            return
        conn._reset_response()
        conn.state = _READ
        worker.set_interest(conn, selectors.EVENT_READ)
        if conn.inbuf:
            self._try_dispatch(worker, conn)  # pipelined follow-up

    def _release_body(self, conn: _Conn) -> None:
        if conn.data is not None:
            conn.data.release()
            conn.data = None
        if conn.mm is not None:
            try:
                conn.mm.close()
            except (OSError, ValueError):
                pass
            conn.mm = None
        if conn.in_fd >= 0:
            try:
                os.close(conn.in_fd)
            except OSError:
                pass
            conn.in_fd = -1
        conn.kind = _NO_BODY
        conn.head = b""
        conn.head_off = 0


# --------------------------------------------------------------------------
# Small pure helpers (unit-testable without sockets).
# --------------------------------------------------------------------------


def _parse_head(head: bytes):
    """(method, target, version, lowercase-header dict) or ValueError."""
    lines = head.split(b"\r\n")
    parts = lines[0].split()
    if len(parts) != 3:
        raise ValueError(f"malformed request line {lines[0]!r}")
    method, target, version = (p.decode("latin-1") for p in parts)
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        k, sep, v = line.partition(b":")
        if not sep:
            raise ValueError(f"malformed header {line!r}")
        headers[k.strip().lower().decode("latin-1")] = \
            v.strip().decode("latin-1")
    return method, target, version, headers


def _keep_alive(version: str, headers: Dict[str, str]) -> bool:
    conn_hdr = headers.get("connection", "").lower()
    if version == "HTTP/1.0":
        return conn_hdr == "keep-alive"
    return conn_hdr != "close"


def _head(status: int, length: int, keep_alive: bool,
          extra: tuple = ()) -> bytes:
    """Response head. Content-Length on EVERY response — the native
    fetcher's C parser treats a missing length as malformed."""
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
             f"Content-Length: {length}"]
    lines.extend(extra)
    lines.append("Connection: " + ("keep-alive" if keep_alive else "close"))
    return ("\r\n".join(lines) + "\r\n\r\n").encode()


# `select` is imported for platforms where DefaultSelector needs it at
# teardown (interpreter-shutdown import races); referenced to keep lint
# honest.
_ = select
