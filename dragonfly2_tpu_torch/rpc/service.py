"""Declarative service assembly over the port's wire — port of
``dragonfly2_tpu/rpc/service.py``.

A ``ServiceSpec`` lists methods with their streaming kinds; ``serve``
mounts implementations on a listener that speaks ``rpc/wire.py`` with the
DF2 codec as the (de)serializer: the shell JAX builds on grpcio, with
grpc's status semantics. A method aborts through ``context.abort(code,
details)``, which raises and ends the call with that status; an uncaught
exception ends it INTERNAL with ``"<Type>: <message>"``. Liveness is the
DF2-spec'd Health service (``rpc/health.py``), mounted on every server.
"""

from __future__ import annotations

import enum
import logging
import socket
import ssl
import threading
import time
from concurrent import futures
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

from dragonfly2_tpu_torch.rpc import wire
from dragonfly2_tpu_torch.rpc.codec import decode, encode
from dragonfly2_tpu_torch.rpc.status import RpcAbort, RpcError, StatusCode

logger = logging.getLogger(__name__)


class MethodKind(enum.Enum):
    UNARY_UNARY = "uu"
    UNARY_STREAM = "us"
    STREAM_UNARY = "su"
    STREAM_STREAM = "ss"


_STREAM_REQUEST = (MethodKind.STREAM_UNARY, MethodKind.STREAM_STREAM)
_STREAM_RESPONSE = (MethodKind.UNARY_STREAM, MethodKind.STREAM_STREAM)


@dataclass(frozen=True)
class ServiceSpec:
    """Full service name + method kinds, e.g. ``df2.scheduler.Scheduler``."""

    name: str
    methods: Dict[str, MethodKind] = field(default_factory=dict)

    def full_method(self, method: str) -> str:
        return f"/{self.name}/{method}"


def message_limits(options: Optional[Iterable[tuple[str, Any]]]
                   ) -> tuple[int, int]:
    """(send cap, receive cap) from grpc-named channel/server options;
    256 MiB each by default, as the JAX package's options set them."""
    opts = dict(options or ())
    return (int(opts.get("grpc.max_send_message_length",
                         wire.MAX_MESSAGE_BYTES)),
            int(opts.get("grpc.max_receive_message_length",
                         wire.MAX_MESSAGE_BYTES)))


class ServerContext:
    """A call's server-side context: grpc's ``ServicerContext`` surface
    that the services use."""

    def __init__(self, conn: wire.Conn, metadata: tuple,
                 timeout: Optional[float]):
        self._conn = conn
        self._metadata = metadata
        self._deadline = (None if timeout is None
                          else time.monotonic() + timeout)
        self._aborted: Optional[tuple] = None
        self._client_gone = False
        self._done = False

    def abort(self, code: StatusCode, details: str):
        """End the call with ``code``: raises, as grpc's does."""
        self._aborted = (code, details)
        raise RpcAbort(code, details)

    def is_active(self) -> bool:
        """False once the client hung up, the deadline passed or the call
        ended."""
        if self._done or self._client_gone:
            return False
        if self._deadline is not None and time.monotonic() >= self._deadline:
            return False
        if self._conn.peer_closed():
            self._client_gone = True
            return False
        return True

    def invocation_metadata(self) -> tuple:
        return self._metadata

    def time_remaining(self) -> Optional[float]:
        if self._deadline is None:
            return None
        return max(self._deadline - time.monotonic(), 0.0)

    def _read_timeout(self) -> Optional[float]:
        left = self.time_remaining()
        return None if left is None else max(left, 1e-3)


class _ClientGone(Exception):
    """The client hung up: nothing more can reach it."""


def _requests(conn: wire.Conn, context: ServerContext, limit: int):
    """The request stream of a streaming-request call: messages until the
    client's END. A hang-up before END raises CANCELLED (and turns
    ``is_active`` False), as grpc's request iterator raises on a
    cancelled call."""
    while True:
        try:
            conn.settimeout(context._read_timeout())
            kind, payload = conn.recv_frame(limit)
        except wire.FrameTooLarge as exc:
            raise RpcError(StatusCode.RESOURCE_EXHAUSTED,
                           f"Received message larger than max ({exc})"
                           ) from None
        except OSError:  # a reset, a close, bytes of another protocol
            context._client_gone = True
            raise RpcError(StatusCode.CANCELLED,
                           "the client ended the stream") from None
        if kind == wire.END:
            return
        if kind != wire.MSG:
            context._client_gone = True
            raise RpcError(StatusCode.CANCELLED,
                           f"unexpected frame kind {kind} in the stream")
        try:
            request = decode(payload)
        except Exception:  # noqa: BLE001 — any bad bytes are the client's
            raise RpcError(StatusCode.INTERNAL,
                           "Exception deserializing request!") from None
        yield request


def _one_request(conn: wire.Conn, context: ServerContext, limit: int):
    """A unary call's request: its MSG, then END."""
    requests = _requests(conn, context, limit)
    first = next(requests, None)
    if first is None:
        raise RpcError(StatusCode.INTERNAL, "no request message")
    if next(requests, None) is not None:
        raise RpcError(StatusCode.INTERNAL, "more than one request message")
    return first


class _Method:
    def __init__(self, full: str, kind: MethodKind, fn: Callable):
        self.full = full
        self.kind = kind
        self.fn = fn


def generic_handler(spec: ServiceSpec, impl: Any) -> Dict[str, _Method]:
    """full method name → the method bound on ``impl``."""
    return {spec.full_method(m): _Method(spec.full_method(m), kind,
                                         getattr(impl, m))
            for m, kind in spec.methods.items()}


@dataclass
class ServerTLS:
    """Server-side TLS material (pkg/rpc/credential.go's role).

    ``client_ca_path`` set ⇒ mutual TLS: clients must present a cert
    signed by that CA (the reference's mTLS security mode)."""

    cert_path: str
    key_path: str
    client_ca_path: str = ""

    def ssl_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.cert_path, self.key_path)
        if self.client_ca_path:
            ctx.verify_mode = ssl.CERT_REQUIRED
            ctx.load_verify_locations(self.client_ca_path)
        return ctx


class WireServer:
    """The listener: accepts connections and serves each call on a
    bounded pool of ``max_workers`` threads (a call past them waits for
    a free one, as on grpc's thread pool)."""

    def __init__(self, methods: Dict[str, _Method], host: str, port: int,
                 max_workers: int, tls: Optional[ServerTLS],
                 options=None):
        self._methods = methods
        self._max_send, self._max_recv = message_limits(options)
        self._tls = tls.ssl_context() if tls is not None else None
        self._listener = socket.create_server((host, port))
        self.port = self._listener.getsockname()[1]
        self._pool = futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="rpc-worker")
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        # accepted socket → the socket its call runs on (the TLS one
        # once wrapped), None while it waits for a worker.
        self._conns: Dict[socket.socket, Optional[socket.socket]] = {}
        self._stopped = False
        self._acceptor = threading.Thread(
            target=self._accept_loop, name=f"rpc-accept-{self.port}",
            daemon=True)

    def start(self) -> None:
        self._acceptor.start()

    def _accept_loop(self) -> None:
        while True:
            try:
                sock, _ = self._listener.accept()
            except OSError:
                if self._stopped:
                    return
                time.sleep(0.01)  # out of descriptors: let calls end
                continue
            with self._lock:
                if self._stopped:
                    sock.close()
                    return
                self._conns[sock] = None
            self._pool.submit(self._serve, sock)

    def stop(self, grace: Optional[float]) -> None:
        """Refuse new calls, let calls in flight end for up to ``grace``
        seconds, then cut the rest off."""
        with self._lock:
            self._stopped = True
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._listener.close()
        self._acceptor.join(timeout=5)
        end = time.monotonic() + (grace or 0.0)
        with self._idle:
            while self._conns and (left := end - time.monotonic()) > 0:
                self._idle.wait(left)
        self._pool.shutdown(wait=False, cancel_futures=True)
        with self._lock:
            cut = dict(self._conns)
        for raw, live in cut.items():
            if live is None:  # never reached a worker
                with self._lock:
                    self._conns.pop(raw, None)
                raw.close()
                continue
            try:  # the worker's reads and writes fail; it closes
                live.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def _serve(self, sock: socket.socket) -> None:
        raw = sock
        conn = None
        with self._lock:
            if raw not in self._conns:  # cut off by stop()
                return
            self._conns[raw] = raw
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(wire.HANDSHAKE_TIMEOUT_S)
            if self._tls is not None:
                sock = self._tls.wrap_socket(sock, server_side=True)
                with self._lock:
                    self._conns[raw] = sock
            conn = wire.Conn(sock)
            conn.expect_magic()
            conn.send(wire.MAGIC)
            kind, payload = conn.recv_frame(0)
            if kind != wire.HEAD:
                raise wire.ProtocolError("first frame is not a head")
            method, metadata, timeout = wire.decode_head(payload)
            self._call(conn, method, metadata, timeout)
        except (OSError, ValueError, KeyError) as exc:
            # A peer of another protocol, a TLS failure, a bad head.
            logger.debug("rpc connection dropped: %s", exc)
        except Exception:  # noqa: BLE001 — the worker must go on
            logger.exception("rpc connection failed")
        finally:
            if conn is not None:
                conn.close()
            else:
                sock.close()
            with self._idle:
                self._conns.pop(raw, None)
                self._idle.notify_all()

    def _call(self, conn: wire.Conn, name: str, metadata: tuple,
              timeout: Optional[float]) -> None:
        method = self._methods.get(name)
        context = ServerContext(conn, metadata, timeout)
        if method is None:
            self._finish(conn, StatusCode.UNIMPLEMENTED, "Method not found!")
            return
        from dragonfly2_tpu_torch.utils.tracing import (
            default_tracer,
            extract_metadata,
        )

        remote = extract_metadata(metadata)
        with default_tracer().span(f"rpc.server{name}",
                                   remote_parent=remote):
            try:
                code, details = self._run(conn, method, context)
            except _ClientGone:
                context._client_gone = True
                return
            finally:
                context._done = True
        self._finish(conn, code, details)

    def _run(self, conn: wire.Conn, method: _Method,
             context: ServerContext) -> tuple:
        """Run the handler and send its replies → the call's status."""
        try:
            if method.kind in _STREAM_REQUEST:
                request = _requests(conn, context, self._max_recv)
            else:
                request = _one_request(conn, context, self._max_recv)
            result = method.fn(request, context)
            if method.kind in _STREAM_RESPONSE:
                try:
                    for reply in result:
                        self._send(conn, reply)
                finally:
                    close = getattr(result, "close", None)
                    if close is not None:
                        close()
            else:
                self._send(conn, result)
            return StatusCode.OK, ""
        except _ClientGone:
            raise
        except RpcAbort as exc:
            return exc.code, exc.details
        except RpcError as exc:
            if context._client_gone:
                raise _ClientGone() from None
            return exc.code(), exc.details()
        except Exception as exc:  # noqa: BLE001 — service boundary
            if context._aborted is not None:
                return context._aborted
            logger.exception("rpc %s failed", method.full)
            return StatusCode.INTERNAL, f"{type(exc).__name__}: {exc}"

    def _send(self, conn: wire.Conn, reply) -> None:
        try:
            payload = encode(reply)
        except Exception:  # noqa: BLE001 — reported as grpc reports it
            raise RpcError(StatusCode.INTERNAL,
                           "Failed to serialize response!") from None
        if len(payload) > self._max_send:
            raise RpcError(StatusCode.RESOURCE_EXHAUSTED,
                           f"Sent message larger than max "
                           f"({len(payload)} vs. {self._max_send})")
        try:
            conn.settimeout(None)
            conn.send_message(payload)
        except OSError:
            raise _ClientGone() from None

    def _finish(self, conn: wire.Conn, code: StatusCode,
                details: str) -> None:
        try:
            conn.settimeout(wire.HANDSHAKE_TIMEOUT_S)
            conn.send(wire.frame(wire.TRAILER,
                                 wire.encode_trailer(code.value, details)))
        except OSError:
            return
        conn.await_close()


class RpcServer:
    """A started server: ``port``, ``target`` and the auto-mounted DF2
    ``health`` service (callers flip per-service statuses, e.g. the
    sidecar's hot-reload grace window); ``stop()`` drains through
    NOT_SERVING so health-aware clients stop routing here before the
    listener dies."""

    def __init__(self, server: WireServer, port: int, health: Any = None):
        self.server = server
        self.port = port
        self.health = health

    @property
    def target(self) -> str:
        return f"127.0.0.1:{self.port}"

    def stop(self, grace: Optional[float] = 0.5,
             drain_s: float = 0.0) -> None:
        """Flip NOT_SERVING, optionally hold the listener open for
        ``drain_s`` (cooperative handoff window: health-aware clients
        stop routing NEW work here and re-home in-flight peers through
        their re-registration path while this server still answers),
        then stop with the ``grace`` for calls in flight."""
        if self.health is not None:
            from dragonfly2_tpu_torch.rpc.health import NOT_SERVING

            self.health.set_status("", NOT_SERVING)
        if drain_s > 0:
            # Honored even without a health service: the open listener
            # is the drain window; health just advertises it.
            time.sleep(drain_s)
        self.server.stop(grace)


def serve(
    services: Sequence[tuple[ServiceSpec, Any]],
    host: str = "127.0.0.1",
    port: int = 0,
    max_workers: int = 16,
    options: Optional[Iterable[tuple[str, Any]]] = None,
    tls: Optional[ServerTLS] = None,
    health: Any = None,
) -> RpcServer:
    """Bind and start a server hosting the given (spec, impl) pairs.

    A DF2 health service is always mounted (pass ``health`` to share an
    instance the caller also flips, e.g. for drain windows); every
    hosted service is marked SERVING at start, and ``RpcServer.stop``
    flips the whole server to NOT_SERVING before the listener dies.
    ``options`` takes grpc's ``grpc.max_send_message_length`` and
    ``grpc.max_receive_message_length`` (256 MiB each by default)."""
    from dragonfly2_tpu_torch.rpc.health import (
        HEALTH_SPEC,
        SERVING,
        HealthService,
    )

    health = health or HealthService()
    methods: Dict[str, _Method] = {}
    for spec, impl in list(services) + [(HEALTH_SPEC, health)]:
        methods.update(generic_handler(spec, impl))
        if spec is not HEALTH_SPEC:
            health.set_status(spec.name, SERVING)
    health.set_status("", SERVING)
    try:
        server = WireServer(methods, host, port, max_workers, tls, options)
    except OSError as exc:
        raise OSError(f"cannot bind {host}:{port}: {exc}") from exc
    server.start()
    return RpcServer(server=server, port=server.port, health=health)


__all__ = ["MethodKind", "RpcServer", "ServerContext", "ServerTLS",
           "ServiceSpec", "generic_handler", "message_limits", "serve"]
