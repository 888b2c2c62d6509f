"""Client stubs: retry/backoff + consistent-hash multi-target balancing —
port of ``dragonfly2_tpu/rpc/client.py`` over the port's wire
(``rpc/wire.py``) instead of a grpc channel.

- ``ServiceClient`` calls one target, a connection a call, with methods
  as attributes and exponential-backoff retry on UNAVAILABLE (pkg/rpc
  interceptor stack). A call that ends with a status other than OK
  raises :class:`~dragonfly2_tpu_torch.rpc.status.RpcError`; a call past
  its ``timeout`` raises DEADLINE_EXCEEDED here, whatever the server
  does later.
- ``HashRing`` is the consistent-hashing balancer keyed by task ID
  (pkg/balancer/consistent_hashing.go:51-124): all peers of a task reach the
  same scheduler instance regardless of which daemon they sit on.
- ``BalancedClient`` keeps one ServiceClient per live target and routes each
  call by key through the ring, mirroring the resolver+balancer pair fed by
  dynconfig (pkg/resolver/scheduler_resolver.go).
"""

from __future__ import annotations

import bisect
import hashlib
import itertools
import ssl
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

from dragonfly2_tpu_torch.rpc import wire
from dragonfly2_tpu_torch.rpc.codec import decode, encode
from dragonfly2_tpu_torch.rpc.service import (
    MethodKind,
    ServiceSpec,
    message_limits,
)
from dragonfly2_tpu_torch.rpc.status import RpcError, StatusCode

_RETRYABLE = (StatusCode.UNAVAILABLE,)


class RpcRetryError(RuntimeError):
    pass


class ClientTLS:
    """Client-side TLS (pkg/rpc/credential.go): trust roots + optional
    client cert/key for mTLS. ``server_name_override`` is the name the
    server's certificate is checked against (``server_hostname``), so
    tests can dial 127.0.0.1 with a hostname-SAN cert."""

    def __init__(self, ca_path: str, cert_path: str = "",
                 key_path: str = "", server_name_override: str = ""):
        self.ca_path = ca_path
        self.cert_path = cert_path
        self.key_path = key_path
        self.server_name_override = server_name_override

    def ssl_context(self) -> ssl.SSLContext:
        ctx = ssl.create_default_context(cafile=self.ca_path)
        if self.cert_path and self.key_path:
            ctx.load_cert_chain(self.cert_path, self.key_path)
        return ctx


def _failure(exc: BaseException, deadline: Optional[float]) -> RpcError:
    """The status a transport fault ends a call with: DEADLINE_EXCEEDED
    once the deadline has passed, RESOURCE_EXHAUSTED for a reply over
    the cap, UNAVAILABLE for everything else (no connection, a dial or
    handshake that timed out before the deadline, a reset, a peer of
    another protocol)."""
    if isinstance(exc, RpcError):
        return exc
    if isinstance(exc, wire.FrameTooLarge):
        return RpcError(StatusCode.RESOURCE_EXHAUSTED,
                        f"Received message larger than max ({exc})")
    # A socket timeout set to the time left fires at the deadline; the
    # millisecond absorbs the clocks' rounding.
    if deadline is not None and time.monotonic() >= deadline - 1e-3:
        return RpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")
    return RpcError(StatusCode.UNAVAILABLE, f"{type(exc).__name__}: {exc}")


class _Call:
    """One call's connection, from the dial to the trailer."""

    def __init__(self, client: "ServiceClient", method: str,
                 timeout: Optional[float], metadata):
        self.client = client
        self.deadline = (None if timeout is None
                         else time.monotonic() + timeout)
        self.conn: Optional[wire.Conn] = None
        try:
            self.conn = wire.connect(
                client.target, client._tls_context,
                client.tls.server_name_override if client.tls else "",
                self._timeout(wire.HANDSHAKE_TIMEOUT_S))
            self.conn.send(wire.MAGIC + wire.frame(
                wire.HEAD, wire.encode_head(method, metadata, timeout)))
        except Exception as exc:
            self.close()
            raise _failure(exc, self.deadline) from None

    def _timeout(self, cap: Optional[float] = None) -> Optional[float]:
        if self.deadline is None:
            return cap
        left = self.deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError("deadline passed")
        return left if cap is None else min(left, cap)

    def encode(self, request) -> bytes:
        payload = encode(request)
        if len(payload) > self.client._max_send:
            raise RpcError(StatusCode.RESOURCE_EXHAUSTED,
                           f"Sent message larger than max ({len(payload)} "
                           f"vs. {self.client._max_send})")
        return payload

    def send_request(self, payload: bytes, end: bool) -> None:
        self.conn.settimeout(self._timeout())
        self.conn.send_message(payload,
                               suffix=wire.frame(wire.END) if end else b"")

    def send_end(self) -> None:
        self.conn.settimeout(self._timeout())
        self.conn.send(wire.frame(wire.END))

    def replies(self) -> Iterator[Any]:
        """The server's messages until its trailer; a status other than
        OK raises."""
        try:
            # No cap but the deadline: a busy server answers once a
            # worker takes the call, as grpc's queued calls wait.
            self.conn.settimeout(self._timeout())
            self.conn.expect_magic()
            while True:
                self.conn.settimeout(self._timeout())
                kind, payload = self.conn.recv_frame(self.client._max_recv)
                if kind == wire.MSG:
                    try:
                        reply = decode(payload)
                    except Exception:  # noqa: BLE001 — the server's bytes
                        raise RpcError(StatusCode.INTERNAL,
                                       "Exception deserializing response!"
                                       ) from None
                    yield reply
                elif kind == wire.TRAILER:
                    code, details = wire.decode_trailer(payload)
                    if code != StatusCode.OK.value:
                        raise RpcError(StatusCode(code), details)
                    return
                else:
                    raise wire.ProtocolError(f"unexpected frame {kind}")
        except Exception as exc:
            raise _failure(exc, self.deadline) from None
        finally:
            self.close()

    def close(self) -> None:
        if self.conn is not None:
            self.conn.close()

    def abort(self) -> None:
        if self.conn is not None:
            self.conn.abort()


def _send_unary(call: _Call, request) -> None:
    try:
        payload = call.encode(request)
    except BaseException:
        call.close()
        raise
    try:
        call.send_request(payload, end=True)
    except OSError:
        pass  # the server answered early; its trailer says why


def _only_reply(replies: Iterator[Any]):
    out = list(replies)
    if len(out) != 1:
        raise RpcError(StatusCode.INTERNAL,
                       f"{len(out)} reply messages to a unary call")
    return out[0]


class ServiceClient:
    """One target; methods appear as attributes.

    Streaming request methods take an iterator; streaming responses return
    an iterator. Retries apply only to unary-request kinds (a consumed
    request iterator cannot be replayed). ``options`` takes grpc's
    ``grpc.max_send_message_length`` / ``grpc.max_receive_message_length``
    (256 MiB each by default).
    """

    def __init__(
        self,
        target: str,
        spec: ServiceSpec,
        retries: int = 3,
        backoff: float = 0.05,
        options: Optional[Iterable[tuple[str, Any]]] = None,
        tls: Optional["ClientTLS"] = None,
    ) -> None:
        self.target = target
        self.spec = spec
        self.retries = retries
        self.backoff = backoff
        self.tls = tls
        self._tls_context = tls.ssl_context() if tls is not None else None
        self._max_send, self._max_recv = message_limits(options)
        self._closed = False
        ctor = {
            MethodKind.UNARY_UNARY: self._unary_unary,
            MethodKind.UNARY_STREAM: self._unary_stream,
            MethodKind.STREAM_UNARY: self._stream_unary,
            MethodKind.STREAM_STREAM: self._stream_stream,
        }
        self._calls: Dict[str, Callable] = {}
        self._kinds: Dict[str, MethodKind] = {}
        for method, kind in spec.methods.items():
            full = spec.full_method(method)
            self._calls[method] = (
                lambda request, timeout=None, metadata=None, _f=full,
                _c=ctor[kind]: _c(_f, request, timeout, metadata))
            self._kinds[method] = kind

    def _open(self, full: str, timeout, metadata) -> _Call:
        if self._closed:
            raise ValueError("Cannot invoke RPC on closed channel!")
        return _Call(self, full, timeout, metadata)

    def _unary_unary(self, full, request, timeout, metadata):
        call = self._open(full, timeout, metadata)
        _send_unary(call, request)
        return _only_reply(call.replies())

    def _unary_stream(self, full, request, timeout, metadata):
        call = self._open(full, timeout, metadata)
        _send_unary(call, request)
        return call.replies()

    def _stream_unary(self, full, request_iterator, timeout, metadata):
        call = self._open(full, timeout, metadata)
        _send_stream(call, request_iterator)
        return _only_reply(call.replies())

    def _stream_stream(self, full, request_iterator, timeout, metadata):
        call = self._open(full, timeout, metadata)
        failed: list = []
        sender = threading.Thread(
            target=_send_stream, args=(call, request_iterator, failed),
            name=f"rpc-send{full}", daemon=True)
        sender.start()

        def replies():
            try:
                yield from call.replies()
            except RpcError:
                if failed:
                    raise failed[0] from None
                raise
            finally:
                # The sender may still wait on the caller's iterator; it
                # is a daemon and its next write fails.
                call.abort()
        return replies()

    def __getattr__(self, method: str) -> Callable:
        try:
            call = self._calls[method]
            kind = self._kinds[method]
        except KeyError:
            raise AttributeError(method) from None
        from dragonfly2_tpu_torch.utils.tracing import (
            default_tracer,
            inject_metadata,
        )

        full = self.spec.full_method(method)
        if kind in (MethodKind.UNARY_UNARY, MethodKind.UNARY_STREAM):
            # A unary-stream reply stream raises only at its first
            # next(); prefetch inside the retry loop so UNAVAILABLE is
            # actually retried as the class docstring promises.
            prefetch = kind == MethodKind.UNARY_STREAM

            def invoke(request, timeout: Optional[float] = None, **kw):
                with default_tracer().span(f"rpc.client{full}",
                                           target=self.target):
                    # Inject INSIDE the span so the server's remote
                    # parent is this client span, not its parent.
                    kw.setdefault("metadata", inject_metadata([]))
                    return self._retrying(
                        call, request, timeout=timeout, prefetch=prefetch,
                        **kw
                    )
        else:
            def invoke(request_iterator, timeout: Optional[float] = None, **kw):
                kw.setdefault("metadata", inject_metadata([]))
                return call(request_iterator, timeout=timeout, **kw)
        invoke.__name__ = method
        return invoke

    def _retrying(self, call, request, prefetch: bool = False, **kw):
        delay = self.backoff
        for attempt in range(self.retries + 1):
            try:
                result = call(request, **kw)
                return _prefetched(result) if prefetch else result
            except RpcError as err:
                if err.code() not in _RETRYABLE or attempt == self.retries:
                    raise
                time.sleep(delay)
                delay *= 2
        raise RpcRetryError("unreachable")

    def wait_ready(self, timeout: float = 5.0) -> None:
        """Block until the target accepts a connection that speaks the
        wire (TimeoutError after ``timeout``)."""
        from dragonfly2_tpu_torch.rpc.health import (
            HEALTH_SPEC,
            HealthCheckRequest,
        )

        end = time.monotonic() + timeout
        probe = ServiceClient(self.target, HEALTH_SPEC, retries=0,
                              tls=self.tls)
        while True:
            left = end - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{self.target} not ready in {timeout}s")
            try:
                probe.Check(HealthCheckRequest(), timeout=left)
                return
            except RpcError as err:
                if err.code() is not StatusCode.UNAVAILABLE:
                    return  # it answered
            time.sleep(min(0.05, max(end - time.monotonic(), 0)))

    def close(self) -> None:
        self._closed = True


def _send_stream(call: _Call, request_iterator, failed=None) -> None:
    """Send every request of ``request_iterator``, then END. A request
    iterator that raises cuts the connection, so the server sees a
    cancelled stream, and the call fails UNKNOWN as grpc's does."""
    try:
        for request in request_iterator:
            call.send_request(call.encode(request), end=False)
        call.send_end()
    except RpcError as err:  # a request over the cap
        if failed is not None:
            failed.append(err)  # before the abort the reader will see
        call.abort()
        if failed is None:
            raise
    except OSError:
        pass  # the server ended the call early; its trailer says why
    except Exception:  # noqa: BLE001 — the caller's iterator failed
        err = RpcError(StatusCode.UNKNOWN, "Exception iterating requests!")
        if failed is not None:
            failed.append(err)
        call.abort()
        if failed is None:
            raise err from None


class HashRing:
    """Consistent-hash ring with virtual nodes (sha256, 100 replicas)."""

    REPLICAS = 100

    def __init__(self, targets: Sequence[str] = ()) -> None:
        self._lock = threading.Lock()
        self._ring: List[tuple[int, str]] = []
        self._targets: set[str] = set()
        for t in targets:
            self.add(t)

    @staticmethod
    def _hash(key: str) -> int:
        return int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "big")

    def add(self, target: str) -> None:
        with self._lock:
            if target in self._targets:
                return
            self._targets.add(target)
            for i in range(self.REPLICAS):
                bisect.insort(self._ring, (self._hash(f"{target}#{i}"), target))

    def remove(self, target: str) -> None:
        with self._lock:
            if target not in self._targets:
                return
            self._targets.discard(target)
            self._ring = [(h, t) for h, t in self._ring if t != target]

    @property
    def targets(self) -> set[str]:
        with self._lock:
            return set(self._targets)

    def pick(self, key: str) -> str:
        with self._lock:
            if not self._ring:
                raise RpcRetryError("hash ring is empty")
            h = self._hash(key)
            idx = bisect.bisect_left(self._ring, (h, ""))
            if idx == len(self._ring):
                idx = 0
            return self._ring[idx][1]

    def walk(self, key: str) -> Iterator[str]:
        """Targets in ring order from the key's owner — failover order."""
        seen = set()
        with self._lock:
            ring = list(self._ring)
        if not ring:
            return
        h = self._hash(key)
        idx = bisect.bisect_left(ring, (h, ""))
        for i in range(len(ring)):
            t = ring[(idx + i) % len(ring)][1]
            if t not in seen:
                seen.add(t)
                yield t


def _prefetched(stream) -> Iterator[Any]:
    """Pull the first item eagerly so connect errors raise at call time."""
    try:
        first = next(stream)
    except StopIteration:
        return iter(())
    return itertools.chain([first], stream)


class BalancedClient:
    """Task-affine multi-target client (balancer + resolver pair).

    ``update_targets`` is the dynconfig observer hook: when the manager's
    scheduler list changes, the ring and the client cache follow.
    """

    def __init__(self, spec: ServiceSpec, targets: Sequence[str] = (), **client_kw) -> None:
        self.spec = spec
        self._client_kw = client_kw
        self.ring = HashRing(targets)
        self._clients: Dict[str, ServiceClient] = {}
        self._lock = threading.Lock()

    def update_targets(self, targets: Sequence[str]) -> None:
        desired = set(targets)
        for t in desired - self.ring.targets:
            self.ring.add(t)
        for t in self.ring.targets - desired:
            self.ring.remove(t)
            with self._lock:
                old = self._clients.pop(t, None)
            if old is not None:
                old.close()

    def client_for(self, key: str) -> ServiceClient:
        return self._client_at(self.ring.pick(key))

    def _client_at(self, target: str) -> ServiceClient:
        with self._lock:
            cli = self._clients.get(target)
            if cli is None:
                cli = ServiceClient(target, self.spec, **self._client_kw)
                self._clients[target] = cli
        return cli

    def call(self, key: str, method: str, request, failover: bool = True, **kw):
        """Unary-request call routed by key; on UNAVAILABLE walk the ring.

        A server-streaming reply raises at its first ``next()``, not at
        call time, so the first response is prefetched here to keep
        failover inside this loop. Stream-request methods are not
        balanceable (a consumed iterator cannot replay); use
        ``client_for(key)`` and manage the stream directly.
        """
        kind = self.spec.methods[method]
        if kind in (MethodKind.STREAM_UNARY, MethodKind.STREAM_STREAM):
            raise ValueError(
                f"{method} has a streaming request; use client_for(key)"
            )
        last: Optional[Exception] = None
        for target in self.ring.walk(key) if failover else [self.ring.pick(key)]:
            cli = self._client_at(target)
            try:
                # ServiceClient already prefetches UNARY_STREAM results, so
                # connect errors raise here, inside the failover walk.
                return getattr(cli, method)(request, **kw)
            except RpcError as err:
                if err.code() not in _RETRYABLE:
                    raise
                last = err
        raise last if last is not None else RpcRetryError("no targets")

    def close(self) -> None:
        with self._lock:
            for cli in self._clients.values():
                cli.close()
            self._clients.clear()
