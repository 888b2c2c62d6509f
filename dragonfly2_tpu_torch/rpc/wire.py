"""The port's RPC wire: framing over one TCP (or TLS) connection a call.

The JAX package carries its ``ServiceSpec`` methods over grpcio; the port
carries the same methods, the same codec bytes (``rpc/codec.py``) and
gRPC's status semantics over this framing, written with the standard
library alone. It does not interoperate with gRPC peers: each side sends
:data:`MAGIC` first and drops a peer that does not, so a gRPC client or
server on the other end fails at once instead of hanging.

A connection carries one call::

    client → server   MAGIC | HEAD | MSG* | END
    server → client   MAGIC | MSG* | TRAILER

Every frame is a kind byte, a 4-byte big-endian length and the payload,
as gRPC frames a message (its flag byte, its length, the message). MSG
carries one codec-encoded message; HEAD is JSON ``{"method", "metadata",
"timeout"}`` (the full method name, the invocation metadata pairs and
the call's timeout in seconds or null); END is the client's half-close
after its last request; TRAILER is JSON ``{"code", "details"}``, the
call's status and the server's end of stream.
"""

from __future__ import annotations

import json
import select
import socket
import ssl
import struct
import time
from typing import Optional, Tuple

MAGIC = b"DF2WIRE\x01"

MSG = 0
END = 1
HEAD = 2
TRAILER = 3
_KINDS = (MSG, END, HEAD, TRAILER)

_FRAME = struct.Struct(">BI")

#: grpc's default message cap in the JAX package's options, both ways.
MAX_MESSAGE_BYTES = 256 * 1024 * 1024

#: Bound on a HEAD or TRAILER frame (JSON: a method name, metadata pairs,
#: a status detail).
MAX_CONTROL_BYTES = 1 << 20

#: How long a side waits for the other's magic, TLS handshake and head
#: before it drops the connection (a peer of another protocol, a stalled
#: dial).
HANDSHAKE_TIMEOUT_S = 10.0

#: Below this size a message's frame header and payload go out in one
#: write; above it, in two (no copy of a large payload).
_COALESCE_BYTES = 64 << 10


class WireClosed(ConnectionError):
    """The peer closed the connection where a frame was due."""


class ProtocolError(ConnectionError):
    """The peer does not speak this wire (wrong magic, unknown frame)."""


class FrameTooLarge(Exception):
    """A message frame longer than the receiver's cap."""

    def __init__(self, size: int, limit: int):
        super().__init__(f"{size} vs. {limit}")
        self.size = size
        self.limit = limit


def frame(kind: int, payload: bytes = b"") -> bytes:
    return _FRAME.pack(kind, len(payload)) + payload


def encode_head(method: str, metadata, timeout: Optional[float]) -> bytes:
    return json.dumps({"method": method,
                       "metadata": [list(kv) for kv in metadata or ()],
                       "timeout": timeout}).encode()


def decode_head(payload: bytes) -> Tuple[str, tuple, Optional[float]]:
    head = json.loads(bytes(payload).decode())
    timeout = head.get("timeout")
    return (str(head["method"]),
            tuple((str(k), str(v)) for k, v in head.get("metadata") or ()),
            None if timeout is None else float(timeout))


def encode_trailer(code: int, details: str) -> bytes:
    return json.dumps({"code": int(code), "details": details}).encode()


def decode_trailer(payload: bytes) -> Tuple[int, str]:
    trailer = json.loads(bytes(payload).decode())
    return int(trailer["code"]), str(trailer.get("details", ""))


def split_target(target: str) -> Tuple[str, int]:
    """``host:port`` or ``[v6]:port`` → (host, port)."""
    host, sep, port = target.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"target {target!r} is not host:port")
    return host.strip("[]") or "127.0.0.1", int(port)


class Conn:
    """One call's connection: whole frames in and out."""

    def __init__(self, sock: socket.socket):
        self.sock = sock

    def settimeout(self, seconds: Optional[float]) -> None:
        self.sock.settimeout(seconds)

    def send(self, data: bytes) -> None:
        self.sock.sendall(data)

    def send_message(self, payload: bytes, prefix: bytes = b"",
                     suffix: bytes = b"") -> None:
        """``prefix`` (frames already built), one MSG frame, ``suffix``."""
        header = _FRAME.pack(MSG, len(payload))
        if len(payload) <= _COALESCE_BYTES:
            self.sock.sendall(b"".join((prefix, header, payload, suffix)))
            return
        self.sock.sendall(prefix + header)
        self.sock.sendall(payload)
        if suffix:
            self.sock.sendall(suffix)

    def recv_exact(self, n: int) -> bytearray:
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            k = self.sock.recv_into(view[got:], n - got)
            if k == 0:
                raise WireClosed(f"peer closed after {got} of {n} bytes")
            got += k
        return buf

    def expect_magic(self) -> None:
        try:
            got = self.recv_exact(len(MAGIC))
        except WireClosed as exc:
            raise ProtocolError(
                "peer closed before the DF2 wire's magic") from exc
        if bytes(got) != MAGIC:
            raise ProtocolError("peer does not speak the DF2 wire")

    def recv_frame(self, limit: int) -> Tuple[int, bytearray]:
        """(kind, payload). A MSG over ``limit`` raises
        :class:`FrameTooLarge` before its payload is read."""
        kind, n = _FRAME.unpack(self.recv_exact(_FRAME.size))
        if kind not in _KINDS:
            raise ProtocolError(f"unknown frame kind {kind}")
        cap = limit if kind == MSG else MAX_CONTROL_BYTES
        if n > cap:
            if kind != MSG:
                raise ProtocolError(f"control frame of {n} bytes")
            raise FrameTooLarge(n, limit)
        return kind, self.recv_exact(n) if n else bytearray()

    def peer_closed(self) -> bool:
        """True when the peer has closed its end (read without
        consuming; never blocks)."""
        try:
            # A socket with a timeout waits for input before its recv
            # whatever the flags: ask select first.
            readable, _, _ = select.select([self.sock], [], [], 0)
            if not readable:
                return False
            # The raw socket's recv, also under TLS: an orderly close
            # reads as b"", whatever the record layer buffered.
            data = socket.socket.recv(self.sock, 1,
                                      socket.MSG_PEEK | socket.MSG_DONTWAIT)
        except (BlockingIOError, InterruptedError):
            return False
        except (OSError, ValueError):
            return True
        return data == b""

    def await_close(self, seconds: float = HANDSHAKE_TIMEOUT_S) -> None:
        """The server's end of a call, after its trailer: read (and drop)
        what the client still sends until it closes, for up to
        ``seconds``, then close. The client closes first, so the
        TIME_WAIT of the connection is the client's: a server-side one
        can stall a later connect that happens to reuse its client port
        (the kernel answers that SYN for the old connection), and
        closing with input unread would reset the connection, which can
        destroy a trailer the client has not read."""
        try:
            end = time.monotonic() + seconds
            while (left := end - time.monotonic()) > 0:
                self.sock.settimeout(left)
                if not self.sock.recv(1 << 16):
                    break
        except (OSError, ValueError):
            pass
        self.close()

    def abort(self) -> None:
        """End the connection at once in both directions."""
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.close()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def connect(target: str, tls: Optional[ssl.SSLContext] = None,
            server_hostname: str = "",
            timeout: Optional[float] = HANDSHAKE_TIMEOUT_S) -> Conn:
    """Dial ``target`` (TLS when ``tls`` is given) and return the
    connection, its timeout still ``timeout``."""
    host, port = split_target(target)
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if tls is not None:
            sock = tls.wrap_socket(sock,
                                   server_hostname=server_hostname or host)
    except BaseException:
        sock.close()
        raise
    return Conn(sock)
