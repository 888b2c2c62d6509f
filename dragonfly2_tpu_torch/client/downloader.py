"""Piece downloader and dispatcher — the peer-to-peer data path.

Reference counterparts:
- ``PieceDownloader`` (client/daemon/peer/piece_downloader.go:67,165-225):
  HTTP ``GET http://{parent}/download/{taskID[:3]}/{taskID}?peerId=...`` with
  a ``Range`` header selecting the piece bytes; md5-verified on arrival.
- ``PieceDispatcher`` (client/daemon/peer/piece_dispatcher.go:33-172): queues
  candidate (parent, piece) requests, scores parents by smoothed download
  time (``score = (last + cost)/2``, failures pulled toward a 60 s penalty),
  serves the best-scored parent with ε-random exploration (``random_ratio``).
"""

from __future__ import annotations

import errno
import hashlib
import http.client
import os
import random
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from dragonfly2_tpu_torch import native
from dragonfly2_tpu_torch.client.dataplane import HTTPConnectionPool
from dragonfly2_tpu_torch.client.piece import PieceMetadata
from dragonfly2_tpu_torch.utils import faultplan, geoplan

MAX_SCORE_NS = 0                     # best (lower is better)
MIN_SCORE_NS = 60 * 1_000_000_000    # failure penalty pole


class DownloadPieceError(Exception):
    """A piece fetch failed. ``fatal`` marks failures no other parent
    can fix (disk full): the conductor fails the task instead of
    burning the retry budget. ``not_ready`` marks a parent that does
    not hold the piece YET (a partial peer still downloading, HTTP
    404): the conductor parks the piece for the next metadata sync
    instead of ticking the corruption/blacklist counters or burning
    the per-piece retry budget."""

    def __init__(self, message: str, fatal: bool = False,
                 not_ready: bool = False):
        super().__init__(message)
        self.fatal = fatal
        self.not_ready = not_ready


class DispatcherClosedError(Exception):
    pass


@dataclass
class DownloadPieceRequest:
    """One (piece, parent) download assignment."""

    task_id: str
    src_peer_id: str
    dst_peer_id: str
    dst_addr: str  # host:port of the parent's upload server
    piece: PieceMetadata


@dataclass
class DownloadPieceResult:
    dst_peer_id: str
    piece_num: int
    fail: bool
    cost_ns: int = 0


class PieceDispatcher:
    """Parent-scored piece request queue (piece_dispatcher.go:47-172)."""

    def __init__(self, random_ratio: float = 0.1, seed: int | None = None,
                 rarity_fn: Callable[[int], int] | None = None):
        # Rarest-first piece selection: when set, pieces within the
        # chosen parent's queue are served in ascending availability
        # order (how many known parents advertise the piece — the
        # conductor feeds this from its metadata syncs) with a seeded
        # random tie-break, so concurrent children of one partial seed
        # pull DISJOINT pieces and immediately cross-serve instead of
        # all racing for the head of the file. None keeps the original
        # uniform-random order.
        self.rarity_fn = rarity_fn
        self._requests: Dict[str, List[DownloadPieceRequest]] = {}
        self._score: Dict[str, int] = {}
        self._downloaded: Set[int] = set()
        # (piece → parents that served it corrupt): steer the re-fetch to
        # a DIFFERENT parent; falls back to an avoided pair only when no
        # other parent offers the piece (single-parent swarms must still
        # converge on transient corruption).
        self._avoid: Dict[int, Set[str]] = {}
        # Parents blacklisted for this task (repeat corruption).
        self._banned: Set[str] = set()
        self._sum = 0
        self._closed = False
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self.random_ratio = random_ratio
        self._rand = random.Random(seed)

    def put(self, req: DownloadPieceRequest) -> bool:
        """False when the request was REFUSED (blacklisted parent) — the
        caller must roll back its own enqueue bookkeeping, or the piece
        is stranded (marked enqueued but queued nowhere)."""
        with self._cond:
            if req.dst_peer_id in self._banned:
                return False
            self._requests.setdefault(req.dst_peer_id, []).append(req)
            self._score.setdefault(req.dst_peer_id, MAX_SCORE_NS)
            self._sum += 1
            self._cond.notify_all()
            return True

    def get(self, timeout: float | None = None) -> Optional[DownloadPieceRequest]:
        """Next request from the best (or ε-randomly shuffled) parent; None
        when no valid request is available right now; raises when closed."""
        with self._cond:
            deadline = None if timeout is None else time.monotonic() + timeout
            while self._sum == 0 and not self._closed:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining)
            if self._closed:
                raise DispatcherClosedError
            return self._get_desired()

    def _get_desired(self) -> Optional[DownloadPieceRequest]:
        peers = [p for p in self._score if p not in self._banned]
        if self._rand.random() < self.random_ratio:
            self._rand.shuffle(peers)
        else:
            peers.sort(key=lambda p: self._score[p])
        fallback: "tuple[str, DownloadPieceRequest] | None" = None
        for peer in peers:
            queue = self._requests.get(peer) or []
            # Purge already-downloaded entries first (the old loop did
            # this lazily while popping).
            if queue:
                kept = [r for r in queue
                        if r.piece.num not in self._downloaded]
                self._sum -= len(queue) - len(kept)
                queue[:] = kept
            if not queue:
                continue
            order = list(range(len(queue)))
            if self.rarity_fn is None:
                self._rand.shuffle(order)
            else:
                rarity = self.rarity_fn
                order.sort(key=lambda i: (rarity(queue[i].piece.num),
                                          self._rand.random()))
            for i in order:
                req = queue[i]
                if peer in self._avoid.get(req.piece.num, ()):
                    # This parent already served this piece corrupt —
                    # keep it as a last resort only.
                    if fallback is None:
                        fallback = (peer, req)
                    continue
                queue.pop(i)
                self._sum -= 1
                return req
        if fallback is not None:
            peer, req = fallback
            self._requests[peer].remove(req)
            self._sum -= 1
            return req
        return None

    def report(self, result: DownloadPieceResult) -> None:
        with self._lock:
            if not result.dst_peer_id:
                return
            last = self._score.get(result.dst_peer_id, MAX_SCORE_NS)
            if result.fail:
                self._score[result.dst_peer_id] = (last + MIN_SCORE_NS) // 2
            else:
                self._downloaded.add(result.piece_num)
                self._score[result.dst_peer_id] = (last + result.cost_ns) // 2

    def report_corrupt(self, peer_id: str, piece_num: int) -> None:
        """A piece from this parent failed its md5: re-fetch must prefer
        a different parent (the avoid map), and the parent's score takes
        the same failure penalty as a transport error."""
        with self._lock:
            self._avoid.setdefault(piece_num, set()).add(peer_id)
            # The WIRE fetch reported success before the store's md5
            # check ran, so the piece sits in _downloaded — un-mark it,
            # or _get_desired purges every re-enqueued request for it as
            # already-done and the re-fetch can only come from the
            # (source_fallback_wait-slow) origin path.
            self._downloaded.discard(piece_num)
            last = self._score.get(peer_id, MAX_SCORE_NS)
            self._score[peer_id] = (last + MIN_SCORE_NS) // 2

    def ban(self, peer_id: str) -> List[DownloadPieceRequest]:
        """Blacklist a parent for the task: drop its queue (returning the
        still-wanted requests so the conductor can re-open them for
        other parents) and refuse future puts."""
        with self._cond:
            self._banned.add(peer_id)
            dropped = self._requests.pop(peer_id, [])
            self._sum -= len(dropped)
            self._score.pop(peer_id, None)
            return [r for r in dropped
                    if r.piece.num not in self._downloaded]

    def is_banned(self, peer_id: str) -> bool:
        with self._lock:
            return peer_id in self._banned

    def is_downloaded(self, piece_num: int) -> bool:
        with self._lock:
            return piece_num in self._downloaded

    def pending(self) -> bool:
        """Any request enqueued (a superset of what ``get`` would hand
        out — banned/landed entries get purged by the next ``get``).
        The async pump's lost-wakeup re-check: a racer's ``put`` is
        visible here before its pump call could have observed the
        pump's transient in-flight slot."""
        with self._lock:
            return any(self._requests.values())

    def scores(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._score)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()


def piece_request_path(task_id: str, peer_id: str) -> str:
    """Route shape both fetchers (and the upload server) share:
    ``/download/{task_prefix}/{task_id}?peerId=`` — the reference's
    piece URL (piece_downloader.go:165-225). Raises on task ids too
    short to carry the 3-char prefix."""
    if len(task_id) <= 3:
        raise DownloadPieceError(f"invalid task id {task_id!r}")
    return f"/download/{task_id[:3]}/{task_id}?peerId={peer_id}"


class PieceDownloader:
    """Keep-alive HTTP piece fetch from a parent's upload server —
    the pure-Python data plane (piece_downloader.go:165-225 over the
    reference's pooled keep-alive ``http.Client`` transport,
    piece_manager.go:791-891).

    One persistent connection pool per parent address; ``fetch`` streams
    the response body chunk-by-chunk into the task file via ``pwrite``
    at the piece offset with an incremental md5 — a piece is never
    materialized whole in Python memory. ``download_piece`` keeps the
    buffered return-bytes form for callers without a file (same pool).

    A pooled connection may have been closed by the parent's keep-alive
    timeout; requests over a pooled connection retry ONCE on a fresh
    one, flushing the (equally stale) pooled siblings first — the same
    discipline as :class:`NativePieceFetcher`.
    """

    def __init__(self, timeout: float = 30.0, scheme: str = "http",
                 pool_per_addr: int = 4, chunk_size: int = 64 * 1024,
                 stats=None, pool_idle_ttl: float = 60.0,
                 pool_max_total: int = 256):
        self.timeout = timeout
        self.scheme = scheme
        self.chunk_size = chunk_size
        if stats is None:
            from dragonfly2_tpu_torch.client.dataplane import STATS as stats
        self.stats = stats
        # Test instrumentation: called with each body chunk's size, so a
        # test can prove no read ever materializes a whole piece.
        self.chunk_hook: Optional[Callable[[int], None]] = None
        self._pool = HTTPConnectionPool(per_host=pool_per_addr,
                                        timeout=timeout,
                                        idle_ttl=pool_idle_ttl,
                                        max_total=pool_max_total)

    # -- connection pool (shared HTTPConnectionPool, keyed per parent) -----

    def _key(self, addr: str) -> Tuple[str, str, int]:
        host, sep, port = addr.rpartition(":")
        if not sep or not port.isdigit():
            # Malformed parent address from scheduler/peer metadata must
            # surface as a piece failure (retried on another parent),
            # not a ValueError that kills the worker thread.
            raise DownloadPieceError(f"malformed parent address {addr!r}")
        return (self.scheme, host, int(port))

    def _checkin(self, addr: str, conn: http.client.HTTPConnection) -> None:
        self._pool.checkin(self._key(addr), conn)

    def close(self) -> None:
        self._pool.close()

    # -- request plumbing --------------------------------------------------

    def _open(self, req: DownloadPieceRequest):
        """(conn, resp) with the pool's stale-keep-alive retry applied;
        the response status/length are validated by the caller."""
        path = piece_request_path(req.task_id, req.dst_peer_id)
        try:
            return self._pool.request(
                self._key(req.dst_addr), "GET", path,
                headers={
                    "Range": req.piece.range.http_header(),
                    "Connection": "keep-alive",
                },
                stats=self.stats,
            )
        except (OSError, http.client.HTTPException) as exc:
            raise DownloadPieceError(
                f"{req.dst_addr} piece {req.piece.num}: {exc}") from exc

    def _finish(self, addr: str, conn, resp) -> None:
        """Park the connection for reuse iff the response was fully
        consumed and the server didn't ask to close."""
        if resp.will_close or not resp.isclosed():
            conn.close()
        else:
            self._checkin(addr, conn)

    def _validate(self, req: DownloadPieceRequest, conn, resp) -> None:
        piece = req.piece
        if resp.status != 206 or (resp.length is not None
                                  and resp.length != piece.length):
            conn.close()  # unknown body framing — don't try to realign
            raise DownloadPieceError(
                f"{req.dst_addr} piece {piece.num}: status {resp.status}, "
                f"body {resp.length}/{piece.length}",
                # 404 = the parent doesn't hold the piece (yet): a
                # partial peer mid-download (X-Df2-Not-Ready) or a store
                # that raced away — park and re-offer, don't blacklist.
                not_ready=resp.status == 404,
            )

    # -- fetch -------------------------------------------------------------

    def fetch(self, req: DownloadPieceRequest, file_fd: int) -> str:
        """Stream one piece into ``file_fd`` at the piece's offset
        (position-independent pwrite; incremental md5); returns the md5
        hex. Unrecorded bytes from a failed attempt are overwritten by
        the next one — identical contract to NativePieceFetcher.fetch."""
        piece = req.piece
        conn, resp = self._open(req)
        self._validate(req, conn, resp)
        plan = faultplan.ACTIVE
        flt = (faultplan.body_filter(
                   plan.check("piece.body", context=req.dst_addr))
               if plan is not None else None)
        geo = geoplan.ACTIVE
        digest = hashlib.md5()
        offset = piece.offset
        remaining = piece.length
        try:
            while remaining > 0:
                if geo is not None:
                    # WAN emulation (docs/GEO.md): a mid-stream
                    # partition resets like a dropped route; otherwise
                    # pay the link's bandwidth debt for bytes already
                    # read (thread engine parks by sleeping).
                    if geo.refuse(req.dst_addr):
                        raise ConnectionResetError(
                            104, f"geo partition: {req.dst_addr} "
                            "stream reset")
                chunk = resp.read(min(self.chunk_size, remaining))
                if flt is not None:
                    chunk = flt(chunk)
                if not chunk:
                    break
                if geo is not None and len(chunk):
                    pause = geo.pace(req.dst_addr, len(chunk))
                    if pause > 0:
                        time.sleep(pause)
                if self.chunk_hook is not None:
                    self.chunk_hook(len(chunk))
                os.pwrite(file_fd, chunk, offset)
                digest.update(chunk)
                offset += len(chunk)
                remaining -= len(chunk)
        except (OSError, http.client.HTTPException) as exc:
            conn.close()
            raise DownloadPieceError(
                f"{req.dst_addr} piece {piece.num}: {exc}",
                fatal=getattr(exc, "errno", None) == errno.ENOSPC,
            ) from exc
        if remaining:
            conn.close()
            raise DownloadPieceError(
                f"piece {piece.num}: got {piece.length - remaining} bytes, "
                f"want {piece.length}"
            )
        self.stats.parent_request(piece.length)
        self._finish(req.dst_addr, conn, resp)
        return digest.hexdigest()

    def download_piece(self, req: DownloadPieceRequest) -> bytes:
        """Buffered form (callers without a destination file); still
        rides the keep-alive pool."""
        piece = req.piece
        conn, resp = self._open(req)
        self._validate(req, conn, resp)
        plan = faultplan.ACTIVE
        flt = (faultplan.body_filter(
                   plan.check("piece.body", context=req.dst_addr))
               if plan is not None else None)
        geo = geoplan.ACTIVE
        try:
            if geo is not None and geo.refuse(req.dst_addr):
                raise ConnectionResetError(
                    104, f"geo partition: {req.dst_addr} stream reset")
            data = resp.read(piece.length)
            if flt is not None:
                data = flt(data)
            if geo is not None and data:
                pause = geo.pace(req.dst_addr, len(data))
                if pause > 0:
                    time.sleep(pause)
        except (OSError, http.client.HTTPException) as exc:
            conn.close()
            raise DownloadPieceError(
                f"{req.dst_addr} piece {piece.num}: {exc}") from exc
        if len(data) != piece.length:
            conn.close()
            raise DownloadPieceError(
                f"piece {piece.num}: got {len(data)} bytes, "
                f"want {piece.length}"
            )
        self.stats.parent_request(piece.length)
        self._finish(req.dst_addr, conn, resp)
        return data


class NativePieceFetcher:
    """Keep-alive piece fetch through the C++ data plane.

    Replaces the connection-per-piece urllib path with one persistent
    socket per parent and ONE native call per piece: the C side sends
    the GET, parses the response, and streams the body recv → pwrite →
    MD5 with the GIL released (dragonfly2_tpu_torch/native/pieceio.cpp). The
    reference's equivalent hot loop is likewise compiled code
    (client/daemon/peer/piece_downloader.go:165-225 over a pooled
    http.Client transport).

    Only the transfer moves to C; dedup, digest validation and metadata
    stay in :class:`~dragonfly2_tpu_torch.client.storage.TaskStorage` via
    ``record_piece``.
    """

    def __init__(self, timeout: float = 30.0, pool_per_addr: int = 4,
                 stats=None):
        self.timeout = timeout
        self.pool_per_addr = pool_per_addr
        if stats is None:
            from dragonfly2_tpu_torch.client.dataplane import STATS as stats
        self.stats = stats
        self._pool: Dict[str, List[socket.socket]] = {}
        self._lock = threading.Lock()
        self._closed = False

    @staticmethod
    def supported() -> bool:
        return native.available()

    # -- connection pool ---------------------------------------------------

    def _checkout(self, addr: str) -> Tuple[socket.socket, bool]:
        """(socket, was_pooled). A pooled socket may have been closed by
        the server's keep-alive timeout — callers retry once fresh."""
        with self._lock:
            stack = self._pool.get(addr)
            if stack:
                return stack.pop(), True
        host, sep, port = addr.rpartition(":")
        if not sep or not port.isdigit():
            # Malformed parent address from scheduler/peer metadata must
            # surface as a piece failure (retried on another parent),
            # not a ValueError that kills the worker thread.
            raise DownloadPieceError(f"malformed parent address {addr!r}")
        plan = faultplan.ACTIVE
        if plan is not None:
            rule = plan.check("pool.connect", context=addr)
            if rule is not None:
                faultplan.raise_connect(rule, "pool.connect", addr)
        geo = geoplan.ACTIVE
        if geo is not None:
            refused, delay = geo.dial(addr)
            if refused:
                raise ConnectionRefusedError(
                    111, f"geo partition: {addr} unreachable across "
                    "clusters")
            if delay > 0:
                time.sleep(delay)
        sock = socket.create_connection((host, int(port)),
                                        timeout=self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # Python's timeout mode puts the fd in O_NONBLOCK, which the C
        # recv/send loop would see as spurious EAGAIN. Switch to a
        # blocking fd with KERNEL timeouts so a dead parent still fails
        # the native call (EAGAIN after SO_RCVTIMEO) instead of hanging.
        sock.setblocking(True)
        tv = struct.pack("ll", int(self.timeout),
                         int((self.timeout % 1.0) * 1_000_000))
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO, tv)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, tv)
        return sock, False

    def _flush(self, addr: str) -> None:
        """Drop every pooled socket for a parent. Called when a pooled
        socket turns out stale: its siblings were opened to the same
        (now restarted/dead) server, so retrying through them would
        just burn the retry budget on more stale sockets."""
        with self._lock:
            stack = self._pool.pop(addr, [])
        for sock in stack:
            sock.close()

    def _checkin(self, addr: str, sock: socket.socket) -> None:
        with self._lock:
            # A worker finishing its fetch after close() must not park
            # its socket in the emptied pool (nothing would ever close
            # it — fd leak per completed task).
            if not self._closed:
                stack = self._pool.setdefault(addr, [])
                if len(stack) < self.pool_per_addr:
                    stack.append(sock)
                    return
        sock.close()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            pools, self._pool = self._pool, {}
        for stack in pools.values():
            for sock in stack:
                sock.close()

    # -- fetch -------------------------------------------------------------

    def fetch(self, req: DownloadPieceRequest, file_fd: int) -> str:
        """Stream one piece into ``file_fd`` at the piece's offset;
        returns the md5 hex computed in C. Raises DownloadPieceError on
        any failure (the unrecorded file bytes are overwritten by the
        next attempt)."""
        piece = req.piece
        path = piece_request_path(req.task_id, req.dst_peer_id)
        request = (
            f"GET {path} HTTP/1.1\r\n"
            f"Host: {req.dst_addr}\r\n"
            f"Range: {piece.range.http_header()}\r\n"
            f"Connection: keep-alive\r\n\r\n"
        ).encode()
        last_exc: Exception | None = None
        for _attempt in range(2):
            try:
                sock, was_pooled = self._checkout(req.dst_addr)
            except OSError as exc:
                raise DownloadPieceError(
                    f"{req.dst_addr}: connect failed: {exc}") from exc
            try:
                res = native.http_fetch_to_file(
                    sock.fileno(), request, file_fd, piece.offset,
                    piece.length)
            except (native.NativeIOError, ValueError, OSError) as exc:
                sock.close()
                last_exc = exc
                if was_pooled:
                    # Stale keep-alive: drop its pooled siblings too (same
                    # dead server) so the retry really is a fresh connect.
                    self._flush(req.dst_addr)
                    continue
                raise DownloadPieceError(
                    f"{req.dst_addr} piece {piece.num}: {exc}",
                    fatal=getattr(exc, "errno", None) == errno.ENOSPC,
                ) from exc
            # Count only the checkout that actually SERVED the request
            # (a stale pooled socket that failed above must not count a
            # reuse — it produced nothing; the fresh retry counts).
            self.stats.connection(reused=was_pooled)
            if res.status != 206 or res.body_len != piece.length:
                if res.keep_alive:
                    self._checkin(req.dst_addr, sock)
                else:
                    sock.close()
                raise DownloadPieceError(
                    f"{req.dst_addr} piece {piece.num}: status "
                    f"{res.status}, body {res.body_len}/{piece.length}",
                    not_ready=res.status == 404,
                )
            if res.keep_alive:
                self._checkin(req.dst_addr, sock)
            else:
                sock.close()
            geo = geoplan.ACTIVE
            if geo is not None:
                # The C body loop can't be paced per-chunk; settle the
                # link's bandwidth debt for the whole piece afterwards —
                # the aggregate debt clock still bounds WAN throughput.
                pause = geo.pace(req.dst_addr, piece.length)
                if pause > 0:
                    time.sleep(pause)
            self.stats.parent_request(piece.length)
            return res.md5_hex
        raise DownloadPieceError(
            f"{req.dst_addr} piece {piece.num}: {last_exc}",
            fatal=getattr(last_exc, "errno", None) == errno.ENOSPC)
