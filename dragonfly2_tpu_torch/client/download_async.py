"""Event-loop download engine — daemon-wide async piece fetching.

The serve half of the data plane went event-loop in PR 7
(:mod:`upload_async`): a FIXED worker-thread count multiplexing every
keep-alive peer connection. This module is the download half of the same
contract. The thread-per-worker conductor spent, per active task, up to
``max_syncers`` metadata-poll threads + ``piece_concurrency`` piece
workers + ``back_source_concurrency`` origin fetchers — a daemon with
100 concurrent tasks ran ~1,000 blocking threads, which is what capped
concurrent-task density for the fan-out / registry-proxy workloads.

:class:`DownloadLoopEngine` owns a small fixed pool of selector event
loops (``dl-loop-{i}``, default :data:`DEFAULT_DL_WORKERS`) shared
**daemon-wide across all tasks**. Per-task work runs as nonblocking
state machines on those loops:

- :class:`BufferedGetOp` — metadata sync polls over the engine-wide
  keep-alive socket pool (pacing/backoff stays with the conductor,
  which reschedules through the loop's timer wheel);
- :class:`PieceFetchOp` — one parent piece GET streaming
  socket → ``pwrite``-at-offset → incremental md5 in bounded chunks,
  with partial-read resume across readiness events;
- :class:`SourceRunOp` — one coalesced back-to-source ranged GET,
  split into pieces on the fly (same per-piece record/report semantics
  as the threaded run fetcher).

Rate limiting never blocks a loop: reservations park the op on the
loop's timer wheel (the PR-7 upload pattern), and a stream that dies
refunds the unreceived fraction of its up-front charge. Cross-task
fairness is a weighted round-robin over ready connections: each select
round interleaves tasks (rotating start offset) and each dispatch
processes at most :data:`FAIR_BUDGET` body bytes before yielding the
loop — a hot task with many ready sockets cannot monopolize a loop
while a cold task's one socket starves.

TLS and proxied exchanges ride the SAME loops — there is no thread
fallback left. An op constructed with a ``tls`` context runs a
nonblocking handshake state machine (SSLWant* → interest switching,
``sock.pending`` drained before yielding — the upload engine's proven
discipline) and an op with a ``tunnel`` target first speaks CONNECT to
the proxy, then optionally handshakes through the tunnel. Pooled
keep-alive sockets keep their TLS session (keyed separately from
plaintext sockets), so a fleet pays one handshake per (daemon, peer).

Plaintext piece/run bodies land through the native seam when it is
available: :func:`dragonfly2_tpu_torch.native.splice_recv_to_file` moves
socket bytes to the data file at offset with PARTIAL progress on
EAGAIN — zero-copy splice(2) through a loop-owned pipe when no inline
digest is needed, a C recv→pwrite→MD5 loop otherwise — falling back
per-connection to the Python recv path (TLS records, fault filters,
missing toolchain).

Faultplan parity with the threaded engine: fresh dials consult
``pool.connect`` (STALL parks on the timer wheel instead of sleeping
the loop), parent bodies run through ``piece.body`` filters and origin
run bodies through ``source.body`` — the chaos ladder injects through
the async engine exactly as it did through the threads.

Thread accounting: engine threads are named ``dl-loop-{i}`` and the
threaded engine's workers keep their historical names; the density
rung's bound and the tier-1 census test both read
:func:`download_thread_census`.
"""

from __future__ import annotations

import collections
import errno
import fcntl
import hashlib
import heapq
import math
import logging
import os
import queue
import select
import selectors
import socket
import ssl
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from dragonfly2_tpu_torch import native
from dragonfly2_tpu_torch.client.downloader import (
    DownloadPieceError,
    DownloadPieceRequest,
    piece_request_path,
)
from dragonfly2_tpu_torch.utils import faultplan, geoplan

logger = logging.getLogger(__name__)

#: Fixed event-loop worker count (download threads = DEFAULT_DL_WORKERS,
#: a constant independent of concurrent task count).
DEFAULT_DL_WORKERS = 2
#: Daemon-wide cap on concurrently STREAMING body ops (piece fetches +
#: source runs; metadata polls are never gated). Beyond this, ops queue
#: FIFO and start as streams drain. Pure processor-sharing across
#: hundreds of concurrent streams costs real aggregate throughput —
#: every open stream holds a peer/origin server thread and splinters
#: socket buffers into tiny reads — and the threaded engine never paid
#: it (its streams finished fast and staggered naturally). Admission
#: keeps per-stream reads large and peer-side fan-in bounded while the
#: WRR dispatch keeps the admitted set fair.
DEFAULT_DL_MAX_STREAMS = 16
#: Per-recv read size while parsing a response HEAD (body reads go
#: straight to the remaining-length/fairness bound instead — on a
#: 1-core box the per-chunk Python glue, not the wire, is the download
#: ceiling, so body recvs must be as large as the kernel will fill).
RECV_CHUNK = 64 * 1024
#: Fairness quantum: max body bytes one connection may consume per
#: dispatch before yielding the loop back to the selector. Also the
#: size of each loop's reusable recv buffer.
FAIR_BUDGET = 1024 * 1024
#: A response head larger than this is malformed (no piece/metadata
#: response comes close).
MAX_HEAD_BYTES = 64 * 1024

#: Thread-name prefixes that count as "download threads" — the engine's
#: loops plus every per-task worker flavor of the threaded engine. The
#: density rung's bound and the tier-1 census test read this.
DOWNLOAD_THREAD_PREFIXES = (
    "dl-loop-",        # this engine
    "dl-ctl-",         # this engine's off-loop control-RPC runner
    "piece-sync-",     # threaded metadata syncers
    "piece-worker-",   # threaded piece workers
    "back-source-",    # threaded origin run fetchers
)


def download_thread_census() -> Dict[str, int]:
    """Live download-path threads by family, plus the total — the
    quantity the density rung bounds at ``dl_workers + 2``."""
    counts = {prefix: 0 for prefix in DOWNLOAD_THREAD_PREFIXES}
    for thread in threading.enumerate():
        name = thread.name
        for prefix in DOWNLOAD_THREAD_PREFIXES:
            if name.startswith(prefix):
                counts[prefix] += 1
                break
    counts["total"] = sum(counts[p] for p in DOWNLOAD_THREAD_PREFIXES)
    return counts


class ThreadCensusSampler:
    """Background sampler of :func:`download_thread_census` (plus the
    process-total thread count) — the density rung and the tier-1
    census regression test both read its PEAK, because the thread bound
    must hold at the busiest instant of a run, not after the workers
    already retired."""

    def __init__(self, interval: float = 0.02):
        self.interval = interval
        self.peak: Dict[str, int] = {"total": 0}
        self.peak_process_threads = 0
        self.samples = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample_once(self) -> Dict[str, int]:
        census = download_thread_census()
        if census["total"] >= self.peak.get("total", -1):
            self.peak = census
        self.peak_process_threads = max(self.peak_process_threads,
                                        threading.active_count())
        self.samples += 1
        return census

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.sample_once()

    def __enter__(self) -> "ThreadCensusSampler":
        self.sample_once()
        self._thread = threading.Thread(
            target=self._run, name="census-sampler", daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        self.sample_once()


# ----------------------------------------------------------------------
# Nonblocking keep-alive socket pool (daemon-wide, shared across tasks)
# ----------------------------------------------------------------------


class AsyncConnPool:
    """Idle nonblocking sockets keyed by ``host:port``.

    The engine-wide analogue of the threaded transports' per-conductor
    pools: metadata polls, piece fetches and source runs all park their
    keep-alive sockets here, so a fleet's poll+fetch plane pays one TCP
    handshake per (daemon, peer) instead of per (task, peer). ``take``
    peeks the socket for EOF/stray bytes so most dead keep-alives are
    discarded before an op wastes its one stale-retry on them; idle
    sockets older than ``idle_ttl`` are reaped opportunistically."""

    def __init__(self, per_host: int = 4, idle_ttl: float = 60.0,
                 max_total: int = 512):
        self.per_host = per_host
        self.idle_ttl = idle_ttl
        self.max_total = max_total
        self._lock = threading.Lock()
        self._pool: Dict[str, List[Tuple[socket.socket, float]]] = {}
        self._total = 0
        self._closed = False
        self._last_reap = time.monotonic()
        self.reaped = 0
        self.evicted = 0
        # Surface in the shared data_plane pool gauges alongside the
        # threaded transports' HTTPConnectionPools.
        from dragonfly2_tpu_torch.client.dataplane import register_pool

        register_pool(self)

    def take(self, addr: str) -> Optional[socket.socket]:
        now = time.monotonic()
        while True:
            with self._lock:
                stack = self._pool.get(addr)
                if not stack:
                    return None
                sock, parked_at = stack.pop()
                self._total -= 1
                if not stack:
                    self._pool.pop(addr, None)
            if self.idle_ttl > 0 and now - parked_at > self.idle_ttl:
                sock.close()
                with self._lock:
                    self.reaped += 1
                continue
            if isinstance(sock, ssl.SSLSocket):
                # MSG_PEEK is meaningless through a TLS record layer
                # (and rejected by SSLSocket.recv). A live idle TLS
                # keep-alive has nothing decrypted and nothing readable,
                # so a nonblocking recv(1) raising SSLWantRead is the
                # healthy case; data/EOF/error all mean the framing is
                # gone (a consumed stray byte can't be un-read, but a
                # stray byte is a dead keep-alive anyway).
                try:
                    if sock.pending() > 0:
                        raise OSError("stray decrypted bytes")
                    sock.recv(1)
                except (ssl.SSLWantReadError, ssl.SSLWantWriteError,
                        BlockingIOError, InterruptedError):
                    return sock
                except OSError:
                    pass
                sock.close()
                continue
            try:
                peek = sock.recv(1, socket.MSG_PEEK)
            except (BlockingIOError, InterruptedError):
                return sock  # alive, nothing buffered — the normal case
            except OSError:
                sock.close()
                continue
            # EOF (b"") or stray unsolicited bytes: either way the
            # keep-alive framing is gone.
            sock.close()

    def give(self, addr: str, sock: socket.socket) -> None:
        now = time.monotonic()
        evict: List[socket.socket] = []
        with self._lock:
            if self._closed:
                evict.append(sock)
            else:
                stack = self._pool.setdefault(addr, [])
                if (len(stack) >= self.per_host
                        or (self.max_total > 0
                            and self._total >= self.max_total)):
                    self.evicted += 1
                    evict.append(sock)
                else:
                    stack.append((sock, now))
                    self._total += 1
        for s in evict:
            s.close()
        self.reap(now)

    def reap(self, now: Optional[float] = None) -> int:
        """Drop idle sockets past their TTL (and empty keys). Called
        opportunistically from ``give``; cheap no-op between cadences."""
        if self.idle_ttl <= 0:
            return 0
        now = time.monotonic() if now is None else now
        with self._lock:
            if now - self._last_reap < self.idle_ttl / 4:
                return 0
            self._last_reap = now
            dead: List[socket.socket] = []
            for addr in list(self._pool):
                stack = self._pool[addr]
                kept = []
                for sock, parked_at in stack:
                    if now - parked_at > self.idle_ttl:
                        dead.append(sock)
                    else:
                        kept.append((sock, parked_at))
                if kept:
                    self._pool[addr] = kept
                else:
                    self._pool.pop(addr, None)
            self._total -= len(dead)
            self.reaped += len(dead)
        for sock in dead:
            sock.close()
        return len(dead)

    def flush(self, addr: str) -> None:
        """Drop every pooled socket for a host (stale keep-alive: its
        siblings were opened to the same now-dead server)."""
        with self._lock:
            stack = self._pool.pop(addr, [])
            self._total -= len(stack)
        for sock, _parked in stack:
            sock.close()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            pools, self._pool = self._pool, {}
            self._total = 0
        for stack in pools.values():
            for sock, _parked in stack:
                sock.close()

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "keys": len(self._pool),
                "sockets": self._total,
                "reaped": self.reaped,
                "evicted": self.evicted,
            }

    #: Gauge protocol shared with HTTPConnectionPool (dataplane
    #: register_pool) — same shape, one name.
    gauges = snapshot


# ----------------------------------------------------------------------
# Event loops
# ----------------------------------------------------------------------


class _Timer:
    __slots__ = ("when", "fn", "cancelled")

    def __init__(self, when: float, fn: Callable[[], None]):
        self.when = when
        self.fn = fn
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True

    def __lt__(self, other: "_Timer") -> bool:
        return self.when < other.when


class _DlLoop(threading.Thread):
    """One selector event loop owning a subset of the engine's ops."""

    def __init__(self, engine: "DownloadLoopEngine", index: int):
        super().__init__(name=f"dl-loop-{index}", daemon=True)
        self.engine = engine
        self.selector = selectors.DefaultSelector()
        self.inbox: collections.deque = collections.deque()
        self.timers: List[_Timer] = []
        self.ops: set = set()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._rr = 0
        #: Reusable body-recv buffer (loop-thread-only): every op on
        #: this loop recv_intos here and consumes the bytes before the
        #: dispatch returns, so body streaming allocates nothing per
        #: chunk.
        self.recv_buf = bytearray(FAIR_BUDGET)
        self.recv_view = memoryview(self.recv_buf)
        #: Select rounds where >1 task had ready sockets and the loop
        #: interleaved them — the fairness scheduler's visible counter.
        self.fair_interleaves = 0
        #: Loop-owned scratch pipe for zero-copy splice(2) body landing
        #: (loop-thread-only, always drained empty between native
        #: calls). (-1, -1) when pipes are unavailable — the native
        #: seam then uses its C recv→pwrite loop instead.
        try:
            self.splice_pipe = os.pipe()
            try:
                # Widen the pipe to the fairness quantum so one splice
                # round-trip moves a full budget (F_SETPIPE_SZ).
                fcntl.fcntl(self.splice_pipe[1],
                            getattr(fcntl, "F_SETPIPE_SZ", 1031),
                            FAIR_BUDGET)
            except OSError:
                pass
        except OSError:
            self.splice_pipe = (-1, -1)

    # -- cross-thread API --------------------------------------------------

    def call_soon(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` on the loop thread ASAP (thread-safe)."""
        self.inbox.append(fn)
        self.wake()

    def schedule(self, delay: float, fn: Callable[[], None]) -> None:
        """Thread-safe delayed call (routes through the inbox so the
        timer heap stays loop-thread-only)."""
        self.call_soon(lambda: self.call_later(delay, fn))

    def wake(self) -> None:
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    # -- loop-thread API ---------------------------------------------------

    def call_later(self, delay: float, fn: Callable[[], None]) -> _Timer:
        """Timer wheel entry (LOOP THREAD ONLY — ops run there)."""
        timer = _Timer(time.monotonic() + max(delay, 0.0), fn)
        heapq.heappush(self.timers, timer)
        return timer

    # -- loop --------------------------------------------------------------

    def run(self) -> None:
        engine = self.engine
        try:
            self.selector.register(self._wake_r, selectors.EVENT_READ, None)
            while not engine._stop.is_set():
                timeout = 0.5
                while self.timers and self.timers[0].cancelled:
                    heapq.heappop(self.timers)
                if self.timers:
                    timeout = min(
                        timeout,
                        max(self.timers[0].when - time.monotonic(), 0.0))
                if self.inbox:
                    timeout = 0.0
                try:
                    events = self.selector.select(timeout)
                except OSError:
                    events = []
                ready = []
                for key, mask in events:
                    if key.data is None:  # wake pipe
                        try:
                            self._wake_r.recv(4096)
                        except OSError:
                            pass
                        continue
                    ready.append((key.data, mask))
                self._dispatch_fair(ready)
                self._run_timers()
                self._drain_inbox()
                # Idle-TTL reap even when no op is parking sockets (an
                # idle daemon must still shed churned peers' keep-
                # alives); cadence-gated inside, so this is ~free.
                engine.pool.reap()
        finally:
            for op in list(self.ops):
                try:
                    op._finish(OSError("download engine stopped"))
                except Exception:  # noqa: BLE001 — teardown must not die
                    logger.debug("op teardown failed", exc_info=True)
            self._drain_inbox()
            self.selector.close()
            self._wake_r.close()
            self._wake_w.close()
            for fd in self.splice_pipe:
                if fd >= 0:
                    try:
                        os.close(fd)
                    except OSError:
                        pass

    def _drain_inbox(self) -> None:
        while self.inbox:
            fn = self.inbox.popleft()
            try:
                fn()
            except Exception:  # noqa: BLE001 — one bad callback ≠ dead loop
                logger.exception("dl-loop callback failed")

    def _run_timers(self) -> None:
        now = time.monotonic()
        while self.timers and (self.timers[0].cancelled
                               or self.timers[0].when <= now):
            timer = heapq.heappop(self.timers)
            if timer.cancelled:
                continue
            try:
                timer.fn()
            except Exception:  # noqa: BLE001
                logger.exception("dl-loop timer failed")

    def _dispatch_fair(self, ready: List[Tuple["_LoopOp", int]]) -> None:
        """Weighted round-robin over ready connections, grouped by task:
        the per-dispatch FAIR_BUDGET bounds how much one socket consumes,
        and the rotating task order bounds how long one hot task (many
        ready sockets) can hold the loop before a cold task's socket is
        served.  With a QoS policy active the grouping is class-major
        DRR first (each class drains up to its integer weight per cycle),
        then the same per-task rotation within the class."""
        if not ready:
            return
        if len(ready) == 1:
            self._safe_dispatch(*ready[0])
            return
        policy = self.engine.qos_policy if self.engine is not None else None
        if policy is not None:
            by_class: "collections.OrderedDict[str, list]" = \
                collections.OrderedDict()
            for op, mask in ready:
                by_class.setdefault(op.qos_class or policy.default_class,
                                    []).append((op, mask))
            if len(by_class) > 1:
                self._dispatch_class_major(policy, by_class)
                return
        self._dispatch_task_fair(ready)

    def _dispatch_class_major(self, policy, by_class) -> None:
        """Deficit-round-robin over classes: per cycle, class *c* may
        dispatch up to ceil(weight_c) of its ready sockets, rotating
        over its tasks, so a bulk flood of ready connections cannot
        monopolise the loop ahead of a lone interactive socket."""
        self.fair_interleaves += 1
        queues: "collections.OrderedDict[str, list]" = \
            collections.OrderedDict()
        quanta: Dict[str, int] = {}
        for klass, items in by_class.items():
            by_task: "collections.OrderedDict[str, list]" = \
                collections.OrderedDict()
            for op, mask in items:
                by_task.setdefault(op.task_id, []).append((op, mask))
            keys = list(by_task)
            if len(keys) > 1:
                off = self._rr % len(keys)
                self._rr += 1
                keys = keys[off:] + keys[:off]
            flat: list = []
            cursors = [by_task[k] for k in keys]
            while cursors:
                still = []
                for queue in cursors:
                    flat.append(queue.pop(0))
                    if queue:
                        still.append(queue)
                cursors = still
            queues[klass] = flat
            quanta[klass] = max(1, int(math.ceil(policy.weight(klass))))
        # Heaviest class first inside each cycle, then round the cycle
        # until every queue is dry.
        order = sorted(queues, key=lambda c: (-policy.weight(c), c))
        while any(queues.values()):
            for klass in order:
                queue = queues[klass]
                for _ in range(quanta[klass]):
                    if not queue:
                        break
                    op, mask = queue.pop(0)
                    self._safe_dispatch(op, mask)

    def _dispatch_task_fair(self, ready: List[Tuple["_LoopOp", int]]) -> None:
        by_task: "collections.OrderedDict[str, list]" = \
            collections.OrderedDict()
        for op, mask in ready:
            by_task.setdefault(op.task_id, []).append((op, mask))
        keys = list(by_task)
        if len(keys) > 1:
            self.fair_interleaves += 1
            off = self._rr % len(keys)
            self._rr += 1
            keys = keys[off:] + keys[:off]
        queues = [by_task[k] for k in keys]
        while queues:
            still = []
            for queue in queues:
                op, mask = queue.pop(0)
                self._safe_dispatch(op, mask)
                if queue:
                    still.append(queue)
            queues = still

    def _safe_dispatch(self, op: "_LoopOp", mask: int) -> None:
        try:
            op.on_event(mask)
        except Exception as exc:  # noqa: BLE001 — one bad conn ≠ dead loop
            logger.debug("download op died: %s", exc, exc_info=True)
            try:
                op._finish(exc)
            except Exception:
                logger.debug("op finish failed", exc_info=True)


class DownloadLoopEngine:
    """Fixed pool of selector event loops shared by every task's
    download state machines. Thread cost: ``workers`` — a constant,
    independent of how many tasks are in flight."""

    def __init__(self, workers: int = 0, *, stats=None,
                 max_streams: int = 0,
                 pool_per_host: int = 4, pool_idle_ttl: float = 60.0,
                 pool_max_total: int = 512,
                 peer_tls_context: Optional[ssl.SSLContext] = None,
                 source_tls_context: Optional[ssl.SSLContext] = None,
                 qos_policy=None, qos_stats=None):
        self.worker_count = workers if workers > 0 else DEFAULT_DL_WORKERS
        #: Client context for TLS parents/peers (piece fetch + metadata
        #: sync). None → plaintext peers, the default mesh transport.
        self.peer_tls_context = peer_tls_context
        #: Client context for https origins; None → a default-verify
        #: context is built lazily on first https source.
        self.source_tls_context = source_tls_context
        self.max_streams = (max_streams if max_streams > 0
                            else DEFAULT_DL_MAX_STREAMS)
        if stats is None:
            from dragonfly2_tpu_torch.client.dataplane import STATS as stats
        self.stats = stats
        self.pool = AsyncConnPool(per_host=pool_per_host,
                                  idle_ttl=pool_idle_ttl,
                                  max_total=pool_max_total)
        self._stop = threading.Event()
        self._loops: List[_DlLoop] = []
        self._lock = threading.Lock()
        self._rr = 0
        self._inflight_streams = 0
        self._waitq: collections.deque = collections.deque()
        self.admission_queued_peak = 0
        # Multi-tenant QoS (client/qos.py, docs/QOS.md). Policy None =
        # class-blind: admission keeps the single-FIFO path above and
        # dispatch keeps the per-task WRR — the zero-overhead default.
        # With a policy, gated ops park in per-class deques dequeued by
        # smooth-WRR with per-class floors (class-major DRR), and the
        # loop dispatcher interleaves class-major before per-task.
        self.qos_policy = qos_policy
        if qos_policy is not None:
            from dragonfly2_tpu_torch.client import qos as qos_mod

            self._classq = qos_mod.ClassQueues(qos_policy)
            self._inservice: Dict[str, int] = {}
            self.qos_stats = (qos_stats if qos_stats is not None
                              else qos_mod.QOS)
        else:
            self._classq = None
            self._inservice = {}
            self.qos_stats = qos_stats
        # Queued-wait ring (park → admission): the number the admission
        # gate actually bounds — queued_peak alone says how DEEP the
        # queue got, not how LONG anyone waited in it.
        from dragonfly2_tpu_torch.client.qos import LatencyRing

        self._admission_wait_ms = LatencyRing(2048)
        # Off-loop control-plane runner: blocking scheduler RPCs that
        # completions would otherwise issue ON a loop thread (piece-
        # failure reports, count-triggered report-batch flushes, syncer
        # giveups) run here instead — ONE more constant thread, so a
        # slow scheduler stalls this queue, never the byte-moving loops.
        self._ctl_q: "queue.Queue" = queue.Queue()
        self._ctl_thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._loops:
                return
            self._stop.clear()
            self._loops = [_DlLoop(self, i)
                           for i in range(self.worker_count)]
            for loop in self._loops:
                loop.start()
            self._ctl_thread = threading.Thread(
                target=self._ctl_run, name="dl-ctl-0", daemon=True)
            self._ctl_thread.start()

    def _ctl_run(self) -> None:
        while True:
            fn = self._ctl_q.get()
            if fn is None:
                return
            try:
                fn()
            except Exception:  # noqa: BLE001 — control calls are
                # best-effort (their inline forms already swallow/log)
                logger.debug("off-loop control call failed",
                             exc_info=True)

    def offload(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` on the control runner (FIFO, preserves per-caller
        RPC order); inline when the engine is stopped — callers must not
        lose control-plane reports to a shutdown race."""
        if self._stop.is_set() or self._ctl_thread is None:
            fn()
            return
        self._ctl_q.put(fn)

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            loops, self._loops = self._loops, []
            queued = list(self._waitq)
            self._waitq.clear()
            if self._classq is not None:
                queued.extend(self._classq.drain())
            ctl, self._ctl_thread = self._ctl_thread, None
        if ctl is not None:
            # Drain-then-exit: queued control reports still deliver.
            self._ctl_q.put(None)
            ctl.join(timeout=5)
        for op in queued:
            try:
                op._finish(OSError("download engine stopped"))
            except Exception:  # noqa: BLE001 — teardown must not die
                logger.debug("queued op teardown failed", exc_info=True)
        for loop in loops:
            loop.wake()
        for loop in loops:
            loop.join(timeout=5)
        self.pool.close()

    @property
    def running(self) -> bool:
        return bool(self._loops) and not self._stop.is_set()

    def source_tls(self) -> ssl.SSLContext:
        """Client context for https origins (lazily built with default
        system trust when the operator did not pin a CA)."""
        ctx = self.source_tls_context
        if ctx is None:
            ctx = ssl.create_default_context()
            self.source_tls_context = ctx
        return ctx

    def thread_count(self) -> int:
        return sum(1 for loop in self._loops if loop.is_alive())

    def fair_interleaves(self) -> int:
        return sum(loop.fair_interleaves for loop in self._loops)

    # -- submission --------------------------------------------------------

    def submit(self, op: "_LoopOp") -> "_LoopOp":
        """Assign the op to the least-loaded loop and start it there.

        Gated ops (body streams) pass daemon-wide admission first: past
        ``max_streams`` in flight they queue FIFO and start as earlier
        streams drain. Metadata polls (``gated = False``) always start
        immediately — the control plane never waits behind data."""
        op.engine = self
        with self._lock:
            if not self._loops or self._stop.is_set():
                raise RuntimeError("download engine not running")
            if op.gated:
                if self._classq is None:
                    # Class-blind default: the historical single FIFO.
                    if self._inflight_streams >= self.max_streams:
                        op._parked_at = time.monotonic()
                        self._waitq.append(op)
                        self.admission_queued_peak = max(
                            self.admission_queued_peak, len(self._waitq))
                        return op
                else:
                    klass = self.qos_policy.normalize(op.qos_class)
                    op.qos_class = klass
                    # Park when the gate is full, when the class already
                    # has a backlog (FIFO within a class — admitting
                    # around it would reorder one tenant's streams), or
                    # when free capacity is reserved for another class's
                    # unmet floor.
                    if (self._inflight_streams >= self.max_streams
                            or self._classq.backlog(klass)
                            or not self._classq.headroom(
                                klass, self._inservice, self.max_streams)):
                        op._parked_at = time.monotonic()
                        self._classq.push(klass, op)
                        self.qos_stats.admission("download", klass, "parked")
                        self.admission_queued_peak = max(
                            self.admission_queued_peak, len(self._classq))
                        return op
                    self._inservice[klass] = self._inservice.get(klass, 0) + 1
                    self.qos_stats.admission("download", klass, "admitted")
                self._inflight_streams += 1
                op._admitted = True
            loop = min(self._loops, key=lambda l: len(l.ops))
        loop.call_soon(lambda: op._start_on_loop(loop))
        return op

    def _op_finished(self, op: "_LoopOp") -> None:
        """Release one admission slot and start the next queued stream
        (skipping streams cancelled while they waited)."""
        if not op._admitted:
            return
        nxt = None
        loop = None
        with self._lock:
            op._admitted = False
            self._inflight_streams -= 1
            if self._classq is not None:
                klass = op.qos_class
                left = self._inservice.get(klass, 0) - 1
                if left > 0:
                    self._inservice[klass] = left
                else:
                    self._inservice.pop(klass, None)
                # Class-major DRR dequeue: floor-deficit classes first,
                # then the smooth-WRR rotation over classes with
                # headroom (ClassQueues.pick).
                while True:
                    picked = self._classq.pick(self._inservice,
                                               self.max_streams)
                    if picked is None:
                        break
                    pk, cand = picked
                    if cand._finished:
                        continue
                    nxt = cand
                    self._inservice[pk] = self._inservice.get(pk, 0) + 1
                    break
            else:
                while self._waitq:
                    cand = self._waitq.popleft()
                    if cand._finished:
                        continue
                    nxt = cand
                    break
            if nxt is not None:
                if nxt._parked_at:
                    wait_ms = (time.monotonic() - nxt._parked_at) * 1e3
                    self._admission_wait_ms.add(wait_ms)
                    if self.qos_stats is not None:
                        self.qos_stats.observe_wait(
                            "download", nxt.qos_class, wait_ms)
                        self.qos_stats.admission(
                            "download", nxt.qos_class, "admitted")
                if self._loops and not self._stop.is_set():
                    self._inflight_streams += 1
                    nxt._admitted = True
                    loop = min(self._loops, key=lambda l: len(l.ops))
                elif self._classq is not None:
                    left = self._inservice.get(nxt.qos_class, 0) - 1
                    if left > 0:
                        self._inservice[nxt.qos_class] = left
                    else:
                        self._inservice.pop(nxt.qos_class, None)
        if nxt is None:
            return
        if loop is None:
            nxt._finish(OSError("download engine stopped"))
            return
        loop.call_soon(lambda: nxt._start_on_loop(loop))

    def _cancel_queued(self, op: "_LoopOp") -> bool:
        """Remove a still-queued op from the admission queue (True if it
        was there — the caller then completes it as cancelled)."""
        with self._lock:
            if self._classq is not None:
                return self._classq.remove(op.qos_class, op)
            try:
                self._waitq.remove(op)
            except ValueError:
                return False
        return True

    def stream_admission(self) -> Dict[str, object]:
        with self._lock:
            queued = (len(self._classq) if self._classq is not None
                      else len(self._waitq))
            wait_p50, wait_p99 = self._admission_wait_ms.percentiles()
            out: Dict[str, object] = {
                "inflight": self._inflight_streams,
                "queued": queued,
                "queued_peak": self.admission_queued_peak,
                "max_streams": self.max_streams,
                # Park → admission latency of queued streams — the
                # number the admission gate actually bounds.
                "queued_wait_ms_p50": round(wait_p50, 3),
                "queued_wait_ms_p99": round(wait_p99, 3),
                "queued_waits": self._admission_wait_ms.count,
            }
            if self._classq is not None:
                out["inflight_by_class"] = dict(self._inservice)
                out["queued_by_class"] = self._classq.counts()
            return out

    def call_later(self, delay: float, fn: Callable[[], None]) -> None:
        """Thread-safe delayed callable on one of the loops (round-robin)
        — the timer wheel conductors park pump backoffs and metadata
        poll pacing on."""
        with self._lock:
            if not self._loops or self._stop.is_set():
                raise RuntimeError("download engine not running")
            loop = self._loops[self._rr % len(self._loops)]
            self._rr += 1
        loop.schedule(delay, fn)


# ----------------------------------------------------------------------
# Op base
# ----------------------------------------------------------------------


class _LoopOp:
    """A state machine owned by one loop. Exposes the thread-ish
    surface (``is_alive``/``join``) the conductor's bookkeeping already
    speaks, so syncer maps hold threads and ops interchangeably."""

    #: Body streams (piece fetches, source runs) pass the engine's
    #: daemon-wide max_streams admission; control ops never queue.
    gated = False

    def __init__(self, task_id: str):
        self.task_id = task_id
        self.engine: Optional[DownloadLoopEngine] = None
        self.loop: Optional[_DlLoop] = None
        self._done_evt = threading.Event()
        self._finished = False
        self._admitted = False
        # Traffic class (client/qos.py): the conductor stamps gated ops
        # so class-aware engines group admission and dispatch by class.
        # "" = class-blind (the zero-overhead default).
        self.qos_class = ""
        self._parked_at = 0.0

    # -- thread-compatible surface ----------------------------------------

    def is_alive(self) -> bool:
        return not self._done_evt.is_set()

    def join(self, timeout: Optional[float] = None) -> None:
        self._done_evt.wait(timeout)

    def cancel(self) -> None:
        """Thread-safe teardown request."""
        loop = self.loop
        if loop is not None:
            loop.call_soon(
                lambda: self._finish(OSError("cancelled"))
                if not self._finished else None)
            return
        engine = self.engine
        if engine is not None and engine._cancel_queued(self):
            # Parked in the admission queue: never started, never
            # admitted — complete it here.
            self._finish(OSError("cancelled"))
            return
        self._done_evt.set()

    # -- loop-side ---------------------------------------------------------

    def _start_on_loop(self, loop: _DlLoop) -> None:
        if self._finished:  # cancelled before the loop picked it up
            return
        self.loop = loop
        if self.engine is not None and self.engine._stop.is_set():
            self._finish(OSError("download engine stopped"))
            return
        loop.ops.add(self)
        try:
            self._begin()
        except Exception as exc:  # noqa: BLE001
            self._finish(exc)

    def _begin(self) -> None:
        raise NotImplementedError

    def on_event(self, mask: int) -> None:
        raise NotImplementedError

    def _finish(self, err: Optional[BaseException]) -> None:
        if self._finished:
            return
        self._finished = True
        if self.loop is not None:
            self.loop.ops.discard(self)
        try:
            self._teardown(err)
        finally:
            self._done_evt.set()
            if self.engine is not None:
                self.engine._op_finished(self)

    def _teardown(self, err: Optional[BaseException]) -> None:
        """Subclass cleanup + user callback."""


# ----------------------------------------------------------------------
# HTTP exchange state machine
# ----------------------------------------------------------------------

_ST_IDLE = "idle"
_ST_CONNECT = "connect"
_ST_TUNNEL = "tunnel"    # CONNECT exchange with a forward proxy
_ST_TLS = "tls"          # nonblocking client handshake in flight
_ST_SEND = "send"
_ST_HEAD = "head"
_ST_BODY = "body"


def _parse_resp_head(head: bytes) -> Tuple[int, Dict[str, str]]:
    """(status, lowercase-header dict) or ValueError."""
    lines = head.split(b"\r\n")
    parts = lines[0].split(None, 2)
    if len(parts) < 2 or not parts[1].isdigit():
        raise ValueError(f"malformed status line {lines[0]!r}")
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        k, sep, v = line.partition(b":")
        if not sep:
            raise ValueError(f"malformed header {line!r}")
        headers[k.strip().lower().decode("latin-1")] = \
            v.strip().decode("latin-1")
    return int(parts[1]), headers


def _content_range_length(value: Optional[str]) -> Optional[int]:
    """Body length a ``Content-Range: bytes a-b/total`` header frames,
    or None when absent/malformed (unsatisfied ``bytes */total`` forms
    included)."""
    if not value:
        return None
    unit, sep, rng = value.partition(" ")
    if not sep or unit.strip().lower() != "bytes":
        return None
    span = rng.split("/", 1)[0].strip()
    first, sep, last = span.partition("-")
    if not sep or not first.isdigit() or not last.isdigit():
        return None
    length = int(last) - int(first) + 1
    return length if length > 0 else None


class _HttpOp(_LoopOp):
    """One nonblocking HTTP/1.1 GET exchange over the engine pool.

    The stale-keep-alive discipline matches the threaded transports: an
    exchange that fails over a POOLED socket before any response byte
    arrives retries ONCE on a fresh dial, flushing the (equally stale)
    pooled siblings first. ``stats.connection`` ticks only for the
    checkout that actually produced a response head. Fresh dials consult
    the ``pool.connect`` faultplan site; STALL rules park the dial on
    the timer wheel instead of sleeping the loop."""

    #: body bytes an exchange may consume per dispatch before yielding.
    fair_budget = FAIR_BUDGET

    def __init__(self, task_id: str, addr: str, *, timeout: float = 30.0,
                 stats=None, tls: Optional[ssl.SSLContext] = None,
                 server_hostname: Optional[str] = None,
                 tunnel: Optional[Tuple[str, int]] = None,
                 tunnel_auth: Optional[str] = None):
        super().__init__(task_id)
        host, sep, port = addr.rpartition(":")
        if not sep or not port.isdigit():
            raise DownloadPieceError(f"malformed parent address {addr!r}")
        self.addr = addr
        self._host = host
        self._port = int(port)
        self.timeout = timeout
        self.stats = stats
        #: TLS client context; None → plaintext exchange.
        self.tls = tls
        self._server_hostname = server_hostname or host
        #: Forward proxy (host, port) to CONNECT through; None → direct.
        self.tunnel = tunnel
        self._tunnel_auth = tunnel_auth
        #: Pool key: TLS sessions and tunneled sockets must never be
        #: mixed with plaintext/direct sockets to the same address.
        key = addr
        if tls is not None:
            key += "|tls"
        if tunnel is not None:
            key += f"|via={tunnel[0]}:{tunnel[1]}"
        self.pool_key = key
        self.sock: Optional[socket.socket] = None
        self.state = _ST_IDLE
        self._interest = 0
        self._registered = False
        self._was_pooled = False
        self._fresh_retried = False
        self._got_head = False
        self._out = b""
        self._out_off = 0
        self._tun_out = b""
        self._tun_out_off = 0
        self._tun_buf = bytearray()
        self._write_wants_read = False
        self._read_wants_write = False
        self._pump_scheduled = False
        self._head_buf = bytearray()
        self._resp_status = -1
        self._resp_headers: Dict[str, str] = {}
        self._keep_alive = True
        self._body_remaining = -1
        self._deadline: Optional[_Timer] = None
        self._last_progress = time.monotonic()

    # -- subclass hooks ----------------------------------------------------

    def _request_bytes(self) -> bytes:
        raise NotImplementedError

    def _on_head(self) -> bool:
        """Head parsed (``_resp_status``/``_resp_headers`` set). Return
        False to abort the exchange (the subclass has already called
        ``_finish``)."""
        return True

    def _on_chunk(self, chunk: bytes) -> None:
        """One body chunk. Raise to abort (becomes the exchange error)."""

    def _on_body_done(self) -> None:
        """Full body consumed; connection already returned/closed.
        Subclasses normally call ``_finish(None)`` here."""
        self._finish(None)

    def _splice_sink(self) -> Optional[Tuple[int, int, int]]:
        """(fd, file_offset, max_len) to land body bytes through the
        native seam, or None to stream through ``_on_chunk``. Consulted
        per dispatch iteration — eligibility is per-connection (TLS
        records and fault filters need the Python path)."""
        return None

    def _on_spliced(self, nbytes: int) -> None:
        """Bookkeeping for bytes the native seam landed directly."""

    # -- exchange ----------------------------------------------------------

    def _begin(self) -> None:
        self._start_exchange()

    def _start_exchange(self, force_fresh: bool = False) -> None:
        self._got_head = False
        self._head_buf = bytearray()
        self._resp_status = -1
        self._resp_headers = {}
        self._body_remaining = -1
        self._out = self._request_bytes()
        self._out_off = 0
        self._arm_deadline()
        pool = self.engine.pool
        sock = None if force_fresh else pool.take(self.pool_key)
        if sock is not None:
            # Pooled sockets are already tunneled/handshaken (the pool
            # key guarantees it) — go straight to the request.
            self._was_pooled = True
            self._adopt_socket(sock, connected=True, established=True)
            return
        self._was_pooled = False
        plan = faultplan.ACTIVE
        if plan is not None:
            rule = plan.check("pool.connect", context=self.addr)
            if rule is not None:
                if rule.kind is faultplan.FaultKind.STALL:
                    # Park the dial on the timer wheel — the loop never
                    # sleeps an injected latency.
                    self.loop.call_later(rule.delay_s, self._dial)
                    return
                if rule.kind is faultplan.FaultKind.CONNECT_REFUSED:
                    self._finish(ConnectionRefusedError(
                        111, f"injected connect-refused at pool.connect "
                             f"({self.addr})"))
                    return
        geo = geoplan.ACTIVE
        if geo is not None:
            # WAN emulation (docs/GEO.md): fresh dials across a
            # partitioned link refuse; otherwise the emulated RTT parks
            # the dial on the timer wheel, faultplan-STALL style — the
            # loop thread never sleeps.
            refused, delay = geo.dial(self.addr)
            if refused:
                self._finish(ConnectionRefusedError(
                    111, f"geo partition: {self.addr} unreachable "
                    "across clusters"))
                return
            if delay > 0:
                self.loop.call_later(delay, self._dial)
                return
        self._dial()

    def _dial(self) -> None:
        if self._finished:
            return
        dial_host, dial_port = ((self.tunnel[0], self.tunnel[1])
                                if self.tunnel is not None
                                else (self._host, self._port))
        try:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            rc = sock.connect_ex((dial_host, dial_port))
        except OSError as exc:
            self._finish(exc)
            return
        if rc not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK):
            sock.close()
            self._finish(OSError(rc, f"connect to {self.addr} failed"))
            return
        self._adopt_socket(sock, connected=(rc == 0))

    def _adopt_socket(self, sock: socket.socket, connected: bool,
                      established: bool = False) -> None:
        self.sock = sock
        self._registered = False
        self._write_wants_read = False
        self._read_wants_write = False
        if established:
            self.state = _ST_SEND
            self._set_interest(selectors.EVENT_WRITE)
            self._try_send()
        elif connected:
            self._post_connect()
        else:
            self.state = _ST_CONNECT
            self._set_interest(selectors.EVENT_WRITE)

    def _post_connect(self) -> None:
        """TCP is up on a FRESH socket: tunnel first, then TLS, then the
        request — each stage a nonblocking state machine on this loop."""
        if self.tunnel is not None:
            self._start_tunnel()
        elif self.tls is not None:
            self._start_tls()
        else:
            self.state = _ST_SEND
            self._set_interest(selectors.EVENT_WRITE)
            self._try_send()

    # -- CONNECT tunnel ----------------------------------------------------

    def _start_tunnel(self) -> None:
        lines = [f"CONNECT {self._host}:{self._port} HTTP/1.1",
                 f"Host: {self._host}:{self._port}"]
        if self._tunnel_auth:
            lines.append(f"Proxy-Authorization: {self._tunnel_auth}")
        self._tun_out = ("\r\n".join(lines) + "\r\n\r\n").encode()
        self._tun_out_off = 0
        self._tun_buf = bytearray()
        self.state = _ST_TUNNEL
        self._set_interest(selectors.EVENT_WRITE)
        self._tunnel_send()

    def _tunnel_send(self) -> None:
        try:
            while self._tun_out_off < len(self._tun_out):
                n = self.sock.send(
                    memoryview(self._tun_out)[self._tun_out_off:])
                self._tun_out_off += n
                self._last_progress = time.monotonic()
        except (BlockingIOError, InterruptedError):
            return
        except OSError as exc:
            self._stream_fail(exc)
            return
        self._set_interest(selectors.EVENT_READ)

    def _tunnel_recv(self) -> None:
        view = self.loop.recv_view
        while True:
            try:
                n = self.sock.recv_into(view[:RECV_CHUNK])
            except (BlockingIOError, InterruptedError):
                return
            except OSError as exc:
                self._stream_fail(exc)
                return
            if n == 0:
                self._stream_fail(OSError(
                    f"proxy {self.tunnel[0]}:{self.tunnel[1]}: closed "
                    "during CONNECT"))
                return
            self._last_progress = time.monotonic()
            self._tun_buf += view[:n]
            idx = self._tun_buf.find(b"\r\n\r\n")
            if idx >= 0:
                break
            if len(self._tun_buf) > MAX_HEAD_BYTES:
                self._stream_fail(ValueError(
                    "oversized CONNECT response head"))
                return
        try:
            status, _hdrs = _parse_resp_head(bytes(self._tun_buf[:idx]))
        except ValueError as exc:
            self._stream_fail(exc)
            return
        if status < 200 or status >= 300:
            self._stream_fail(OSError(
                f"proxy {self.tunnel[0]}:{self.tunnel[1]}: CONNECT "
                f"{self._host}:{self._port} → {status}"))
            return
        if len(self._tun_buf) > idx + 4:
            # Bytes after the CONNECT reply belong to nobody — a proxy
            # speaking early would desync the (possibly TLS) stream.
            self._stream_fail(ValueError(
                "proxy sent data before the tunnel was used"))
            return
        self._tun_buf = bytearray()
        if self.stats is not None:
            self.stats.connect_tunnel()
        if self.tls is not None:
            self._start_tls()
        else:
            self.state = _ST_SEND
            self._set_interest(selectors.EVENT_WRITE)
            self._try_send()

    # -- nonblocking TLS handshake -----------------------------------------

    def _start_tls(self) -> None:
        plan = faultplan.ACTIVE
        if plan is not None:
            rule = plan.check("tls.handshake", context=self.addr)
            if rule is not None:
                # Mid-handshake fault: the peer is gone before the
                # session is up. The op's normal stream-failure path
                # (drop socket, fail → piece retry) must recover.
                self._stream_fail(ConnectionResetError(
                    104, "injected mid-handshake connection reset"))
                return
        sock = self.sock
        if self._registered:
            # wrap_socket returns a NEW object; the selector registration
            # must move with it.
            try:
                self.loop.selector.unregister(sock)
            except (KeyError, ValueError, OSError):
                pass
            self._registered = False
            self._interest = 0
        try:
            self.sock = self.tls.wrap_socket(
                sock, server_side=False, do_handshake_on_connect=False,
                server_hostname=self._server_hostname)
        except (OSError, ssl.SSLError, ValueError) as exc:
            self.sock = sock
            self._stream_fail(exc)
            return
        self.state = _ST_TLS
        self._continue_handshake()

    def _continue_handshake(self) -> None:
        try:
            self.sock.do_handshake()
        except ssl.SSLWantReadError:
            self._set_interest(selectors.EVENT_READ)
            return
        except ssl.SSLWantWriteError:
            self._set_interest(selectors.EVENT_WRITE)
            return
        except (OSError, ssl.SSLError) as exc:
            self._stream_fail(exc)
            return
        self._last_progress = time.monotonic()
        if self.stats is not None:
            self.stats.tls_handshake(server=False)
        self.state = _ST_SEND
        self._set_interest(selectors.EVENT_WRITE)
        self._try_send()

    def _set_interest(self, events: int) -> None:
        if self.sock is None:
            return
        if not self._registered:
            try:
                self.loop.selector.register(self.sock, events, self)
                self._registered = True
                self._interest = events
            except (ValueError, OSError) as exc:
                self._stream_fail(exc)
            return
        if events == self._interest:
            return
        try:
            self.loop.selector.modify(self.sock, events, self)
            self._interest = events
        except (KeyError, ValueError, OSError) as exc:
            self._stream_fail(exc)

    def _native_md5(self):
        """The op's digest context when it lives in the native seam
        (then C accumulates spliced bytes into it); None → no inline
        digest for spliced bytes."""
        return None

    def _drop_socket(self, keep: bool) -> None:
        sock, self.sock = self.sock, None
        if sock is None:
            return
        if self._registered:
            try:
                self.loop.selector.unregister(sock)
            except (KeyError, ValueError, OSError):
                pass
            self._registered = False
        if keep and isinstance(sock, ssl.SSLSocket) and sock.pending() > 0:
            # Decrypted bytes beyond the response body: the keep-alive
            # framing is desynced — never pool it.
            keep = False
        if keep:
            self.engine.pool.give(self.pool_key, sock)
        else:
            sock.close()

    def _arm_deadline(self) -> None:
        if self._deadline is not None:
            self._deadline.cancel()
        self._last_progress = time.monotonic()
        self._deadline = self.loop.call_later(
            self.timeout, self._deadline_fired)

    def _deadline_fired(self) -> None:
        """IDLE deadline, not a whole-exchange cap: the threaded
        transports bound each socket operation, so a big coalesced run
        on a slow-but-moving origin must not be killed mid-body. Re-arm
        for the remainder while bytes are flowing; fail only after a
        full timeout with zero progress."""
        idle = time.monotonic() - self._last_progress
        if idle < self.timeout:
            self._deadline = self.loop.call_later(
                self.timeout - idle, self._deadline_fired)
            return
        self._stream_fail(TimeoutError(
            f"{self.addr}: exchange stalled {idle:.1f}s "
            f"(timeout {self.timeout}s)"))

    # -- events ------------------------------------------------------------

    def on_event(self, mask: int) -> None:
        if self._finished or self.sock is None:
            return
        if self.state == _ST_CONNECT and mask & selectors.EVENT_WRITE:
            err = self.sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
            if err:
                self._stream_fail(OSError(
                    err, f"connect to {self.addr}: {os.strerror(err)}"))
                return
            self._post_connect()
            return
        if self.state == _ST_TUNNEL:
            if (mask & selectors.EVENT_WRITE
                    and self._tun_out_off < len(self._tun_out)):
                self._tunnel_send()
            elif mask & selectors.EVENT_READ:
                self._tunnel_recv()
            return
        if self.state == _ST_TLS:
            self._continue_handshake()
            return
        if self.state == _ST_SEND:
            if self._write_wants_read and mask & selectors.EVENT_READ:
                # Renegotiation: the record layer needed inbound bytes
                # to make write progress (upload engine's discipline).
                self._write_wants_read = False
                self._set_interest(selectors.EVENT_WRITE)
                self._try_send()
            elif mask & selectors.EVENT_WRITE:
                self._try_send()
            return
        if self.state in (_ST_HEAD, _ST_BODY):
            if self._read_wants_write and mask & selectors.EVENT_WRITE:
                self._read_wants_write = False
                self._set_interest(selectors.EVENT_READ)
                self._try_recv()
            elif mask & selectors.EVENT_READ:
                self._try_recv()

    def _try_send(self) -> None:
        try:
            while self._out_off < len(self._out):
                n = self.sock.send(memoryview(self._out)[self._out_off:])
                self._out_off += n
                self._last_progress = time.monotonic()
        except ssl.SSLWantReadError:
            # MUST precede the OSError clause — SSLWant* subclass it.
            self._write_wants_read = True
            self._set_interest(selectors.EVENT_READ)
            return
        except (ssl.SSLWantWriteError, BlockingIOError, InterruptedError):
            return
        except OSError as exc:
            self._stream_fail(exc)
            return
        self.state = _ST_HEAD
        self._set_interest(selectors.EVENT_READ)
        if (isinstance(self.sock, ssl.SSLSocket)
                and self.sock.pending() > 0):
            # Decrypted bytes already sit in the record layer; the
            # selector watches the RAW fd and would never fire for them.
            self._schedule_pump()

    def _try_recv(self) -> None:
        geo = geoplan.ACTIVE
        if geo is not None and geo.refuse(self.addr):
            # WAN emulation (docs/GEO.md): a partition severing this
            # link mid-stream resets like a dropped route.
            self._stream_fail(ConnectionResetError(
                104, f"geo partition: {self.addr} stream reset"))
            return
        budget = self.fair_budget
        view = self.loop.recv_view
        while budget > 0:
            if geo is not None:
                # Outstanding bandwidth debt on this link: park the op
                # on the timer wheel (socket off the selector) instead
                # of sleeping the shared loop thread.
                delay = geo.pace(self.addr, 0)
                if delay > 0:
                    self._geo_pause(delay)
                    return
            if self.state == _ST_BODY and self._body_remaining > 0:
                sink = self._splice_sink()
                if sink is not None:
                    # Native seam: socket → file-at-offset entirely in
                    # C, PARTIAL progress on EAGAIN. Digest (when the
                    # sink carries one) accumulates in the op's shared
                    # md5 context, so Python-fed head-surplus bytes and
                    # C-landed bytes form one digest stream.
                    fd, file_off, max_len = sink
                    want = min(self._body_remaining, budget, max_len)
                    try:
                        res = native.splice_recv_to_file(
                            self.sock.fileno(), fd, file_off, want,
                            self._native_md5(), self.loop.splice_pipe)
                    except (native.NativeIOError, OSError) as exc:
                        self._stream_fail(exc)
                        return
                    if res.nbytes > 0:
                        self._last_progress = time.monotonic()
                        budget -= res.nbytes
                        self._body_remaining -= res.nbytes
                        if self.stats is not None:
                            self.stats.splice(res.nbytes, res.zero_copy)
                        if geo is not None:
                            geo.pace(self.addr, res.nbytes)
                        self._on_spliced(res.nbytes)
                        if self._body_remaining == 0:
                            self._complete_exchange()
                            return
                    if res.eof:
                        self._stream_fail(OSError(
                            f"{self.addr}: connection closed mid-body"))
                        return
                    if res.nbytes < want:
                        return  # EAGAIN — the selector re-fires
                    continue
            if self.state == _ST_BODY and self._body_remaining >= 0:
                # Body: one recv as large as remaining × budget allows —
                # the kernel hands back whatever is buffered in a single
                # syscall, and the chunk flows to the sink as a view of
                # the loop's reusable buffer (consumed synchronously, so
                # no copy survives the dispatch).
                want = min(self._body_remaining, budget, len(view))
            else:
                want = min(RECV_CHUNK, budget)
            if want == 0:
                break
            try:
                n = self.sock.recv_into(view[:want])
            except ssl.SSLWantReadError:
                # MUST precede OSError (SSLWant* subclass it): the
                # record layer has no complete record yet.
                return
            except ssl.SSLWantWriteError:
                self._read_wants_write = True
                self._set_interest(selectors.EVENT_WRITE)
                return
            except (BlockingIOError, InterruptedError):
                return
            except OSError as exc:
                self._stream_fail(exc)
                return
            if n == 0:
                self._stream_fail(OSError(
                    f"{self.addr}: connection closed "
                    f"{'mid-body' if self.state == _ST_BODY else 'pre-head'}"))
                return
            self._last_progress = time.monotonic()
            budget -= n
            if geo is not None:
                # Accumulate the link's bandwidth debt; the query at
                # the top of the loop parks once it goes positive.
                geo.pace(self.addr, n)
            if self.state == _ST_HEAD:
                if not self._feed_head(bytes(view[:n])):
                    return
            elif self.state == _ST_BODY:
                if not self._feed_body(view[:n]):
                    return
        # Budget exhausted with body left: yield the loop. For plaintext
        # the level-triggered selector re-fires while bytes remain
        # kernel-buffered; decrypted-but-unread TLS bytes live in the
        # record layer where the selector can't see them, so drain those
        # via the loop's inbox (still AFTER other ready ops this round —
        # fairness holds).
        if (isinstance(self.sock, ssl.SSLSocket)
                and self.sock.pending() > 0):
            self._schedule_pump()

    def _geo_pause(self, delay: float) -> None:
        """Park this op for an emulated-WAN bandwidth debt: the socket
        comes off the selector (kernel buffering backpressures the
        sender, like a real slow link) and a timer re-arms the read."""
        if self._registered and self.sock is not None:
            try:
                self.loop.selector.unregister(self.sock)
            except (KeyError, ValueError, OSError):
                pass
            self._registered = False
            self._interest = 0
        self.loop.call_later(delay, self._geo_resume)

    def _geo_resume(self) -> None:
        if (self._finished or self.sock is None
                or self.state not in (_ST_HEAD, _ST_BODY)):
            return
        self._set_interest(selectors.EVENT_READ)
        self._try_recv()

    def _schedule_pump(self) -> None:
        if self._pump_scheduled or self._finished:
            return
        self._pump_scheduled = True
        self.loop.call_soon(self._pump_pending)

    def _pump_pending(self) -> None:
        self._pump_scheduled = False
        if (self._finished or self.sock is None
                or self.state not in (_ST_HEAD, _ST_BODY)):
            return
        self._try_recv()

    def _feed_head(self, data: bytes) -> bool:
        self._head_buf += data
        idx = self._head_buf.find(b"\r\n\r\n")
        if idx < 0:
            if len(self._head_buf) > MAX_HEAD_BYTES:
                self._stream_fail(ValueError(
                    f"{self.addr}: response head exceeds "
                    f"{MAX_HEAD_BYTES} bytes"))
                return False
            return True
        head = bytes(self._head_buf[:idx])
        rest = bytes(self._head_buf[idx + 4:])
        self._head_buf = bytearray()
        try:
            self._resp_status, self._resp_headers = _parse_resp_head(head)
        except ValueError as exc:
            self._stream_fail(exc)
            return False
        self._got_head = True
        if self.stats is not None:
            # The checkout that actually served the request — a stale
            # pooled socket that died above never counted.
            self.stats.connection(reused=self._was_pooled)
        conn_hdr = self._resp_headers.get("connection", "").lower()
        self._keep_alive = conn_hdr != "close"
        length = self._resp_headers.get("content-length")
        if length is not None and length.isdigit():
            self._body_remaining = int(length)
        else:
            # Close-delimited reply (legal HTTP/1.1; the reference's
            # no-content-length origin fixture): a 206 still frames its
            # body exactly via Content-Range, so derive the length from
            # there. Without an explicit length the keep-alive framing
            # is not trustworthy — never pool the socket.
            self._keep_alive = False
            derived = _content_range_length(
                self._resp_headers.get("content-range"))
            if derived is None:
                self._stream_fail(ValueError(
                    f"{self.addr}: response without Content-Length"))
                return False
            self._body_remaining = derived
        if not self._on_head():
            return False
        if self._finished:
            return False
        self.state = _ST_BODY
        if rest:
            if not self._feed_body(rest):
                return False
        elif self._body_remaining == 0:
            self._complete_exchange()
            return False
        return True

    def _feed_body(self, data: bytes) -> bool:
        if len(data) > self._body_remaining:
            # Pipelined surplus would desync the keep-alive framing.
            self._stream_fail(ValueError(
                f"{self.addr}: {len(data) - self._body_remaining} surplus "
                "body bytes"))
            return False
        self._body_remaining -= len(data)
        try:
            self._on_chunk(data)
        except Exception as exc:  # noqa: BLE001 — sink decides the failure
            self._stream_fail(exc)
            return False
        if self._body_remaining == 0:
            self._complete_exchange()
            return False
        return True

    def _complete_exchange(self) -> None:
        if self._deadline is not None:
            self._deadline.cancel()
            self._deadline = None
        self._drop_socket(keep=self._keep_alive)
        self._on_body_done()

    # -- failure -----------------------------------------------------------

    def _stream_fail(self, exc: BaseException) -> None:
        if self._finished:
            return
        retry = (self._was_pooled and not self._got_head
                 and not self._fresh_retried)
        self._drop_socket(keep=False)
        if retry:
            # Stale keep-alive: drop its pooled siblings too (same dead
            # server) so the retry really is a fresh connect.
            self._fresh_retried = True
            self.engine.pool.flush(self.pool_key)
            try:
                self._start_exchange(force_fresh=True)
            except Exception as fresh_exc:  # noqa: BLE001
                self._finish(fresh_exc)
            return
        self._finish(exc)

    def _teardown(self, err: Optional[BaseException]) -> None:
        if self._deadline is not None:
            self._deadline.cancel()
            self._deadline = None
        self._drop_socket(keep=False)
        self._on_finished(err)

    def _on_finished(self, err: Optional[BaseException]) -> None:
        """Terminal subclass hook (both success and failure paths)."""


# ----------------------------------------------------------------------
# Buffered GET (metadata polls, small control fetches)
# ----------------------------------------------------------------------


class BufferedGetOp(_HttpOp):
    """GET ``path`` from ``addr``; body buffered whole (bounded).
    ``callback(status, headers, body, err)`` on the loop thread —
    exactly one of (status≥0, err) is meaningful."""

    MAX_BODY = 16 << 20

    def __init__(self, task_id: str, addr: str, path: str, *,
                 timeout: float = 5.0, stats=None,
                 tls: Optional[ssl.SSLContext] = None,
                 server_hostname: Optional[str] = None,
                 tunnel: Optional[Tuple[str, int]] = None,
                 tunnel_auth: Optional[str] = None,
                 callback: Callable[[int, Dict[str, str],
                                     Optional[bytes],
                                     Optional[BaseException]], None]):
        super().__init__(task_id, addr, timeout=timeout, stats=stats,
                         tls=tls, server_hostname=server_hostname,
                         tunnel=tunnel, tunnel_auth=tunnel_auth)
        self.path = path
        self.callback = callback
        self._body = bytearray()

    def _request_bytes(self) -> bytes:
        return (f"GET {self.path} HTTP/1.1\r\n"
                f"Host: {self.addr}\r\n"
                f"Connection: keep-alive\r\n\r\n").encode()

    def _on_head(self) -> bool:
        if self._body_remaining > self.MAX_BODY:
            self._stream_fail(ValueError(
                f"{self.addr}{self.path}: body {self._body_remaining} "
                "exceeds buffered cap"))
            return False
        return True

    def _on_chunk(self, chunk: bytes) -> None:
        self._body += chunk

    def _on_finished(self, err: Optional[BaseException]) -> None:
        cb, self.callback = self.callback, None
        if cb is None:
            return
        if err is None:
            cb(self._resp_status, self._resp_headers, bytes(self._body),
               None)
        else:
            cb(-1, {}, None, err)


# ----------------------------------------------------------------------
# Piece fetch (parent → pwrite at offset → incremental md5)
# ----------------------------------------------------------------------


class PieceFetchOp(_HttpOp):
    """One parent piece GET streamed straight into the task data file.

    Mirrors ``PieceDownloader.fetch`` semantics exactly: 206 + exact
    Content-Length required, 404 surfaces ``not_ready`` (partial-parent
    park), ``piece.body`` faults filter the chunk stream, ENOSPC is
    fatal, unrecorded bytes from a failed attempt are overwritten by the
    next one. Rate limiting parks the op on the loop's timer wheel
    before the GET is issued; a stream that dies refunds the unreceived
    fraction of the reservation."""

    gated = True

    def __init__(self, req: DownloadPieceRequest, *,
                 open_fd: Callable[[], int],
                 reserve: Callable[[int], float],
                 refund: Callable[[float], None],
                 callback: Callable[[Optional[str], int,
                                     Optional[DownloadPieceError]], None],
                 timeout: float = 30.0, stats=None,
                 tls: Optional[ssl.SSLContext] = None,
                 server_hostname: Optional[str] = None,
                 chunk_hook: Optional[Callable[[int], None]] = None,
                 verify_body: bool = True):
        super().__init__(req.task_id, req.dst_addr, timeout=timeout,
                         stats=stats, tls=tls,
                         server_hostname=server_hostname)
        self.req = req
        self.open_fd = open_fd
        self.reserve = reserve
        self.refund = refund
        self.callback = callback
        self.chunk_hook = chunk_hook
        #: False → no inline digest: the ZERO-COPY splice mode (bench
        #: rungs that verify whole windows post-hoc via
        #: ``native.md5_file_range``). The daemon's piece path always
        #: verifies inline.
        self.verify_body = verify_body
        #: Stamped by the conductor when a traffic class is active so
        #: the serving peer's upload gate can classify this stream.
        self.qos_tenant = ""
        self._fd = -1
        self._offset = req.piece.offset
        self._md5 = hashlib.md5() if verify_body else None
        self._received = 0
        self._reserved = 0
        self._filter = None
        self._begin_ns = 0

    def _begin(self) -> None:
        delay = self.reserve(self.req.piece.length)
        self._reserved = self.req.piece.length
        if delay > 0:
            # Rate-limited: park on the timer wheel (never block a loop).
            self.loop.call_later(delay, self._go)
            return
        self._go()

    def _go(self) -> None:
        if self._finished:
            return
        self._begin_ns = time.monotonic_ns()
        self._start_exchange()

    def _request_bytes(self) -> bytes:
        piece = self.req.piece
        path = piece_request_path(self.req.task_id, self.req.dst_peer_id)
        extra = ""
        if self.qos_class:
            from dragonfly2_tpu_torch.client import qos as qos_mod
            extra = qos_mod.class_request_headers(self.qos_class,
                                                  self.qos_tenant)
        return (f"GET {path} HTTP/1.1\r\n"
                f"Host: {self.addr}\r\n"
                f"Range: {piece.range.http_header()}\r\n"
                f"{extra}"
                f"Connection: keep-alive\r\n\r\n").encode()

    def _on_head(self) -> bool:
        piece = self.req.piece
        if self._resp_status != 206 or self._body_remaining != piece.length:
            # Unknown body framing — don't try to realign the keep-alive.
            status, body = self._resp_status, self._body_remaining
            self._drop_socket(keep=False)
            self._finish(DownloadPieceError(
                f"{self.addr} piece {piece.num}: status {status}, "
                f"body {body}/{piece.length}",
                not_ready=status == 404,
            ))
            return False
        plan = faultplan.ACTIVE
        self._filter = (faultplan.body_filter(
            plan.check("piece.body", context=self.addr))
            if plan is not None else None)
        try:
            self._fd = self.open_fd()
        except OSError as exc:
            self._drop_socket(keep=False)
            self._finish(DownloadPieceError(
                f"data file unavailable: {exc}"))
            return False
        if self.verify_body and native.available():
            # One digest context shared across the ctypes boundary:
            # head-surplus bytes fed from Python and body bytes landed
            # by the C splice loop accumulate into the SAME stream.
            self._md5 = native.Md5()
        return True

    def _splice_sink(self) -> Optional[Tuple[int, int, int]]:
        if (self._fd < 0 or self._filter is not None
                or self.chunk_hook is not None
                or isinstance(self.sock, ssl.SSLSocket)
                or not native.available()):
            return None
        return (self._fd, self._offset, self._body_remaining)

    def _native_md5(self):
        return self._md5 if isinstance(self._md5, native.Md5) else None

    def _on_spliced(self, nbytes: int) -> None:
        self._offset += nbytes
        self._received += nbytes

    def _on_chunk(self, chunk: bytes) -> None:
        if self._filter is not None:
            chunk = self._filter(chunk)
        if not chunk:
            return
        if self.chunk_hook is not None:
            self.chunk_hook(len(chunk))
        os.pwrite(self._fd, chunk, self._offset)
        if self._md5 is not None:
            self._md5.update(chunk)
        self._offset += len(chunk)
        self._received += len(chunk)

    def _on_body_done(self) -> None:
        piece = self.req.piece
        if self._received != piece.length:
            # A TRUNCATE body fault shortens chunks without closing the
            # socket early — the wire framing completed but the piece
            # did not.
            self._finish(DownloadPieceError(
                f"piece {piece.num}: got {self._received} bytes, "
                f"want {piece.length}"))
            return
        if self.stats is not None:
            self.stats.parent_request(piece.length)
        self._finish(None)

    def _on_finished(self, err: Optional[BaseException]) -> None:
        if self._fd >= 0:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = -1
        cb, self.callback = self.callback, None
        if cb is None:
            return
        cost_ns = (time.monotonic_ns() - self._begin_ns
                   if self._begin_ns else 0)
        if err is None:
            digest = "" if self._md5 is None else self._md5.hexdigest()
            cb(digest, cost_ns, None)
            return
        if self._reserved and self._received < self._reserved:
            # Refund the unreceived fraction of the up-front charge so a
            # flapping parent can't drain the task's bucket with bytes
            # that never arrived.
            self.refund(self._reserved - self._received)
        if not isinstance(err, DownloadPieceError):
            err = DownloadPieceError(
                f"{self.addr} piece {self.req.piece.num}: {err}",
                fatal=getattr(err, "errno", None) == errno.ENOSPC)
        cb(None, cost_ns, err)


# ----------------------------------------------------------------------
# Coalesced back-to-source range run
# ----------------------------------------------------------------------


class RunPiece:
    """One piece of a coalesced source run (task-local offsets)."""

    __slots__ = ("num", "offset", "length", "skip")

    def __init__(self, num: int, offset: int, length: int,
                 skip: bool = False):
        self.num = num
        self.offset = offset
        self.length = length
        self.skip = skip


class SourceRunOp(_HttpOp):
    """ONE ranged origin GET covering a run of pieces, split into pieces
    as the stream arrives — the async mirror of the threaded
    ``fetch_run_impl``. Per landed piece, ``piece_cb(run_piece,
    md5_hex, cost_ns)`` runs on the loop thread (record + report +
    shaper accounting live with the conductor); pieces marked ``skip``
    (landed via the mesh since the claim) are consumed and discarded.
    ``done_cb(completed, completed_bytes, err)`` always fires exactly
    once — counters record what actually LANDED."""

    gated = True

    def __init__(self, task_id: str, addr: str, path: str, *,
                 host_header: str, src_range_header: str, url: str,
                 pieces: List[RunPiece],
                 open_fd: Callable[[], int],
                 reserve: Callable[[int], float],
                 refund: Callable[[float], None],
                 piece_cb: Callable[[RunPiece, str, int], None],
                 done_cb: Callable[[int, int, Optional[BaseException]],
                                   None],
                 extra_headers: Optional[Dict[str, str]] = None,
                 timeout: float = 30.0, stats=None,
                 tls: Optional[ssl.SSLContext] = None,
                 server_hostname: Optional[str] = None,
                 tunnel: Optional[Tuple[str, int]] = None,
                 tunnel_auth: Optional[str] = None):
        super().__init__(task_id, addr, timeout=timeout, stats=stats,
                         tls=tls, server_hostname=server_hostname,
                         tunnel=tunnel, tunnel_auth=tunnel_auth)
        self.path = path
        self.url = url
        self.host_header = host_header
        self.src_range_header = src_range_header
        self.extra_headers = dict(extra_headers or {})
        self.pieces = pieces
        self.open_fd = open_fd
        self.reserve = reserve
        self.refund = refund
        self.piece_cb = piece_cb
        self.done_cb = done_cb
        self.run_bytes = sum(p.length for p in pieces)
        self._fd = -1
        self._idx = 0
        self._cur_md5 = hashlib.md5()
        self._cur_written = 0
        self._cur_begin_ns = 0
        self._received = 0
        self._reserved = 0
        self.completed = 0
        self.completed_bytes = 0
        self._filter = None

    def _begin(self) -> None:
        # Shape the WHOLE run before the GET is issued (threaded-path
        # contract: blocking mid-body would idle the origin connection
        # into send-timeouts) — but park on the timer wheel, not a
        # thread.
        delay = self.reserve(self.run_bytes)
        self._reserved = self.run_bytes
        if delay > 0:
            self.loop.call_later(delay, self._go)
            return
        self._go()

    def _go(self) -> None:
        if self._finished:
            return
        self._start_exchange()

    def _request_bytes(self) -> bytes:
        lines = [f"GET {self.path} HTTP/1.1",
                 f"Host: {self.host_header}"]
        for key, value in self.extra_headers.items():
            if key.lower() in ("range", "host", "connection"):
                continue
            lines.append(f"{key}: {value}")
        lines.append(f"Range: {self.src_range_header}")
        lines.append("Connection: keep-alive")
        return ("\r\n".join(lines) + "\r\n\r\n").encode()

    def _on_head(self) -> bool:
        if self._resp_status != 206:
            # A server that ignores Range would hand back the whole
            # body; treating it as the slice silently corrupts pieces.
            status = self._resp_status
            self._drop_socket(keep=False)
            self._finish(OSError(
                f"{self.url}: server ignored Range (status {status})"))
            return False
        if self._body_remaining != self.run_bytes:
            length = self._body_remaining
            self._drop_socket(keep=False)
            self._finish(OSError(
                f"{self.url}: range body {length} != "
                f"run {self.run_bytes}"))
            return False
        plan = faultplan.ACTIVE
        self._filter = (faultplan.body_filter(
            plan.check("source.body", context=self.url))
            if plan is not None else None)
        try:
            self._fd = self.open_fd()
        except OSError as exc:
            self._drop_socket(keep=False)
            self._finish(exc)
            return False
        if native.available():
            self._cur_md5 = native.Md5()
        self._cur_begin_ns = time.monotonic_ns()
        return True

    def _splice_sink(self) -> Optional[Tuple[int, int, int]]:
        if (self._fd < 0 or self._filter is not None
                or self._idx >= len(self.pieces)
                or isinstance(self.sock, ssl.SSLSocket)
                or not native.available()):
            return None
        piece = self.pieces[self._idx]
        if piece.skip:
            # Skip pieces (landed via the mesh since the claim) are
            # consumed and DISCARDED — the Python path drains them.
            return None
        return (self._fd, piece.offset + self._cur_written,
                piece.length - self._cur_written)

    def _native_md5(self):
        return (self._cur_md5
                if isinstance(self._cur_md5, native.Md5) else None)

    def _on_spliced(self, nbytes: int) -> None:
        # The sink caps max_len at the current piece's remainder, so a
        # spliced burst never crosses a piece boundary.
        piece = self.pieces[self._idx]
        self._cur_written += nbytes
        self._received += nbytes
        if self._cur_written == piece.length:
            cost = time.monotonic_ns() - self._cur_begin_ns
            self.piece_cb(piece, self._cur_md5.hexdigest(), cost)
            self.completed += 1
            self.completed_bytes += piece.length
            self._idx += 1
            self._cur_md5 = (native.Md5() if native.available()
                             else hashlib.md5())
            self._cur_written = 0
            self._cur_begin_ns = time.monotonic_ns()

    def _on_chunk(self, chunk: bytes) -> None:
        if self._filter is not None:
            chunk = self._filter(chunk)
        view = memoryview(chunk)
        while len(view):
            if self._idx >= len(self.pieces):
                return  # surplus beyond the last piece — framing guard
            piece = self.pieces[self._idx]
            take = min(len(view), piece.length - self._cur_written)
            part = view[:take]
            if not piece.skip:
                try:
                    os.pwrite(self._fd, part,
                              piece.offset + self._cur_written)
                except OSError as exc:
                    if exc.errno == errno.ENOSPC:
                        from dragonfly2_tpu_torch.client.storage import (
                            DiskFullError,
                        )

                        raise DiskFullError(
                            f"piece {piece.num}: {exc}") from exc
                    raise
                self._cur_md5.update(part)
            self._cur_written += take
            self._received += take
            view = view[take:]
            if self._cur_written == piece.length:
                cost = time.monotonic_ns() - self._cur_begin_ns
                if not piece.skip:
                    # piece_cb records + reports; its failures
                    # (DiskFullError from the journal, storage races)
                    # abort the run like a stream failure.
                    self.piece_cb(piece, self._cur_md5.hexdigest(), cost)
                    self.completed += 1
                    self.completed_bytes += piece.length
                self._idx += 1
                self._cur_md5 = (native.Md5() if native.available()
                                 else hashlib.md5())
                self._cur_written = 0
                self._cur_begin_ns = time.monotonic_ns()

    def _on_body_done(self) -> None:
        if self._idx < len(self.pieces):
            self._finish(OSError(
                f"{self.url}: run ended after {self._idx}/"
                f"{len(self.pieces)} pieces"))
            return
        self._finish(None)

    def _on_finished(self, err: Optional[BaseException]) -> None:
        if self._fd >= 0:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = -1
        cb, self.done_cb = self.done_cb, None
        if cb is None:
            return
        if err is not None and self._reserved:
            leftover = self._reserved - self._received
            if leftover > 0:
                self.refund(leftover)
        cb(self.completed, self.completed_bytes, err)


# `select` is imported for platforms where DefaultSelector needs it at
# teardown (interpreter-shutdown import races); referenced to keep lint
# honest — the same stance as upload_async.
_ = select
