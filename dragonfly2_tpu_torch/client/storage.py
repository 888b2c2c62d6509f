"""Piece-granular local task storage with persisted metadata and reuse.

Reference counterpart: client/daemon/storage — ``TaskStorageDriver``
(storage_manager.go:52-77), the simple on-disk layout (local_storage.go:
one data file per peer task + metadata JSON), completed-task reuse lookup
(storage_manager.go:101-106 FindCompletedTask), and TTL/disk-usage GC
(storage_manager.go TryGC). Layout here: ``<root>/<taskID>/<peerID>/data``
plus ``metadata.json``; md5-per-piece verification happens at write time via
:class:`~dragonfly2_tpu_torch.utils.digest.DigestReader` semantics.

Crash-safety contract (ISSUE 8 — KeepStorage semantics that survive
SIGKILL, client/config/peerhost.go:63):

- ``metadata.json`` is a **piece-granular durable journal**, updated
  incrementally on the write path (amortized: every
  ``persist_every_pieces`` landings or ``persist_interval_s`` seconds,
  whichever first) — not only at ``mark_done``. A journaled piece was
  md5-verified BEFORE it was journaled, so the journal never claims
  bytes that were not fully written.
- ``persist()`` is crash-atomic and race-free: the snapshot is written
  to a **unique-per-call** tmp name, fsynced, published with
  ``os.replace``, and the parent directory is fsynced — a crash at any
  point leaves either the old or the new journal, never a torn or
  empty one, and two concurrent persists never interleave writes into
  a shared tmp path.
- ``_reload`` recovers **partial** stores too, re-verifying every
  resident piece against its journaled md5 (mismatched/short/unhashed
  pieces are dropped, a ``done`` store with drops is demoted), and
  sweeps orphan directories whose journal is missing or corrupt. A
  restarted daemon resumes from the verified journal instead of
  re-downloading from zero (``StorageManager.register_or_resume``).
"""

from __future__ import annotations

import errno
import hashlib
import json
import logging
import os
import shutil
import threading
import time
import uuid
from dataclasses import asdict, dataclass, field
from typing import BinaryIO, Dict, Iterable, List, Optional, Tuple

from dragonfly2_tpu_torch.client.piece import PieceMetadata, Range
from dragonfly2_tpu_torch.utils import digest as digestutil
from dragonfly2_tpu_torch.utils import faultplan

logger = logging.getLogger(__name__)

METADATA_FILE = "metadata.json"
DATA_FILE = "data"
# Root-level sentinel a graceful shutdown leaves behind (and the next
# reload consumes): present ⇒ every journal was persisted by a live
# stop() ⇒ the full resident-byte verify pass can be skipped.
CLEAN_SHUTDOWN_FILE = ".clean_shutdown"


class StorageError(Exception):
    pass


class InvalidPieceDigestError(StorageError):
    """Piece payload did not match its announced md5."""


class DiskFullError(StorageError):
    """ENOSPC on a piece write. Terminal for the task: retrying a full
    disk from another parent just hangs workers, so conductors fail the
    task fast when they see this."""


@dataclass
class WritePieceRequest:
    task_id: str
    peer_id: str
    piece: PieceMetadata
    # Unknown-length pieces may pass length<0 and learn it from the stream.
    unknown_length: bool = False


@dataclass
class TaskMetadata:
    """Persisted per-peer-task state
    (reference: client/daemon/storage/metadata.go:29-45)."""

    task_id: str
    peer_id: str
    content_length: int = -1
    total_pieces: int = -1
    piece_md5_sign: str = ""
    header: Dict[str, str] = field(default_factory=dict)
    done: bool = False
    # Source URL the task was derived from: lets a restarted daemon
    # re-announce a completed replica to the scheduler (the scheduler's
    # Task needs a url for other peers' back-to-source budget).
    url: str = ""
    pieces: Dict[int, PieceMetadata] = field(default_factory=dict)

    def to_json(self) -> str:
        d = asdict(self)
        d["pieces"] = {str(k): asdict(v) for k, v in self.pieces.items()}
        return json.dumps(d)

    @classmethod
    def from_json(cls, raw: str) -> "TaskMetadata":
        d = json.loads(raw)
        d["pieces"] = {
            int(k): PieceMetadata(**v) for k, v in d.get("pieces", {}).items()
        }
        return cls(**d)


class TaskStorage:
    """One peer task's on-disk state: sparse data file + metadata."""

    def __init__(self, directory: str, meta: TaskMetadata,
                 persist_every_pieces: int = 0,
                 persist_interval_s: float = 0.0):
        self.directory = directory
        self.meta = meta
        self._lock = threading.Lock()
        self.last_access = time.monotonic()
        os.makedirs(directory, exist_ok=True)
        self.data_path = os.path.join(directory, DATA_FILE)
        if not os.path.exists(self.data_path):
            open(self.data_path, "wb").close()
        self._invalid = False
        # Incremental-journal cadence (0/0 = persist only at mark_done
        # and persist_all — the pre-ISSUE-8 behavior). Landings since
        # the last persist and its timestamp live under _lock.
        self._persist_every = max(int(persist_every_pieces), 0)
        self._persist_interval = max(float(persist_interval_s), 0.0)
        self._dirty_pieces = 0
        self._last_persist = time.monotonic()
        # Set by the owning StorageManager: called once when mark_done
        # completes, so the manager's task_id → done-replica index stays
        # current without the manager lock wrapping every piece write.
        self.on_done = None
        # True for stores rebuilt by StorageManager._reload and not yet
        # adopted by a conductor — the register_or_resume handshake only
        # ever adopts recovered stores, so a concurrent in-process
        # download of the same task can never steal a live writer's.
        self.recovered = False

    # -- write path --------------------------------------------------------

    def write_piece(self, req: WritePieceRequest, reader: BinaryIO) -> int:
        """Stream a piece into the data file at its offset, hashing as we
        write; raises :class:`InvalidPieceDigestError` on md5 mismatch and
        discards nothing (the slot is simply not recorded). Returns bytes
        written. Idempotent per piece number."""
        self.touch()
        piece = req.piece
        with self._lock:
            duplicate = self.meta.pieces.get(piece.num)
        if duplicate is not None:
            # Duplicate of an already-verified piece: drain and ignore
            # (outside the lock — the reader may be a slow network
            # stream). Drain exactly this piece's span when the length
            # is known: the reader may be a shared coalesced-run stream
            # (peer_task._download_source) that later pieces continue
            # from — draining to EOF would eat their bytes.
            remaining = None if req.unknown_length else piece.length
            while remaining is None or remaining > 0:
                n = 1 << 20 if remaining is None else min(1 << 20, remaining)
                chunk = reader.read(n)
                if not chunk:
                    break
                if remaining is not None:
                    remaining -= len(chunk)
            return duplicate.length
        plan = faultplan.ACTIVE
        if plan is not None:
            rule = plan.check("storage.write", context=self.meta.task_id)
            if rule is not None and rule.kind is faultplan.FaultKind.ENOSPC:
                raise DiskFullError(
                    f"piece {piece.num}: injected ENOSPC")
        src = (
            digestutil.DigestReader(reader, digestutil.ALGORITHM_MD5,
                                    expected=piece.md5)
            if piece.md5 else None
        )
        written = 0
        try:
            with open(self.data_path, "r+b") as f:
                f.seek(piece.offset)
                remaining = None if req.unknown_length else piece.length
                while remaining is None or remaining > 0:
                    n = (1 << 20 if remaining is None
                         else min(1 << 20, remaining))
                    chunk = (src or reader).read(n)
                    if not chunk:
                        break
                    f.write(chunk)
                    written += len(chunk)
                    if remaining is not None:
                        remaining -= len(chunk)
        except OSError as exc:
            if exc.errno == errno.ENOSPC:
                raise DiskFullError(
                    f"piece {piece.num}: {exc}") from exc
            raise
        if not req.unknown_length and written != piece.length:
            raise StorageError(
                f"piece {piece.num}: wrote {written}, expected {piece.length}"
            )
        if src is not None and not src.validate():
            raise InvalidPieceDigestError(
                f"piece {piece.num}: md5 {src.hexdigest()} != {piece.md5}"
            )
        final = PieceMetadata(
            num=piece.num, md5=piece.md5, offset=piece.offset,
            start=piece.start, length=written, cost_ns=piece.cost_ns,
        )
        with self._lock:
            self.meta.pieces[piece.num] = final
        self._piece_landed()
        return written

    def _piece_landed(self) -> None:
        """Amortized journal tick on the write path: the landing that
        crosses the count or age threshold persists the metadata
        inline (the data write it journals already closed/flushed, so
        the journal never leads the data). Writer-thread cost is one
        fsynced ~KB JSON per ``persist_every_pieces`` landings; the
        serve path never comes through here."""
        if self._persist_every <= 0 and self._persist_interval <= 0:
            return
        now = time.monotonic()
        with self._lock:
            self._dirty_pieces += 1
            due = (
                (0 < self._persist_every <= self._dirty_pieces)
                or (self._persist_interval > 0
                    and now - self._last_persist >= self._persist_interval)
            )
        if due:
            try:
                self.persist()
            except OSError as exc:
                if exc.errno == errno.ENOSPC:
                    # Same fail-fast contract as the data write: a full
                    # disk is terminal for the task, and retrying the
                    # piece (the generic transient path) just grinds.
                    raise DiskFullError(f"journal persist: {exc}") from exc
                # Any other journal-write failure must NOT fail a piece
                # whose data landed: a stale journal is exactly the
                # state the crash-recovery verify pass tolerates.
                logger.warning("journal persist failed (piece kept): %s",
                               exc)

    # -- native data-plane hooks ------------------------------------------
    # The C++ hot loops (dragonfly2_tpu_torch/native) stream bytes directly
    # between the data file and peer sockets; storage stays the owner of
    # dedup, digest validation and metadata, so the native path cannot
    # diverge from write_piece's semantics.

    def has_piece(self, num: int) -> bool:
        with self._lock:
            return num in self.meta.pieces

    def data_write_fd(self) -> int:
        """Raw O_WRONLY fd on the data file for native pwrite. Caller
        closes (os.close); position-independent, so concurrent piece
        writers don't conflict."""
        self.touch()
        return os.open(self.data_path, os.O_WRONLY)

    def record_piece(self, piece: PieceMetadata, written: int,
                     md5_hex: str, cost_ns: int = 0) -> int:
        """Record a piece whose bytes a native writer already placed at
        ``piece.offset``. Validates length and digest exactly like
        write_piece; an unrecorded slot is simply garbage bytes the next
        attempt overwrites."""
        if written != piece.length:
            raise StorageError(
                f"piece {piece.num}: wrote {written}, expected {piece.length}"
            )
        if piece.md5 and md5_hex and md5_hex != piece.md5:
            raise InvalidPieceDigestError(
                f"piece {piece.num}: md5 {md5_hex} != {piece.md5}"
            )
        final = PieceMetadata(
            num=piece.num, md5=piece.md5 or md5_hex, offset=piece.offset,
            start=piece.start, length=written, cost_ns=cost_ns,
        )
        with self._lock:
            self.meta.pieces[piece.num] = final
        self._piece_landed()
        return written

    def piece_span(self, rng: Range) -> Optional[Tuple[str, int, int]]:
        """``(data_path, file_offset, length)`` when ``rng`` is fully
        covered by verified pieces — the upload server's sendfile fast
        path. The data file is addressed by CONTENT offset (write_piece
        seeks ``piece.offset`` and every producer sets offset == start),
        so the file offset IS the content offset.

        Only exact in-extent ranges qualify: ``covers()`` answers True
        for any ``done`` store regardless of range end, and the upload
        server resolves open-ended ranges against a 2^62 sentinel — a
        span taken at face value would sendfile a 2^62 Content-Length.
        Out-of-extent ranges return None and the bytes path clamps
        them as before."""
        self.touch()
        extent = self.meta.content_length
        if extent < 0:
            with self._lock:
                extent = max((p.start + p.length
                              for p in self.meta.pieces.values()), default=0)
        if rng.start + rng.length > extent:
            return None
        if not self.covers(rng):
            return None
        return (self.data_path, rng.start, rng.length)

    def set_piece_digest(self, num: int, md5: str, cost_ns: int = 0) -> None:
        """Attach an after-the-fact digest to a stored piece (the
        back-to-source path learns the md5 from the wire while writing)."""
        with self._lock:
            existing = self.meta.pieces.get(num)
            if existing is None:
                raise StorageError(f"piece {num} not present")
            self.meta.pieces[num] = PieceMetadata(
                num=num, md5=md5, offset=existing.offset,
                start=existing.start, length=existing.length, cost_ns=cost_ns,
            )
        # The digest is what makes the journaled piece verifiable at
        # reload (write_piece stored it with md5="" on this path) — its
        # arrival is journal-worthy like the landing itself.
        self._piece_landed()

    def update(self, content_length: int | None = None,
               total_pieces: int | None = None,
               piece_md5_sign: str | None = None,
               header: Dict[str, str] | None = None,
               url: str | None = None) -> None:
        with self._lock:
            if content_length is not None:
                self.meta.content_length = content_length
            if total_pieces is not None:
                self.meta.total_pieces = total_pieces
            if piece_md5_sign is not None:
                self.meta.piece_md5_sign = piece_md5_sign
            if header is not None:
                self.meta.header = dict(header)
            if url is not None:
                self.meta.url = url

    def mark_done(self) -> None:
        """Validate completeness, compute the piece-md5 signature, persist.

        The signature is the sha256 over the ordered piece md5s — the same
        whole-task integrity construct as the reference's PieceMd5Sign
        (client/daemon/storage/local_storage.go digest of sorted piece md5s).
        """
        with self._lock:
            n = self.meta.total_pieces
            if n >= 0 and len(self.meta.pieces) < n:
                raise StorageError(
                    f"task {self.meta.task_id}: {len(self.meta.pieces)}/{n} pieces"
                )
            md5s = [self.meta.pieces[i].md5 for i in sorted(self.meta.pieces)]
            if all(md5s):
                self.meta.piece_md5_sign = digestutil.sha256_from_strings(*md5s)
            self.meta.done = True
        self.persist()
        cb = self.on_done
        if cb is not None:  # outside self._lock: the callback takes the
            cb(self)        # manager lock (lock order: manager > store)

    def persist(self) -> None:
        """Crash-atomic journal publish: unique-per-call tmp (two
        concurrent persists never interleave into one path), fsync the
        tmp BEFORE ``os.replace`` (a crash can publish old or new,
        never torn or empty), fsync the directory after (the rename
        itself survives the crash)."""
        tmp = os.path.join(
            self.directory, f".{METADATA_FILE}.{uuid.uuid4().hex}.tmp")
        with self._lock:
            if self._invalid:
                return  # deleted underneath us; nothing to persist
            raw = self.meta.to_json()
            # Claimed optimistically (concurrent landings keep counting
            # toward the NEXT window) but restored on failure — a
            # failed publish must not silently double the documented
            # at-most-one-cadence-window loss bound.
            claimed_dirty = self._dirty_pieces
            self._dirty_pieces = 0
            self._last_persist = time.monotonic()
        try:
            with open(tmp, "w") as f:
                f.write(raw)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.directory, METADATA_FILE))
            dir_fd = os.open(self.directory, os.O_RDONLY)
            try:
                os.fsync(dir_fd)
            finally:
                os.close(dir_fd)
        except FileNotFoundError:
            # Directory raced away (concurrent delete_task/GC): a store
            # that lost its directory is dead weight, not a crash.
            self.invalidate()
            self._unlink_quietly(tmp)
        except Exception:
            # Never leak a partial tmp next to a journal a crashy disk
            # already failed to update; the old journal stays current.
            # (Debris from a REAL mid-persist process death is swept by
            # _reload's stale-tmp pass instead.) The claimed dirty
            # count flows back so the NEXT landing re-arms the cadence
            # instead of waiting out a whole fresh window.
            with self._lock:
                self._dirty_pieces += claimed_dirty
            self._unlink_quietly(tmp)
            raise

    @staticmethod
    def _unlink_quietly(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    def verify_resident_pieces(self) -> Tuple[int, int]:
        """Re-hash every journaled piece against the data file —
        ``(verified, dropped)``. Mismatched, short, or md5-less pieces
        are dropped from the journal (their bytes are garbage the next
        fetch overwrites); a ``done`` store that loses a piece is
        demoted to partial (its piece_md5_sign no longer holds). The
        restart path runs this so a crash between a data write and its
        fsync — or real on-disk corruption — can never serve or skip a
        bad piece."""
        with self._lock:
            pieces = list(self.meta.pieces.values())
        dropped: List[int] = []
        try:
            f = open(self.data_path, "rb")
        except OSError:
            f = None
        try:
            for piece in pieces:
                ok = False
                if f is not None and piece.md5:
                    f.seek(piece.offset)
                    digest = hashlib.new(digestutil.ALGORITHM_MD5)
                    remaining = piece.length
                    while remaining > 0:
                        chunk = f.read(min(1 << 20, remaining))
                        if not chunk:
                            break
                        digest.update(chunk)
                        remaining -= len(chunk)
                    ok = remaining == 0 and digest.hexdigest() == piece.md5
                if not ok:
                    dropped.append(piece.num)
        finally:
            if f is not None:
                f.close()
        if dropped:
            with self._lock:
                for num in dropped:
                    self.meta.pieces.pop(num, None)
                if self.meta.done:
                    self.meta.done = False
                    self.meta.piece_md5_sign = ""
        return len(pieces) - len(dropped), len(dropped)

    # -- read path ---------------------------------------------------------

    def read_piece(self, num: int = -1, rng: Range | None = None) -> bytes:
        """Read one piece by number, or an arbitrary content range
        (num=-1 + rng), the upload server's access pattern
        (upload_manager.go:229-237 reads Num:-1 with an HTTP range)."""
        self.touch()
        if num >= 0:
            with self._lock:
                piece = self.meta.pieces.get(num)
            if piece is None:
                raise StorageError(f"piece {num} not present")
            rng = Range(piece.start, piece.length)
        if rng is None:
            raise StorageError("need piece num or range")
        with open(self.data_path, "rb") as f:
            # Clamp to the file extent: an open-ended HTTP range reaches
            # here resolved against a 2^62 sentinel, and f.read(2^62)
            # tries to allocate the buffer up front (MemoryError).
            size = os.fstat(f.fileno()).st_size
            f.seek(rng.start)
            return f.read(min(rng.length, max(size - rng.start, 0)))

    def iter_content(self, rng: Range | None = None,
                     chunk: int = 1 << 20) -> Iterable[bytes]:
        self.touch()
        if rng is None:
            # Unknown content length (never learned from source): fall back
            # to the verified extent — the end of the last stored piece.
            total = self.meta.content_length
            if total < 0:
                with self._lock:
                    total = max(
                        (p.start + p.length for p in self.meta.pieces.values()),
                        default=0,
                    )
            rng = Range(0, total)
        with open(self.data_path, "rb") as f:
            f.seek(rng.start)
            remaining = rng.length
            while remaining > 0:
                data = f.read(min(chunk, remaining))
                if not data:
                    return
                remaining -= len(data)
                yield data

    def covers(self, rng: Range) -> bool:
        """True when [start, end] is fully covered by verified pieces —
        guards range reads on incomplete stores from serving sparse-file
        zeros."""
        if self.meta.done:
            return True
        with self._lock:
            spans = sorted(
                (p.start, p.start + p.length) for p in self.meta.pieces.values()
            )
        pos = rng.start
        end = rng.start + rng.length
        for s, e in spans:
            if s > pos:
                return False
            pos = max(pos, e)
            if pos >= end:
                return True
        return pos >= end

    def pieces_in(self, nums: Iterable[int]) -> List[PieceMetadata]:
        with self._lock:
            return [self.meta.pieces[n] for n in nums if n in self.meta.pieces]

    def existing_piece_nums(self) -> List[int]:
        with self._lock:
            return sorted(self.meta.pieces)

    @property
    def done(self) -> bool:
        return self.meta.done

    def touch(self) -> None:
        self.last_access = time.monotonic()

    def invalidate(self) -> None:
        self._invalid = True

    @property
    def valid(self) -> bool:
        return not self._invalid

    def disk_usage(self) -> int:
        try:
            return os.path.getsize(self.data_path)
        except OSError:
            return 0


@dataclass
class StorageOptions:
    """(reference: client/config/peerhost.go StorageOption)"""

    root: str = ""
    task_expire_seconds: float = 6 * 60 * 60.0
    disk_gc_threshold_bytes: int = 0  # 0 = unlimited
    keep_storage: bool = True
    # Incremental-journal cadence on the write path: persist task
    # metadata after this many piece landings since the last persist
    # (0 disables) and/or when the journal is dirty and this many
    # seconds old. Both amortize the fsync so the loopback MB/s ladder
    # does not regress; a SIGKILL loses at most one cadence window of
    # progress, never the whole download.
    persist_every_pieces: int = 16
    persist_interval_s: float = 2.0
    # Re-hash every journaled piece at _reload (drop mismatches). The
    # cost is one sequential read of resident bytes at startup; turn
    # off only for stores whose medium is trusted end-to-end.
    reload_verify: bool = True


class StorageManager:
    """Registry of :class:`TaskStorage` keyed by (taskID, peerID), with
    completed-task reuse and TTL/usage GC
    (reference: client/daemon/storage/storage_manager.go:91-154)."""

    def __init__(self, opts: StorageOptions, recovery=None):
        if not opts.root:
            raise ValueError("storage root required")
        from dragonfly2_tpu_torch.client.recovery import RECOVERY

        self.opts = opts
        # Reload/resume observability ("recovery" debug block unless a
        # bench/test injects its own scope).
        self.recovery = recovery if recovery is not None else RECOVERY
        os.makedirs(opts.root, exist_ok=True)
        self._lock = threading.Lock()
        self._tasks: Dict[Tuple[str, str], TaskStorage] = {}
        # task_id → one done+valid replica: the upload/metadata hot path
        # (every request whose exact-peer lookup misses) resolves in
        # O(1) instead of scanning every registered task under the
        # manager lock. Maintained on mark_done (store callback) and
        # delete_task; lookups self-heal on staleness (GC'd replica →
        # one rescan refreshes or drops the entry).
        self._done_index: Dict[str, TaskStorage] = {}
        # task_id → reload-recovered stores not yet adopted: the
        # register_or_resume fast path (EVERY registration comes
        # through it) must not scan the whole task map under the
        # manager lock on a long-lived seed. Entries are pruned at
        # adoption; the set is small and fixed after _reload.
        self._recovered_by_task: Dict[str, List[TaskStorage]] = {}
        # Set by the owning daemon: called (task_id) once the LAST
        # local replica of a task is deleted (explicit delete or GC) so
        # announce-side state — the balanced client's re-routable seed
        # record, the restart re-announce backlog — is dropped with it;
        # a membership change must never re-announce a seed whose bytes
        # are gone.
        self.on_task_deleted = None
        if opts.keep_storage:
            self._reload()

    def _new_store(self, directory: str, meta: TaskMetadata) -> TaskStorage:
        store = TaskStorage(
            directory, meta,
            persist_every_pieces=self.opts.persist_every_pieces,
            persist_interval_s=self.opts.persist_interval_s,
        )
        store.on_done = self._note_done
        return store

    def _reload(self) -> None:
        """Recover persisted tasks after restart (KeepStorage semantics,
        client/config/peerhost.go:63). Partial stores are recovered too
        — their journaled pieces are re-verified against the data file
        (``reload_pieces_verified``/``reload_pieces_dropped``) so a
        resumed download only ever skips bytes that are provably good.
        Directories whose journal is missing or corrupt leak data files
        forever with nothing to GC them (no registration → no TTL); the
        sweep quarantines them through the tombstone path and counts
        ``reload_orphans_swept``."""
        # A clean shutdown leaves the sentinel (mark_clean_shutdown);
        # its presence means every journal was persisted by a live
        # stop() and nothing was written since — the full resident-byte
        # re-hash is for CRASH recovery. Consumed either way, so only
        # the next shutdown can re-earn the skip.
        clean = False
        sentinel = os.path.join(self.opts.root, CLEAN_SHUTDOWN_FILE)
        if os.path.exists(sentinel):
            clean = True
            TaskStorage._unlink_quietly(sentinel)
        orphans = 0
        verified = dropped = 0

        def sweep(path: str) -> None:
            nonlocal orphans
            orphans += 1
            tomb = self._tombstone(path)
            shutil.rmtree(tomb or path, ignore_errors=True)

        for task_id in sorted(os.listdir(self.opts.root)):
            task_dir = os.path.join(self.opts.root, task_id)
            if not os.path.isdir(task_dir):
                continue
            if task_id == ".trash":
                # Tombstones a previous process renamed but never got
                # to rmtree (crash mid-delete): finish the job.
                for leftover in os.listdir(task_dir):
                    shutil.rmtree(os.path.join(task_dir, leftover),
                                  ignore_errors=True)
                continue
            for peer_id in sorted(os.listdir(task_dir)):
                peer_dir = os.path.join(task_dir, peer_id)
                if not os.path.isdir(peer_dir):
                    continue
                meta_path = os.path.join(peer_dir, METADATA_FILE)
                try:
                    with open(meta_path) as f:
                        meta = TaskMetadata.from_json(f.read())
                except FileNotFoundError:
                    logger.warning("orphan task dir %s (no journal)",
                                   peer_dir)
                    sweep(peer_dir)
                    continue
                except (ValueError, TypeError, KeyError) as exc:
                    logger.warning(
                        "orphan task dir %s (corrupt journal): %s",
                        peer_dir, exc)
                    sweep(peer_dir)
                    continue
                except OSError as exc:
                    # Transient I/O (EIO/EACCES/EMFILE) is NOT proof of
                    # orphanhood — deleting a valid replica over a read
                    # blip would be the opposite of durability. Skip;
                    # the next reload retries.
                    logger.warning("skip unreadable journal %s: %s",
                                   meta_path, exc)
                    continue
                self._sweep_stale_tmp(peer_dir)
                store = self._new_store(peer_dir, meta)
                if self.opts.reload_verify and not clean:
                    ok, bad = store.verify_resident_pieces()
                    verified += ok
                    dropped += bad
                    if bad:
                        logger.warning(
                            "task %s peer %s: dropped %d unverifiable "
                            "piece(s) at reload", task_id[:16], peer_id, bad)
                        store.persist()  # re-journal the verified truth
                store.recovered = True
                # Key by the JOURNALED peer id, not the directory name:
                # a crash between a failed adoption rename and the
                # re-keyed journal's persist leaves them diverged, and
                # the journal is the truth every other lookup uses.
                self._tasks[(task_id, meta.peer_id)] = store
                self._recovered_by_task.setdefault(task_id, []).append(store)
                if store.done:
                    self._done_index[task_id] = store
            try:  # a task dir whose every peer was swept is itself junk
                os.rmdir(task_dir)
            except OSError:
                pass
        if orphans:
            self.recovery.tick("reload_orphans_swept", orphans)
        if verified:
            self.recovery.tick("reload_pieces_verified", verified)
        if dropped:
            self.recovery.tick("reload_pieces_dropped", dropped)

    def mark_clean_shutdown(self) -> None:
        """Leave the clean-shutdown sentinel: every journal was just
        persisted (persist_all) and this process is stopping. The next
        reload then skips the full resident-byte re-hash — a graceful
        rolling restart of a seed holding many GB stays O(metadata) —
        while any crash (no sentinel) still pays the verify pass."""
        try:
            with open(os.path.join(self.opts.root, CLEAN_SHUTDOWN_FILE),
                      "w") as f:
                f.write(str(time.time()))
        except OSError:
            pass  # worst case: the next start verifies, as after a crash

    @staticmethod
    def _sweep_stale_tmp(peer_dir: str) -> None:
        """Unique-per-call persist tmps survive a crash between write
        and replace; they are garbage once a reload is looking."""
        try:
            names = os.listdir(peer_dir)
        except OSError:
            return
        for name in names:
            if name.startswith(f".{METADATA_FILE}.") and name.endswith(".tmp"):
                TaskStorage._unlink_quietly(os.path.join(peer_dir, name))

    def register_task(self, task_id: str, peer_id: str) -> TaskStorage:
        with self._lock:
            key = (task_id, peer_id)
            if key not in self._tasks:
                directory = os.path.join(self.opts.root, task_id, peer_id)
                self._tasks[key] = self._new_store(
                    directory, TaskMetadata(task_id=task_id, peer_id=peer_id)
                )
            return self._tasks[key]

    def register_or_resume(
        self, task_id: str, peer_id: str,
    ) -> Tuple[TaskStorage, List[PieceMetadata]]:
        """Registration that ADOPTS a crash-recovered partial store for
        the task when one exists: the store is re-keyed to the new peer
        id (a restarted daemon registers with a fresh one) and its
        verified pieces are returned so the conductor can seed its
        downloaded-set and fetch only the missing tail. Only stores
        marked ``recovered`` by ``_reload`` are adoptable — a live
        writer's store in this same process never is — and adoption
        clears the mark, so exactly one conductor resumes each
        recovered store. Falls back to plain registration."""
        with self._lock:
            key = (task_id, peer_id)
            existing = self._tasks.get(key)
            if existing is not None:
                return existing, []
            best: Optional[TaskStorage] = None
            pool = self._recovered_by_task.get(task_id, ())
            for candidate in pool:
                if (candidate.recovered and candidate.valid
                        and not candidate.done
                        and (best is None
                             or len(candidate.meta.pieces)
                             > len(best.meta.pieces))):
                    best = candidate
            if best is None:
                self._recovered_by_task.pop(task_id, None)  # all spent
                directory = os.path.join(self.opts.root, task_id, peer_id)
                store = self._new_store(
                    directory, TaskMetadata(task_id=task_id, peer_id=peer_id))
                self._tasks[key] = store
                return store, []
            best.recovered = False
            self._recovered_by_task[task_id] = [
                s for s in pool if s is not best]
            self._tasks.pop((task_id, best.meta.peer_id), None)
            old_dir = best.directory
            new_dir = os.path.join(self.opts.root, task_id, peer_id)
            try:
                os.rename(old_dir, new_dir)
                best.directory = new_dir
                best.data_path = os.path.join(new_dir, DATA_FILE)
            except OSError:
                pass  # layout keeps the old dir name; ids live in the meta
            best.meta.peer_id = peer_id
            self._tasks[key] = best
            resumed = [best.meta.pieces[n]
                       for n in sorted(best.meta.pieces)]
        best.persist()  # journal the adoption (new peer id) durably
        return best, resumed

    def done_tasks(self) -> List[TaskStorage]:
        """Every valid completed replica — the restart re-announce
        inventory (one per task: the done index is authoritative)."""
        with self._lock:
            return [s for s in self._done_index.values()
                    if s.done and s.valid]

    def _note_done(self, store: TaskStorage) -> None:
        """mark_done hook: index the fresh done replica (unless it was
        deleted between finishing and the callback firing)."""
        with self._lock:
            if store.valid and store.done:
                self._done_index[store.meta.task_id] = store

    def get(self, task_id: str, peer_id: str) -> Optional[TaskStorage]:
        with self._lock:
            return self._tasks.get((task_id, peer_id))

    def find_completed_task(self, task_id: str) -> Optional[TaskStorage]:
        """Any valid, done storage for this task — the reuse fast path
        (storage_manager.go:101-106). O(1) through the done-replica
        index on the hot path (every upload/metadata request whose
        exact-peer lookup misses lands here); a stale entry (replica
        GC'd/invalidated since) falls back to one scan that refreshes or
        drops it."""
        with self._lock:
            store = self._done_index.get(task_id)
            if store is not None and store.done and store.valid:
                return store
            for (tid, _), candidate in self._tasks.items():
                if tid == task_id and candidate.done and candidate.valid:
                    self._done_index[task_id] = candidate
                    return candidate
            self._done_index.pop(task_id, None)
        return None

    def read_piece_any(self, task_id: str, peer_id: str,
                       num: int = -1, rng: Range | None = None) -> bytes:
        """Serve a read preferring the exact peer, falling back to any
        completed replica of the task (the upload server's lookup)."""
        store = self.get(task_id, peer_id)
        if (
            store is None
            or (num >= 0 and num not in store.meta.pieces)
            or (num < 0 and rng is not None and not store.covers(rng))
        ):
            fallback = self.find_completed_task(task_id)
            if fallback is not None:
                store = fallback
        if store is None:
            raise StorageError(f"task {task_id} not in storage")
        if num < 0 and rng is not None and not store.covers(rng):
            raise StorageError(
                f"task {task_id}: range {rng.start}+{rng.length} not stored"
            )
        return store.read_piece(num=num, rng=rng)

    def piece_span_any(self, task_id: str, peer_id: str,
                       rng: Range) -> Optional[Tuple[str, int, int]]:
        """sendfile span with read_piece_any's lookup order (exact peer,
        else any completed replica); None = caller takes the bytes path."""
        store = self.get(task_id, peer_id)
        if store is None or not store.covers(rng):
            store = self.find_completed_task(task_id)
        if store is None:
            return None
        return store.piece_span(rng)

    # A not-yet-done registration touched within this window is a live
    # writer; rmtree under it turns its next piece write into ENOENT and
    # fails the download (observed under churn). Abandoned (failed) tasks
    # stop touching and become reclaimable once the grace passes.
    ACTIVE_WRITER_GRACE_SECONDS = 60.0

    def delete_task(self, task_id: str, peer_id: str | None = None) -> int:
        """Remove task storage (all peers when peer_id is None), skipping
        registrations that look actively written (not ``done`` and touched
        within ACTIVE_WRITER_GRACE_SECONDS) — callers retry later; GC
        sweeps them once they idle out."""
        removed = 0
        now = time.monotonic()
        tombstones = []
        task_dir = os.path.join(self.opts.root, task_id)
        with self._lock:
            keys = [
                k for k in self._tasks
                if k[0] == task_id and (peer_id is None or k[1] == peer_id)
                and (self._tasks[k].meta.done
                     or now - self._tasks[k].last_access
                     >= self.ACTIVE_WRITER_GRACE_SECONDS)
            ]
            for k in keys:
                store = self._tasks.pop(k)
                store.invalidate()
                if self._done_index.get(task_id) is store:
                    self._done_index.pop(task_id)
                tombstones.append(self._tombstone(store.directory))
                removed += 1
            # Task-dir decision under the SAME lock as the registration
            # map (a check-then-delete outside it would raze a directory
            # a concurrent register_task just created) — but the actual
            # rmtree happens outside via tombstone rename, so a multi-GB
            # delete never stalls every other registration/lookup.
            live = any(k[0] == task_id for k in self._tasks)
            if peer_id is None and not live:
                tombstones.append(self._tombstone(task_dir))
            else:
                try:  # reap the parent dir once its last peer is gone
                    os.rmdir(task_dir)
                except OSError:
                    pass
        for tomb in tombstones:
            if tomb:
                shutil.rmtree(tomb, ignore_errors=True)
        if removed and not live and self.on_task_deleted is not None:
            try:
                self.on_task_deleted(task_id)
            except Exception:  # noqa: BLE001 — observer only
                logger.debug("on_task_deleted hook failed for %s",
                             task_id, exc_info=True)
        return removed

    def _tombstone(self, directory: str) -> str:
        """Atomically rename a dir out of the namespace (cheap, under the
        caller's lock); returns the tombstone path to rmtree lock-free.
        Tombstones live in ``<root>/.trash`` — NOT beside the original —
        so a per-peer delete leaves its parent task dir empty and the
        os.rmdir reap actually succeeds."""
        trash = os.path.join(self.opts.root, ".trash")
        os.makedirs(trash, exist_ok=True)
        tomb = os.path.join(trash, uuid.uuid4().hex)
        try:
            os.rename(directory, tomb)
        except OSError:
            return ""
        return tomb

    def total_usage(self) -> int:
        with self._lock:
            return sum(s.disk_usage() for s in self._tasks.values())

    def try_gc(self) -> int:
        """Reclaim expired tasks, then oldest-first until under the disk
        threshold. Returns tasks removed. (storage_manager.go TryGC)"""
        now = time.monotonic()
        removed = 0
        with self._lock:
            items = sorted(self._tasks.items(), key=lambda kv: kv[1].last_access)
        for key, store in items:
            if now - store.last_access >= self.opts.task_expire_seconds:
                removed += self.delete_task(*key)
        if self.opts.disk_gc_threshold_bytes > 0:
            with self._lock:
                items = sorted(
                    self._tasks.items(), key=lambda kv: kv[1].last_access
                )
            for key, _ in items:
                if self.total_usage() <= self.opts.disk_gc_threshold_bytes:
                    break
                # Count what delete_task actually reclaimed (it skips
                # active writers under the grace window).
                removed += self.delete_task(*key)
        return removed

    def persist_all(self) -> None:
        with self._lock:
            stores = list(self._tasks.values())
        for s in stores:
            s.persist()

    def task_count(self) -> int:
        with self._lock:
            return len(self._tasks)
