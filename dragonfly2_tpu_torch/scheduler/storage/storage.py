"""Rotating training-dataset sink.

Reference counterpart: scheduler/storage/storage.go:59-475. Buffered appends
of Download / NetworkTopology records into size-rotated files with bounded
backups, plus open/list/clear used by the announcer to stream datasets to
the trainer.

Differences from the reference (deliberate):
- Files are our headered CSV (readable by read_csv_records); the
  reference's headerless format is still readable on the ingest side.
- The JAX package's ``export_parquet`` is not part of this copy: it needs
  pyarrow, which the port does not import.
"""

from __future__ import annotations

import glob
import os
import threading
import time
from dataclasses import dataclass
from typing import Iterator, List, Sequence, Type

from dragonfly2_tpu_torch.schema import Download, NetworkTopology, ReplayDecision
from dragonfly2_tpu_torch.schema.io import (
    CsvRecordWriter,
    read_csv_records,
)

DOWNLOAD_FILE_PREFIX = "download"
NETWORK_TOPOLOGY_FILE_PREFIX = "networktopology"
REPLAY_FILE_PREFIX = "replay"
CSV_EXT = ".csv"


@dataclass
class StorageConfig:
    max_size: int = 100 * (1 << 20)  # bytes before rotation
    max_backups: int = 10
    buffer_size: int = 100  # records buffered before flush


class _RotatingDataset:
    """One record type's rotating file set."""

    def __init__(self, base_dir: str, prefix: str, record_type: Type,
                 config: StorageConfig):
        self.base_dir = base_dir
        self.prefix = prefix
        self.record_type = record_type
        self.config = config
        self._buffer: List = []
        self._count = 0
        # _lock guards ONLY the in-memory buffer and counters — it is the
        # lock the announce path touches, and it is never held across
        # file IO. _io_lock serializes every file operation (flush write,
        # rotation, removal); a flush swaps the buffer out under _lock and
        # writes under _io_lock, so concurrent create() calls block for a
        # list-append, not a disk write.
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        # Records swapped out of the buffer but not yet written — keeps
        # count() exact while a flush is in flight.
        self._inflight = 0
        # Records flushed per live file; keeps count() consistent when
        # snapshots/backup-eviction remove individual files.
        self._file_counts: dict = {}
        # Monotonic suffix makes backup names unique even when two
        # rotations land in the same wall-clock second.
        self._rotation_seq = len(self.backups())

    @property
    def active_path(self) -> str:
        return os.path.join(self.base_dir, f"{self.prefix}{CSV_EXT}")

    def backups(self) -> List[str]:
        pattern = os.path.join(self.base_dir, f"{self.prefix}-*{CSV_EXT}")
        return sorted(glob.glob(pattern))

    def all_files(self) -> List[str]:
        files = self.backups()
        if os.path.exists(self.active_path):
            files.append(self.active_path)
        return files

    def create(self, record) -> None:
        """Buffered append. When the buffer fills, the CSV flush happens
        OUTSIDE the record lock (buffer swapped under lock, written
        after) — a full buffer on the announce path costs the announcing
        thread one serialized write, and every other creator only a
        list append."""
        with self._lock:
            self._buffer.append(record)
            flush_needed = len(self._buffer) >= self.config.buffer_size
        if flush_needed:
            self.flush()

    def create_batch(self, records) -> None:
        """Buffered append of MANY records under ONE lock acquisition —
        the replay recorder's per-drain sink (one IO call per capture
        wakeup, not per event). Same flush discipline as create()."""
        records = list(records)
        if not records:
            return
        with self._lock:
            self._buffer.extend(records)
            flush_needed = len(self._buffer) >= self.config.buffer_size
        if flush_needed:
            self.flush()

    def flush(self) -> None:
        with self._io_lock:
            self._flush_io_locked()

    def _flush_io_locked(self) -> None:
        """Swap the buffer out under _lock, write it under _io_lock only.
        Caller must hold _io_lock."""
        with self._lock:
            batch, self._buffer = self._buffer, []
            self._inflight += len(batch)
        if not batch:
            return
        try:
            self._maybe_rotate()
            with CsvRecordWriter(self.record_type, self.active_path) as w:
                for r in batch:
                    w.write(r)
        except BaseException:
            # Put the batch back (order preserved) so a transient IO
            # failure retries on the next flush instead of losing data.
            with self._lock:
                self._inflight -= len(batch)
                self._buffer[:0] = batch
            raise
        with self._lock:
            self._inflight -= len(batch)
            self._count += len(batch)
            self._file_counts[self.active_path] = (
                self._file_counts.get(self.active_path, 0) + len(batch)
            )

    def _maybe_rotate(self) -> None:
        path = self.active_path
        if os.path.exists(path) and os.path.getsize(path) >= self.config.max_size:
            self._rotate_locked(path)
        backups = self.backups()
        while len(backups) + 1 > self.config.max_backups:
            victim = backups.pop(0)
            os.remove(victim)
            with self._lock:
                self._count = max(
                    self._count - self._file_counts.pop(victim, 0), 0)

    def _rotate_locked(self, path: str) -> None:
        stamp = time.strftime("%Y-%m-%dT%H-%M-%S")
        self._rotation_seq += 1
        backup = os.path.join(
            self.base_dir, f"{self.prefix}-{stamp}.{self._rotation_seq:06d}{CSV_EXT}"
        )
        os.rename(path, backup)
        self._file_counts[backup] = self._file_counts.pop(path, 0)

    def count(self) -> int:
        with self._lock:
            return self._count + len(self._buffer) + self._inflight

    def records(self) -> Iterator:
        self.flush()
        for path in self.all_files():
            yield from read_csv_records(self.record_type, path)

    def take_snapshot(self) -> List[str]:
        """Freeze current data for upload: flush, force-rotate the active
        file, return every closed file. Records created after this call go
        to a fresh active file and are NOT part of the snapshot — so the
        announcer can stream for minutes while appends continue, then
        delete exactly what it sent (remove_files)."""
        with self._io_lock:
            self._flush_io_locked()
            path = self.active_path
            if os.path.exists(path) and os.path.getsize(path) > 0:
                self._rotate_locked(path)
            return self.backups()

    def remove_files(self, paths: List[str]) -> None:
        removed = 0
        with self._io_lock:
            for path in paths:
                if path == self.active_path:
                    raise ValueError("cannot remove the active file; snapshot first")
                try:
                    os.remove(path)
                    removed += self._file_counts.pop(path, 0)
                except FileNotFoundError:
                    pass
            with self._lock:
                self._count = max(self._count - removed, 0)

    def clear(self) -> None:
        with self._io_lock:
            with self._lock:
                self._buffer = []
                self._count = 0
            self._file_counts.clear()
            for path in self.all_files():
                os.remove(path)


class Storage:
    """The scheduler's dataset sink: one rotating set per record type."""

    def __init__(self, base_dir: str, config: StorageConfig | None = None):
        os.makedirs(base_dir, exist_ok=True)
        config = config or StorageConfig()
        self.download = _RotatingDataset(
            base_dir, DOWNLOAD_FILE_PREFIX, Download, config
        )
        self.network_topology = _RotatingDataset(
            base_dir, NETWORK_TOPOLOGY_FILE_PREFIX, NetworkTopology, config
        )
        # Replay-plane decision corpus (docs/REPLAY.md): same rotation /
        # snapshot / removal machinery as the training datasets — a
        # decision recorded just before a rotation replays identically
        # from the rotated backup (regression-tested).
        self.replay = _RotatingDataset(
            base_dir, REPLAY_FILE_PREFIX, ReplayDecision, config
        )

    # Interface names mirror storage.go:59-89.
    def create_download(self, record: Download) -> None:
        self.download.create(record)

    def create_network_topology(self, record: NetworkTopology) -> None:
        self.network_topology.create(record)

    def create_replay(self, record: ReplayDecision) -> None:
        self.replay.create(record)

    def create_replay_batch(self, records: Sequence[ReplayDecision]) -> None:
        self.replay.create_batch(records)

    def list_download(self) -> List[Download]:
        return list(self.download.records())

    def list_network_topology(self) -> List[NetworkTopology]:
        return list(self.network_topology.records())

    def list_replay(self) -> List[ReplayDecision]:
        return list(self.replay.records())

    def download_count(self) -> int:
        return self.download.count()

    def network_topology_count(self) -> int:
        return self.network_topology.count()

    def replay_count(self) -> int:
        return self.replay.count()

    def open_download(self) -> List[str]:
        """Paths of all download dataset files, oldest first (announcer
        streams them to the trainer)."""
        self.download.flush()
        return self.download.all_files()

    def open_network_topology(self) -> List[str]:
        self.network_topology.flush()
        return self.network_topology.all_files()

    def snapshot_download(self) -> List[str]:
        """Freeze+list download files for upload (see take_snapshot)."""
        return self.download.take_snapshot()

    def snapshot_network_topology(self) -> List[str]:
        return self.network_topology.take_snapshot()

    def snapshot_replay(self) -> List[str]:
        return self.replay.take_snapshot()

    def open_replay(self) -> List[str]:
        self.replay.flush()
        return self.replay.all_files()

    def remove_download_files(self, paths: List[str]) -> None:
        self.download.remove_files(paths)

    def remove_network_topology_files(self, paths: List[str]) -> None:
        self.network_topology.remove_files(paths)

    def clear_download(self) -> None:
        self.download.clear()

    def clear_network_topology(self) -> None:
        self.network_topology.clear()

    def remove_replay_files(self, paths: List[str]) -> None:
        self.replay.remove_files(paths)

    def clear_replay(self) -> None:
        self.replay.clear()
