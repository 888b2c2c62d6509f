"""Per-source-host dataset files for the trainer — port copy of
``dragonfly2_tpu/trainer/storage.py``.

Mirrors trainer/storage/storage.go (open/read/clear keyed by host ID), with
one twist: the announcer streams each rotated CSV file separately (each has
its own header), so datasets are kept as numbered segment files per host
rather than one concatenated blob — ``download-<hostID>.0000.csv`` etc.

Concurrency contract: segment numbering is a monotonic per-(prefix, host)
counter (never derived from directory listings), so deleting trained
segments can never collide numbering with an in-flight ingest stream; and
``snapshot`` excludes segments that still have open write handles, so a
training job only ever reads and deletes closed files.
"""

from __future__ import annotations

import glob
import os
import re
import threading
from typing import Iterator, List, Tuple, Type

from dragonfly2_tpu_torch.schema import Download, NetworkTopology, ReplayDecision
from dragonfly2_tpu_torch.schema.io import read_csv_records

DOWNLOAD_PREFIX = "download"
NETWORK_TOPOLOGY_PREFIX = "networktopology"
REPLAY_PREFIX = "replay"
_PREFIXES = (DOWNLOAD_PREFIX, NETWORK_TOPOLOGY_PREFIX, REPLAY_PREFIX)
_SAFE_HOST = re.compile(r"[^A-Za-z0-9._-]")
_SEG_RE = re.compile(r"\.(\d+)\.csv$")


def _safe(host_id: str) -> str:
    return _SAFE_HOST.sub("_", host_id)


class TrainerStorage:
    def __init__(self, base_dir: str) -> None:
        self.base_dir = base_dir
        os.makedirs(base_dir, exist_ok=True)
        self._lock = threading.Lock()
        # (prefix, host_id) -> open segment (file handle, path)
        self._open_files: dict = {}
        # (prefix, host_id) -> next segment number (monotonic)
        self._seq: dict = {}

    # -- ingest ---------------------------------------------------------------

    def append(self, prefix: str, host_id: str, data: bytes, new_file: bool) -> str:
        """Append a chunk; ``new_file`` starts the next numbered segment.

        Returns the segment path written to (the service tracks these to
        roll back a failed stream).
        """
        key = (prefix, host_id)
        with self._lock:
            entry = self._open_files.get(key)
            if entry is None or new_file:
                if entry is not None:
                    entry[0].close()
                seq = self._next_seq_locked(prefix, host_id)
                path = os.path.join(
                    self.base_dir, f"{prefix}-{_safe(host_id)}.{seq:06d}.csv"
                )
                entry = (open(path, "ab"), path)
                self._open_files[key] = entry
            entry[0].write(data)
            return entry[1]

    def _next_seq_locked(self, prefix: str, host_id: str) -> int:
        key = (prefix, host_id)
        if key not in self._seq:
            existing = [
                int(m.group(1))
                for p in self._segments(prefix, host_id)
                if (m := _SEG_RE.search(p))
            ]
            self._seq[key] = max(existing, default=-1) + 1
        seq = self._seq[key]
        self._seq[key] = seq + 1
        return seq

    def close_host(self, host_id: str) -> None:
        """Flush+close open segments for a host (end of a Train stream)."""
        with self._lock:
            for key in [k for k in self._open_files if k[1] == host_id]:
                self._open_files.pop(key)[0].close()

    def discard_files(self, paths: List[str]) -> None:
        """Roll back segments written by a failed ingest stream (or delete
        a training snapshot after the models ship)."""
        with self._lock:
            open_paths = {entry[1] for entry in self._open_files.values()}
        for path in paths:
            if path in open_paths:
                continue
            try:
                os.remove(path)
            except FileNotFoundError:
                pass

    # -- read -----------------------------------------------------------------

    def _segments(self, prefix: str, host_id: str) -> List[str]:
        return sorted(
            glob.glob(
                os.path.join(self.base_dir, f"{prefix}-{_safe(host_id)}.*.csv")
            )
        )

    def _closed_segments(self, prefix: str, host_id: str) -> List[str]:
        with self._lock:
            open_paths = {entry[1] for entry in self._open_files.values()}
        return [p for p in self._segments(prefix, host_id) if p not in open_paths]

    def download_files(self, host_id: str) -> List[str]:
        return self._segments(DOWNLOAD_PREFIX, host_id)

    def network_topology_files(self, host_id: str) -> List[str]:
        return self._segments(NETWORK_TOPOLOGY_PREFIX, host_id)

    def replay_files(self, host_id: str) -> List[str]:
        return self._segments(REPLAY_PREFIX, host_id)

    def snapshot(self, host_id: str) -> Tuple[List[str], List[str], List[str]]:
        """(download, topology, replay) files that are safe to train
        from: closed segments only — a concurrent ingest stream's open
        segment is left alone and picked up by the next training round."""
        return (
            self._closed_segments(DOWNLOAD_PREFIX, host_id),
            self._closed_segments(NETWORK_TOPOLOGY_PREFIX, host_id),
            self._closed_segments(REPLAY_PREFIX, host_id),
        )

    def has_closed_segments(self, host_id: str) -> bool:
        """Any trainable data for a host? (The interval cycle driver's
        skip predicate — docs/REPLAY.md continuous-learning loop.)"""
        return any(any(files) for files in self.snapshot(host_id))

    def _records(self, record_type: Type, paths: List[str]) -> Iterator:
        for path in paths:
            yield from read_csv_records(record_type, path)

    def list_download(self, host_id: str, paths: List[str] | None = None) -> List[Download]:
        paths = self.download_files(host_id) if paths is None else paths
        return list(self._records(Download, paths))

    def list_network_topology(
        self, host_id: str, paths: List[str] | None = None
    ) -> List[NetworkTopology]:
        paths = self.network_topology_files(host_id) if paths is None else paths
        return list(self._records(NetworkTopology, paths))

    def list_replay(
        self, host_id: str, paths: List[str] | None = None
    ) -> List[ReplayDecision]:
        paths = self.replay_files(host_id) if paths is None else paths
        return list(self._records(ReplayDecision, paths))

    # -- lifecycle ------------------------------------------------------------

    def clear_host(self, host_id: str) -> None:
        self.close_host(host_id)
        for prefix in _PREFIXES:
            for path in self._segments(prefix, host_id):
                os.remove(path)

    def clear(self) -> None:
        """trainer.go:146-187 clears all datasets on stop."""
        with self._lock:
            for entry in self._open_files.values():
                entry[0].close()
            self._open_files.clear()
        for path in glob.glob(os.path.join(self.base_dir, "*.csv")):
            os.remove(path)
