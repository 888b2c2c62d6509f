"""Piece layout math shared by storage, download and upload paths.

Reference counterpart: internal/util/util.go:22-50 (ComputePieceSize grows
the piece from 4 MiB by 1 MiB per 100 MiB of content past 200 MiB, capped at
15 MiB; ComputePieceCount is a ceiling divide). Identical constants and
growth rule so piece boundaries — and therefore piece digests and training
labels derived from piece costs — line up with the reference's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

DEFAULT_PIECE_SIZE = 4 * 1024 * 1024
PIECE_SIZE_LIMIT = 15 * 1024 * 1024


def compute_piece_size(content_length: int) -> int:
    """Piece size for a task of ``content_length`` bytes (<0 = unknown)."""
    if content_length <= 200 * 1024 * 1024:
        return DEFAULT_PIECE_SIZE
    gap_count = content_length // (100 * 1024 * 1024)
    size = (gap_count - 2) * 1024 * 1024 + DEFAULT_PIECE_SIZE
    return min(size, PIECE_SIZE_LIMIT)


def compute_piece_count(content_length: int, piece_size: int) -> int:
    return int(math.ceil(content_length / piece_size))


@dataclass(frozen=True)
class Range:
    """A byte range [start, start+length) within a task's content."""

    start: int
    length: int

    @property
    def end(self) -> int:
        """Inclusive end offset (HTTP Range convention)."""
        return self.start + self.length - 1

    def http_header(self) -> str:
        return f"bytes={self.start}-{self.end}"


def parse_url_range(spec: str) -> Range:
    """Parse dfget's ``--range a-b`` spec (inclusive byte positions, the
    reference's `Download range. Like: 0-9` — cmd/dfget/cmd/root.go:195).
    Distinct from HTTP header parsing: both ends are required and total
    size is unknown at parse time."""
    a, sep, b = spec.partition("-")
    if not sep or not a.strip().isdigit() or not b.strip().isdigit():
        raise ValueError(f"range must be 'start-end' digits: {spec!r}")
    start, end = int(a), int(b)
    if end < start:
        raise ValueError(f"range end before start: {spec!r}")
    return Range(start=start, length=end - start + 1)


class RangeNotSatisfiable(ValueError):
    """Syntactically valid single range that no byte of the representation
    satisfies — the only case HTTP answers with 416. Malformed or
    unsupported specs raise plain ValueError and servers ignore the header
    (RFC 9110 §14.1.1: an invalid Range field is ignored)."""


def parse_http_range(header: str, total: int) -> Range:
    """Parse a single-range ``bytes=a-b`` header against ``total`` bytes.

    Mirrors the subset the reference accepts on the upload path
    (client/daemon/upload/upload_manager.go:214-227: exactly one range).
    Suffix ranges (``bytes=-n``) and open ends (``bytes=a-``) are resolved
    against ``total``. Raises RangeNotSatisfiable for valid-but-empty
    ranges (zero suffix, start beyond EOF) and plain ValueError for
    anything malformed or unsupported (multi-range, non-bytes units,
    non-digit positions, end before start).
    """
    if not header.startswith("bytes="):
        raise ValueError(f"unsupported range unit in {header!r}")
    spec = header[len("bytes="):]
    if "," in spec:
        raise ValueError("multi-range not supported")
    start_s, sep, end_s = spec.partition("-")
    if not sep:
        raise ValueError(f"malformed range {header!r}")
    if not start_s:  # suffix: last n bytes
        if not end_s.isdigit():  # catches 'bytes=--5', 'bytes=-', 'bytes=-x'
            raise ValueError(f"malformed range {header!r}")
        n = int(end_s)
        if n <= 0 or total <= 0:
            # Zero suffix, or any suffix of an empty representation: no
            # byte satisfies it (RFC 9110 §14.1.2).
            raise RangeNotSatisfiable(
                f"suffix {header!r} unsatisfiable for length {total}")
        start = max(0, total - n)
        return Range(start, total - start)
    if not start_s.isdigit() or (end_s and not end_s.isdigit()):
        raise ValueError(f"malformed range {header!r}")
    start = int(start_s)
    end = int(end_s) if end_s else total - 1
    if end >= total:
        end = total - 1
    if end_s and int(end_s) < start:
        # end before start is a malformed spec, not an unsatisfiable one
        # (RFC 9110 §14.1.1) — callers ignore the header.
        raise ValueError(f"malformed range {header!r}")
    if start >= total:
        raise RangeNotSatisfiable(
            f"range {header!r} unsatisfiable for length {total}")
    return Range(start, end - start + 1)


@dataclass(frozen=True)
class PieceMetadata:
    """One stored piece (reference: client/daemon/storage/metadata.go:47-56)."""

    num: int
    md5: str = ""
    offset: int = 0  # offset in the data file
    start: int = 0   # offset in the task content (== offset for full tasks)
    length: int = 0
    cost_ns: int = 0

    @property
    def range(self) -> Range:
        return Range(self.start, self.length)


def piece_range(num: int, piece_size: int, content_length: int) -> Range:
    """The content range of piece ``num`` in a fully-known-length task."""
    start = num * piece_size
    length = min(piece_size, content_length - start)
    if length <= 0:
        raise ValueError(
            f"piece {num} out of range for length {content_length}"
        )
    return Range(start, length)
