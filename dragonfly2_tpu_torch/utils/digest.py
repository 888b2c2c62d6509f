"""Digest utilities.

Reference counterpart: pkg/digest/digest.go:1-177 and digest_reader.go:1-122.
Digests are used (1) to derive deterministic task/host/model IDs and (2) to
verify piece payloads during P2P transfer.

Digest string format matches the reference: ``<algorithm>:<hex>`` (e.g.
``sha256:9f86d0...``), parsed/validated by :func:`parse`.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import BinaryIO, Iterator

ALGORITHM_MD5 = "md5"
ALGORITHM_SHA1 = "sha1"
ALGORITHM_SHA256 = "sha256"
ALGORITHM_SHA512 = "sha512"

_SUPPORTED = {ALGORITHM_MD5, ALGORITHM_SHA1, ALGORITHM_SHA256, ALGORITHM_SHA512}

_HEX_LEN = {
    ALGORITHM_MD5: 32,
    ALGORITHM_SHA1: 40,
    ALGORITHM_SHA256: 64,
    ALGORITHM_SHA512: 128,
}


class InvalidDigestError(ValueError):
    """Raised for malformed digest strings."""


@dataclass(frozen=True)
class Digest:
    """A parsed ``<algorithm>:<hex>`` digest."""

    algorithm: str
    encoded: str

    def __str__(self) -> str:
        return f"{self.algorithm}:{self.encoded}"


def parse(value: str) -> Digest:
    """Parse and validate a digest string (reference: pkg/digest/digest.go Parse)."""
    algorithm, sep, encoded = value.partition(":")
    if not sep:
        raise InvalidDigestError(f"digest {value!r} missing ':' separator")
    if algorithm not in _SUPPORTED:
        raise InvalidDigestError(f"unsupported digest algorithm {algorithm!r}")
    encoded = encoded.lower()
    if len(encoded) != _HEX_LEN[algorithm] or any(
        c not in "0123456789abcdef" for c in encoded
    ):
        raise InvalidDigestError(f"invalid {algorithm} hex in digest {value!r}")
    return Digest(algorithm, encoded)


def sha256_from_strings(*values: str) -> str:
    """SHA-256 over concatenated UTF-8 strings.

    Identical semantics to the reference's ``digest.SHA256FromStrings``
    (pkg/digest/digest.go), which feeds each string into one hash state —
    this is the primitive beneath task/host/model ID generation.
    """
    h = hashlib.sha256()
    for v in values:
        h.update(v.encode("utf-8"))
    return h.hexdigest()


def hash_file(path: str, algorithm: str = ALGORITHM_SHA256, chunk_size: int = 4 << 20) -> str:
    """Hash a file's contents, streaming in chunks."""
    h = hashlib.new(algorithm)
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_size)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def hash_bytes(data: bytes, algorithm: str = ALGORITHM_SHA256) -> str:
    return hashlib.new(algorithm, data).hexdigest()


class DigestReader:
    """Wraps a binary stream, hashing bytes as they are read.

    Reference counterpart: pkg/digest/digest_reader.go — used on the piece
    download path so verification overlaps IO instead of re-reading payloads.
    """

    def __init__(self, raw: BinaryIO, algorithm: str = ALGORITHM_SHA256,
                 expected: str | None = None):
        self._raw = raw
        self._hash = hashlib.new(algorithm)
        self.algorithm = algorithm
        self.expected = expected.lower() if expected else None

    def read(self, n: int = -1) -> bytes:
        data = self._raw.read(n)
        if data:
            self._hash.update(data)
        return data

    def __iter__(self) -> Iterator[bytes]:
        while True:
            chunk = self.read(1 << 20)
            if not chunk:
                return
            yield chunk

    def hexdigest(self) -> str:
        return self._hash.hexdigest()

    def validate(self) -> bool:
        """True when the observed digest matches the expected one."""
        if self.expected is None:
            return True
        return self.hexdigest() == self.expected
