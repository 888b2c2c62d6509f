"""``sha256_from_strings`` — port copy of the one function of
``dragonfly2_tpu/utils/digest.py`` that ID generation needs (the digest
parser and file hashing are not part of the port)."""

from __future__ import annotations

import hashlib


def sha256_from_strings(*values: str) -> str:
    """SHA-256 over concatenated UTF-8 strings, hex.

    Identical semantics to the reference's ``digest.SHA256FromStrings``
    (pkg/digest/digest.go), which feeds each string into one hash state —
    the primitive beneath task/host/model ID generation.
    """
    h = hashlib.sha256()
    for v in values:
        h.update(v.encode("utf-8"))
    return h.hexdigest()
