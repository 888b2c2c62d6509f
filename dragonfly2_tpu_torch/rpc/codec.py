"""Self-describing binary codec for dataclass RPC messages.

Wire format::

    b"DF2\\x01" | u32 header_len | header (UTF-8 JSON) | blob (raw bytes)

The header is the message tree with every ``bytes`` value replaced by a
``{"$b": [offset, length]}`` span into the blob and every numpy array by
``{"$a": [dtype, shape, offset, length]}`` — so piece payloads and feature
tensors are a single contiguous copy, never base64. Nested dataclasses are
tagged ``{"$m": tag, "d": {...}}`` and resolved through the registry, so
decoding needs no type hints.

Replaces the reference's protobuf layer (pkg/rpc, d7y.io/api) for our
services; unlike protobuf this codec is schema-light — adding a field with a
default is backward compatible because decode passes only known fields.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from enum import Enum
from typing import Any, Dict, Type, TypeVar

import numpy as np

_MAGIC = b"DF2\x01"
_REGISTRY: Dict[str, type] = {}
_TAGS: Dict[type, str] = {}

T = TypeVar("T")


def message(tag: str):
    """Class decorator: make a frozen-ish dataclass wire message.

    Tags are namespaced like protobuf full names, e.g.
    ``"trainer.TrainGnnRequest"``.
    """

    def wrap(cls: Type[T]) -> Type[T]:
        if not dataclasses.is_dataclass(cls):
            cls = dataclasses.dataclass(cls)  # type: ignore[assignment]
        if tag in _REGISTRY and _REGISTRY[tag] is not cls:
            raise ValueError(f"duplicate message tag {tag!r}")
        _REGISTRY[tag] = cls
        _TAGS[cls] = tag
        return cls

    return wrap


def lookup(tag: str) -> type:
    return _REGISTRY[tag]


class _Blob:
    def __init__(self) -> None:
        self.parts: list[bytes] = []
        self.size = 0

    def add(self, data: bytes | memoryview) -> tuple[int, int]:
        off = self.size
        self.parts.append(bytes(data) if isinstance(data, memoryview) else data)
        self.size += len(data)
        return off, len(data)


def _enc(value: Any, blob: _Blob) -> Any:
    # Enum first: IntEnum/StrEnum members are also int/str instances and
    # would otherwise silently lose their type on the wire.
    if isinstance(value, Enum):
        tag = _TAGS.get(type(value))
        if tag is None:
            raise TypeError(
                f"unregistered enum type {type(value).__name__}; "
                "decorate it with @register_enum"
            )
        return {"$e": [tag, value.value]}
    if value is None or isinstance(value, (bool, int, str)):
        return value
    if isinstance(value, float):
        # JSON has no inf/nan literals; tag them.
        if value != value or value in (float("inf"), float("-inf")):
            return {"$f": repr(value)}
        return value
    if isinstance(value, (bytes, bytearray, memoryview)):
        off, n = blob.add(value)
        return {"$b": [off, n]}
    if isinstance(value, np.ndarray):
        arr = np.ascontiguousarray(value)
        off, n = blob.add(arr.tobytes())
        return {"$a": [arr.dtype.str, list(arr.shape), off, n]}
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        tag = _TAGS.get(type(value))
        if tag is None:
            raise TypeError(f"unregistered message type {type(value).__name__}")
        fields = {
            f.name: _enc(getattr(value, f.name), blob)
            for f in dataclasses.fields(value)
        }
        return {"$m": tag, "d": fields}
    if isinstance(value, (list, tuple)):
        return [_enc(v, blob) for v in value]
    if isinstance(value, (set, frozenset)):
        return {"$s": [_enc(v, blob) for v in sorted(value)]}
    if isinstance(value, dict):
        return {"$d": [[_enc(k, blob), _enc(v, blob)] for k, v in value.items()]}
    raise TypeError(f"cannot encode {type(value).__name__}")


def _span(blob: memoryview, off: Any, n: Any) -> memoryview:
    """Bounds-checked blob span. Python slicing CLAMPS out-of-range
    indexes, so without this a message truncated in the blob region
    would decode silently with a shortened payload — the silently-wrong
    decode a wire format must never produce."""
    if (not isinstance(off, int) or not isinstance(n, int)
            or off < 0 or n < 0 or off + n > len(blob)):
        raise ValueError(
            f"blob span [{off}:{off}+{n}] outside blob of {len(blob)} bytes")
    return blob[off : off + n]


def _dec(node: Any, blob: memoryview) -> Any:
    if isinstance(node, list):
        return [_dec(v, blob) for v in node]
    if not isinstance(node, dict):
        return node
    if "$f" in node:
        return float(node["$f"])
    if "$b" in node:
        off, n = node["$b"]
        return bytes(_span(blob, off, n))
    if "$a" in node:
        dtype, shape, off, n = node["$a"]
        return np.frombuffer(
            _span(blob, off, n), dtype=np.dtype(dtype)
        ).reshape(shape).copy()
    if "$e" in node:
        tag, raw = node["$e"]
        return lookup(tag)(raw)
    if "$s" in node:
        return set(_dec(v, blob) for v in node["$s"])
    if "$d" in node:
        return {_dec(k, blob): _dec(v, blob) for k, v in node["$d"]}
    if "$m" in node:
        cls = lookup(node["$m"])
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: _dec(v, blob) for k, v in node["d"].items() if k in known}
        return cls(**kwargs)
    raise ValueError(f"malformed codec node: {node!r}")


def register_enum(tag: str):
    """Decorator registering an Enum for wire round-tripping."""

    def wrap(cls):
        _REGISTRY[tag] = cls
        _TAGS[cls] = tag
        return cls

    return wrap


def encode(msg: Any) -> bytes:
    blob = _Blob()
    header = json.dumps(_enc(msg, blob), separators=(",", ":")).encode()
    return b"".join([_MAGIC, struct.pack("<I", len(header)), header, *blob.parts])


def decode(data: bytes | memoryview) -> Any:
    view = memoryview(data)
    # Length checks up front: truncated wire bytes must fail as a clean
    # ValueError, never a struct.error leaking from the unpack.
    if len(view) < 8:
        raise ValueError("truncated DF2 message (shorter than header)")
    if bytes(view[:4]) != _MAGIC:
        raise ValueError("bad magic; not a DF2 message")
    (hlen,) = struct.unpack("<I", view[4:8])
    if 8 + hlen > len(view):
        raise ValueError("DF2 header length exceeds message size")
    header = json.loads(bytes(view[8 : 8 + hlen]).decode())
    return _dec(header, view[8 + hlen :])
