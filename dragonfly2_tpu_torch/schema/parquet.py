"""Parquet files on the standard library and numpy: the port's codec for
the columnar layer, in place of pyarrow.

A table here is ``{column: ndarray}`` (as in :mod:`schema.io`). The
writer makes files that pyarrow reads back as the tables pyarrow itself
writes from the same columns:

- ``PAR1``, then one row group for every ``row_group_size`` rows (at
  most 1 Mi rows, pyarrow's default), each column chunk one v1 data page,
  PLAIN encoded and UNCOMPRESSED, then the FileMetaData footer in
  Thrift's compact protocol;
- INT32, INT64, FLOAT, DOUBLE, BOOLEAN (bit-packed, LSB first) and
  BYTE_ARRAY with the STRING logical type (and the UTF8 converted type);
- every field OPTIONAL, as ``pa.table`` makes them, so each page carries
  its definition levels: one RLE run of 1s.

The values go out as ``ndarray.tobytes`` (strings: one join of their
UTF-8 bytes), never a Python loop per number.

The reader reads those files and the ones pyarrow writes for these types
with its defaults: SNAPPY pages, a dictionary page with RLE_DICTIONARY or
PLAIN_DICTIONARY data pages, a chunk that falls back from the dictionary
to PLAIN pages part way, RLE / bit-packed hybrid levels, several v1 pages
a chunk. Row-group counts and sizes come from the footer alone.
Anything else raises ``ValueError`` naming the feature: another codec,
v2 data pages, the DELTA and BYTE_STREAM_SPLIT encodings, nested or
repeated columns, a null value.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"PAR1"
#: pyarrow's row-group cap when ``row_group_size`` is not given.
DEFAULT_ROW_GROUP_SIZE = 1024 * 1024
CREATED_BY = "dragonfly2_tpu_torch parquet"

# parquet.thrift enums
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED = range(8)
REQUIRED, OPTIONAL, REPEATED = range(3)
UTF8 = 0  # ConvertedType
PLAIN, PLAIN_DICTIONARY, RLE, RLE_DICTIONARY = 0, 2, 3, 8
UNCOMPRESSED, SNAPPY = 0, 1
DATA_PAGE, INDEX_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = range(4)

_ENCODING_NAMES = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE",
                   4: "BIT_PACKED", 5: "DELTA_BINARY_PACKED",
                   6: "DELTA_LENGTH_BYTE_ARRAY", 7: "DELTA_BYTE_ARRAY",
                   8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
_CODEC_NAMES = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO",
                4: "BROTLI", 5: "LZ4", 6: "ZSTD", 7: "LZ4_RAW"}
_TYPE_NAMES = {0: "BOOLEAN", 1: "INT32", 2: "INT64", 3: "INT96",
               4: "FLOAT", 5: "DOUBLE", 6: "BYTE_ARRAY",
               7: "FIXED_LEN_BYTE_ARRAY"}
_NUMERIC = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}

#: Column types by name (``arrow_schema``'s names for them) → physical.
TYPES = {"int32": INT32, "int64": INT64, "float": FLOAT, "double": DOUBLE,
         "bool": BOOLEAN, "string": BYTE_ARRAY}


# ----------------------------------------------------------------------
# Thrift compact protocol
# ----------------------------------------------------------------------

# compact type ids
_T_TRUE, _T_FALSE, _T_BYTE, _T_I16, _T_I32, _T_I64 = 1, 2, 3, 4, 5, 6
_T_DOUBLE, _T_BINARY, _T_LIST, _T_SET, _T_MAP, _T_STRUCT = 7, 8, 9, 10, 11, 12


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag(n: int) -> bytes:
    return _varint((n << 1) ^ (n >> 63))


class _Struct:
    """A struct being written, its fields added in ascending id order."""

    def __init__(self):
        self.out = bytearray()
        self._last = 0

    def _header(self, fid: int, ctype: int) -> None:
        delta = fid - self._last
        if 0 < delta <= 15:
            self.out.append((delta << 4) | ctype)
        else:
            self.out.append(ctype)
            self.out += _zigzag(fid)
        self._last = fid

    def i32(self, fid: int, value: int) -> "_Struct":
        self._header(fid, _T_I32)
        self.out += _zigzag(value)
        return self

    i16 = i32

    def i64(self, fid: int, value: int) -> "_Struct":
        self._header(fid, _T_I64)
        self.out += _zigzag(value)
        return self

    def binary(self, fid: int, value: bytes) -> "_Struct":
        self._header(fid, _T_BINARY)
        self.out += _varint(len(value)) + value
        return self

    def struct(self, fid: int, value: "_Struct") -> "_Struct":
        self._header(fid, _T_STRUCT)
        self.out += value.bytes()
        return self

    def list(self, fid: int, ctype: int, items: list) -> "_Struct":
        self._header(fid, _T_LIST)
        n = len(items)
        self.out.append((n << 4 | ctype) if n < 15 else (0xF0 | ctype))
        if n >= 15:
            self.out += _varint(n)
        for item in items:
            if ctype == _T_I32:
                self.out += _zigzag(item)
            elif ctype == _T_BINARY:
                self.out += _varint(len(item)) + item
            else:
                self.out += item.bytes()
        return self

    def bytes(self) -> bytes:
        return bytes(self.out) + b"\x00"


class _Reader:
    """Reads compact-protocol values from ``buf`` at ``pos``. A struct
    reads as ``{field id: value}``, every field kept, unknown ones too."""

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def varint(self) -> int:
        shift = result = 0
        buf = self.buf
        while True:
            b = buf[self.pos]
            self.pos += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                return result
            shift += 7

    def zigzag(self) -> int:
        n = self.varint()
        return (n >> 1) ^ -(n & 1)

    def value(self, ctype: int):
        if ctype == _T_TRUE:
            return True
        if ctype == _T_FALSE:
            return False
        if ctype == _T_BYTE:
            b = self.buf[self.pos]
            self.pos += 1
            return b - 256 if b > 127 else b
        if ctype in (_T_I16, _T_I32, _T_I64):
            return self.zigzag()
        if ctype == _T_DOUBLE:
            v = struct.unpack_from("<d", self.buf, self.pos)[0]
            self.pos += 8
            return v
        if ctype == _T_BINARY:
            n = self.varint()
            v = bytes(self.buf[self.pos:self.pos + n])
            self.pos += n
            return v
        if ctype in (_T_LIST, _T_SET):
            head = self.buf[self.pos]
            self.pos += 1
            n, etype = head >> 4, head & 0x0F
            if n == 15:
                n = self.varint()
            if etype in (_T_TRUE, _T_FALSE):  # a bool element is one byte
                out = [self.buf[p] == 1 for p in range(self.pos, self.pos + n)]
                self.pos += n
                return out
            return [self.value(etype) for _ in range(n)]
        if ctype == _T_MAP:
            n = self.varint()
            if n == 0:
                return {}
            kv = self.buf[self.pos]
            self.pos += 1
            return {self.value(kv >> 4): self.value(kv & 0x0F)
                    for _ in range(n)}
        if ctype == _T_STRUCT:
            return self.struct()
        raise ValueError(f"parquet: bad thrift compact type {ctype}")

    def struct(self) -> dict:
        fields = {}
        last = 0
        while True:
            head = self.buf[self.pos]
            self.pos += 1
            if head == 0:
                return fields
            ctype, delta = head & 0x0F, head >> 4
            fid = last + delta if delta else self.zigzag()
            fields[fid] = self.value(ctype)
            last = fid


# ----------------------------------------------------------------------
# Snappy and the RLE / bit-packed hybrid
# ----------------------------------------------------------------------


def snappy_decompress(data) -> bytes:
    """Decode one raw snappy block (the format of a parquet SNAPPY page)."""
    r = _Reader(data)
    n = r.varint()
    out = bytearray()
    pos, end = r.pos, len(data)
    while pos < end:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = tag >> 2
            if length >= 60:
                width = length - 59
                length = int.from_bytes(data[pos:pos + width], "little")
                pos += width
            length += 1
            out += data[pos:pos + length]
            pos += length
            continue
        if kind == 1:
            length = 4 + ((tag >> 2) & 7)
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:
            length = (tag >> 2) + 1
            offset = data[pos] | (data[pos + 1] << 8)
            pos += 2
        else:
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise ValueError("snappy: copy offset outside the output")
        start = len(out) - offset
        if offset >= length:
            out += out[start:start + length]
        else:  # the copy overlaps what it writes: repeat the pattern
            pattern = out[start:]
            out += (pattern * (length // offset + 1))[:length]
    if len(out) != n:
        raise ValueError(f"snappy: {len(out)} bytes decoded, header says {n}")
    return bytes(out)


def _unpack_bits(raw: np.ndarray, bit_width: int, count: int) -> np.ndarray:
    """``count`` little-endian ``bit_width``-bit integers, LSB first."""
    if bit_width == 0:
        return np.zeros(count, np.int64)
    bits = np.unpackbits(raw, bitorder="little")[:count * bit_width]
    weights = (1 << np.arange(bit_width, dtype=np.int64))
    return bits.reshape(count, bit_width).astype(np.int64) @ weights


def decode_hybrid(buf, pos: int, end: int, bit_width: int,
                  count: int) -> np.ndarray:
    """``count`` values of the RLE / bit-packed hybrid in ``buf[pos:end]``."""
    r = _Reader(buf, pos)
    out = np.empty(count, np.int64)
    got = 0
    byte_width = (bit_width + 7) // 8
    while got < count:
        if r.pos >= end:
            raise ValueError("parquet: RLE / bit-packed run past its end")
        header = r.varint()
        if header & 1:  # bit-packed: (header >> 1) groups of 8 values
            n = (header >> 1) * 8
            nbytes = (header >> 1) * bit_width
            raw = np.frombuffer(buf, np.uint8, nbytes, r.pos)
            r.pos += nbytes
            take = min(n, count - got)
            out[got:got + take] = _unpack_bits(raw, bit_width, n)[:take]
        else:
            n = header >> 1
            value = int.from_bytes(buf[r.pos:r.pos + byte_width], "little")
            r.pos += byte_width
            take = min(n, count - got)
            out[got:got + take] = value
        got += take
    return out


def _rle_ones(count: int) -> bytes:
    """Definition levels of ``count`` present values: one RLE run of 1s
    (bit width 1), with its 4-byte length."""
    run = _varint(count << 1) + b"\x01"
    return struct.pack("<i", len(run)) + run


# ----------------------------------------------------------------------
# Values
# ----------------------------------------------------------------------


def _physical(values: np.ndarray) -> int:
    kind = values.dtype
    if kind == np.bool_:
        return BOOLEAN
    if kind == np.int32:
        return INT32
    if kind == np.int64:
        return INT64
    if kind == np.float32:
        return FLOAT
    if kind == np.float64:
        return DOUBLE
    if kind.kind in "UO":
        return BYTE_ARRAY
    raise ValueError(f"parquet: no column type for numpy dtype {kind}")


def _as_type(values, ptype: int) -> np.ndarray:
    if ptype == BYTE_ARRAY:
        return np.asarray(values, dtype=np.str_)
    dtype = {BOOLEAN: np.bool_, **{t: np.dtype(d) for t, d in
                                   _NUMERIC.items()}}[ptype]
    return np.asarray(values, dtype=dtype)


def _plain_bytes(values: np.ndarray, ptype: int) -> bytes:
    if ptype in _NUMERIC:
        return values.astype(_NUMERIC[ptype], copy=False).tobytes()
    if ptype == BOOLEAN:
        return np.packbits(values.astype(np.bool_),
                           bitorder="little").tobytes()
    encoded = [s.encode("utf-8") for s in values.tolist()]
    lengths = np.fromiter(map(len, encoded), np.int64, len(encoded))
    body = np.frombuffer(b"".join(encoded), np.uint8)
    out = np.empty(len(body) + 4 * len(encoded), np.uint8)
    starts = np.arange(len(encoded)) * 4
    starts[1:] += np.cumsum(lengths)[:-1]
    out[(starts[:, None] + np.arange(4)).ravel()] = (
        lengths.astype("<u4").view(np.uint8))
    owner = np.repeat(np.arange(len(encoded)), lengths)
    out[np.arange(len(body)) + 4 * (owner + 1)] = body
    return out.tobytes()


def _plain_values(buf, pos: int, end: int, ptype: int,
                  count: int) -> np.ndarray:
    if ptype in _NUMERIC:
        return np.frombuffer(buf, _NUMERIC[ptype], count, pos).astype(
            _NUMERIC[ptype][1:])
    if ptype == BOOLEAN:
        raw = np.frombuffer(buf, np.uint8, (count + 7) // 8, pos)
        return np.unpackbits(raw, bitorder="little")[:count].astype(np.bool_)
    if ptype == BYTE_ARRAY:
        out = []
        mv = memoryview(buf)
        for _ in range(count):
            n = int.from_bytes(mv[pos:pos + 4], "little")
            out.append(str(mv[pos + 4:pos + 4 + n], "utf-8"))
            pos += 4 + n
        if pos > end:
            raise ValueError("parquet: byte arrays past their page")
        return np.array(out, dtype=np.str_)
    raise ValueError(f"parquet: {_TYPE_NAMES.get(ptype, ptype)} columns "
                     "are not supported")


# ----------------------------------------------------------------------
# Writer
# ----------------------------------------------------------------------


class ParquetWriter:
    """Appends row groups to one file; :meth:`close` writes the footer.

    ``schema`` is ``[(column, type)]`` with the types of :data:`TYPES`;
    every table given to :meth:`write_table` is cast to it."""

    def __init__(self, path: str, schema: Sequence[Tuple[str, str]]):
        for name, typ in schema:
            if typ not in TYPES:
                raise ValueError(f"parquet: unknown column type {typ!r}")
        self.schema = [(name, TYPES[typ]) for name, typ in schema]
        self._file = open(path, "wb")
        self._file.write(MAGIC)
        self._groups: List[_Struct] = []
        self._rows = 0

    def write_table(self, table: Dict[str, np.ndarray],
                    row_group_size: Optional[int] = None) -> None:
        """``table``'s rows as row groups of at most ``row_group_size``
        rows (one group for an empty table, as pyarrow writes it)."""
        columns = [(name, ptype, _as_type(table[name], ptype))
                   for name, ptype in self.schema]
        n = len(columns[0][2]) if columns else 0
        if any(len(values) != n for _, _, values in columns):
            raise ValueError("parquet: columns of different lengths")
        step = min(row_group_size or DEFAULT_ROW_GROUP_SIZE,
                   DEFAULT_ROW_GROUP_SIZE)
        if step <= 0:
            raise ValueError("parquet: row_group_size must be positive")
        for lo in range(0, max(n, 1), step):
            hi = min(lo + step, n)
            self._write_group([(name, ptype, values[lo:hi])
                               for name, ptype, values in columns], hi - lo)

    def _write_group(self, columns, rows: int) -> None:
        chunks, group_start, total = [], self._file.tell(), 0
        for name, ptype, values in columns:
            page = _rle_ones(rows) + _plain_bytes(values, ptype)
            header = (_Struct().i32(1, DATA_PAGE).i32(2, len(page))
                      .i32(3, len(page))
                      .struct(5, _Struct().i32(1, rows).i32(2, PLAIN)
                              .i32(3, RLE).i32(4, RLE))).bytes()
            offset = self._file.tell()
            self._file.write(header)
            self._file.write(page)
            size = len(header) + len(page)
            total += size
            meta = (_Struct().i32(1, ptype).list(2, _T_I32, [PLAIN, RLE])
                    .list(3, _T_BINARY, [name.encode("utf-8")])
                    .i32(4, UNCOMPRESSED).i64(5, rows).i64(6, size)
                    .i64(7, size).i64(9, offset))
            chunks.append(_Struct().i64(2, offset).struct(3, meta))
        self._groups.append(
            _Struct().list(1, _T_STRUCT, chunks).i64(2, total)
            .i64(3, rows).i64(5, group_start).i64(6, total)
            .i16(7, len(self._groups)))
        self._rows += rows

    def close(self) -> None:
        if self._file.closed:
            return
        elements = [_Struct().binary(4, b"schema")
                    .i32(5, len(self.schema))]
        for name, ptype in self.schema:
            el = (_Struct().i32(1, ptype).i32(3, OPTIONAL)
                  .binary(4, name.encode("utf-8")))
            if ptype == BYTE_ARRAY:
                el.i32(6, UTF8).struct(10, _Struct().struct(1, _Struct()))
            elements.append(el)
        footer = (_Struct().i32(1, 1).list(2, _T_STRUCT, elements)
                  .i64(3, self._rows).list(4, _T_STRUCT, self._groups)
                  .binary(6, CREATED_BY.encode())).bytes()
        try:
            self._file.write(footer)
            self._file.write(struct.pack("<i", len(footer)) + MAGIC)
        finally:
            self._file.close()

    def __enter__(self) -> "ParquetWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def table_schema(table: Dict[str, np.ndarray]) -> List[Tuple[str, str]]:
    """``[(column, type)]`` from the columns' numpy dtypes, as
    ``pa.table`` infers it from numpy arrays."""
    names = {v: k for k, v in TYPES.items()}
    return [(name, names[_physical(np.asarray(values))])
            for name, values in table.items()]


def write_table(table: Dict[str, np.ndarray], path: str,
                row_group_size: Optional[int] = None,
                schema: Optional[Sequence[Tuple[str, str]]] = None) -> None:
    """``pq.write_table`` for a ``{column: ndarray}`` table."""
    with ParquetWriter(path, schema or table_schema(table)) as writer:
        writer.write_table(table, row_group_size)


# ----------------------------------------------------------------------
# Reader
# ----------------------------------------------------------------------


class RowGroupMetaData:
    def __init__(self, fields: dict):
        self.num_rows = fields[3]
        self.columns = [c.get(3) for c in fields[1]]


class FileMetaData:
    """The footer: schema, rows, row groups. Made without reading data."""

    def __init__(self, fields: dict):
        self.num_rows = fields[3]
        self._groups = [RowGroupMetaData(g) for g in fields.get(4, [])]
        elements = fields[2]
        root, leaves = elements[0], elements[1:]
        if root.get(5, 0) != len(leaves):
            raise ValueError("parquet: nested columns are not supported")
        self.columns: List[str] = []
        self.types: List[int] = []
        self.optional: List[bool] = []
        for el in leaves:
            name = el[4].decode("utf-8")
            if el.get(5):
                raise ValueError(f"parquet: nested column {name!r} is not "
                                 "supported")
            if el.get(3, REQUIRED) == REPEATED:
                raise ValueError(f"parquet: repeated column {name!r} is "
                                 "not supported")
            ptype = el.get(1)
            if ptype == BYTE_ARRAY and not (el.get(6) == UTF8
                                            or 1 in el.get(10, {})):
                raise ValueError(f"parquet: binary column {name!r} without "
                                 "the STRING type is not supported")
            if ptype not in (BOOLEAN, BYTE_ARRAY, *_NUMERIC):
                raise ValueError(f"parquet: {_TYPE_NAMES.get(ptype, ptype)}"
                                 f" column {name!r} is not supported")
            self.columns.append(name)
            self.types.append(ptype)
            self.optional.append(el.get(3, REQUIRED) == OPTIONAL)

    @property
    def num_row_groups(self) -> int:
        return len(self._groups)

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def row_group(self, group: int) -> RowGroupMetaData:
        return self._groups[group]


def read_metadata(path: str) -> FileMetaData:
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size < 12:
            raise ValueError(f"parquet: {path} is too short")
        f.seek(size - 8)
        tail = f.read(8)
        if tail[4:] != MAGIC:
            raise ValueError(f"parquet: {path} has no PAR1 footer")
        length = struct.unpack("<i", tail[:4])[0]
        f.seek(size - 8 - length)
        footer = f.read(length)
    return FileMetaData(_Reader(footer).struct())


class ParquetFile:
    """One file: :attr:`metadata` from the footer; column chunks read
    and decoded on demand."""

    def __init__(self, path: str):
        self.path = path
        self.metadata = read_metadata(path)

    def _columns(self, columns: Optional[Sequence[str]]) -> List[int]:
        if columns is None:
            return list(range(self.metadata.num_columns))
        index = {name: i for i, name in enumerate(self.metadata.columns)}
        missing = [c for c in columns if c not in index]
        if missing:
            raise KeyError(f"parquet: no column {missing[0]!r} in "
                           f"{self.path}")
        return [index[c] for c in columns]

    def read_row_group(self, group: int,
                       columns: Optional[Sequence[str]] = None
                       ) -> Dict[str, np.ndarray]:
        meta = self.metadata
        rg = meta.row_group(group)
        out = {}
        with open(self.path, "rb") as f:
            for i in self._columns(columns):
                cm = rg.columns[i]
                start = cm[9]
                dict_offset = cm.get(11)
                if dict_offset is not None and 0 < dict_offset < start:
                    start = dict_offset
                f.seek(start)
                data = f.read(cm[7])
                out[meta.columns[i]] = _read_chunk(
                    data, cm, meta.types[i], meta.optional[i],
                    meta.columns[i])
        return out

    def read(self, columns: Optional[Sequence[str]] = None
             ) -> Dict[str, np.ndarray]:
        """Every row group's ``columns``, concatenated."""
        meta = self.metadata
        picked = self._columns(columns)
        groups = [self.read_row_group(g, [meta.columns[i] for i in picked])
                  for g in range(meta.num_row_groups)]
        return {meta.columns[i]: (
            np.concatenate([g[meta.columns[i]] for g in groups]) if groups
            else _as_type([], meta.types[i])) for i in picked}


def _read_chunk(data: bytes, cm: dict, ptype: int, optional: bool,
                name: str) -> np.ndarray:
    codec = cm[4]
    if codec not in (UNCOMPRESSED, SNAPPY):
        raise ValueError(f"parquet: codec {_CODEC_NAMES.get(codec, codec)} "
                         f"(column {name!r}) is not supported")
    want = cm[5]
    parts: List[np.ndarray] = []
    dictionary = None
    got = 0
    r = _Reader(data)
    while got < want:
        header = r.struct()
        page_type, size = header[1], header[3]
        raw = data[r.pos:r.pos + size]
        r.pos += size
        if page_type == DATA_PAGE_V2:
            raise ValueError(f"parquet: data page v2 (column {name!r}) is "
                             "not supported")
        if page_type not in (DATA_PAGE, DICTIONARY_PAGE):
            raise ValueError(f"parquet: page type {page_type} (column "
                             f"{name!r}) is not supported")
        page = snappy_decompress(raw) if codec == SNAPPY else raw
        if page_type == DICTIONARY_PAGE:
            dh = header[7]
            if dh[2] not in (PLAIN, PLAIN_DICTIONARY):
                raise ValueError(f"parquet: dictionary encoding "
                                 f"{_ENCODING_NAMES.get(dh[2], dh[2])} is "
                                 "not supported")
            dictionary = _plain_values(page, 0, len(page), ptype, dh[1])
            continue
        dh = header[5]
        n, encoding = dh[1], dh[2]
        pos = 0
        if optional:
            if dh[3] != RLE:
                raise ValueError(
                    f"parquet: definition-level encoding "
                    f"{_ENCODING_NAMES.get(dh[3], dh[3])} is not supported")
            length = struct.unpack_from("<i", page, 0)[0]
            levels = decode_hybrid(page, 4, 4 + length, 1, n)
            if not levels.all():
                raise ValueError(f"parquet: null values (column {name!r}) "
                                 "are not supported")
            pos = 4 + length
        if encoding == PLAIN:
            parts.append(_plain_values(page, pos, len(page), ptype, n))
        elif encoding in (RLE_DICTIONARY, PLAIN_DICTIONARY):
            if dictionary is None:
                raise ValueError(f"parquet: dictionary page missing "
                                 f"(column {name!r})")
            width = page[pos]
            idx = decode_hybrid(page, pos + 1, len(page), width, n)
            parts.append(dictionary[idx])
        else:
            raise ValueError(
                f"parquet: encoding {_ENCODING_NAMES.get(encoding, encoding)}"
                f" (column {name!r}) is not supported")
        got += n
    return np.concatenate(parts) if parts else _as_type([], ptype)
