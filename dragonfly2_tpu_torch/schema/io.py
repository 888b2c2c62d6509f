"""Columnar IO for dataset records: parquet (native) and CSV (interop) —
port of ``dragonfly2_tpu/schema/io.py``, without pyarrow.

Reference counterpart: scheduler/storage/storage.go (gocsv writes) and
trainer/storage/storage.go (reads). The CSV writer and reader are the JAX
package's, so both packages write the same bytes and read each other's
files, headered or headerless. In place of an arrow table, a "table" here
is ``{column: numpy array}`` in :func:`column_spec` order
(:func:`records_to_table`): int64, float64, bool or unicode columns, the
types the arrow schema gives them. Parquet goes through the port's own
codec (:mod:`schema.parquet`): pyarrow reads the files written here as
the tables the JAX package writes, and the files the JAX package writes
read back here.
"""

from __future__ import annotations

import csv
import os
from typing import Any, Iterable, Iterator, List, Sequence, Type

import numpy as np

from dragonfly2_tpu_torch.schema import parquet
from dragonfly2_tpu_torch.schema.records import (
    column_spec,
    flatten_record,
    unflatten_record,
)

_NUMPY_TYPES = {int: np.int64, float: np.float64, bool: np.bool_, str: np.str_}
_PARQUET_TYPES = {int: "int64", float: "double", str: "string", bool: "bool"}


def parquet_schema(record_type: Type) -> List[tuple]:
    """``[(column, type)]``: the JAX package's ``arrow_schema`` (int →
    int64, float → double, str → string, bool → bool) in the codec's
    type names."""
    return [(name, _PARQUET_TYPES[t]) for name, t in column_spec(record_type)]


def records_to_table(record_type: Type,
                     records: Sequence[Any]) -> dict[str, np.ndarray]:
    """One numpy column for each :func:`column_spec` entry, rows in
    ``records`` order."""
    rows = [flatten_record(r) for r in records]
    return {name: np.array([row[name] for row in rows], dtype=_NUMPY_TYPES[t])
            for name, t in column_spec(record_type)}


def table_to_records(record_type: Type, table: dict) -> List[Any]:
    columns = [name for name, _ in column_spec(record_type)]
    values = [table[c].tolist() for c in columns]
    return [unflatten_record(record_type, dict(zip(columns, row)))
            for row in zip(*values)]


def write_parquet(record_type: Type, records: Sequence[Any], path: str) -> None:
    parquet.write_table(records_to_table(record_type, records), path,
                        schema=parquet_schema(record_type))


def read_parquet(path: str, columns: Sequence[str] | None = None) -> dict:
    return parquet.ParquetFile(path).read(list(columns) if columns else None)


def read_parquet_records(record_type: Type, path: str) -> List[Any]:
    return table_to_records(record_type, read_parquet(path))


class CsvRecordWriter:
    """Append-only CSV writer for one record type.

    By default writes a header row of flattened column names (self-
    describing files); pass ``write_header=False`` for reference-format
    files — the reference writes headerless CSV
    (gocsv.MarshalWithoutHeaders, scheduler/storage/storage.go:393,408).
    The reader auto-detects either form.
    """

    def __init__(self, record_type: Type, path: str, write_header: bool = True):
        self.record_type = record_type
        self.path = path
        self._columns = [name for name, _ in column_spec(record_type)]
        empty = not os.path.exists(path) or os.path.getsize(path) == 0
        self._file = open(path, "a", newline="")
        self._writer = csv.writer(self._file)
        if write_header and empty:
            self._writer.writerow(self._columns)

    def write(self, record: Any) -> None:
        row = flatten_record(record)
        self._writer.writerow([row[c] for c in self._columns])

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.close()

    def __enter__(self) -> "CsvRecordWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _parse_cell(t: type, raw: str) -> Any:
    if t is bool:
        return raw in ("True", "true", "1")
    if t is int:
        return int(raw) if raw else 0
    if t is float:
        return float(raw) if raw else 0.0
    return raw


def _read_csv_rows(record_type: Type, path: str) -> Iterator[dict]:
    """Stream typed ``{column: value}`` rows from a CSV dataset file.

    The first line is a header iff it equals the schema's column names (a
    data row cannot collide: its first field is an ID or value, not the
    literal column name). Empty files yield nothing.
    """
    spec = column_spec(record_type)
    columns = [name for name, _ in spec]
    with open(path, newline="") as f:
        reader = csv.reader(f)
        first = next(reader, None)
        if first is None:
            return

        def typed(line: List[str]) -> dict:
            return {name: _parse_cell(t, raw) for (name, t), raw in zip(spec, line)}

        if first != columns:
            yield typed(first)
        for line in reader:
            yield typed(line)


def read_csv_records(record_type: Type, path: str) -> Iterator[Any]:
    """Stream records back from a CSV dataset file (headered or headerless)."""
    for row in _read_csv_rows(record_type, path):
        yield unflatten_record(record_type, row)


def csv_to_parquet(record_type: Type, csv_path: str, parquet_path: str,
                   batch_size: int = 8192) -> int:
    """Convert a CSV dataset (ours or reference-format headerless) to
    parquet, streaming in batches: one row group a batch. Returns the
    number of records converted.

    Builds columns straight from the typed rows — no intermediate
    dataclass trees (a Download row flattens to ~2400 leaves; at 10M
    records the round-trip through objects would double the CPU cost).
    """
    columns = [name for name, _ in column_spec(record_type)]
    writer = parquet.ParquetWriter(parquet_path, parquet_schema(record_type))
    total = 0

    def flush(batch_rows: List[dict]) -> None:
        writer.write_table({c: [r[c] for r in batch_rows] for c in columns})

    batch: List[dict] = []
    try:
        for row in _read_csv_rows(record_type, csv_path):
            batch.append(row)
            if len(batch) >= batch_size:
                flush(batch)
                total += len(batch)
                batch = []
        if batch:
            flush(batch)
            total += len(batch)
    finally:
        writer.close()
    return total


def concat_tables(paths: Iterable[str],
                  columns: Sequence[str] | None = None) -> dict:
    tables = [read_parquet(p, columns) for p in paths]
    if not tables:
        return {}
    return {name: np.concatenate([t[name] for t in tables])
            for name in tables[0]}
