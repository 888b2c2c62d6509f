"""Dataset records as CSV files and numpy columns — port of the CSV half of
``dragonfly2_tpu/schema/io.py``, without pyarrow.

Reference counterpart: scheduler/storage/storage.go (gocsv writes) and
trainer/storage/storage.go (reads). The writer and the reader are the JAX
package's, so both packages write the same bytes and read each other's
files, headered or headerless. In place of an arrow table, a "table" here
is ``{column: numpy array}`` in :func:`column_spec` order
(:func:`records_to_table`): int64, float64, bool or unicode columns, the
types the arrow schema gives them.
"""

from __future__ import annotations

import csv
import os
from typing import Any, Iterator, List, Sequence, Type

import numpy as np

from dragonfly2_tpu_torch.schema.records import (
    column_spec,
    flatten_record,
    unflatten_record,
)

_NUMPY_TYPES = {int: np.int64, float: np.float64, bool: np.bool_, str: np.str_}


def records_to_table(record_type: Type,
                     records: Sequence[Any]) -> dict[str, np.ndarray]:
    """One numpy column for each :func:`column_spec` entry, rows in
    ``records`` order."""
    rows = [flatten_record(r) for r in records]
    return {name: np.array([row[name] for row in rows], dtype=_NUMPY_TYPES[t])
            for name, t in column_spec(record_type)}


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
