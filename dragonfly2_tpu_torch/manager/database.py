"""SQLite-backed manager database — port of the model-registry half of
``dragonfly2_tpu/manager/database.py``.

The ``models`` table with its unique ``(type, version, scheduler_id)``
key, and the generic helpers the registry uses (stdlib sqlite3, JSON
columns decoded on read, a deferred-commit transaction for the
single-active-version invariant). The cluster, instance, application,
user and job tables wait for the manager's cluster half.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

STATE_ACTIVE = "active"
STATE_INACTIVE = "inactive"
# Model-lifecycle states (manager/validation.py gate). A model row moves
# candidate → active → inactive (superseded) and any state →
# quarantined (gate rejection, runtime guard escalation, or rollback);
# quarantined is terminal — a quarantined version can never re-activate.
STATE_CANDIDATE = "candidate"
STATE_QUARANTINED = "quarantined"

_SCHEMA = """
CREATE TABLE IF NOT EXISTS models (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL,
    type TEXT NOT NULL,
    bio TEXT NOT NULL DEFAULT '',
    version TEXT NOT NULL,
    state TEXT NOT NULL DEFAULT 'inactive',
    evaluation TEXT NOT NULL DEFAULT '{}',
    scheduler_id INTEGER NOT NULL,
    object_key TEXT NOT NULL DEFAULT '',
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL,
    UNIQUE(type, version, scheduler_id)
);
"""


def _now() -> float:
    return time.time()


@dataclass
class Row:
    """Generic row wrapper with attribute access."""

    data: Dict[str, Any] = field(default_factory=dict)

    def __getattr__(self, name: str) -> Any:
        try:
            return self.data[name]
        except KeyError:
            raise AttributeError(name) from None

    def __getitem__(self, name: str) -> Any:
        return self.data[name]

    def get(self, name: str, default: Any = None) -> Any:
        return self.data.get(name, default)


_JSON_COLUMNS = {"evaluation"}


class Database:
    """Thread-safe sqlite3 wrapper with JSON column handling."""

    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.RLock()
        with self._lock:
            self._conn.executescript(_SCHEMA)
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    # -- generic helpers ---------------------------------------------------

    @staticmethod
    def _encode(table_values: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        for k, v in table_values.items():
            if k in _JSON_COLUMNS and not isinstance(v, str):
                v = json.dumps(v)
            out[k] = v
        return out

    @staticmethod
    def _decode(row: sqlite3.Row) -> Row:
        data = dict(row)
        for k in list(data):
            if k in _JSON_COLUMNS and isinstance(data[k], str):
                try:
                    data[k] = json.loads(data[k])
                except ValueError:
                    pass
        return Row(data)

    def update(self, table: str, row_id: int, **values: Any) -> None:
        values["updated_at"] = _now()
        enc = self._encode(values)
        sets = ", ".join(f"{k}=?" for k in enc)
        with self._lock:
            self._conn.execute(
                f"UPDATE {table} SET {sets} WHERE id=?",
                [*enc.values(), row_id],
            )
            self._conn.commit()

    def get(self, table: str, row_id: int) -> Optional[Row]:
        rows = self.query(f"SELECT * FROM {table} WHERE id=?", [row_id])
        return rows[0] if rows else None

    def find(self, table: str, **where: Any) -> List[Row]:
        if not where:
            return self.query(f"SELECT * FROM {table}")
        cond = " AND ".join(f"{k}=?" for k in where)
        return self.query(
            f"SELECT * FROM {table} WHERE {cond}", list(where.values())
        )

    def find_one(self, table: str, **where: Any) -> Optional[Row]:
        rows = self.find(table, **where)
        return rows[0] if rows else None

    def query(self, sql: str, params: List[Any] | None = None) -> List[Row]:
        with self._lock:
            cur = self._conn.execute(sql, params or [])
            return [self._decode(r) for r in cur.fetchall()]

    def transaction(self):
        """Context manager yielding a handle whose ``execute`` defers the
        commit to block exit — the activation invariant needs multi-row
        atomicity (manager/service/model.go:109-150
        updateModelStateToActive). Exceptions roll the whole block back."""
        return _Transaction(self)


class _Transaction:
    """Deferred-commit statement handle. Only ``execute`` is exposed, so a
    caller cannot accidentally reach a self-committing public Database
    method mid-transaction."""

    def __init__(self, db: Database):
        self._db = db

    def __enter__(self) -> "_Transaction":
        self._db._lock.acquire()
        return self

    def execute(self, sql: str, params: List[Any] | None = None):
        return self._db._conn.execute(sql, params or [])

    def __exit__(self, exc_type, *exc) -> None:
        try:
            if exc_type is None:
                self._db._conn.commit()
            else:
                self._db._conn.rollback()
        finally:
            self._db._lock.release()
