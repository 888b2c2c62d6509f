"""SQLite-backed manager database.

Reference counterpart: manager/database/database.go + manager/models/*.go
(GORM over MySQL/Postgres). Same entities and constraints, stdlib sqlite3:
scheduler clusters with JSON config/scopes, scheduler & seed-peer instances
with keepalive state, applications, and the model registry with its unique
``(type, version, scheduler_id)`` key and single-active-version invariant
(manager/models/model.go:36-46, manager/service/model.go:109-150).
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
# Model-lifecycle states (manager/validation.py gate; docs/SERVING.md
# "Model lifecycle & guarded rollout"). A model row moves
# candidate → active → inactive (superseded) and any state →
# quarantined (gate rejection, runtime guard escalation, or rollback);
# quarantined is terminal — a quarantined version can never re-activate.
STATE_CANDIDATE = "candidate"
STATE_QUARANTINED = "quarantined"

_SCHEMA = """
CREATE TABLE IF NOT EXISTS scheduler_clusters (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT UNIQUE NOT NULL,
    config TEXT NOT NULL DEFAULT '{}',
    client_config TEXT NOT NULL DEFAULT '{}',
    scopes TEXT NOT NULL DEFAULT '{}',
    is_default INTEGER NOT NULL DEFAULT 0,
    seed_peer_clusters TEXT NOT NULL DEFAULT '[]',
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS schedulers (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    hostname TEXT NOT NULL,
    ip TEXT NOT NULL,
    port INTEGER NOT NULL,
    state TEXT NOT NULL DEFAULT 'inactive',
    features TEXT NOT NULL DEFAULT '[]',
    scheduler_cluster_id INTEGER NOT NULL,
    last_keepalive REAL NOT NULL DEFAULT 0,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL,
    UNIQUE(hostname, ip, scheduler_cluster_id)
);
CREATE TABLE IF NOT EXISTS seed_peer_clusters (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT UNIQUE NOT NULL,
    config TEXT NOT NULL DEFAULT '{}',
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS seed_peers (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    hostname TEXT NOT NULL,
    ip TEXT NOT NULL,
    port INTEGER NOT NULL,
    download_port INTEGER NOT NULL,
    object_storage_port INTEGER NOT NULL DEFAULT 0,
    type TEXT NOT NULL DEFAULT 'super',
    state TEXT NOT NULL DEFAULT 'inactive',
    idc TEXT NOT NULL DEFAULT '',
    location TEXT NOT NULL DEFAULT '',
    seed_peer_cluster_id INTEGER NOT NULL,
    last_keepalive REAL NOT NULL DEFAULT 0,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL,
    UNIQUE(hostname, ip, seed_peer_cluster_id)
);
CREATE TABLE IF NOT EXISTS applications (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT UNIQUE NOT NULL,
    url TEXT NOT NULL DEFAULT '',
    bio TEXT NOT NULL DEFAULT '',
    priorities TEXT NOT NULL DEFAULT '{}',
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);
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
CREATE TABLE IF NOT EXISTS configs (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT UNIQUE NOT NULL,
    value TEXT NOT NULL DEFAULT '',
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS oauths (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT UNIQUE NOT NULL,
    bio TEXT NOT NULL DEFAULT '',
    client_id TEXT NOT NULL,
    client_secret TEXT NOT NULL,
    redirect_url TEXT NOT NULL DEFAULT '',
    auth_url TEXT NOT NULL DEFAULT '',
    token_url TEXT NOT NULL DEFAULT '',
    userinfo_url TEXT NOT NULL DEFAULT '',
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS users (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT UNIQUE NOT NULL,
    password_hash TEXT NOT NULL,
    email TEXT NOT NULL DEFAULT '',
    oauth_provider TEXT NOT NULL DEFAULT '',
    oauth_subject TEXT NOT NULL DEFAULT '',
    state TEXT NOT NULL DEFAULT 'enable',
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS user_roles (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    user_id INTEGER NOT NULL,
    role TEXT NOT NULL,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL,
    UNIQUE(user_id, role)
);
CREATE TABLE IF NOT EXISTS personal_access_tokens (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL,
    token_hash TEXT UNIQUE NOT NULL,
    user_id INTEGER NOT NULL,
    scopes TEXT NOT NULL DEFAULT '[]',
    state TEXT NOT NULL DEFAULT 'active',
    expires_at REAL NOT NULL,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS queued_jobs (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    queue TEXT NOT NULL,
    type TEXT NOT NULL,
    payload TEXT NOT NULL DEFAULT '{}',
    group_id TEXT NOT NULL DEFAULT '',
    state TEXT NOT NULL DEFAULT 'pending',
    attempts INTEGER NOT NULL DEFAULT 0,
    max_attempts INTEGER NOT NULL DEFAULT 3,
    not_before REAL NOT NULL DEFAULT 0,
    lease_expires_at REAL NOT NULL DEFAULT 0,
    worker_id TEXT NOT NULL DEFAULT '',
    error TEXT NOT NULL DEFAULT '',
    result TEXT NOT NULL DEFAULT 'null',
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_queued_jobs_queue_state
    ON queued_jobs (queue, state);
CREATE INDEX IF NOT EXISTS idx_queued_jobs_group
    ON queued_jobs (group_id);
CREATE TABLE IF NOT EXISTS peers (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    host_id TEXT NOT NULL,
    hostname TEXT NOT NULL,
    ip TEXT NOT NULL,
    port INTEGER NOT NULL DEFAULT 0,
    download_port INTEGER NOT NULL DEFAULT 0,
    type TEXT NOT NULL DEFAULT 'normal',
    idc TEXT NOT NULL DEFAULT '',
    location TEXT NOT NULL DEFAULT '',
    state TEXT NOT NULL DEFAULT 'active',
    scheduler_id INTEGER NOT NULL,
    created_at REAL NOT NULL,
    updated_at REAL NOT NULL,
    UNIQUE(host_id, scheduler_id)
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


_JSON_COLUMNS = {
    "config", "client_config", "scopes", "features", "priorities",
    "evaluation", "seed_peer_clusters", "payload", "result",
}


class Database:
    """Thread-safe sqlite3 wrapper with JSON column handling."""

    def __init__(self, path: str = ":memory:"):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.RLock()
        with self._lock:
            self._conn.executescript(_SCHEMA)
            # Additive migrations for DB files created by older builds
            # (CREATE IF NOT EXISTS can't add columns to existing tables).
            for table, column, decl in (
                ("users", "oauth_provider", "TEXT NOT NULL DEFAULT ''"),
                ("users", "oauth_subject", "TEXT NOT NULL DEFAULT ''"),
            ):
                cols = {r["name"] for r in self._conn.execute(
                    f"PRAGMA table_info({table})")}
                if column not in cols:
                    self._conn.execute(
                        f"ALTER TABLE {table} ADD COLUMN {column} {decl}")
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

    def insert(self, table: str, **values: Any) -> int:
        values.setdefault("created_at", _now())
        values.setdefault("updated_at", _now())
        enc = self._encode(values)
        cols = ", ".join(enc)
        marks = ", ".join("?" for _ in enc)
        with self._lock:
            cur = self._conn.execute(
                f"INSERT INTO {table} ({cols}) VALUES ({marks})",
                list(enc.values()),
            )
            self._conn.commit()
            return int(cur.lastrowid)

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

    def delete(self, table: str, row_id: int) -> None:
        with self._lock:
            self._conn.execute(f"DELETE FROM {table} WHERE id=?", [row_id])
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

    def execute(self, sql: str, params: List[Any] | None = None) -> None:
        with self._lock:
            self._conn.execute(sql, params or [])
            self._conn.commit()

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
