"""TTL in-memory cache (reference counterpart: pkg/cache/cache.go:445).

Same semantics: per-entry expiration with a default TTL, optional
never-expire sentinel, lazy expiry on read plus an optional janitor
sweep, and hit/miss accounting. Backs the CA's leaf-revalidation verdict
cache (utils/certs.py — the reference's certify cert cache role).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

NO_EXPIRATION = -1.0


class TTLCache:
    def __init__(self, default_ttl: float = 60.0,
                 janitor_interval: float = 0.0):
        self.default_ttl = default_ttl
        self._items: Dict[Any, Tuple[Any, float]] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self._stop = threading.Event()
        self._janitor: Optional[threading.Thread] = None
        if janitor_interval > 0:
            self._janitor = threading.Thread(
                target=self._sweep_loop, args=(janitor_interval,),
                daemon=True, name="ttlcache-janitor")
            self._janitor.start()

    def set(self, key: Any, value: Any, ttl: Optional[float] = None) -> None:
        ttl = self.default_ttl if ttl is None else ttl
        expires = (float("inf") if ttl == NO_EXPIRATION
                   else time.monotonic() + ttl)
        with self._lock:
            self._items[key] = (value, expires)

    def get(self, key: Any, default: Any = None) -> Any:
        with self._lock:
            entry = self._items.get(key)
            if entry is None:
                self.misses += 1
                return default
            value, expires = entry
            if time.monotonic() >= expires:
                del self._items[key]
                self.misses += 1
                return default
            self.hits += 1
            return value

    def get_or_set(self, key: Any, factory: Callable[[], Any],
                   ttl: Optional[float] = None) -> Any:
        """Single-flight-ish convenience; factory runs outside the lock
        (duplicate computation possible under contention, never deadlock)."""
        sentinel = object()
        value = self.get(key, sentinel)
        if value is not sentinel:
            return value
        value = factory()
        self.set(key, value, ttl)
        return value

    def delete(self, key: Any) -> None:
        with self._lock:
            self._items.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._items.clear()

    def __len__(self) -> int:
        now = time.monotonic()
        with self._lock:
            return sum(1 for _, exp in self._items.values() if exp > now)

    def __contains__(self, key: Any) -> bool:
        sentinel = object()
        return self.get(key, sentinel) is not sentinel

    def items(self) -> Iterator[Tuple[Any, Any]]:
        now = time.monotonic()
        with self._lock:
            snapshot = list(self._items.items())
        return iter([(k, v) for k, (v, exp) in snapshot if exp > now])

    def sweep(self) -> int:
        """Drop expired entries; returns how many were removed."""
        now = time.monotonic()
        with self._lock:
            dead = [k for k, (_, exp) in self._items.items() if exp <= now]
            for k in dead:
                del self._items[k]
        return len(dead)

    def _sweep_loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            self.sweep()

    def close(self) -> None:
        self._stop.set()
        if self._janitor is not None:
            self._janitor.join(timeout=2)
