"""Manager read-through cache (manager/cache/cache.go's role).

The reference fronts GORM with a two-tier local-LRU + Redis cache keyed
per entity. Here the database is embedded sqlite, so the second tier is
pointless — but the HOT paths (dynconfig answers polled by every daemon
and scheduler on a ticker) still repeat identical queries fleet-wide.
This module gives ManagerService a short-TTL read-through with explicit
invalidation on the writes that change the answers; bounded staleness
(seconds) is safe because consumers re-poll on 60 s tickers anyway.
"""

from __future__ import annotations

import threading
from typing import Callable

from dragonfly2_tpu_torch.utils.ttlcache import TTLCache


class ReadThroughCache:
    def __init__(self, ttl: float = 5.0):
        self._cache = TTLCache(default_ttl=ttl)
        self._lock = threading.Lock()
        self._generation = 0

    def get(self, key, load: Callable[[], object]):
        sentinel = object()
        value = self._cache.get(key, sentinel)
        if value is not sentinel:
            return value
        # Generation fence: if an invalidation lands while load() reads
        # the pre-write state, DON'T cache the stale answer — a plain
        # get_or_set would re-cache it for a full TTL after the writer's
        # invalidate, hiding the write from the whole fleet.
        with self._lock:
            generation = self._generation
        value = load()
        with self._lock:
            if generation == self._generation:
                self._cache.set(key, value)
        return value

    def invalidate_prefix(self, prefix: str) -> None:
        with self._lock:
            self._generation += 1
        for key, _ in list(self._cache.items()):
            if isinstance(key, str) and key.startswith(prefix):
                self._cache.delete(key)

    @property
    def hits(self) -> int:
        return self._cache.hits

    @property
    def misses(self) -> int:
        return self._cache.misses
