"""Dynamic config: cached remote fetch + disk fallback + observers.

Reference counterpart: internal/dynconfig/dynconfig.go:45-138 (generic
cached manager-config fetcher with local-file fallback and expiry) and the
per-service managers built on it (scheduler/config/dynconfig.go,
client/config/dynconfig_manager.go). The contract:

- ``get()`` serves the freshest data available: memory → remote fetch →
  disk cache (so services boot offline with the last-known config).
- ``refresh()`` (ticker or manual) refetches; on success it persists the
  snapshot atomically and notifies observers ONLY when the data changed;
  on failure it keeps serving the cache and logs.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Callable, Dict, List, Optional

logger = logging.getLogger(__name__)


class Dynconfig:
    def __init__(self, fetch: Callable[[], Dict], cache_path: str = "",
                 refresh_interval: float = 60.0, name: str = "dynconfig"):
        self._fetch = fetch
        self.cache_path = cache_path
        self.refresh_interval = refresh_interval
        self.name = name
        self._data: Optional[Dict] = None
        self._observers: List[Callable[[Dict], None]] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- data --------------------------------------------------------------

    def get(self) -> Dict:
        with self._lock:
            if self._data is not None:
                return dict(self._data)
        if self.refresh():
            with self._lock:
                return dict(self._data or {})
        disk = self._load_cache()
        if disk is not None:
            with self._lock:
                if self._data is None:
                    self._data = disk
            logger.warning("%s: serving disk-cached config (remote down)",
                           self.name)
            return dict(disk)
        raise ConnectionError(
            f"{self.name}: no remote config and no local cache")

    def refresh(self) -> bool:
        """Returns True when a fetch succeeded (changed or not)."""
        try:
            fresh = self._fetch()
        except Exception as exc:  # noqa: BLE001 — remote may be down
            logger.warning("%s: refresh failed: %s", self.name, exc)
            return False
        with self._lock:
            changed = fresh != self._data
            self._data = fresh
            observers = list(self._observers)
        self._store_cache(fresh)
        if changed:
            for fn in observers:
                try:
                    fn(dict(fresh))
                except Exception:  # noqa: BLE001 — observers are isolated
                    logger.exception("%s: observer failed", self.name)
        return True

    def subscribe(self, fn: Callable[[Dict], None]) -> None:
        """Register an observer; immediately applied if data exists."""
        with self._lock:
            self._observers.append(fn)
            data = self._data
        if data is not None:
            fn(dict(data))

    # -- disk cache --------------------------------------------------------

    def _load_cache(self) -> Optional[Dict]:
        if not self.cache_path or not os.path.exists(self.cache_path):
            return None
        try:
            with open(self.cache_path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def _store_cache(self, data: Dict) -> None:
        if not self.cache_path:
            return
        try:
            os.makedirs(os.path.dirname(self.cache_path) or ".",
                        exist_ok=True)
            tmp = self.cache_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(data, f)
            os.replace(tmp, self.cache_path)
        except OSError:
            logger.warning("%s: cache write to %s failed", self.name,
                           self.cache_path)

    # -- ticker ------------------------------------------------------------

    def serve(self) -> None:
        if self._thread is not None:
            return

        def loop() -> None:
            while not self._stop.wait(self.refresh_interval):
                self.refresh()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"{self.name}-refresh")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
