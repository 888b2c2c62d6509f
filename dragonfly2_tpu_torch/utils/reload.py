"""Daemon config hot-reload: interval file watching + SIGHUP.

Reference counterpart: client/daemon/daemon.go:797 — Serve() starts a
``dependency.WatchConfig`` loop at ``Reload.Interval`` that re-parses the
daemon YAML and fans the fresh options out to registered watchers
(proxy rules via ProxyManager.Watch, scheduler targets via dynconfig
OnNotify). This is that loop, plus SIGHUP for an immediate re-read (the
unix-idiomatic trigger the Go daemon gets for free from its interval).

A bad config file must never kill a serving daemon: parse errors are
logged and the previous options stay live — same stance as the
reference's WatchConfig, which drops unparseable reloads.
"""

from __future__ import annotations

import hashlib
import logging
import signal
import threading
from typing import Callable, Optional

logger = logging.getLogger(__name__)


class ConfigWatcher:
    """Watch a YAML config file; call ``on_change(dict)`` when its
    content changes. ``interval<=0`` disables polling (SIGHUP-only)."""

    def __init__(self, path: str, on_change: Callable[[dict], None],
                 interval: float = 10.0, install_sighup: bool = True):
        self.path = path
        self.on_change = on_change
        self.interval = interval
        self._install_sighup = install_sighup
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_digest = self._digest()  # baseline: current content
        self._last_failed_digest = ""       # apply-failure log dedup

    def _digest(self) -> str:
        try:
            with open(self.path, "rb") as f:
                return hashlib.sha256(f.read()).hexdigest()
        except OSError:
            return ""

    def _check(self) -> bool:
        """Re-read; returns True when a change was applied."""
        digest = self._digest()
        if not digest or digest == self._last_digest:
            return False
        try:
            import yaml

            with open(self.path) as f:
                data = yaml.safe_load(f) or {}
            if not isinstance(data, dict):
                raise ValueError("top level must be a mapping")
            # Same key normalization as cmd/common.py parse_with_config:
            # the file spells keys like the flags (upload-rate), watchers
            # match on dests (upload_rate).
            data = {str(k).replace("-", "_"): v for k, v in data.items()}
        except Exception as exc:  # noqa: BLE001 — keep serving old config
            logger.error("config reload of %s failed (keeping previous "
                         "options): %s", self.path, exc)
            self._last_digest = digest  # don't re-log every tick
            return False
        try:
            self.on_change(data)
        except Exception:  # noqa: BLE001
            # Do NOT commit the digest: the config parsed but was never
            # applied, so the next tick must retry it (a transient apply
            # failure would otherwise skip this version forever). Log the
            # traceback once per version — a permanently-rejected config
            # retries every tick and would otherwise spam the log.
            if digest != self._last_failed_digest:
                logger.exception("config watcher callback failed; will retry")
                self._last_failed_digest = digest
            return False
        self._last_failed_digest = ""
        self._last_digest = digest
        logger.info("reloaded config from %s", self.path)
        return True

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.interval if self.interval > 0 else None)
            if self._stop.is_set():
                return
            self._wake.clear()
            self._check()

    def start(self) -> "ConfigWatcher":
        if self._install_sighup and threading.current_thread() is threading.main_thread():
            try:
                signal.signal(signal.SIGHUP, lambda *_: self._wake.set())
            except (ValueError, OSError, AttributeError):
                pass  # non-unix or nested interpreter
        self._thread = threading.Thread(target=self._loop,
                                        name="config-reload", daemon=True)
        self._thread.start()
        return self

    def poke(self) -> None:
        """Force an immediate check (what SIGHUP does; tests use this)."""
        self._wake.set()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
