"""Named interval GC task runner.

Reference counterpart: pkg/gc/gc.go:63-149 — scheduler resource managers and
daemon storage register reclaim callbacks that run on per-task intervals.
Thread-based; tasks run on a shared timer thread so a hundred registered
tasks don't cost a hundred threads.
"""

from __future__ import annotations

import heapq
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict

logger = logging.getLogger(__name__)


@dataclass(order=True)
class _Scheduled:
    when: float
    task_id: str = field(compare=False)


class GC:
    """Interval task runner with run-now support."""

    def __init__(self):
        self._tasks: Dict[str, tuple[float, Callable[[], None]]] = {}
        self._heap: list[_Scheduled] = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def add(self, task_id: str, interval_seconds: float, run: Callable[[], None]) -> None:
        with self._lock:
            if task_id in self._tasks:
                raise ValueError(f"gc task {task_id!r} already registered")
            self._tasks[task_id] = (interval_seconds, run)
            heapq.heappush(self._heap, _Scheduled(time.monotonic() + interval_seconds, task_id))
        self._wake.set()

    def run(self, task_id: str) -> None:
        """Run one task immediately (reference: GC.Run)."""
        with self._lock:
            _, fn = self._tasks[task_id]
        self._run_safely(task_id, fn)

    def run_all(self) -> None:
        with self._lock:
            items = list(self._tasks.items())
        for task_id, (_, fn) in items:
            self._run_safely(task_id, fn)

    def serve(self) -> None:
        """Start the background loop (idempotent)."""
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="gc", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run_safely(self, task_id: str, fn: Callable[[], None]) -> None:
        try:
            fn()
        except Exception:
            logger.exception("gc task %s failed", task_id)

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                if not self._heap:
                    timeout = None
                else:
                    timeout = max(self._heap[0].when - time.monotonic(), 0)
            if timeout is None or timeout > 0:
                self._wake.wait(timeout)
                self._wake.clear()
                if self._stop.is_set():
                    return
                continue
            with self._lock:
                item = heapq.heappop(self._heap)
                entry = self._tasks.get(item.task_id)
                if entry is not None:
                    interval, fn = entry
                    heapq.heappush(
                        self._heap, _Scheduled(time.monotonic() + interval, item.task_id)
                    )
            if entry is not None:
                self._run_safely(item.task_id, fn)
