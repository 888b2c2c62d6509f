"""Threaded HTTP service lifecycle — port of
``dragonfly2_tpu/utils/httpserver.py``: one implementation of the
ThreadingHTTPServer + daemon-thread start/stop plumbing.
"""

from __future__ import annotations

import logging
import threading
from http.server import ThreadingHTTPServer
from typing import Optional, Type

logger = logging.getLogger(__name__)


class QuietThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer whose per-request errors go to the logger
    instead of a raw stderr traceback: clients vanishing mid-request are
    debug noise, not operator pages."""

    def handle_error(self, request, client_address):
        logger.debug("request from %s failed", client_address,
                     exc_info=True)


class ThreadedHTTPService:
    def __init__(self, handler_cls: Type, host: str = "127.0.0.1",
                 port: int = 0, name: str = "http-service"):
        self._server = QuietThreadingHTTPServer((host, port), handler_cls)
        self._thread: Optional[threading.Thread] = None
        self._name = name

    @property
    def address(self) -> str:
        host, port = self._server.server_address[:2]
        return f"{host}:{port}"

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(
            target=self._server.serve_forever, name=self._name, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        # shutdown() waits for serve_forever to exit: on a server that was
        # never started it would block forever.
        if self._thread is not None:
            self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
