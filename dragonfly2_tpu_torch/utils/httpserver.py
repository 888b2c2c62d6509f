"""Shared threaded-HTTP-service lifecycle.

One implementation of the ThreadingHTTPServer + daemon-thread start/stop/
port plumbing used by the upload server, proxy, object gateway, and manager
REST shell — shutdown ordering and join timeouts live here once.
"""

from __future__ import annotations

import logging
import threading
from http.server import ThreadingHTTPServer
from typing import Optional, Type

logger = logging.getLogger(__name__)


class QuietThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer whose per-request errors go to the logger
    instead of a raw stderr traceback. Clients vanishing mid-request
    (resets, refused continuations — routine under churn and by DESIGN
    under fault injection) are debug noise, not operator pages."""

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
    def port(self) -> int:
        return self._server.server_address[1]

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
        # shutdown() handshakes with serve_forever via an event that is
        # only ever SET by serve_forever exiting — on a server that was
        # never started it blocks forever (stdlib footgun). Only
        # handshake when the serve thread actually ran.
        if self._thread is not None:
            self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
