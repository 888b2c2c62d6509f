"""Health service — port of ``dragonfly2_tpu/rpc/health.py``.

Tracks per-service status; the empty service name is the whole server.
The inference service flips it ``NOT_SERVING`` while a hot-reload grace
window is open, so health-aware clients drain to a replica. The port has
no codec: request and reply are plain dataclasses, as the sidecar's
messages are.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

SERVING = "SERVING"
NOT_SERVING = "NOT_SERVING"
UNKNOWN = "SERVICE_UNKNOWN"


@dataclass
class HealthCheckRequest:
    service: str = ""


@dataclass
class HealthCheckReply:
    status: str = SERVING


class HealthService:
    """Tracks per-service status; empty service name = whole server."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._status: dict[str, str] = {"": SERVING}

    def set_status(self, service: str, status: str) -> None:
        with self._lock:
            self._status[service] = status

    def Check(self, request: HealthCheckRequest,  # noqa: N802
              context=None) -> HealthCheckReply:
        with self._lock:
            return HealthCheckReply(
                status=self._status.get(request.service, UNKNOWN))
