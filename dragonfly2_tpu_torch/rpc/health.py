"""DF2 health service, auto-mounted on every server — port of
``dragonfly2_tpu/rpc/health.py``.

Plays the role of grpc.health.v1 in the reference's rpcserver shells
(scheduler/rpcserver/rpcserver.go registers health + reflection) with the
DF2 codec's messages. Tracks per-service status; the empty service name
is the whole server. The inference service flips it ``NOT_SERVING``
while a hot-reload grace window is open, so health-aware clients drain
to a replica.
"""

from __future__ import annotations

import threading

from dragonfly2_tpu_torch.rpc.codec import message
from dragonfly2_tpu_torch.rpc.service import MethodKind, ServiceSpec

SERVING = "SERVING"
NOT_SERVING = "NOT_SERVING"
UNKNOWN = "SERVICE_UNKNOWN"


@message("health.CheckRequest")
class HealthCheckRequest:
    service: str = ""


@message("health.CheckReply")
class HealthCheckReply:
    status: str = SERVING


HEALTH_SPEC = ServiceSpec(
    name="df2.health.Health",
    methods={"Check": MethodKind.UNARY_UNARY},
)


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
