"""Prometheus /metrics endpoint for any service.

Reference counterpart: each service's metrics server (scheduler/metrics/
metrics.go New → promhttp mount; client/daemon/metrics, manager, trainer).
Every service owns a private CollectorRegistry so multiple services can
share one process (the single-process test harness and the bench) without
collector-name collisions in prometheus_client's global default registry.
"""

from __future__ import annotations

from http.server import BaseHTTPRequestHandler

from dragonfly2_tpu_torch.utils.prom import CollectorRegistry, generate_latest
from dragonfly2_tpu_torch.utils.prom import CONTENT_TYPE_LATEST

from dragonfly2_tpu_torch.utils.httpserver import ThreadedHTTPService


class MetricsServer(ThreadedHTTPService):
    """Serves ``GET /metrics`` (and ``/healthy``) for one registry."""

    def __init__(self, registry: CollectorRegistry,
                 host: str = "127.0.0.1", port: int = 0):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def do_GET(self):  # noqa: N802
                if self.path.split("?")[0] == "/metrics":
                    body = generate_latest(server.registry)
                    self.send_response(200)
                    self.send_header("Content-Type", CONTENT_TYPE_LATEST)
                elif self.path == "/healthy":
                    body = b"ok"
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                else:
                    body = b"not found"
                    self.send_response(404)
                    self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.registry = registry
        super().__init__(Handler, host=host, port=port, name="metrics")
