"""HTTP piece upload server — what other peers download pieces from.

Reference counterpart: client/daemon/upload/upload_manager.go:92-188. Route
shape is identical: ``GET /download/{task_prefix}/{task_id}?peerId=...`` with
a single HTTP ``Range`` header selecting the piece bytes, plus
``/metadata/{task_id}`` (the piece-inventory poll) and ``/healthy``.
Rate-limited by a token bucket (the reference uses x/time/rate at :110).

The implementation is the event-loop engine in
:mod:`dragonfly2_tpu_torch.client.upload_async`: a fixed worker-thread count
multiplexing every keep-alive peer connection (the old
``ThreadingHTTPServer`` shell held one OS thread per connection), with
zero-copy bodies — native sendfile → pure-Python ``os.sendfile`` → mmap
chunks → buffered, in that order (docs/DATAPLANE.md has the decision
table). This module keeps the historical import surface:
``UploadServer`` and the route constants.
"""

from __future__ import annotations

from dragonfly2_tpu_torch.client.upload_async import (  # noqa: F401
    ROUTE_DOWNLOAD,
    ROUTE_HEALTHY,
    ROUTE_METADATA,
    SERVE_PATHS,
    AsyncUploadServer,
)

#: The daemon's upload server IS the async engine; the name survives for
#: every existing constructor site (daemon assembly, tests, benches).
UploadServer = AsyncUploadServer
