"""Debug monitor — port of the expvar half of
``dragonfly2_tpu/utils/debugmon.py``.

Services publish live blocks with :func:`register_debug_var` (a name and
a zero-argument callable returning a JSON-serializable value, evaluated
per request): the serving counters register as ``serving``
(``utils/servingstats.py``), the evaluator counters as ``scheduler``
(``scheduler/controlstats.py``), and the owner of an inference service
registers its ``batcher_stats`` as ``inference_batcher_stats``.
:class:`DebugMonitor` serves them on

  GET /debug/vars     uptime, threads, gc counts, python and torch
                      versions, and every registered block
  GET /healthy        liveness

A process stamped with a geo cluster (:func:`set_cluster_id`, from
``cmd/common.init_observability_identity``) adds a ``cluster`` key. The
JAX package's thread dump, sampling profiler and ``?full=1`` heap count
are not ported.
"""

from __future__ import annotations

import gc
import json
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler
from urllib.parse import urlparse

from dragonfly2_tpu_torch.utils.httpserver import ThreadedHTTPService

_START_TIME = time.time()

# Geo cluster identity of this process ("" = cluster-blind). Set once at
# service startup (cmd/common.init_observability_identity).
_CLUSTER_ID = ""

_VARS: dict = {}
_VARS_LOCK = threading.Lock()


def set_cluster_id(cluster_id: str) -> None:
    global _CLUSTER_ID
    _CLUSTER_ID = cluster_id or ""


def cluster_id() -> str:
    return _CLUSTER_ID


def register_debug_var(name: str, fn) -> None:
    with _VARS_LOCK:
        _VARS[name] = fn


def process_vars() -> dict:
    """The base process vars, without the registered blocks."""
    out = {
        "uptime_seconds": round(time.time() - _START_TIME, 1),
        "threads": threading.active_count(),
        "gc_counts": gc.get_count(),
        "python": sys.version.split()[0],
    }
    if _CLUSTER_ID:
        # Only cluster-labeled processes grow the key: cluster-blind
        # /debug/vars output stays byte-identical.
        out["cluster"] = _CLUSTER_ID
    try:
        import resource

        out["max_rss_kb"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss
    except ImportError:
        pass
    if "torch" in sys.modules:
        out["torch"] = sys.modules["torch"].__version__
    return out


def debug_vars() -> dict:
    out = process_vars()
    with _VARS_LOCK:
        published = list(_VARS.items())
    for name, fn in published:
        try:
            out[name] = fn()
        except Exception as exc:  # noqa: BLE001 — one bad var must not
            out[name] = f"<error: {exc}>"  # take down the whole page
    return out


class DebugMonitor(ThreadedHTTPService):
    """The monitor HTTP shell; bind where only operators can reach."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code: int, body: str,
                      ctype: str = "text/plain") -> None:
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802
                parsed = urlparse(self.path)
                if parsed.path == "/healthy":
                    return self._send(200, "OK")
                if parsed.path == "/debug/vars":
                    return self._send(200, json.dumps(debug_vars()),
                                      "application/json")
                return self._send(404, "unknown debug route; try "
                                  "/debug/vars")

        super().__init__(Handler, host=host, port=port, name="debug-monitor")
