"""Debug/profiling monitor: the pprof + statsview role, Python-native.

Reference counterpart: cmd/dependency/dependency.go:95-130 InitMonitor —
every service can expose net/http/pprof and a live statsview on a flag
port. The TPU-native equivalents here (all stdlib, no signal handlers,
safe on a serving process):

  GET /debug/threads            goroutine-dump analogue: stack of every
                                live Python thread
  GET /debug/profile?seconds=N  sampling profiler: walks
                                sys._current_frames() at ~100 Hz for N
                                seconds and returns hot stacks by count
                                (py-spy's approach, in-process)
  GET /debug/vars               expvar analogue: uptime, rss, gc stats,
                                thread count, python/torch versions
  GET /healthy                  liveness

Port of ``dragonfly2_tpu/utils/debugmon.py``: the same routes and
blocks; ``/debug/vars`` names the torch version where JAX's names jax's.
The device-side profile (JAX's ``profile_dir`` on the train configs) is
not part of this module.
"""

from __future__ import annotations

import gc
import json
import sys
import threading
import time
import traceback
from collections import Counter
from http.server import BaseHTTPRequestHandler
from urllib.parse import parse_qs, urlparse

from dragonfly2_tpu_torch.utils.httpserver import ThreadedHTTPService

_START_TIME = time.time()

# Geo cluster identity of this process ("" = cluster-blind). Set once at
# service startup (cmd/common.init_observability_identity); read by
# process_vars and the Prometheus bridge so every exported block carries
# which site it came from (docs/GEO.md).
_CLUSTER_ID = ""


def set_cluster_id(cluster_id: str) -> None:
    global _CLUSTER_ID
    _CLUSTER_ID = cluster_id or ""


def cluster_id() -> str:
    return _CLUSTER_ID


def thread_dump() -> str:
    """All live threads with their current stacks (the goroutine dump)."""
    names = {t.ident: t for t in threading.enumerate()}
    out = []
    for ident, frame in sorted(sys._current_frames().items()):
        t = names.get(ident)
        label = (f"{t.name} daemon={t.daemon}" if t is not None
                 else "unknown")
        out.append(f"--- thread {ident} ({label}) ---")
        out.append("".join(traceback.format_stack(frame)))
    return "\n".join(out)


def sample_profile(seconds: float, hz: float = 100.0) -> str:
    """Stack-sampling profile across ALL threads (cProfile only sees its
    own thread; sampling sys._current_frames is what py-spy does, minus
    the external process). Returns hot stacks by sample count."""
    me = threading.get_ident()
    counts: Counter = Counter()
    samples = 0
    deadline = time.monotonic() + seconds
    interval = 1.0 / hz
    while time.monotonic() < deadline:
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            stack = []
            f = frame
            while f is not None and len(stack) < 24:
                code = f.f_code
                stack.append(f"{code.co_filename.rsplit('/', 1)[-1]}:"
                             f"{f.f_lineno}:{code.co_name}")
                f = f.f_back
            counts[";".join(reversed(stack))] += 1
        samples += 1
        time.sleep(interval)
    lines = [f"# {samples} sampling rounds over {seconds:.1f}s at ~{hz:.0f}Hz",
             "# count  stack (root;...;leaf)"]
    for stack, count in counts.most_common(50):
        lines.append(f"{count:7d}  {stack}")
    return "\n".join(lines)


# Service-registered live vars (expvar.Publish analogue): name →
# zero-arg callable returning a JSON-serializable value, evaluated per
# /debug/vars request. The inference sidecar registers its
# batcher_stats here so operators can watch per-lane dispatch/coalesce/
# shed counters on a live process, and the client data plane registers
# "data_plane" (client/dataplane.py): requests_saved /
# connections_reused / coalesce_run_p50 / report_rpcs_saved — the
# amortization counters behind the keep-alive pools, range coalescing
# and batched piece reporting (docs/DATAPLANE.md).
_VARS: dict = {}
_VARS_LOCK = threading.Lock()


def register_debug_var(name: str, fn) -> None:
    with _VARS_LOCK:
        _VARS[name] = fn


def registered_debug_vars() -> dict:
    """Snapshot of the registered blocks (name → callable) — the
    Prometheus bridge (utils/prombridge.py) walks this to export every
    stats block a process publishes."""
    with _VARS_LOCK:
        return dict(_VARS)


def process_vars(full: bool = False) -> dict:
    """The base process vars (no registered blocks) — also what the
    Prometheus bridge exports as the ``process`` pseudo-block."""
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
    if full:
        # len(gc.get_objects()) is an O(live heap) stop-the-world scan —
        # hundreds of ms on a 100k-peer scheduler, per poll. Opt-in via
        # /debug/vars?full=1; the default answers from gc.get_count()'s
        # per-generation counters, which are O(1).
        out["gc_objects"] = len(gc.get_objects())
    try:
        import resource

        out["max_rss_kb"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss
    except ImportError:
        pass
    if "torch" in sys.modules:
        out["torch"] = sys.modules["torch"].__version__
    return out


def debug_vars(full: bool = False) -> dict:
    out = process_vars(full=full)
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

            def do_GET(self):
                parsed = urlparse(self.path)
                if parsed.path == "/healthy":
                    return self._send(200, "OK")
                if parsed.path == "/debug/threads":
                    return self._send(200, thread_dump())
                if parsed.path == "/debug/vars":
                    q = parse_qs(parsed.query)
                    full = q.get("full", ["0"])[0] not in ("0", "", "false")
                    return self._send(200, json.dumps(debug_vars(full=full)),
                                      "application/json")
                if parsed.path == "/debug/profile":
                    q = parse_qs(parsed.query)
                    seconds = min(
                        float(q.get("seconds", ["5"])[0]), 60.0)
                    return self._send(200, sample_profile(seconds))
                return self._send(404, "unknown debug route; try "
                                  "/debug/threads /debug/profile "
                                  "/debug/vars")

        super().__init__(Handler, host=host, port=port, name="debug-monitor")
