"""OTLP/HTTP span export — traces leave the box like the reference's
Jaeger path (cmd/dependency/dependency.go:263-295 initializes a Jaeger
exporter behind ``--jaeger`` flags; here any OTLP collector works).

Dependency-free by design: this image carries no opentelemetry SDK, and
the OTLP spec admits a JSON encoding over HTTP (the proto3 JSON mapping
of ``ExportTraceServiceRequest``), which stdlib ``urllib`` ships fine.
Spans are enqueued by the tracer's hot path (bounded queue, drop-oldest
— tracing must never apply backpressure to the service), batched by a
daemon thread, and POSTed to ``<endpoint>/v1/traces``. Delivery is
best-effort: a dead collector costs dropped spans and a rate-limited
warning, never a blocked request path.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
import urllib.request
from typing import List

logger = logging.getLogger(__name__)

# OTLP id widths (W3C traceparent): 16-byte trace id, 8-byte span id.
# The in-process tracer mints shorter ids; left-pad for the wire.
_TRACE_ID_HEX = 32
_SPAN_ID_HEX = 16


def _any_value(value):
    """Proto3-JSON ``AnyValue`` for a span attribute."""
    if isinstance(value, bool):
        return {"boolValue": value}
    if isinstance(value, int):
        return {"intValue": str(value)}  # int64 maps to a JSON string
    if isinstance(value, float):
        return {"doubleValue": value}
    return {"stringValue": str(value)}


def _attributes(attrs: dict) -> List[dict]:
    return [{"key": str(k), "value": _any_value(v)}
            for k, v in (attrs or {}).items()]


def record_to_otlp_span(record: dict) -> dict:
    """One tracer JSONL record → one OTLP ``Span`` (proto3 JSON)."""
    start_ns = int(record["start"] * 1e9)
    end_ns = start_ns + int(record.get("duration_ms", 0.0) * 1e6)
    status = record.get("status", "ok")
    if status == "ok":
        otlp_status = {"code": 1}  # STATUS_CODE_OK
    else:
        otlp_status = {"code": 2, "message": status}  # STATUS_CODE_ERROR
    span = {
        "traceId": record["trace_id"].rjust(_TRACE_ID_HEX, "0"),
        "spanId": record["span_id"].rjust(_SPAN_ID_HEX, "0"),
        "name": record["name"],
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(start_ns),
        "endTimeUnixNano": str(end_ns),
        "attributes": _attributes(record.get("attrs")),
        "status": otlp_status,
    }
    if record.get("parent_id"):
        span["parentSpanId"] = record["parent_id"].rjust(_SPAN_ID_HEX, "0")
    return span


def spans_to_request(service: str, spans: List[dict]) -> dict:
    """``ExportTraceServiceRequest`` carrying one resource + one scope."""
    return {
        "resourceSpans": [{
            "resource": {"attributes": [{
                "key": "service.name",
                "value": {"stringValue": service},
            }]},
            "scopeSpans": [{
                "scope": {"name": "dragonfly2_tpu_torch.utils.tracing"},
                "spans": spans,
            }],
        }],
    }


class OTLPSpanExporter:
    """Batching background exporter for tracer records."""

    def __init__(self, endpoint: str, service: str,
                 flush_interval: float = 2.0, max_batch: int = 256,
                 max_queue: int = 4096, timeout: float = 5.0, stats=None):
        self.url = endpoint.rstrip("/") + "/v1/traces"
        self.service = service
        self.flush_interval = flush_interval
        self.max_batch = max_batch
        self.timeout = timeout
        # Every drop path ticks the "observability" stats block — a
        # best-effort exporter whose losses are uncounted is invisible.
        if stats is None:
            from dragonfly2_tpu_torch.utils.obsstats import OBS as stats
        self.stats = stats
        self._queue: "queue.Queue[dict]" = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        # Serializes drain+POST so flush() returning means any batch the
        # background thread had in flight has actually been delivered,
        # not just that the queue LOOKED empty while it was being posted.
        self._post_lock = threading.Lock()
        self._last_warn = 0.0
        self.exported = 0
        self.dropped = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="otlp-export")
        self._thread.start()
        # Spans buffered when the process exits would vanish with the
        # daemon thread (short-lived CLIs could export nothing at all);
        # drain them on interpreter shutdown. close() is idempotent and
        # an explicit close() unregisters nothing — the second run is a
        # no-op.
        import atexit

        atexit.register(self.close)

    def enqueue(self, record: dict) -> None:
        try:
            self._queue.put_nowait(record)
        except queue.Full:
            # Drop the OLDEST so a stuck collector keeps the freshest
            # spans, then retry once; losing one is fine either way.
            try:
                self._queue.get_nowait()
                self._queue.put_nowait(record)
            except (queue.Empty, queue.Full):
                pass
            self.dropped += 1
            self.stats.tick("otlp_enqueue_drops")
            self.stats.tick("otlp_spans_dropped")

    def _drain(self) -> List[dict]:
        batch: List[dict] = []
        while len(batch) < self.max_batch:
            try:
                batch.append(self._queue.get_nowait())
            except queue.Empty:
                break
        return batch

    def _post(self, batch: List[dict]) -> None:
        body = json.dumps(spans_to_request(
            self.service, [record_to_otlp_span(r) for r in batch]
        )).encode()
        req = urllib.request.Request(
            self.url, data=body, method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                resp.read()
            self.exported += len(batch)
            self.stats.tick("otlp_spans_exported", len(batch))
        except Exception as exc:  # noqa: BLE001 — best-effort delivery
            self.dropped += len(batch)
            self.stats.tick("otlp_ship_failures")
            self.stats.tick("otlp_spans_dropped", len(batch))
            now = time.monotonic()
            if now - self._last_warn > 60.0:
                self._last_warn = now
                logger.warning("OTLP export to %s failed (%s); dropping "
                               "spans until it recovers", self.url, exc)

    def _flush_once(self) -> None:
        with self._post_lock:
            batch = self._drain()
            if batch:
                self._post(batch)

    def _loop(self) -> None:
        while not self._stop.wait(self.flush_interval):
            self._flush_once()
        # Final flush on close: loop — a single pass posts at most one
        # max_batch, and shutdown must drain everything queued.
        while not self._queue.empty():
            self._flush_once()

    def flush(self, timeout: float = 5.0) -> None:
        """Synchronously export everything queued. The first pass also
        waits out any batch the background thread already drained but
        has not finished POSTing — "flushed" means delivered."""
        deadline = time.monotonic() + timeout
        while True:
            self._flush_once()
            if self._queue.empty() or time.monotonic() >= deadline:
                return

    def close(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        self._thread.join(timeout=self.flush_interval + self.timeout + 1)
