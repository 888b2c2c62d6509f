"""Distributed span tracing for the control plane.

Reference counterpart: the otel/jaeger plumbing in
cmd/dependency/dependency.go:263-295 (tracer init), the otelgrpc stats
handlers on every pkg/rpc client, and explicit spans in the peer engine
(peertask_conductor.go:255 SpanRegisterTask). TPU-native rebuild keeps the
shape but not the dependency: spans are JSONL records written through a
size-rotated file (jaeger has no collector in this image; the records
carry the same trace/span/parent ids so any OTLP shipper can forward
them), and trace context propagates across processes in gRPC invocation
metadata (``df2-trace``), mirroring W3C traceparent.

Usage::

    tracer = Tracer("scheduler", out_dir="/var/log/df2")
    with tracer.span("schedule", peer_id=pid):
        ...

A disabled tracer (no out_dir) costs one contextvar lookup per span.

Tail-based sampling (docs/OBSERVABILITY.md): pass a
:class:`TailSampler` and spans buffer in bounded memory per trace id
instead of writing eagerly. A small head-sampled fraction (chosen
deterministically from the trace id, so every process in the swarm
agrees without coordination) still writes through; everything else
waits for the task's verdict — ``promote_trace`` ships the buffer when
the task breached an SLO (slow / failed / degraded-to-source /
failovered), ``finish_trace`` discards it on a clean end. Every drop
path is counted in the ``"observability"`` stats block.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import json
import os
import secrets
import threading
import time
from typing import Iterator, List, Optional, Tuple

_current: contextvars.ContextVar[Optional[Tuple[str, str]]] = \
    contextvars.ContextVar("df2_trace", default=None)

TRACE_METADATA_KEY = "df2-trace"


def current_trace_context() -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) of the active span, if any."""
    return _current.get()


def adopt_trace_context(ctx: Optional[Tuple[str, str]]) -> None:
    """Bind a captured trace context to THIS thread.

    Worker/timer threads start with a fresh contextvar context, so a
    conductor that fans work out must hand its (trace_id, span_id) to
    each thread explicitly; a ``None`` ctx is a no-op so callers can
    pass through whatever :func:`current_trace_context` returned."""
    if ctx is not None:
        _current.set(ctx)


def inject_metadata(metadata: list) -> list:
    """Append the active trace context as gRPC invocation metadata."""
    ctx = _current.get()
    if ctx is not None:
        metadata = list(metadata) + [(TRACE_METADATA_KEY,
                                      f"{ctx[0]}-{ctx[1]}")]
    return metadata


def extract_metadata(invocation_metadata) -> Optional[Tuple[str, str]]:
    for key, value in invocation_metadata or ():
        if key == TRACE_METADATA_KEY and "-" in value:
            trace_id, _, span_id = value.partition("-")
            return trace_id, span_id
    return None


class TailSampler:
    """Bounded in-memory tail-sampling buffer for one tracer.

    - ``head_fraction`` of traces write through immediately (the
      decision is a pure function of the trace id: every service in the
      swarm samples the SAME traces with zero coordination).
    - Everything else buffers per trace id, bounded two ways:
      ``max_traces`` concurrent trace buffers (oldest evicted, counted)
      and ``max_spans_per_trace`` spans each (overflow truncated,
      counted — the kept prefix still promotes).
    - ``promote(trace_id, reason)`` returns the buffered spans for the
      tracer to write (task breached an SLO); later spans of a promoted
      trace write through directly.
    - ``finish(trace_id)`` drops the buffer (clean, in-SLO task end).

    ``slow_slo_s`` is carried here so every layer that owns a terminal
    event (conductor, announce stream, bench) agrees on what "slow"
    means for this process.
    """

    def __init__(self, head_fraction: float = 0.05, max_traces: int = 512,
                 max_spans_per_trace: int = 512, slow_slo_s: float = 30.0,
                 class_slos=None, stats=None):
        self.head_fraction = max(0.0, min(1.0, head_fraction))
        self.max_traces = max(1, int(max_traces))
        self.max_spans_per_trace = max(1, int(max_spans_per_trace))
        self.slow_slo_s = slow_slo_s
        #: Per-traffic-class SLO overrides (seconds): an interactive
        #: task blown past ITS bound is tail-promoted even when it is
        #: nowhere near the process-wide slow_slo_s.
        self.class_slos = dict(class_slos or {})
        if stats is None:
            from dragonfly2_tpu_torch.utils.obsstats import OBS as stats
        self.stats = stats
        self._lock = threading.Lock()
        self._buffers: "collections.OrderedDict[str, List[dict]]" = \
            collections.OrderedDict()
        # Promoted trace ids (bounded: a long-running process promotes
        # traces forever; oldest marks age out once the trace is over).
        self._promoted: "collections.OrderedDict[str, str]" = \
            collections.OrderedDict()
        # Traces somebody PROMISED a verdict for (conductor root /
        # announce stream): only these buffer. A span of an unexpected
        # trace — e.g. a traced scheduler receiving announces from
        # untraced daemons, every span a fresh orphan trace id — would
        # otherwise buffer forever awaiting an impossible verdict, and
        # its churn would evict the genuine in-flight buffers.
        self._expected: "collections.OrderedDict[str, bool]" = \
            collections.OrderedDict()

    def slo_for(self, traffic_class: str) -> float:
        """The slow-verdict SLO for one traffic class ('' / unknown →
        the process-wide ``slow_slo_s``)."""
        return self.class_slos.get(traffic_class, self.slow_slo_s)

    # -- head sampling -----------------------------------------------------

    def head_sampled(self, trace_id: str) -> bool:
        """Deterministic: the same trace id samples identically in every
        process (trace ids are random hex, so the leading 32 bits are a
        uniform draw)."""
        if self.head_fraction <= 0.0:
            return False
        if self.head_fraction >= 1.0:
            return True
        try:
            draw = int(trace_id[:8], 16) / 0xFFFFFFFF
        except ValueError:
            return False
        return draw < self.head_fraction

    # -- buffer side -------------------------------------------------------

    def expect(self, trace_id: str) -> None:
        """Promise a verdict (``promote`` or ``finish``) for the trace —
        its spans may buffer. Called by the verdict owners: the
        conductor's root span and the scheduler's announce stream."""
        with self._lock:
            while len(self._expected) >= 4 * self.max_traces:
                self._expected.popitem(last=False)
            self._expected[trace_id] = True

    def offer(self, record: dict) -> bool:
        """True = the tracer should write the record through now; False =
        buffered / truncated awaiting the trace verdict, or dropped (a
        span of a trace nobody promised a verdict for, outside the head
        sample)."""
        trace_id = record["trace_id"]
        if self.head_sampled(trace_id):
            return True
        with self._lock:
            if trace_id in self._promoted:
                record.setdefault("tail", self._promoted[trace_id])
                return True
            buf = self._buffers.get(trace_id)
            if buf is None:
                if trace_id not in self._expected:
                    drop = True
                else:
                    drop = False
                    while len(self._buffers) >= self.max_traces:
                        self._buffers.popitem(last=False)
                        self.stats.tick("traces_evicted")
                    buf = self._buffers[trace_id] = []
                if drop:
                    self.stats.tick("spans_unsampled")
                    return False
            if len(buf) >= self.max_spans_per_trace:
                self.stats.tick("spans_truncated")
                return False
            buf.append(record)
        self.stats.tick("spans_buffered")
        return False

    def promote(self, trace_id: str, reason: str) -> List[dict]:
        """Mark the trace kept; returns the buffered spans to write
        (stamped with the keep reason). Idempotent."""
        with self._lock:
            already = trace_id in self._promoted
            if not already:
                while len(self._promoted) >= 4 * self.max_traces:
                    self._promoted.popitem(last=False)
                self._promoted[trace_id] = reason
            buf = self._buffers.pop(trace_id, [])
        if not already:
            self.stats.tick("traces_promoted")
        for record in buf:
            record.setdefault("tail", reason)
        return buf

    def finish(self, trace_id: str) -> None:
        """The trace ended within SLO: discard its buffer and retire
        the expectation. A PROMOTED mark deliberately survives (it is
        bounded by promote()'s own eviction): spans of a kept trace
        that close after the stream's finish — the rpc-layer stream
        span, a straggler report — must still write through."""
        with self._lock:
            buf = self._buffers.pop(trace_id, None)
            self._expected.pop(trace_id, None)
        if buf is not None:
            self.stats.tick("traces_dropped")

    def is_promoted(self, trace_id: str) -> bool:
        with self._lock:
            return trace_id in self._promoted

    def buffered_traces(self) -> int:
        with self._lock:
            return len(self._buffers)


class Tracer:
    """Per-service span recorder: rotated JSONL locally, and — when
    ``otlp_endpoint`` is set — OTLP/HTTP export to a collector, the role
    the reference's Jaeger exporter plays (dependency.go:263-295).
    Export is off by default and never blocks or fails a span."""

    def __init__(self, service: str, out_dir: str = "",
                 max_bytes: int = 32 * 1024 * 1024, backups: int = 2,
                 otlp_endpoint: str = "", sampler: TailSampler | None = None,
                 stats=None, cluster: str = ""):
        self.service = service
        #: Geo cluster of the emitting process (docs/GEO.md); when set,
        #: every record carries a ``cluster`` field so multi-site trace
        #: stores can tell which side of the WAN a span ran on.
        self.cluster = cluster
        self.enabled = bool(out_dir) or bool(otlp_endpoint)
        self.sampler = sampler
        self._lock = threading.Lock()
        self._path = (os.path.join(out_dir, f"trace-{service}.jsonl")
                      if out_dir else "")
        self.max_bytes = max_bytes
        self.backups = backups
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        self._stats = stats
        if self._stats is None and self.enabled:
            from dragonfly2_tpu_torch.utils.obsstats import OBS

            self._stats = OBS
        self._otlp = None
        if otlp_endpoint:
            from dragonfly2_tpu_torch.utils.otlp import OTLPSpanExporter

            self._otlp = OTLPSpanExporter(otlp_endpoint, service,
                                          stats=self._stats)

    @contextlib.contextmanager
    def span(self, name: str, *, remote_parent: Tuple[str, str] | None = None,
             links: List[Tuple[str, str]] | None = None,
             **attrs) -> Iterator[dict]:
        if not self.enabled:
            yield {}
            return
        parent = remote_parent or _current.get()
        trace_id = parent[0] if parent else secrets.token_hex(8)
        span_id = secrets.token_hex(4)
        record = {
            "trace_id": trace_id,
            "span_id": span_id,
            "parent_id": parent[1] if parent else "",
            "service": self.service,
            "name": name,
            "start": time.time(),
            "attrs": attrs,
            "status": "ok",
        }
        if self.cluster:
            record["cluster"] = self.cluster
        if links:
            # OTel span links: e.g. a report batch pointing at the piece
            # spans whose reports it carries.
            record["links"] = [{"trace_id": t, "span_id": s}
                               for t, s in links]
        token = _current.set((trace_id, span_id))
        t0 = time.perf_counter()
        try:
            yield record
        except BaseException as exc:
            record["status"] = f"error: {type(exc).__name__}"
            raise
        finally:
            _current.reset(token)
            record["duration_ms"] = round(
                (time.perf_counter() - t0) * 1e3, 3)
            self._sink(record)

    def emit(self, name: str, *, start: float, duration_s: float,
             parent: Tuple[str, str] | None = None, status: str = "ok",
             **attrs) -> None:
        """Record a span RETROSPECTIVELY — for intervals only known
        after the fact (e.g. schedule-wait: registration → first
        decision), where no code block exists to wrap. ``start`` is a
        ``time.time()`` stamp; the span parents under ``parent`` (or
        the calling thread's active span)."""
        if not self.enabled:
            return
        parent = parent or _current.get()
        record = {
            "trace_id": parent[0] if parent else secrets.token_hex(8),
            "span_id": secrets.token_hex(4),
            "parent_id": parent[1] if parent else "",
            "service": self.service,
            "name": name,
            "start": start,
            "attrs": attrs,
            "status": status,
            "duration_ms": round(duration_s * 1e3, 3),
        }
        if self.cluster:
            record["cluster"] = self.cluster
        self._sink(record)

    # -- tail-sampling surface --------------------------------------------

    def expect_trace(self, trace_id: str) -> None:
        """Promise this trace a tail verdict so its spans may buffer
        (no sampler / disabled = nothing to do)."""
        if self.enabled and self.sampler is not None and trace_id:
            self.sampler.expect(trace_id)

    def promote_trace(self, trace_id: str, reason: str) -> None:
        """Ship everything buffered for the trace (SLO breach) and write
        its later spans through. No sampler = spans already written."""
        if not self.enabled or self.sampler is None or not trace_id:
            return
        for record in self.sampler.promote(trace_id, reason):
            self._write(record)

    def finish_trace(self, trace_id: str) -> None:
        """Discard the trace's buffer — it ended within SLO."""
        if not self.enabled or self.sampler is None or not trace_id:
            return
        self.sampler.finish(trace_id)

    def _sink(self, record: dict) -> None:
        if self.sampler is not None and not self.sampler.offer(record):
            return
        self._write(record)

    def _write(self, record: dict) -> None:
        if self._stats is not None:
            self._stats.tick("spans_recorded")
        if self._otlp is not None:
            self._otlp.enqueue(record)
        if not self._path:
            return
        line = json.dumps(record, separators=(",", ":")) + "\n"
        with self._lock:
            try:
                if (os.path.exists(self._path)
                        and os.path.getsize(self._path) > self.max_bytes):
                    self._rotate()
                with open(self._path, "a") as f:
                    f.write(line)
            except OSError:
                pass  # tracing must never take the service down

    def flush(self) -> None:
        """Push any queued OTLP spans out now (shutdown / tests)."""
        if self._otlp is not None:
            self._otlp.flush()

    def close(self) -> None:
        if self._otlp is not None:
            self._otlp.close()

    def _rotate(self) -> None:
        for i in range(self.backups - 1, 0, -1):
            src = f"{self._path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self._path}.{i + 1}")
        os.replace(self._path, f"{self._path}.1")


def promote_current_trace(reason: str) -> None:
    """Promote the ACTIVE trace on the default tracer (SLO breach seen
    from inside the traced code path). Zero work when tracing is off."""
    tracer = _default
    if not tracer.enabled:
        return
    ctx = _current.get()
    if ctx is not None:
        tracer.promote_trace(ctx[0], reason)


_NOOP = Tracer("noop")
_default = _NOOP


def set_default_tracer(tracer: Tracer) -> None:
    global _default
    _default = tracer


def default_tracer() -> Tracer:
    return _default
