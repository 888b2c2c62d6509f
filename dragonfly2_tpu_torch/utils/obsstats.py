"""Observability-plane counters — the ``/debug/vars`` ``"observability"``
block (beside ``data_plane`` / ``scheduler`` / ``recovery`` / ``serving``).

The tracing pipeline must never take a service down, which means every
one of its failure modes is a silent drop by design — and a silent drop
that is also *uncounted* is invisible. This block makes each one
observable:

- ``spans_recorded`` — spans written through to the local JSONL and/or
  the OTLP exporter (head-sampled, promoted, or written by a tracer
  with no tail sampler).
- ``spans_buffered`` — spans parked in the tail-sampling buffer awaiting
  a keep/drop verdict for their trace.
- ``traces_promoted`` — buffered traces promoted to disk/OTLP because
  their task breached an SLO (slow / failed / degraded-to-source /
  failovered) or matched the head sample.
- ``traces_dropped`` — traces whose buffer was discarded at a clean,
  in-SLO task end (the tail sampler doing its job).
- ``traces_evicted`` — trace buffers evicted because the bounded buffer
  was full (too many concurrent traces; oldest goes first).
- ``spans_truncated`` — spans dropped because ONE trace overflowed its
  per-trace span cap (a pathological task; the kept prefix still
  promotes).
- ``spans_unsampled`` — spans of traces NOBODY promised a verdict for
  (e.g. a traced scheduler receiving announces from untraced daemons),
  dropped outside the head sample instead of buffering forever.
- ``otlp_enqueue_drops`` — spans that could not even be queued for
  export (stuck collector backlog; drop-oldest kept the freshest).
- ``otlp_ship_failures`` — export POSTs that failed (dead/erroring
  collector); each failed batch also counts its spans into
  ``otlp_spans_dropped``.
- ``otlp_spans_exported`` / ``otlp_spans_dropped`` — spans delivered to
  the collector vs lost at the export boundary.

Everything here is a monotonic counter; the Prometheus bridge
(``utils/prombridge.py``) exports the block at ``/metrics`` like every
other registered stats block.
"""

from __future__ import annotations

import threading
from typing import Dict

from dragonfly2_tpu_torch.utils.debugmon import register_debug_var

COUNTER_KEYS = (
    "spans_recorded",
    "spans_buffered",
    "traces_promoted",
    "traces_dropped",
    "traces_evicted",
    "spans_truncated",
    "spans_unsampled",
    "otlp_enqueue_drops",
    "otlp_ship_failures",
    "otlp_spans_exported",
    "otlp_spans_dropped",
)


class ObservabilityStats:
    """Thread-safe counters for one tracing scope. Components default to
    the process-wide :data:`OBS` (what ``/debug/vars`` shows); tests
    inject a fresh instance for hermetic assertions."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {k: 0 for k in COUNTER_KEYS}

    def tick(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counts[key] = self._counts.get(key, 0) + n

    def get(self, key: str) -> int:
        with self._lock:
            return self._counts.get(key, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


#: Process-wide default scope — published as the ``"observability"`` block.
OBS = ObservabilityStats()

register_debug_var("observability", OBS.snapshot)
