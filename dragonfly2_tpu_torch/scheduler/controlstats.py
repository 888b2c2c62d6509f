"""Scheduler control-plane counters — the part of
``dragonfly2_tpu/scheduler/controlstats.py`` the evaluators tick.

- ``bad_node_fast`` / ``bad_node_slow`` — ``is_bad_node`` verdicts served
  from the O(1) windowed Welford aggregates vs the numpy-over-history
  path (duck-typed peers without stats).
- ``bad_node_learned`` / ``bad_node_learned_bad`` — verdicts served by
  the learned piece-cost model, and how many of them said "bad".
- ``cost_guard_trips`` / ``cost_fallbacks`` — learned-cost score batches
  or predictions the guard rejected, and decisions or verdicts that fell
  back to the rule evaluator (guard trip or scorer failure).

The ticks are lock-free, as in the reference: each fires once per
candidate inside the filter hot loop, and a rare lost increment is
acceptable for a monitoring counter. :data:`STATS` is published as the
``scheduler`` block on ``/debug/vars`` (``utils/debugmon.py``).
"""

from __future__ import annotations

from typing import Dict

from dragonfly2_tpu_torch.utils.debugmon import register_debug_var

COUNTER_KEYS = (
    "bad_node_fast",
    "bad_node_slow",
    "bad_node_learned",
    "bad_node_learned_bad",
    "cost_guard_trips",
    "cost_fallbacks",
)


class ControlPlaneStats:
    """Evaluator counters for one scheduler scope. Components default to
    the process-wide :data:`STATS`; tests inject a fresh instance."""

    def __init__(self) -> None:
        for key in COUNTER_KEYS:
            setattr(self, key, 0)

    def observe_bad_node(self, *, fast: bool) -> None:
        if fast:
            self.bad_node_fast += 1
        else:
            self.bad_node_slow += 1

    def observe_bad_node_learned(self, *, bad: bool) -> None:
        self.bad_node_learned += 1
        if bad:
            self.bad_node_learned_bad += 1

    def observe_cost_guard_trip(self) -> None:
        self.cost_guard_trips += 1

    def observe_cost_fallback(self) -> None:
        self.cost_fallbacks += 1

    def snapshot(self) -> Dict[str, int]:
        return {key: getattr(self, key) for key in COUNTER_KEYS}


#: Process-wide default scope — published as the ``scheduler`` block.
STATS = ControlPlaneStats()

register_debug_var("scheduler", STATS.snapshot)
