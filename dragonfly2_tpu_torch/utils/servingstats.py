"""ML serving-health counters — port of
``dragonfly2_tpu/utils/servingstats.py``.

The ML scheduling loop degrades to rules in several places (a failing
scorer, guard-tripped score batches); these counters let an operator
tell "model live" from "fleet silently rule-falling-back". Components
default to the process-wide :data:`SERVING` scope; tests inject a fresh
instance. The keys are the reference's, so both packages' snapshots
compare key for key: ``MLEvaluator`` ticks the ``ml_*`` keys, the
inference service the reload, shadow and canary keys, and the manager's
model registry the validation, quarantine, rollback and promotion keys.
:data:`SERVING` is published as the ``serving`` block on
``/debug/vars`` (``utils/debugmon.py``).
"""

from __future__ import annotations

import threading
from typing import Dict

from dragonfly2_tpu_torch.utils.debugmon import register_debug_var

COUNTER_KEYS = (
    "ml_scored",
    "ml_fallbacks",
    "ml_sheds",
    "ml_guard_trips",
    "ml_quarantines_reported",
    "model_reload_failures",
    "shadow_batches",
    "shadow_probe_batches",
    "shadow_guard_trips",
    "canary_promotions",
    "canary_rollbacks",
    "model_validation_rejections",
    "model_quarantines",
    "model_rollbacks",
    "models_promoted",
)


class ServingStats:
    """Thread-safe ML serving-health counters for one scope."""

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


#: Process-wide default scope — published as the ``serving`` block.
SERVING = ServingStats()

register_debug_var("serving", SERVING.snapshot)
