"""Deterministic, seeded fault injection — port of the serving sites of
``dragonfly2_tpu/utils/faultplan.py``.

A :class:`FaultPlan` names injection *sites* and attaches
:class:`FaultRule`\\ s that decide, deterministically from a seed, when a
visit to a site turns into a fault. With no plan installed a site costs
one ``faultplan.ACTIVE is not None`` test. Each site owns a
``random.Random`` derived from ``(seed, site)`` and each (site, rule)
pair its own visit counter, so a site's fault sequence for a fixed visit
order is the same in every run, whatever other sites do.

The serving sites:

======================  =====================================================
site                    where it fires
======================  =====================================================
``infer.model_infer``   ``InferenceService.ModelInfer`` (context = model
                        name): ``STALL`` sleeps ``delay_s``,
                        ``UNAVAILABLE`` and ``DEADLINE`` abort the call
                        with that status
``model.artifact``      the inference service's model download (context =
                        ``<type>:<version>``): ``CORRUPT`` flips tar bytes,
                        ``TRUNCATE`` halves the payload — the load must
                        fail cleanly, memoize the bad version, and keep
                        the previous one serving
``model.weights``       checkpoint params at load (context = model type):
                        ``CORRUPT`` fills the float leaves with NaN,
                        ``SCALE`` zeroes them — a loadable model only the
                        score-batch guards can catch
======================  =====================================================

The transport sites and their helpers (``pool.connect``,
``scheduler.rpc``, ``BodyFilter``, ``RpcFaultProxy``, ``raise_connect``,
``maybe_raise_rpc``) wait for the transport's port.
"""

from __future__ import annotations

import enum
import math
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


class FaultKind(enum.Enum):
    STALL = "stall"                       # injected latency (delay_s)
    CORRUPT = "corrupt"                   # flip bytes / NaN weights
    TRUNCATE = "truncate"                 # payload ends early
    UNAVAILABLE = "unavailable"           # RPC UNAVAILABLE
    DEADLINE = "deadline_exceeded"        # RPC DEADLINE_EXCEEDED
    SCALE = "scale_poison"                # zero model weights at load


@dataclass
class FaultRule:
    """When a site visit becomes a fault.

    ``every_nth`` fires on eligible visits 1×N, 2×N, … (0 = off);
    ``probability`` flips the site's seeded coin per eligible visit;
    ``after``/``until`` bound a time window in seconds since install;
    ``match`` restricts to visits whose context contains the substring;
    ``max_fires`` caps total fires (0 = unlimited). A rule with both
    ``every_nth`` and ``probability`` zero never fires.
    """

    kind: FaultKind
    every_nth: int = 0
    probability: float = 0.0
    after: float = 0.0
    until: float = math.inf
    match: str = ""
    max_fires: int = 0
    delay_s: float = 0.05

    def __post_init__(self) -> None:
        self.visits = 0
        self.fires = 0


class FaultPlan:
    """A named set of injection sites with seeded rules; install with
    :func:`install`, and components consult :data:`ACTIVE`."""

    def __init__(self, seed: int = 0, clock=time.monotonic):
        self.seed = seed
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._rules: Dict[str, List[FaultRule]] = {}
        self._rngs: Dict[str, random.Random] = {}
        self._site_visits: Dict[str, int] = {}
        # Fired faults in order: (site, site_visit_index, kind_value).
        self.history: List[Tuple[str, int, str]] = []

    def add(self, site: str, kind: FaultKind, **kw) -> "FaultPlan":
        """Attach a rule; returns self for chaining."""
        with self._lock:
            self._rules.setdefault(site, []).append(FaultRule(kind, **kw))
            if site not in self._rngs:
                self._rngs[site] = random.Random(f"{self.seed}:{site}")
        return self

    def check(self, site: str, context: str = "") -> Optional[FaultRule]:
        """Count one visit to ``site``; return the rule that fires, or
        None. First matching rule wins (declaration order)."""
        with self._lock:
            rules = self._rules.get(site)
            if not rules:
                return None
            visit = self._site_visits.get(site, 0) + 1
            self._site_visits[site] = visit
            now = self._clock() - self._t0
            rng = self._rngs[site]
            for rule in rules:
                if rule.match and rule.match not in context:
                    continue
                if not (rule.after <= now < rule.until):
                    continue
                if rule.max_fires and rule.fires >= rule.max_fires:
                    continue
                rule.visits += 1
                fired = False
                if rule.every_nth > 0 and rule.visits % rule.every_nth == 0:
                    fired = True
                # The coin is tossed on every eligible visit, so the
                # site's random stream advances the same way whether or
                # not every_nth fired.
                if rule.probability > 0 and rng.random() < rule.probability:
                    fired = True
                if fired:
                    rule.fires += 1
                    self.history.append((site, visit, rule.kind.value))
                    return rule
            return None

    def snapshot(self) -> Dict[str, dict]:
        """Per-site visit and fire counts (per kind)."""
        with self._lock:
            out: Dict[str, dict] = {}
            for site, rules in self._rules.items():
                fires: Dict[str, int] = {}
                for rule in rules:
                    key = rule.kind.value
                    fires[key] = fires.get(key, 0) + rule.fires
                out[site] = {
                    "visits": self._site_visits.get(site, 0),
                    "fires": fires,
                    "total_fires": sum(fires.values()),
                }
            return out


#: The process-wide plan; ``None`` means no site does any work.
ACTIVE: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    global ACTIVE
    ACTIVE = plan
    return plan


def uninstall() -> None:
    global ACTIVE
    ACTIVE = None
