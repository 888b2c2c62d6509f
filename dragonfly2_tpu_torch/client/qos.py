"""Multi-tenant QoS: traffic classes + weighted-fair admission primitives.

A production fleet serves interactive container pulls, bulk checkpoint
fan-out and background preheat CONCURRENTLY, and every admission point
used to be a class-blind daemon-wide FIFO — one bulk tenant could push
interactive p99 off a cliff. This module is the shared core the three
arbitration loops build on (docs/QOS.md):

- :class:`QosPolicy` — the per-daemon class model: class → weight,
  optional per-class admission floors, the default class for unlabeled
  work, and the per-class park-queue bound (overflow = shed). A daemon
  with no policy configured is CLASS-BLIND and must pay zero overhead
  (the faultplan ACTIVE-is-None discipline): every gate keeps its
  original single-queue path when its policy reference is None.
- :class:`ClassQueues` — per-class parked-item deques with a
  smooth-weighted-round-robin pick (the deficit/credit form of DRR for
  unit-cost items) and floor-aware headroom: a class below its floor
  always has reserved headroom, so interactive never waits behind a
  full bulk backlog. NOT thread-safe by design — each gate serializes
  it under the admission lock it already owns.
- :class:`LatencyRing` — bounded p50/p99 sample ring (the
  controlstats ring shape) for queued-wait and per-class latency.
- :class:`QosStats` — the process-wide ``"qos"`` /debug/vars block:
  admitted/parked/shed per class per side, queued-wait rings, per-class
  shaper grants and allocated rates, per-class task latency. The
  Prometheus bridge flattens the nested dicts to
  ``df2_qos_<side>_<counter>_<class>`` gauges for free.

Identity plumbing (CLI → daemon → conductor → ``register_peer`` →
scheduler) carries ``traffic_class`` and an optional ``tenant`` id;
piece GETs tag ``X-Df2-Class`` / ``X-Df2-Tenant`` request headers so
the UPLOAD side of a class-aware peer can classify at request time.
"""

from __future__ import annotations

import collections
import sys
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from dragonfly2_tpu_torch.utils.debugmon import register_debug_var
from dragonfly2_tpu_torch.utils.percentile import percentile

CLASS_INTERACTIVE = "interactive"
CLASS_BULK = "bulk"
CLASS_BACKGROUND = "background"

#: The documented class ladder (docs/QOS.md). Policies may add tenant-
#: specific classes; these are the conventional three.
KNOWN_CLASSES = (CLASS_INTERACTIVE, CLASS_BULK, CLASS_BACKGROUND)

#: Default weights when a policy is enabled without an explicit spec:
#: interactive dominates, background scavenges.
DEFAULT_WEIGHTS: Dict[str, float] = {
    CLASS_INTERACTIVE: 8.0, CLASS_BULK: 3.0, CLASS_BACKGROUND: 1.0,
}

#: Request headers the download side tags piece GETs with so the serving
#: peer's upload gate can classify the stream (upload_async._route).
CLASS_HEADER = "x-df2-class"
TENANT_HEADER = "x-df2-tenant"

#: Per-class park-queue bound on the upload gate (overflow → 503 shed).
DEFAULT_SHED_LIMIT = 512


def parse_class_map(spec: str, *, what: str = "class map") -> Dict[str, float]:
    """``"interactive=8,bulk=3,background=1"`` → {class: value}.

    Raises ``ValueError`` with a usable message on malformed entries —
    the CLI surfaces it via ``parser.error``.
    """
    out: Dict[str, float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, val = part.partition("=")
        name = name.strip()
        if not sep or not name:
            raise ValueError(
                f"malformed {what} entry {part!r} (want name=value)")
        try:
            value = float(val.strip())
        except ValueError:
            raise ValueError(
                f"malformed {what} value {part!r} (want a number)") from None
        if value <= 0:
            raise ValueError(f"{what} value must be > 0 in {part!r}")
        out[sys.intern(name)] = value
    return out


class QosPolicy:
    """The per-daemon traffic-class model. Immutable after build; shared
    by the upload gate, the download engine, the shaper and the
    conductor plumbing of one daemon."""

    __slots__ = ("weights", "floors", "default_class", "shed_limit")

    def __init__(self, weights: "Dict[str, float] | None" = None,
                 floors: "Dict[str, int] | None" = None,
                 default_class: str = CLASS_BULK,
                 shed_limit: int = DEFAULT_SHED_LIMIT):
        self.weights: Dict[str, float] = dict(weights or DEFAULT_WEIGHTS)
        if default_class not in self.weights:
            self.weights[default_class] = 1.0
        self.floors: Dict[str, int] = {
            k: int(v) for k, v in (floors or {}).items() if int(v) > 0}
        self.default_class = sys.intern(default_class)
        self.shed_limit = max(1, int(shed_limit))

    def normalize(self, traffic_class: str) -> str:
        """Map an arbitrary wire/CLI class to a policy class: known
        classes pass through (interned), everything else lands on the
        default class — an unknown label must degrade to a share, not a
        KeyError on the hot path."""
        if traffic_class in self.weights:
            return sys.intern(traffic_class)
        return self.default_class

    def weight(self, traffic_class: str) -> float:
        return self.weights.get(traffic_class, 1.0)

    def floor(self, traffic_class: str) -> int:
        return self.floors.get(traffic_class, 0)

    @classmethod
    def from_specs(cls, weights: str = "", floors: str = "",
                   default_class: str = "",
                   shed_limit: int = DEFAULT_SHED_LIMIT,
                   ) -> "Optional[QosPolicy]":
        """Build from the CLI/config string knobs; None when the weights
        spec is empty — the daemon stays class-blind (zero-overhead
        default path)."""
        if not weights.strip():
            return None
        wmap = parse_class_map(weights, what="qos class weights")
        fmap = {k: int(v) for k, v in parse_class_map(
            floors, what="qos class floors").items()} if floors.strip() \
            else {}
        default = default_class.strip() or CLASS_BULK
        return cls(weights=wmap, floors=fmap, default_class=default,
                   shed_limit=shed_limit)


class ClassQueues:
    """Per-class parked-item deques + smooth-WRR pick with per-class
    admission floors.

    The pick is the unit-cost form of deficit round robin: every
    non-empty eligible class accrues credit equal to its weight per
    pick round, the highest-credit class wins and pays the round's
    total weight — long-run dequeue rates converge to the weight
    ratios without bursts (the nginx smooth-WRR property).

    Floors reserve headroom inside the shared slot budget: class ``c``
    with ``floor(c) = f`` always finds ``f`` slots that bulk backlog
    cannot occupy, so an arriving interactive stream is admitted
    immediately instead of queueing behind a saturated bulk class.
    Floors never push the total over capacity (they carve the existing
    budget), so ``sum(floors) < capacity`` is the operator's contract.

    NOT thread-safe: callers hold their own admission lock around every
    method (the download engine's ``_lock``, the upload server's
    admission lock).
    """

    __slots__ = ("policy", "bound", "_queues", "_credit")

    def __init__(self, policy: QosPolicy, *, bound: int = 0):
        self.policy = policy
        #: Per-class park bound; 0 = unbounded (download engine keeps
        #: the historical unbounded park, the upload gate sheds).
        self.bound = bound
        self._queues: "Dict[str, collections.deque]" = {}
        self._credit: Dict[str, float] = {}

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def backlog(self, traffic_class: str) -> int:
        q = self._queues.get(traffic_class)
        return len(q) if q else 0

    def counts(self) -> Dict[str, int]:
        return {k: len(q) for k, q in self._queues.items() if q}

    def push(self, traffic_class: str, item) -> bool:
        """Park ``item``; False = the class queue is full (shed it)."""
        q = self._queues.get(traffic_class)
        if q is None:
            q = self._queues[traffic_class] = collections.deque()
        if self.bound > 0 and len(q) >= self.bound:
            return False
        q.append(item)
        return True

    def headroom(self, traffic_class: str, inservice: Dict[str, int],
                 capacity: int) -> bool:
        """May one more ``traffic_class`` stream be admitted given the
        per-class in-service counts? True while the class is below its
        floor (its reserved lane) or while free capacity remains after
        honoring every OTHER class's unmet floor."""
        total = sum(inservice.values())
        if total >= capacity:
            return False
        if inservice.get(traffic_class, 0) < self.policy.floor(traffic_class):
            return True
        reserved = sum(
            max(0, f - inservice.get(c, 0))
            for c, f in self.policy.floors.items() if c != traffic_class)
        return total < capacity - reserved

    def pick(self, inservice: Dict[str, int],
             capacity: int) -> "Optional[Tuple[str, object]]":
        """Dequeue the next parked item a freed slot should admit, or
        None (nothing parked / nothing eligible). Floor-deficit classes
        outrank the weighted rotation — the reserved lane drains first."""
        candidates = [c for c, q in self._queues.items() if q]
        if not candidates:
            return None
        pool = [c for c in candidates
                if inservice.get(c, 0) < self.policy.floor(c)]
        if not pool:
            pool = [c for c in candidates
                    if self.headroom(c, inservice, capacity)]
        if not pool:
            return None
        total = 0.0
        for c in pool:
            total += self.policy.weight(c)
            self._credit[c] = self._credit.get(c, 0.0) + self.policy.weight(c)
        chosen = max(pool, key=lambda c: (self._credit.get(c, 0.0), c))
        self._credit[chosen] = self._credit.get(chosen, 0.0) - total
        return chosen, self._queues[chosen].popleft()

    def remove(self, traffic_class: str, item) -> bool:
        """Withdraw a parked item (cancelled op / vanished connection)."""
        q = self._queues.get(traffic_class)
        if not q:
            return False
        try:
            q.remove(item)
        except ValueError:
            return False
        return True

    def drain(self) -> List[object]:
        out: List[object] = []
        for q in self._queues.values():
            out.extend(q)
            q.clear()
        return out


class LatencyRing:
    """Bounded sample ring with p50/p99 readout (controlstats shape)."""

    __slots__ = ("_vals", "count")

    def __init__(self, maxlen: int = 2048):
        self._vals: deque = deque(maxlen=maxlen)
        self.count = 0

    def add(self, v: float) -> None:
        self._vals.append(v)
        self.count += 1

    def percentiles(self) -> "Tuple[float, float]":
        vals = sorted(self._vals)
        return percentile(vals, 0.50), percentile(vals, 0.99)


class _SideStats:
    """One admission gate's per-class counters + queued-wait ring."""

    __slots__ = ("admitted", "parked", "shed", "abandoned", "wait_ms",
                 "wait_by_class")

    def __init__(self) -> None:
        self.admitted: Dict[str, int] = {}
        self.parked: Dict[str, int] = {}
        self.shed: Dict[str, int] = {}
        self.abandoned: Dict[str, int] = {}
        self.wait_ms = LatencyRing(2048)
        self.wait_by_class: Dict[str, LatencyRing] = {}


class QosStats:
    """Thread-safe per-class QoS counters for one process scope.

    Components default to the process-wide :data:`QOS` instance (what
    ``/debug/vars`` publishes as ``"qos"``); benches and tests inject a
    fresh instance for hermetic assertions.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sides: Dict[str, _SideStats] = {
            "download": _SideStats(), "upload": _SideStats()}
        self.shaper_grant_bytes: Dict[str, int] = {}
        self.shaper_rate_bps: Dict[str, float] = {}
        self._task_ms: Dict[str, LatencyRing] = {}
        self.tasks_done: Dict[str, int] = {}

    # -- admission-gate ticks ---------------------------------------------

    def admission(self, side: str, traffic_class: str, outcome: str) -> None:
        """One admission verdict: ``admitted`` / ``parked`` / ``shed`` /
        ``abandoned`` (parked stream whose peer vanished)."""
        klass = traffic_class or "default"
        with self._lock:
            counters = getattr(self._sides[side], outcome)
            counters[klass] = counters.get(klass, 0) + 1

    def observe_wait(self, side: str, traffic_class: str, ms: float) -> None:
        """Park → admission latency of one queued stream — the number
        the QoS gate actually bounds."""
        klass = traffic_class or "default"
        with self._lock:
            s = self._sides[side]
            s.wait_ms.add(ms)
            ring = s.wait_by_class.get(klass)
            if ring is None:
                ring = s.wait_by_class[klass] = LatencyRing(1024)
            ring.add(ms)

    # -- shaper ticks ------------------------------------------------------

    def shaper_grant(self, traffic_class: str, nbytes: int) -> None:
        with self._lock:
            self.shaper_grant_bytes[traffic_class] = \
                self.shaper_grant_bytes.get(traffic_class, 0) + nbytes

    def shaper_rate(self, traffic_class: str, rate_bps: float) -> None:
        with self._lock:
            self.shaper_rate_bps[traffic_class] = round(rate_bps, 1)

    # -- task latency ------------------------------------------------------

    def task_done(self, traffic_class: str, ms: float) -> None:
        with self._lock:
            self.tasks_done[traffic_class] = \
                self.tasks_done.get(traffic_class, 0) + 1
            ring = self._task_ms.get(traffic_class)
            if ring is None:
                ring = self._task_ms[traffic_class] = LatencyRing(2048)
            ring.add(ms)

    def task_p99_ms(self, traffic_class: str) -> float:
        with self._lock:
            ring = self._task_ms.get(traffic_class)
            return ring.percentiles()[1] if ring is not None else 0.0

    # -- read side ---------------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = {}
            for side, s in self._sides.items():
                p50, p99 = s.wait_ms.percentiles()
                out[side] = {
                    "admitted": dict(s.admitted),
                    "parked": dict(s.parked),
                    "shed": dict(s.shed),
                    "abandoned": dict(s.abandoned),
                    "queued_wait_ms_p50": round(p50, 3),
                    "queued_wait_ms_p99": round(p99, 3),
                    "queued_waits": s.wait_ms.count,
                    "wait_ms_p99_by_class": {
                        k: round(r.percentiles()[1], 3)
                        for k, r in s.wait_by_class.items()},
                }
            out["shaper_grant_bytes"] = dict(self.shaper_grant_bytes)
            out["shaper_rate_bps"] = dict(self.shaper_rate_bps)
            out["tasks_done"] = dict(self.tasks_done)
            out["task_ms_p50"] = {
                k: round(r.percentiles()[0], 3)
                for k, r in self._task_ms.items()}
            out["task_ms_p99"] = {
                k: round(r.percentiles()[1], 3)
                for k, r in self._task_ms.items()}
            return out


#: Process-wide default scope — published as the "qos" /debug/vars
#: block next to data_plane / scheduler / recovery.
QOS = QosStats()

register_debug_var("qos", QOS.snapshot)


def class_request_headers(traffic_class: str, tenant: str = "") -> str:
    """Wire-format header lines (CRLF-terminated) tagging a piece GET
    with its traffic class, '' when class-blind — zero bytes added to
    the default path."""
    if not traffic_class:
        return ""
    lines = f"X-Df2-Class: {traffic_class}\r\n"
    if tenant:
        lines += f"X-Df2-Tenant: {tenant}\r\n"
    return lines
