"""Deterministic, seeded fault-injection plane.

Recovery code that only magic constants can provoke is recovery code no
test exercises. This module gives every unhappy path a switch: a
:class:`FaultPlan` names injection *sites* (string keys compiled into
the transports — connection pools, the piece downloader, the
back-to-source client, the scheduler RPC adapters, client storage
writes, the inference sidecar) and attaches :class:`FaultRule`\\ s that
decide, deterministically from a seed, when a visit to a site turns
into a fault.

Design rules:

- **No plan installed ⇒ no work.** Hot paths guard with
  ``faultplan.ACTIVE is not None`` — one module-attribute load and an
  identity check; nothing else runs. The ``dataplane`` bench stage is
  the regression witness (ISSUE 5 acceptance: no measurable regression
  with no plan installed).
- **Determinism per site.** Each (site, rule) pair keeps its own visit
  counter, and each site owns a ``random.Random`` derived from
  ``(seed, site)`` — the fault sequence for a fixed visit order is
  bit-identical across runs regardless of what other sites do
  (tests/test_faultplan.py). Under real thread interleaving the
  per-site sequences stay deterministic; only their global order moves.
- **Faults are REAL failures.** An injected fault raises the same
  exception type (or produces the same wire effect) the genuine failure
  would: connect-refused raises ``ConnectionRefusedError`` from the
  dial path, a mid-stream reset raises ``ConnectionResetError`` inside
  the body read, corruption flips a byte the md5 check must catch,
  ``ENOSPC`` surfaces as an ``OSError``-rooted disk-full error, and
  scheduler faults raise ``ServiceError("Unavailable"|
  "DeadlineExceeded")`` — so the recovery code under test is the
  production code, not a test double.

Known injection sites (see docs/CHAOS.md for the full contract):

======================  =====================================================
site                    where it fires
======================  =====================================================
``pool.connect``        fresh dials in the shared ``HTTPConnectionPool`` and
                        ``NativePieceFetcher`` (context = host key / addr)
``piece.body``          parent piece body stream in ``PieceDownloader``
                        (context = parent addr)
``source.body``         back-to-source response body in ``HTTPSourceClient``
                        (context = url)
``tls.handshake``       client-side TLS handshake starts in the async
                        download engine (context = peer addr) — a RESET
                        rule drops the connection mid-handshake, before
                        the session is established
``scheduler.rpc``       ``GrpcSchedulerClient`` sends + the in-process
                        :class:`RpcFaultProxy` (context = method name)
``storage.write``       ``TaskStorage.write_piece`` (context = task id)
``infer.model_infer``   sidecar ``ModelInfer`` (context = model name)
``scheduler.process``   process-level replica kills: the chaos bench's
                        replica supervisor polls :func:`should_kill` per
                        live scheduler replica (context = replica target)
                        and SIGKILLs the one whose visit fires a ``KILL``
                        rule — hard replica death, complementing the
                        RPC-level ``scheduler.rpc`` faults
``daemon.process``      process-level DAEMON kills: the daemon-kill chaos
                        rung polls :func:`should_kill` once a victim
                        daemon's download progress crosses the rung's
                        threshold (context = daemon hostname) and
                        SIGKILLs it mid-write — the failure the durable
                        piece journal + restart-resume path exist for
``model.artifact``      the inference sidecar's model download
                        (context = ``<type>:<version>``): ``CORRUPT``
                        flips tar bytes, ``TRUNCATE`` halves the
                        payload — the load must fail cleanly, memoize
                        the bad version, and keep the previous one
                        serving
``model.weights``       checkpoint params at sidecar load (context =
                        model type): ``CORRUPT`` NaN-poisons the float
                        leaves, ``SCALE`` zeroes them — a perfectly
                        LOADABLE model only the score-batch guards can
                        catch (the poisoned-model mlguard rung's shape)
======================  =====================================================
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
    CONNECT_REFUSED = "connect_refused"   # dial fails (ECONNREFUSED)
    RESET = "reset"                       # mid-stream connection reset
    STALL = "stall"                       # injected latency (delay_s)
    CORRUPT = "corrupt"                   # flip a body byte (md5 must catch)
    TRUNCATE = "truncate"                 # body ends early
    UNAVAILABLE = "unavailable"           # gRPC UNAVAILABLE
    DEADLINE = "deadline_exceeded"        # gRPC DEADLINE_EXCEEDED
    ENOSPC = "enospc"                     # disk full on write
    KILL = "kill"                         # SIGKILL a whole process (bench)
    SCALE = "scale_poison"                # zero model weights at load
    #                                       (collapsed-constant scores)


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

    # mutable per-plan state (visits eligible for THIS rule, fires)
    def __post_init__(self) -> None:
        self.visits = 0
        self.fires = 0


class FaultPlan:
    """A named set of injection sites with seeded rules.

    Install with :func:`install`; components consult :data:`ACTIVE`.
    Thread-safe; one lock — injection is only ever enabled in chaos
    runs, where the lock cost is irrelevant.
    """

    def __init__(self, seed: int = 0, clock=time.monotonic):
        self.seed = seed
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._rules: Dict[str, List[FaultRule]] = {}
        self._rngs: Dict[str, random.Random] = {}
        self._site_visits: Dict[str, int] = {}
        # Fired faults in order: (site, site_visit_index, kind_value) —
        # the bit-identical-sequence witness.
        self.history: List[Tuple[str, int, str]] = []

    def add(self, site: str, kind: FaultKind, **kw) -> "FaultPlan":
        """Attach a rule; returns self for chaining."""
        with self._lock:
            self._rules.setdefault(site, []).append(FaultRule(kind, **kw))
            if site not in self._rngs:
                # Site-scoped RNG: derived from (seed, site) so sites
                # never perturb each other's sequences.
                self._rngs[site] = random.Random(f"{self.seed}:{site}")
        return self

    # -- decision ----------------------------------------------------------

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
                # The coin is tossed for every eligible visit (even when
                # every_nth already fired) so the per-site random stream
                # advances identically whether or not other rules hit.
                if rule.probability > 0 and rng.random() < rule.probability:
                    fired = True
                if fired:
                    rule.fires += 1
                    self.history.append((site, visit, rule.kind.value))
                    return rule
            return None

    # -- observability -----------------------------------------------------

    def snapshot(self) -> Dict[str, dict]:
        """Per-site visit/fire counts (per kind) for bench JSON."""
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


#: The process-wide plan. ``None`` (the default) means every injection
#: check is a single ``is not None`` test — the hot path stays intact.
ACTIVE: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> FaultPlan:
    global ACTIVE
    ACTIVE = plan
    return plan


def uninstall() -> None:
    global ACTIVE
    ACTIVE = None


# ----------------------------------------------------------------------
# Application helpers — turn a fired rule into the real failure shape.
# ----------------------------------------------------------------------


def raise_connect(rule: FaultRule, site: str, context: str = "") -> None:
    """CONNECT_REFUSED → the exception a refused dial raises; STALL
    sleeps then lets the dial proceed."""
    if rule.kind is FaultKind.STALL:
        time.sleep(rule.delay_s)
        return
    if rule.kind is FaultKind.CONNECT_REFUSED:
        raise ConnectionRefusedError(
            111, f"injected connect-refused at {site} ({context})")


class BodyFilter:
    """Applies one body fault to a chunked read stream.

    Call with each chunk read off the wire; returns the (possibly
    corrupted/shortened) chunk, raises ``ConnectionResetError`` for
    RESET, or returns ``b""`` after a TRUNCATE to end the body early —
    each of which the transport's own length/digest validation must
    catch and recover from.
    """

    def __init__(self, rule: FaultRule):
        self.rule = rule
        self._applied = False

    def __call__(self, chunk: bytes) -> bytes:
        kind = self.rule.kind
        if self._applied:
            return b"" if kind is FaultKind.TRUNCATE else chunk
        if not chunk:
            return chunk
        self._applied = True
        if kind is FaultKind.RESET:
            raise ConnectionResetError(
                104, "injected mid-stream connection reset")
        if kind is FaultKind.STALL:
            time.sleep(self.rule.delay_s)
            return chunk
        if kind is FaultKind.CORRUPT:
            mutated = bytearray(chunk)
            mutated[0] ^= 0xFF
            return bytes(mutated)
        if kind is FaultKind.TRUNCATE:
            return chunk[: max(len(chunk) // 2, 1)]
        return chunk


def body_filter(rule: Optional[FaultRule]) -> Optional[BodyFilter]:
    return None if rule is None else BodyFilter(rule)


class FaultingBody:
    """Wrap a response body object, applying a :class:`BodyFilter` to
    every ``read`` — the back-to-source stream shim."""

    def __init__(self, body, rule: FaultRule):
        self._body = body
        self._filter = BodyFilter(rule)

    def read(self, amt: Optional[int] = None) -> bytes:
        return self._filter(self._body.read(amt))

    def close(self) -> None:
        close = getattr(self._body, "close", None)
        if close is not None:
            close()

    def __getattr__(self, name):
        return getattr(self._body, name)


def maybe_raise_rpc(plan: FaultPlan, site: str, context: str = "") -> None:
    """RPC-shaped faults: UNAVAILABLE / DEADLINE_EXCEEDED raise the
    scheduler's ServiceError (what the retry/failover paths key on);
    STALL sleeps; other kinds are ignored at RPC sites."""
    rule = plan.check(site, context)
    if rule is None:
        return
    if rule.kind is FaultKind.STALL:
        time.sleep(rule.delay_s)
        return
    from dragonfly2_tpu_torch.scheduler.service import ServiceError

    if rule.kind is FaultKind.UNAVAILABLE:
        raise ServiceError(
            "Unavailable", f"injected UNAVAILABLE at {site} ({context})")
    if rule.kind is FaultKind.DEADLINE:
        raise ServiceError(
            "DeadlineExceeded",
            f"injected DEADLINE_EXCEEDED at {site} ({context})")


def should_kill(plan: FaultPlan, site: str, context: str = "") -> bool:
    """Process-level site (``scheduler.process``): the supervisor that
    OWNS the child processes polls this per live process; True means the
    visit fired a ``KILL`` rule and the caller must hard-kill the
    process named by ``context``. The decision (which visit fires) is
    seeded like every other site; the kill itself stays with the caller
    because only it holds the Popen handles."""
    rule = plan.check(site, context)
    return rule is not None and rule.kind is FaultKind.KILL


class RpcFaultProxy:
    """Wrap any object (e.g. an in-process ``SchedulerService``) so each
    method call first consults ``scheduler.rpc`` — the chaos bench's way
    of flapping a scheduler the conductor holds by direct reference,
    exercising the SAME site the gRPC adapters compile in."""

    def __init__(self, target, site: str = "scheduler.rpc"):
        self._target = target
        self._site = site

    def __getattr__(self, name):
        attr = getattr(self._target, name)
        if not callable(attr):
            return attr

        def call(*args, **kwargs):
            plan = ACTIVE
            if plan is not None:
                maybe_raise_rpc(plan, self._site, context=name)
            return attr(*args, **kwargs)

        call.__name__ = name
        return call
