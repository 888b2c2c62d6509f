"""Race checking — the repo's analogue of Go's ``-race`` test mode.

Reference counterpart: SURVEY §5 race detection. The reference leans on
Go's ``-race`` test mode (compiler-inserted happens-before tracking);
CPython has no equivalent, and the repo's stance is layered:

1. Churn/stress tests hammer the concurrent structures
   (tests/test_churn_stress.py) so schedule-dependent bugs get many
   chances to fire.
2. :class:`LockOrderAuditor` proves DEADLOCK-freedom structurally —
   every lock acquisition is recorded into a global lock-ORDER graph,
   and a cycle in that graph is a potential ABBA deadlock even if the
   schedule never actually interleaved badly during the run. One pass
   over any schedule certifies all schedules over the same edges.
3. :class:`RaceDetector` covers the DATA-RACE half with the classic
   lockset (Eraser) algorithm: every tracked access intersects the
   variable's candidate lockset with the locks the accessing thread
   holds; a write-shared variable whose candidate set goes empty is a
   data race — again regardless of whether this particular schedule
   interleaved the racy accesses. The virgin → exclusive → shared →
   shared-modified state machine suppresses the classic false
   positives (single-thread init, init-then-publish handoff,
   read-only sharing).

Usage (tests)::

    auditor = LockOrderAuditor()
    storage._lock = auditor.wrap(storage._lock, "storage")
    daemon._conductors_lock = auditor.wrap(daemon._conductors_lock,
                                           "daemon.conductors")
    ... run the concurrent workload ...
    auditor.assert_acyclic()        # raises LockOrderViolation w/ cycle

    detector = RaceDetector()               # owns its auditor
    storage._lock = detector.wrap(storage._lock, "storage")
    storage._tasks = detector.wrap_dict(storage._tasks, "storage.tasks")
    ... run the concurrent workload ...
    detector.assert_race_free()             # raises DataRaceViolation

Zero overhead in production: nothing imports this outside tests.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List, Optional, Set, Tuple


class LockOrderViolation(AssertionError):
    """A cycle in the lock-order graph: the witnessed acquisition orders
    admit an interleaving that deadlocks."""

    def __init__(self, cycle: List[str],
                 witnesses: Dict[Tuple[str, str], str]):
        self.cycle = cycle
        lines = [" -> ".join(cycle + cycle[:1])]
        for a, b in zip(cycle, cycle[1:] + cycle[:1]):
            where = witnesses.get((a, b), "")
            lines.append(f"  {a} held while acquiring {b}"
                         + (f" ({where})" if where else ""))
        super().__init__("lock-order cycle:\n" + "\n".join(lines))


class _WrappedLock:
    """Transparent proxy over a Lock/RLock that reports acquisitions to
    the auditor. Supports the context-manager protocol and the plain
    acquire/release/locked surface the codebase uses."""

    def __init__(self, inner, name: str, auditor: "LockOrderAuditor"):
        self._inner = inner
        self._name = name
        self._auditor = auditor

    def acquire(self, *args, **kwargs) -> bool:
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._auditor._on_acquire(self._name)
        return got

    def release(self) -> None:
        self._auditor._on_release(self._name)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class LockOrderAuditor:
    """Global lock-order graph across all threads of the process."""

    def __init__(self):
        self._graph_lock = threading.Lock()
        # name -> set of names acquired WHILE name was held
        self._edges: Dict[str, Set[str]] = defaultdict(set)
        # (a, b) -> thread name that witnessed the edge (diagnostics)
        self._witnesses: Dict[Tuple[str, str], str] = {}
        self._held = threading.local()
        self.acquire_count = 0  # total acquisitions seen (sanity probe)

    def wrap(self, lock, name: str) -> _WrappedLock:
        return _WrappedLock(lock, name, self)

    # -- hooks -----------------------------------------------------------

    def _stack(self) -> List[str]:
        stack = getattr(self._held, "stack", None)
        if stack is None:
            stack = self._held.stack = []
        return stack

    def _on_acquire(self, name: str) -> None:
        self.acquire_count += 1  # benign race: a probe, not a metric
        stack = self._stack()
        if stack:
            holder = stack[-1]
            if holder != name:  # re-entrant RLock acquires are not edges
                with self._graph_lock:
                    if name not in self._edges[holder]:
                        self._edges[holder].add(name)
                        self._witnesses[(holder, name)] = (
                            threading.current_thread().name)
        stack.append(name)

    def _on_release(self, name: str) -> None:
        stack = self._stack()
        # Locks are usually released LIFO, but tolerate out-of-order
        # (hand-over-hand patterns) by removing the newest matching hold.
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    # -- verdicts --------------------------------------------------------

    def edges(self) -> Dict[str, Set[str]]:
        with self._graph_lock:
            return {k: set(v) for k, v in self._edges.items()}

    def find_cycle(self) -> Optional[List[str]]:
        """One cycle in the order graph, or None. Iterative DFS with the
        classic white/grey/black coloring."""
        graph = self.edges()
        WHITE, GREY, BLACK = 0, 1, 2
        color = {n: WHITE for n in
                 set(graph) | {m for vs in graph.values() for m in vs}}
        parent: Dict[str, Optional[str]] = {}
        for root in sorted(color):
            if color[root] != WHITE:
                continue
            stack = [(root, iter(sorted(graph.get(root, ()))))]
            color[root] = GREY
            parent[root] = None
            while stack:
                node, children = stack[-1]
                advanced = False
                for child in children:
                    if color.get(child, WHITE) == WHITE:
                        color[child] = GREY
                        parent[child] = node
                        stack.append(
                            (child, iter(sorted(graph.get(child, ())))))
                        advanced = True
                        break
                    if color.get(child) == GREY:
                        cycle = [child]
                        cursor = node
                        while cursor is not None and cursor != child:
                            cycle.append(cursor)
                            cursor = parent.get(cursor)
                        cycle.reverse()
                        return cycle
                if not advanced:
                    color[node] = BLACK
                    stack.pop()
        return None

    def assert_acyclic(self) -> None:
        cycle = self.find_cycle()
        if cycle is not None:
            with self._graph_lock:
                witnesses = dict(self._witnesses)
            raise LockOrderViolation(cycle, witnesses)

    def held_locks(self) -> frozenset:
        """Locks the CURRENT thread holds right now (for the lockset
        detector). Re-entrant holds collapse; order is irrelevant."""
        return frozenset(self._stack())


# ---------------------------------------------------------------------------
# Lockset (Eraser) data-race detection
# ---------------------------------------------------------------------------

# Per-variable lifecycle states (Savage et al., "Eraser", SOSP '97):
_VIRGIN = 0            # never accessed
_EXCLUSIVE = 1         # touched by exactly one thread so far (init phase)
_SHARED = 2            # read by multiple threads, written by at most one
                       # thread *before* sharing — benign without locks
_SHARED_MODIFIED = 3   # written while shared: lockset emptiness = race


class DataRaceViolation(AssertionError):
    """A tracked variable was write-shared across threads with no common
    lock protecting every access — a data race under SOME schedule, even
    if this run's interleaving happened to be benign."""

    def __init__(self, races: List["RaceReport"]):
        self.races = races
        lines = []
        for r in races:
            lines.append(
                f"  {r.variable}: {r.kind} by {r.thread} holding "
                f"{sorted(r.held) or '{}'} (candidate set empty; "
                f"threads seen: {sorted(r.threads_seen)}) at {r.where}")
        super().__init__("data race on %d variable(s):\n%s"
                         % (len(races), "\n".join(lines)))


class RaceReport:
    """One detected race (first emptying access per variable)."""

    def __init__(self, variable: str, thread: str, kind: str,
                 held: frozenset, threads_seen: Set[str], where: str):
        self.variable = variable
        self.thread = thread
        self.kind = kind              # "read" | "write"
        self.held = held
        self.threads_seen = set(threads_seen)
        self.where = where

    def __repr__(self):
        return (f"RaceReport({self.variable!r}, thread={self.thread!r}, "
                f"kind={self.kind!r}, held={sorted(self.held)})")


class _VarState:
    __slots__ = ("state", "owner", "lockset", "threads")

    def __init__(self):
        self.state = _VIRGIN
        self.owner: Optional[str] = None      # exclusive-phase thread
        self.lockset: Optional[frozenset] = None  # candidate set C(v)
        self.threads: Set[str] = set()


class RaceDetector:
    """Lockset-based data-race detector over explicitly tracked state.

    Tracking is explicit (wrap the locks with :meth:`wrap`, the shared
    structures with :meth:`wrap_dict` / :meth:`cell`, or call
    :meth:`on_access` directly) because CPython offers no compiler hook
    to instrument every memory access; the structures the daemon and
    scheduler actually share are few and known, so explicit wrapping
    covers the surface Go's ``-race`` would cover for them.
    """

    MAX_REPORTS = 32  # keep the first N distinct racy variables

    def __init__(self, auditor: Optional[LockOrderAuditor] = None):
        self.auditor = auditor or LockOrderAuditor()
        self._state_lock = threading.Lock()
        self._vars: Dict[str, _VarState] = {}
        self._races: List[RaceReport] = []
        self._reported: Set[str] = set()
        self.access_count = 0
        self._tid = threading.local()
        self._tid_next = 0

    def _thread_token(self) -> str:
        """Stable unique id for the calling thread. ``Thread.name`` can
        collide and ``Thread.ident`` is reused after join — either would
        merge two distinct threads into one 'owner' and mask races — so
        each thread gets a fresh token on first access."""
        token = getattr(self._tid, "token", None)
        if token is None:
            with self._state_lock:
                self._tid_next += 1
                n = self._tid_next
            token = self._tid.token = (
                f"{threading.current_thread().name}#{n}")
        return token

    # -- wiring ----------------------------------------------------------

    def wrap(self, lock, name: str) -> _WrappedLock:
        """Wrap a lock so held-set tracking sees it (shared with the
        order auditor — one wrapped lock feeds both analyses)."""
        return self.auditor.wrap(lock, name)

    def wrap_dict(self, d: Dict, name: str) -> "TrackedDict":
        return TrackedDict(d, name, self)

    def cell(self, name: str, value=None) -> "TrackedCell":
        return TrackedCell(name, self, value)

    # -- the Eraser state machine ---------------------------------------

    def on_access(self, variable: str, write: bool,
                  where: str = "") -> None:
        thread = self._thread_token()
        held = self.auditor.held_locks()
        kind = "write" if write else "read"
        with self._state_lock:
            self.access_count += 1
            v = self._vars.get(variable)
            if v is None:
                v = self._vars[variable] = _VarState()
            v.threads.add(thread)
            if v.state == _VIRGIN:
                v.state = _EXCLUSIVE
                v.owner = thread
                return
            if v.state == _EXCLUSIVE:
                if thread == v.owner:
                    return  # still the init phase
                # First cross-thread access: sharing begins NOW; the
                # candidate set starts from this access's held locks
                # (the exclusive phase is exempt — init-then-publish).
                v.lockset = held
                v.state = _SHARED_MODIFIED if write else _SHARED
                # A write-shared variable entering with no locks held is
                # already a race; fall through to the emptiness check.
            else:
                v.lockset = (held if v.lockset is None
                             else v.lockset & held)
                if write and v.state == _SHARED:
                    v.state = _SHARED_MODIFIED
            if (v.state == _SHARED_MODIFIED and not v.lockset
                    and variable not in self._reported
                    and len(self._races) < self.MAX_REPORTS):
                self._reported.add(variable)
                self._races.append(RaceReport(
                    variable, thread, kind, held, v.threads,
                    where or _caller()))

    # -- verdicts --------------------------------------------------------

    def races(self) -> List[RaceReport]:
        with self._state_lock:
            return list(self._races)

    def assert_race_free(self) -> None:
        races = self.races()
        if races:
            raise DataRaceViolation(races)

    def assert_acyclic(self) -> None:
        self.auditor.assert_acyclic()


def _caller() -> str:
    """file:line of the first frame outside this module (diagnostics)."""
    import sys
    frame = sys._getframe(2)
    while frame is not None and frame.f_code.co_filename == __file__:
        frame = frame.f_back
    if frame is None:
        return "?"
    return f"{frame.f_code.co_filename.rsplit('/', 1)[-1]}:{frame.f_lineno}"


class TrackedDict:
    """Dict proxy reporting every operation to the detector as one
    logical variable. Granularity is the WHOLE dict, matching how the
    codebase guards its shared maps (one lock per map, not per key)."""

    def __init__(self, inner: Dict, name: str, detector: RaceDetector):
        self._inner = inner
        self._name = name
        self._det = detector

    # reads
    def __getitem__(self, k):
        self._det.on_access(self._name, write=False)
        return self._inner[k]

    def __contains__(self, k):
        self._det.on_access(self._name, write=False)
        return k in self._inner

    def __len__(self):
        self._det.on_access(self._name, write=False)
        return len(self._inner)

    def __iter__(self):
        self._det.on_access(self._name, write=False)
        return iter(list(self._inner))

    def get(self, k, default=None):
        self._det.on_access(self._name, write=False)
        return self._inner.get(k, default)

    def keys(self):
        self._det.on_access(self._name, write=False)
        return list(self._inner.keys())

    def values(self):
        self._det.on_access(self._name, write=False)
        return list(self._inner.values())

    def items(self):
        self._det.on_access(self._name, write=False)
        return list(self._inner.items())

    # writes
    def __setitem__(self, k, v):
        self._det.on_access(self._name, write=True)
        self._inner[k] = v

    def __delitem__(self, k):
        self._det.on_access(self._name, write=True)
        del self._inner[k]

    def setdefault(self, k, default=None):
        self._det.on_access(self._name, write=True)
        return self._inner.setdefault(k, default)

    def pop(self, k, *default):
        self._det.on_access(self._name, write=True)
        return self._inner.pop(k, *default)

    def update(self, *a, **kw):
        self._det.on_access(self._name, write=True)
        self._inner.update(*a, **kw)

    def clear(self):
        self._det.on_access(self._name, write=True)
        self._inner.clear()

    def __repr__(self):
        return f"TrackedDict({self._name}, {self._inner!r})"


class TrackedCell:
    """A single tracked value slot (for scalar shared state like
    counters and flags)."""

    def __init__(self, name: str, detector: RaceDetector, value=None):
        self._name = name
        self._det = detector
        self._value = value

    def get(self):
        self._det.on_access(self._name, write=False)
        return self._value

    def set(self, value) -> None:
        self._det.on_access(self._name, write=True)
        self._value = value
