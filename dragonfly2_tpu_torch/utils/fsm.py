"""Minimal finite-state machine.

Backs the peer/task lifecycle state (reference uses looplab/fsm via
scheduler/resource/peer.go:230-251 and task.go:197-202). Transitions are a
static event table; firing an event from a wrong source state raises —
bugs in lifecycle logic surface immediately instead of corrupting
scheduling state.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterable, Mapping, Tuple


class InvalidTransitionError(RuntimeError):
    def __init__(self, event: str, state: str):
        super().__init__(f"event {event!r} inappropriate in current state {state!r}")
        self.event = event
        self.state = state


def freeze_events(
    events: Mapping[str, Tuple[Iterable[str], str]],
) -> Dict[str, Tuple[frozenset, str]]:
    """Build the frozen transition table ONCE so every FSM instance over
    the same event map shares it. Before this, each FSM re-froze the
    table per instance — a dict of frozensets per peer/task, which at
    100k peers was the single largest per-peer allocation."""
    return {
        name: (frozenset(srcs), dst) for name, (srcs, dst) in events.items()
    }


def _is_frozen(events) -> bool:
    for srcs, _dst in events.values():
        return isinstance(srcs, frozenset)
    return True


class FSM:
    """Thread-safe event-table state machine."""

    __slots__ = ("_state", "_events", "_lock", "_on_transition")

    def __init__(
        self,
        initial: str,
        events: Mapping[str, Tuple[Iterable[str], str]],
        on_transition: Callable[[str, str, str], None] | None = None,
    ):
        """``events`` maps event name → (allowed source states, destination).

        Pass a table pre-built with :func:`freeze_events` to share it
        across instances (hot-path callers do); a raw mapping is frozen
        here per instance, preserving the old contract.

        ``on_transition(event, src, dst)`` fires after every state change.
        """
        self._state = initial
        self._events: Dict[str, Tuple[frozenset, str]] = (
            events if _is_frozen(events) else freeze_events(events)
        )
        self._lock = threading.Lock()
        self._on_transition = on_transition

    @property
    def current(self) -> str:
        return self._state

    def is_state(self, *states: str) -> bool:
        return self._state in states

    def can(self, event: str) -> bool:
        srcs, _ = self._events[event]
        return self._state in srcs

    def fire(self, event: str) -> None:
        with self._lock:
            srcs, dst = self._events[event]
            if self._state not in srcs:
                raise InvalidTransitionError(event, self._state)
            src = self._state
            self._state = dst
        if self._on_transition is not None:
            self._on_transition(event, src, dst)
