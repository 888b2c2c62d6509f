"""Peer — one download of one task by one host.

Reference counterpart: scheduler/resource/peer.go. Tracks finished pieces
(bitset), per-piece costs (bad-node statistics input), the lifecycle FSM,
blocked parents, and back-to-source intent. Satisfies the evaluator's
PeerLike protocol.

Piece costs are retained in a bounded window backed by O(1) running
mean/M2 aggregates (:class:`~dragonfly2_tpu_torch.scheduler.resource.piecestats.
PieceCostStats`), so long-lived seed peers stop growing without bound and
the evaluator's ``is_bad_node`` never re-materializes a history.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from dragonfly2_tpu_torch.scheduler.resource.host import Host
from dragonfly2_tpu_torch.scheduler.resource.piecestats import (
    DEFAULT_PIECE_COST_WINDOW,
    PieceCostStats,
)
from dragonfly2_tpu_torch.scheduler.resource.task import Piece, Task
from dragonfly2_tpu_torch.utils.fsm import FSM, freeze_events


class PeerState:
    PENDING = "Pending"
    RECEIVED_EMPTY = "ReceivedEmpty"
    RECEIVED_TINY = "ReceivedTiny"
    RECEIVED_SMALL = "ReceivedSmall"
    RECEIVED_NORMAL = "ReceivedNormal"
    RUNNING = "Running"
    BACK_TO_SOURCE = "BackToSource"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    LEAVE = "Leave"


class PeerEvent:
    REGISTER_EMPTY = "RegisterEmpty"
    REGISTER_TINY = "RegisterTiny"
    REGISTER_SMALL = "RegisterSmall"
    REGISTER_NORMAL = "RegisterNormal"
    DOWNLOAD = "Download"
    DOWNLOAD_BACK_TO_SOURCE = "DownloadBackToSource"
    DOWNLOAD_SUCCEEDED = "DownloadSucceeded"
    DOWNLOAD_FAILED = "DownloadFailed"
    LEAVE = "Leave"


_RECEIVED = [
    PeerState.RECEIVED_EMPTY,
    PeerState.RECEIVED_TINY,
    PeerState.RECEIVED_SMALL,
    PeerState.RECEIVED_NORMAL,
]

# Transition table mirrors peer.go:230-251 (incl. the out-of-order
# success path: results may arrive before piece reports). Frozen once
# below so all peers share ONE table (see freeze_events).
_PEER_EVENTS = {
    PeerEvent.REGISTER_EMPTY: ([PeerState.PENDING], PeerState.RECEIVED_EMPTY),
    PeerEvent.REGISTER_TINY: ([PeerState.PENDING], PeerState.RECEIVED_TINY),
    PeerEvent.REGISTER_SMALL: ([PeerState.PENDING], PeerState.RECEIVED_SMALL),
    PeerEvent.REGISTER_NORMAL: ([PeerState.PENDING], PeerState.RECEIVED_NORMAL),
    PeerEvent.DOWNLOAD: (_RECEIVED, PeerState.RUNNING),
    PeerEvent.DOWNLOAD_BACK_TO_SOURCE: (
        _RECEIVED + [PeerState.RUNNING],
        PeerState.BACK_TO_SOURCE,
    ),
    PeerEvent.DOWNLOAD_SUCCEEDED: (
        _RECEIVED + [PeerState.RUNNING, PeerState.BACK_TO_SOURCE],
        PeerState.SUCCEEDED,
    ),
    PeerEvent.DOWNLOAD_FAILED: (
        [PeerState.PENDING] + _RECEIVED
        + [PeerState.RUNNING, PeerState.BACK_TO_SOURCE, PeerState.SUCCEEDED],
        PeerState.FAILED,
    ),
    PeerEvent.LEAVE: (
        [PeerState.PENDING] + _RECEIVED
        + [PeerState.RUNNING, PeerState.BACK_TO_SOURCE, PeerState.FAILED,
           PeerState.SUCCEEDED],
        PeerState.LEAVE,
    ),
}


_PEER_EVENTS_FROZEN = freeze_events(_PEER_EVENTS)

# Shared read-only stand-in for peers that have reported no costs yet:
# the evaluator's fast path snapshots it to (0, 0, 0, 0) — exactly what
# a fresh per-peer window would answer — so the real window (deque +
# lock) is only allocated once the first cost actually arrives. Appends
# never reach this instance (append_piece_cost materializes the peer's
# own window first).
_EMPTY_COST_STATS = PieceCostStats()


class Peer:
    # Slotted: at 100k peers the per-instance __dict__ was the second
    # largest per-peer allocation after the (now shared) FSM table.
    # announce_channel rides in the slots so the service layer's
    # ``peer.announce_channel = channel`` upsert still works; it is
    # read with getattr(..., None) so leaving it unset is fine.
    __slots__ = (
        "id", "task", "host", "tag", "application", "priority",
        "range_header", "traffic_class", "tenant", "cluster_id",
        "finished_pieces",
        "pieces", "_piece_costs",
        "cost", "block_parents", "need_back_to_source", "schedule_count",
        "piece_updated_at", "created_at", "updated_at", "_lock", "fsm",
        "announce_channel",
    )

    def __init__(self, id: str, task: Task, host: Host, *,
                 tag: str = "", application: str = "", priority: int = 0,
                 range_header: str = "", traffic_class: str = "",
                 tenant: str = "", cluster_id: str = "",
                 piece_cost_window: int = DEFAULT_PIECE_COST_WINDOW):
        self.id = id
        self.task = task
        self.host = host
        self.tag = tag
        self.application = application
        self.priority = priority
        self.range_header = range_header
        # QoS identity carried by register_peer ('' = class-blind):
        # class-aware candidate ordering + per-class scheduler counters.
        self.traffic_class = traffic_class
        self.tenant = tenant
        # Geo cluster (docs/GEO.md): defaults to the host's announced
        # cluster so register_peer payloads need not repeat it.
        self.cluster_id = cluster_id or getattr(host, "cluster_id", "")
        self.finished_pieces: set[int] = set()
        self.pieces: Dict[int, Piece] = {}
        # Lazily materialized on the first appended cost; window size is
        # re-validated there. Non-default windows materialize eagerly
        # (the lazy path could not remember the requested size without
        # spending the slot it saves).
        if piece_cost_window == DEFAULT_PIECE_COST_WINDOW:
            self._piece_costs = None
        else:
            self._piece_costs = PieceCostStats(piece_cost_window)
        self.cost: float = 0.0
        self.block_parents: set[str] = set()
        self.need_back_to_source = False
        self.schedule_count = 0
        now = time.time()
        self.piece_updated_at = now
        self.created_at = now
        self.updated_at = now
        self._lock = threading.RLock()
        self.fsm = FSM(PeerState.PENDING, _PEER_EVENTS_FROZEN,
                       on_transition=self._touch_transition)

    def _touch_transition(self, *_: object) -> None:
        self.touch()

    def touch(self) -> None:
        self.updated_at = time.time()

    # -- evaluator PeerLike protocol ------------------------------------------

    def state(self) -> str:
        return self.fsm.current

    def finished_piece_count(self) -> int:
        return len(self.finished_pieces)

    def piece_costs(self) -> List[float]:
        """Windowed cost history (bounded copy, newest last). The
        evaluator's fast path never calls this — it reads the O(1)
        aggregates via :meth:`piece_cost_stats`."""
        return self.piece_cost_stats().values()

    def piece_cost_stats(self) -> PieceCostStats:
        stats = self._piece_costs
        return stats if stats is not None else _EMPTY_COST_STATS

    # -- piece bookkeeping ----------------------------------------------------

    def append_piece_cost(self, cost: float) -> None:
        stats = self._piece_costs
        if stats is None:
            with self._lock:
                stats = self._piece_costs
                if stats is None:
                    stats = self._piece_costs = PieceCostStats()
        stats.append(cost)

    def store_piece(self, piece: Piece) -> None:
        with self._lock:
            # Upsert: a redelivered/replayed report (failover replay,
            # report-batcher redelivery) refreshes the piece record but
            # must not double-count its cost in the bad-node window —
            # exactly-once statistics over at-least-once delivery.
            fresh = piece.number not in self.finished_pieces
            self.pieces[piece.number] = piece
            self.finished_pieces.add(piece.number)
            if fresh:
                self.append_piece_cost(piece.cost)
            self.piece_updated_at = time.time()

    def load_piece(self, number: int) -> Optional[Piece]:
        return self.pieces.get(number)

    # -- lifecycle helpers ----------------------------------------------------

    def leave(self) -> None:
        if self.fsm.can(PeerEvent.LEAVE):
            self.fsm.fire(PeerEvent.LEAVE)

    def parents(self):
        return self.task.peer_parents(self.id)

    def children(self):
        return self.task.peer_children(self.id)

    def main_parent(self):
        ps = self.parents()
        return ps[0] if ps else None
