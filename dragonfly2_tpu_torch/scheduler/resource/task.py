"""Task — one piece of content being distributed, plus its peer DAG.

Reference counterpart: scheduler/resource/task.go. The task owns the piece
metadata map, the back-to-source budget, the FSM, and the DAG of its
peers (edges parent→child along piece flow).
"""

from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dragonfly2_tpu_torch.utils import dag as dag_mod
from dragonfly2_tpu_torch.utils.fsm import FSM, freeze_events

EMPTY_FILE_SIZE = 0
TINY_FILE_SIZE = 128  # bytes — fits inline in the register response


class TaskState:
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    LEAVE = "Leave"


class TaskEvent:
    DOWNLOAD = "Download"
    DOWNLOAD_SUCCEEDED = "DownloadSucceeded"
    DOWNLOAD_FAILED = "DownloadFailed"
    LEAVE = "Leave"


# Transition table mirrors task.go:197-202.
_TASK_EVENTS = {
    TaskEvent.DOWNLOAD: (
        [TaskState.PENDING, TaskState.SUCCEEDED, TaskState.FAILED, TaskState.LEAVE],
        TaskState.RUNNING,
    ),
    TaskEvent.DOWNLOAD_SUCCEEDED: (
        [TaskState.LEAVE, TaskState.RUNNING, TaskState.FAILED],
        TaskState.SUCCEEDED,
    ),
    TaskEvent.DOWNLOAD_FAILED: ([TaskState.RUNNING], TaskState.FAILED),
    TaskEvent.LEAVE: (
        [TaskState.PENDING, TaskState.RUNNING, TaskState.SUCCEEDED, TaskState.FAILED],
        TaskState.LEAVE,
    ),
}


class TaskType(enum.Enum):
    # reference: commonv2.TaskType — DFDAEMON tasks may back-to-source;
    # DFCACHE are cache-only; DFSTORE object-storage backed.
    DFDAEMON = "dfdaemon"
    DFCACHE = "dfcache"
    DFSTORE = "dfstore"


class SizeScope(enum.Enum):
    """Register fast-path class (task.go:442-464 SizeScope)."""

    NORMAL = "normal"
    SMALL = "small"     # single piece: parent returned inline
    TINY = "tiny"       # ≤128 B: bytes returned inline
    EMPTY = "empty"     # zero-length
    UNKNOW = "unknow"   # content length not yet known


@dataclass(slots=True)
class Piece:
    """Piece metadata (reference: scheduler/resource/task.go Piece).

    Slotted: one Piece per reported piece per peer is the dominant
    steady-state allocation of a large swarm's resource view."""

    number: int
    parent_id: str = ""
    offset: int = 0
    length: int = 0
    digest: str = ""
    traffic_type: str = ""
    cost: float = 0.0  # seconds
    created_at: float = field(default_factory=time.time)


_TASK_EVENTS_FROZEN = freeze_events(_TASK_EVENTS)


class Task:
    __slots__ = (
        "id", "url", "tag", "application", "type", "digest",
        "filtered_query_params", "request_header", "piece_length",
        "url_range", "content_length", "total_piece_count", "direct_piece",
        "back_to_source_limit", "back_to_source_peers", "peer_failed_count",
        "pieces", "source_claims", "bridge_claims", "dag", "created_at",
        "updated_at", "_lock", "fsm",
    )

    def __init__(
        self,
        id: str,
        url: str = "",
        *,
        tag: str = "",
        application: str = "",
        type: TaskType = TaskType.DFDAEMON,
        digest: str = "",
        filtered_query_params: Optional[List[str]] = None,
        request_header: Optional[Dict[str, str]] = None,
        piece_length: int = 0,
        back_to_source_limit: int = 3,
        url_range: str = "",
    ):
        self.id = id
        self.url = url
        self.tag = tag
        self.application = application
        self.type = type
        self.digest = digest
        self.filtered_query_params = filtered_query_params or []
        self.request_header = request_header or {}
        self.piece_length = piece_length
        self.url_range = url_range
        self.content_length = -1
        self.total_piece_count = 0
        self.direct_piece = b""  # tiny-task inline payload
        self.back_to_source_limit = back_to_source_limit
        self.back_to_source_peers: set[str] = set()
        self.peer_failed_count = 0
        self.pieces: Dict[int, Piece] = {}
        # Lazily-created source-claim coordinator (resource/claims.py):
        # present only once a back-to-source peer asked for disjoint
        # origin claims — the piece-report hot path guards on None.
        self.source_claims = None
        # Lazily-created WAN bridge election (resource/claims.py
        # BridgeClaims): present only once a cluster-tagged peer wanted
        # a cross-cluster parent — cluster-blind swarms never pay it.
        self.bridge_claims = None
        self.dag: dag_mod.DAG = dag_mod.DAG()
        now = time.time()
        self.created_at = now
        self.updated_at = now
        self._lock = threading.RLock()
        self.fsm = FSM(TaskState.PENDING, _TASK_EVENTS_FROZEN,
                       on_transition=self._touch_transition)

    def _touch_transition(self, *_: object) -> None:
        self.touch()

    def touch(self) -> None:
        self.updated_at = time.time()

    # -- piece registry -------------------------------------------------------

    def store_piece(self, piece: Piece) -> None:
        with self._lock:
            self.pieces[piece.number] = piece

    def load_piece(self, number: int) -> Optional[Piece]:
        return self.pieces.get(number)

    def delete_piece(self, number: int) -> None:
        with self._lock:
            self.pieces.pop(number, None)

    # -- source claims (fan-out dissemination, resource/claims.py) ------------

    def ensure_source_claims(self, total_pieces: int):
        """Lazily create the claim coordinator sized to the task. First
        claimant wins the shape; a mismatched later total (cannot happen
        for one URL, but duck-typed callers exist) keeps the original."""
        from dragonfly2_tpu_torch.scheduler.resource.claims import SourceClaims

        with self._lock:
            if self.source_claims is None:
                self.source_claims = SourceClaims(total_pieces, seed=self.id)
            return self.source_claims

    def ensure_bridge_claims(self, max_bridges: int = 1):
        """Lazily create the per-cluster WAN bridge election (first
        cross-cluster candidate ask wins the shape, docs/GEO.md)."""
        from dragonfly2_tpu_torch.scheduler.resource.claims import BridgeClaims

        with self._lock:
            if self.bridge_claims is None:
                self.bridge_claims = BridgeClaims(max_bridges=max_bridges)
            return self.bridge_claims

    def mark_piece_landed(self, number: int) -> None:
        """Feed the claim map from the piece-report path: ANY replica of
        a piece in the swarm means the origin never needs to serve it
        again. No-op (one attribute read) while no claimant exists."""
        claims = self.source_claims
        if claims is not None:
            claims.mark_landed(number)

    # -- peer DAG -------------------------------------------------------------

    def store_peer(self, peer) -> None:
        if peer.id not in self.dag:
            self.dag.add_vertex(peer.id, peer)

    def load_peer(self, peer_id: str):
        try:
            return self.dag.vertex(peer_id).value
        except dag_mod.VertexNotFoundError:
            return None

    def delete_peer(self, peer_id: str) -> None:
        self.dag.delete_vertex(peer_id)

    def peer_count(self) -> int:
        return len(self.dag)

    def peers(self):
        return list(self.dag.values())

    def can_add_peer_edge(self, parent_id: str, child_id: str) -> bool:
        return self.dag.can_add_edge(parent_id, child_id)

    def add_peer_edge(self, parent, child) -> None:
        """parent serves pieces to child; counts an upload slot on the
        parent's host (task.go AddPeerEdge)."""
        with self._lock:
            self.dag.add_edge(parent.id, child.id)
            parent.host.adjust_uploads(+1)

    def delete_peer_in_edges(self, peer_id: str) -> None:
        with self._lock:
            for parent in self.dag.parents(peer_id):
                parent.host.adjust_uploads(-1)
            self.dag.delete_vertex_in_edges(peer_id)

    def delete_peer_out_edges(self, peer) -> None:
        with self._lock:
            n = self.dag.vertex(peer.id).out_degree
            peer.host.adjust_uploads(-n)
            self.dag.delete_vertex_out_edges(peer.id)

    def peer_parents(self, peer_id: str):
        return self.dag.parents(peer_id)

    def peer_children(self, peer_id: str):
        return self.dag.children(peer_id)

    # -- scope / lifecycle ----------------------------------------------------

    def size_scope(self) -> SizeScope:
        if self.content_length < 0 or self.total_piece_count < 0:
            return SizeScope.UNKNOW
        if self.content_length == EMPTY_FILE_SIZE:
            return SizeScope.EMPTY
        if self.content_length <= TINY_FILE_SIZE:
            return SizeScope.TINY
        if self.total_piece_count == 1:
            return SizeScope.SMALL
        return SizeScope.NORMAL

    def can_back_to_source(self) -> bool:
        """(task.go:467-470) budget not exhausted and task type supports
        origin downloads."""
        return len(self.back_to_source_peers) <= self.back_to_source_limit and (
            self.type in (TaskType.DFDAEMON, TaskType.DFSTORE)
        )

    def has_available_peer(self, blocklist: set[str] | None = None) -> bool:
        """Any peer in a state that could serve pieces (task.go
        HasAvailablePeer)."""
        from dragonfly2_tpu_torch.scheduler.resource.peer import PeerState

        block = blocklist or set()
        for peer in self.dag.values():
            if peer.id in block:
                continue
            if peer.fsm.is_state(
                PeerState.SUCCEEDED, PeerState.RUNNING, PeerState.BACK_TO_SOURCE
            ):
                return True
        return False

    def report_success(self, content_length: int, total_piece_count: int) -> None:
        with self._lock:
            if self.fsm.can(TaskEvent.DOWNLOAD_SUCCEEDED):
                self.fsm.fire(TaskEvent.DOWNLOAD_SUCCEEDED)
            self.content_length = content_length
            self.total_piece_count = total_piece_count
            self.peer_failed_count = 0
