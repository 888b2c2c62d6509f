"""In-memory cluster resource model (reference: scheduler/resource/).

Hosts, tasks, and peers with lifecycle FSMs, the per-task peer DAG, and
TTL-GC'd managers. This is the state the scheduling core reads and mutates
on every announce/piece event, and the state snapshotted into the ML
training datasets.
"""

from dragonfly2_tpu_torch.scheduler.resource.host import (
    DEFAULT_PEER_CONCURRENT_UPLOAD_LIMIT,
    DEFAULT_SEED_PEER_CONCURRENT_UPLOAD_LIMIT,
    Host,
)
from dragonfly2_tpu_torch.scheduler.resource.managers import (
    DEFAULT_GC_BUDGET_S,
    DEFAULT_SHARD_COUNT,
    HostManager,
    PeerManager,
    TaskManager,
    shard_index,
)
from dragonfly2_tpu_torch.scheduler.resource.peer import Peer, PeerEvent, PeerState
from dragonfly2_tpu_torch.scheduler.resource.piecestats import (
    DEFAULT_PIECE_COST_WINDOW,
    PieceCostStats,
)
from dragonfly2_tpu_torch.scheduler.resource.resource import Resource
from dragonfly2_tpu_torch.scheduler.resource.task import (
    Piece,
    SizeScope,
    Task,
    TaskEvent,
    TaskState,
    TaskType,
)

__all__ = [
    "DEFAULT_GC_BUDGET_S",
    "DEFAULT_PEER_CONCURRENT_UPLOAD_LIMIT",
    "DEFAULT_PIECE_COST_WINDOW",
    "DEFAULT_SEED_PEER_CONCURRENT_UPLOAD_LIMIT",
    "DEFAULT_SHARD_COUNT",
    "Host",
    "HostManager",
    "Peer",
    "PeerEvent",
    "PeerManager",
    "PeerState",
    "Piece",
    "PieceCostStats",
    "Resource",
    "SizeScope",
    "Task",
    "TaskEvent",
    "TaskManager",
    "TaskState",
    "TaskType",
    "shard_index",
]
