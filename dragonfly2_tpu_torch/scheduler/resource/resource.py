"""Resource assembly — one object owning the three managers + GC.

Reference counterpart: scheduler/resource/resource.go:30-100 (the
``Resource`` interface wired in scheduler.go:109-293). Seed-peer triggering
binds here once the daemon layer lands.
"""

from __future__ import annotations

from dataclasses import dataclass

from dragonfly2_tpu_torch.scheduler.resource.managers import (
    DEFAULT_GC_BUDGET_S,
    DEFAULT_SHARD_COUNT,
    HostManager,
    PeerManager,
    TaskManager,
)
from dragonfly2_tpu_torch.utils.gc import GC


@dataclass
class ResourceConfig:
    host_ttl: float = 6 * 60.0
    task_ttl: float = 30 * 60.0
    peer_ttl: float = 24 * 60 * 60.0
    gc_interval: float = 60.0
    # Swarm-scale knobs (docs/SCHEDULER.md): shards per manager map and
    # the per-tick incremental-GC sweep budget (seconds).
    shard_count: int = DEFAULT_SHARD_COUNT
    gc_budget_s: float = DEFAULT_GC_BUDGET_S


class Resource:
    def __init__(self, config: ResourceConfig | None = None,
                 seed_peer_client=None, stats=None):
        config = config or ResourceConfig()
        self.gc = GC()
        self.host_manager = HostManager(
            config.host_ttl, self.gc, config.gc_interval,
            shard_count=config.shard_count, gc_budget_s=config.gc_budget_s,
            stats=stats)
        self.task_manager = TaskManager(
            config.task_ttl, self.gc, config.gc_interval,
            shard_count=config.shard_count, gc_budget_s=config.gc_budget_s,
            stats=stats)
        self.peer_manager = PeerManager(
            config.peer_ttl, self.gc, config.gc_interval,
            shard_count=config.shard_count, gc_budget_s=config.gc_budget_s,
            stats=stats)
        self.seed_peer_client = seed_peer_client

    def serve(self) -> None:
        self.gc.serve()

    def stop(self) -> None:
        self.gc.stop()
