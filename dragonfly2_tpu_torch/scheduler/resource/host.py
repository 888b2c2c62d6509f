"""Host — one announced dfdaemon instance.

Reference counterpart: scheduler/resource/host.go:125-460. Carries identity,
network affinity (IDC / '|'-separated location), upload accounting, and the
telemetry snapshot used for dataset export. Satisfies the evaluator's
HostLike protocol directly.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from dragonfly2_tpu_torch.schema import records
from dragonfly2_tpu_torch.utils.hosttypes import HostType

# Default concurrent upload slots by host class
# (reference: scheduler/config/constants.go — seed peers serve many more
# children than ordinary peers).
DEFAULT_PEER_CONCURRENT_UPLOAD_LIMIT = 50
DEFAULT_SEED_PEER_CONCURRENT_UPLOAD_LIMIT = 300


@dataclass(slots=True)
class Host:
    id: str
    hostname: str = ""
    ip: str = ""
    port: int = 0
    download_port: int = 0
    object_storage_port: int = 0
    type: HostType = HostType.NORMAL
    os: str = ""
    platform: str = ""
    platform_family: str = ""
    platform_version: str = ""
    kernel_version: str = ""
    scheduler_cluster_id: int = 0
    # Geo cluster identity ('' = cluster-blind, docs/GEO.md): announced
    # by the daemon, inherited by its peers, and the key the bridge
    # election + same-cluster candidate steering group by.
    cluster_id: str = ""
    concurrent_upload_limit: int = 0
    concurrent_upload_count: int = 0
    upload_count: int = 0
    upload_failed_count: int = 0
    # Telemetry snapshots (announced by the daemon's announcer).
    cpu: records.CPU = field(default_factory=records.CPU)
    memory: records.Memory = field(default_factory=records.Memory)
    network: records.Network = field(default_factory=records.Network)
    disk: records.Disk = field(default_factory=records.Disk)
    build: records.Build = field(default_factory=records.Build)
    created_at: float = field(default_factory=time.time)
    updated_at: float = field(default_factory=time.time)
    # Internal state as init=False fields so the slotted dataclass can
    # carry them (slots=True forbids __post_init__ inventing attributes).
    _lock: threading.Lock = field(
        init=False, repr=False, compare=False,
        default_factory=threading.Lock)
    _peers: Dict[str, object] = field(
        init=False, repr=False, compare=False, default_factory=dict)

    def __post_init__(self):
        if self.concurrent_upload_limit == 0:
            self.concurrent_upload_limit = (
                DEFAULT_SEED_PEER_CONCURRENT_UPLOAD_LIMIT
                if self.type.is_seed
                else DEFAULT_PEER_CONCURRENT_UPLOAD_LIMIT
            )

    # -- affinity accessors (evaluator HostLike protocol) ---------------------

    @property
    def idc(self) -> str:
        return self.network.idc

    @property
    def location(self) -> str:
        return self.network.location

    @property
    def locality_idc(self) -> str:
        """Effective IDC for the evaluator's affinity term: the
        operator-announced idc when set, else a synthetic one derived
        from the geo cluster — so multi-site fleets get intra-cluster
        scoring affinity without a 12th feature column (the trained
        models' 11-wide rows stay valid), and cluster-blind hosts score
        byte-for-byte as before."""
        return self.network.idc or (
            "cluster:" + self.cluster_id if self.cluster_id else "")

    def free_upload_count(self) -> int:
        return self.concurrent_upload_limit - self.concurrent_upload_count

    # -- upload accounting ----------------------------------------------------

    def acquire_upload(self) -> bool:
        with self._lock:
            if self.concurrent_upload_count >= self.concurrent_upload_limit:
                return False
            self.concurrent_upload_count += 1
            return True

    def release_upload(self, success: bool = True) -> None:
        with self._lock:
            self.concurrent_upload_count = max(self.concurrent_upload_count - 1, 0)
            self.upload_count += 1
            if not success:
                self.upload_failed_count += 1

    def adjust_uploads(self, delta: int) -> None:
        """Atomic slot adjustment for DAG edge add/remove (floored at 0).

        Unlike acquire_upload this never refuses: the scheduling filter has
        already checked free_upload_count, and edge bookkeeping must stay
        consistent with the DAG even when racing other announce threads.
        """
        with self._lock:
            self.concurrent_upload_count = max(self.concurrent_upload_count + delta, 0)

    # -- peer registry --------------------------------------------------------

    def store_peer(self, peer) -> None:
        with self._lock:
            self._peers[peer.id] = peer

    def load_peer(self, peer_id: str) -> Optional[object]:
        return self._peers.get(peer_id)

    def delete_peer(self, peer_id: str) -> None:
        with self._lock:
            self._peers.pop(peer_id, None)

    @property
    def peer_count(self) -> int:
        return len(self._peers)

    def peers(self) -> list:
        return list(self._peers.values())

    def leave_peers(self) -> None:
        """Mark every peer on this host as left (reference: LeavePeers —
        the LeaveHost cascade)."""
        for peer in self.peers():
            peer.leave()

    def touch(self) -> None:
        self.updated_at = time.time()
