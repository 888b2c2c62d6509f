"""Cross-replica probe anti-entropy.

Reference counterpart: scheduler/networktopology/probes.go:115-186 keeps
probe queues in Redis, shared by every scheduler replica, so a replica
crash loses no probe state. Our store is in-process
(:mod:`.store`); the durability snapshot covers *restart* but a replica
dying mid-window used to lose its whole in-window probe history
(the accepted trade in docs/DESIGN_DECISIONS.md, closed here).

This syncer bounds that loss with symmetric push-pull: every tick each
replica pushes its probe-window delta to its peers over the scheduler
wire's ``SyncReplicaProbes`` and merges the delta each peer answers
with. Merges are idempotent (probe-level dedup, counts max-merged —
``store.merge_delta``), so retries after a failed tick are safe, and a
killed replica loses at most one tick of probes — everything older
already lives on its peers.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, Optional, Sequence

logger = logging.getLogger(__name__)

DEFAULT_SYNC_INTERVAL = 60.0


class ReplicaSyncer:
    """Ticks the anti-entropy exchange against a set of peer replicas.

    ``peers`` are scheduler RPC targets (``host:port``). ``client_factory``
    builds the per-peer client (defaults to the wire
    :class:`~dragonfly2_tpu_torch.scheduler.rpcserver.GrpcSchedulerClient`);
    tests inject in-process fakes.
    """

    def __init__(self, store, peers: Sequence[str],
                 interval: float = DEFAULT_SYNC_INTERVAL,
                 tls=None, client_factory: Optional[Callable] = None,
                 metrics=None):
        self.store = store
        self.peers = list(peers)
        self.interval = interval
        self.metrics = metrics
        if client_factory is None:
            from dragonfly2_tpu_torch.scheduler.rpcserver import GrpcSchedulerClient

            client_factory = lambda target: GrpcSchedulerClient(  # noqa: E731
                target, tls=tls)
        self._client_factory = client_factory
        self._clients: Dict[str, object] = {}
        # Watermarks per peer: what we last merged FROM it, and the
        # export stamp of what we last successfully pushed TO it. Neither
        # advances on a failed call, so the next tick re-sends — the
        # merge's idempotence makes the retry free. Stamps are MONOTONIC
        # clocks, each valid only within one store "epoch": when a
        # peer's epoch changes (it restarted, its monotonic clock reset
        # to ~0) its watermark is discarded instead of filtering its
        # fresh probes against a stale high-water mark.
        self._merged_from: Dict[str, float] = {}
        self._peer_epoch: Dict[str, str] = {}
        self._pushed_to: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _client(self, target: str):
        client = self._clients.get(target)
        if client is None:
            client = self._client_factory(target)
            self._clients[target] = client
        return client

    def sync_once(self) -> Dict[str, int]:
        """One exchange with every peer. Returns probes merged per peer;
        a peer that failed maps to -1 (and keeps its watermarks)."""
        results: Dict[str, int] = {}
        for target in self.peers:
            delta = self.store.export_delta(self._pushed_to.get(target, 0.0))
            try:
                reply = self._client(target).sync_replica_probes(
                    delta, since=self._merged_from.get(target, 0.0))
            except Exception:
                logger.warning("probe anti-entropy with %s failed", target,
                               exc_info=True)
                # Drop the client: the peer may have restarted on a new
                # connection; the factory rebuilds it next tick.
                stale = self._clients.pop(target, None)
                if stale is not None and hasattr(stale, "close"):
                    try:
                        stale.close()
                    except Exception:  # noqa: BLE001
                        pass
                results[target] = -1
                continue
            self._pushed_to[target] = delta["exported_at"]
            merged = self.store.merge_delta(reply) if reply else 0
            epoch = (reply or {}).get("epoch", "")
            prev_epoch = self._peer_epoch.get(target)
            self._peer_epoch[target] = epoch
            if prev_epoch is not None and epoch != prev_epoch:
                # Peer restarted: its monotonic clock reset, so this
                # exchange ran with a watermark from the OLD clock and
                # may have missed everything — and the peer itself may
                # have warm-started from a snapshot missing what we
                # pushed since its last persist. Zero BOTH watermarks:
                # the next tick re-pulls its full window and re-pushes
                # ours (the merge is idempotent, so the overlap is
                # free).
                self._merged_from[target] = 0.0
                self._pushed_to[target] = 0.0
            else:
                self._merged_from[target] = reply.get(
                    "exported_at", self._merged_from.get(target, 0.0))
            results[target] = merged
            if self.metrics is not None:
                self.metrics.probes_stored.inc(merged)
        return results

    def serve(self) -> None:
        if self._thread is not None or not self.peers:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="probe-antientropy", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        for client in self._clients.values():
            if hasattr(client, "close"):
                try:
                    client.close()
                except Exception:  # noqa: BLE001
                    pass
        self._clients.clear()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.sync_once()
            except Exception:  # noqa: BLE001 — the tick must keep ticking
                logger.exception("probe anti-entropy tick failed")
