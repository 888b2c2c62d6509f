"""Client-side network-topology prober — the data-collection half of the
ML loop.

Reference counterpart: client/daemon/networktopology/network_topology.go:
71-203 — a ticker opens a ``SyncProbes`` stream, sends the started request,
receives candidate hosts from the scheduler (least-probed sample), pings
them concurrently, and reports finished/failed results. Without this loop
the GNN pipeline only ever trains on synthetic probes.

RTT measurement is a TCP connect handshake to each candidate's upload port
(utils/netping.py) — ICMP echo needs raw-socket privileges a userland
daemon doesn't have; the choice is stated there.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import List, Protocol, Sequence, Tuple

from dragonfly2_tpu_torch.scheduler.service import ProbeResult
from dragonfly2_tpu_torch.utils.netping import ping_hosts

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class ProbeTarget:
    host_id: str
    ip: str
    port: int


class ProbeSync(Protocol):
    """One probe round-trip against a scheduler (in-process or gRPC)."""

    def probe_started(self, host_id: str) -> List[ProbeTarget]: ...

    def probe_finished(self, host_id: str,
                       results: Sequence[ProbeResult]) -> None: ...

    def probe_failed(self, host_id: str,
                     results: Sequence[ProbeResult]) -> None: ...


class InProcessProbeSync:
    """Adapter over a SchedulerService living in the same process."""

    def __init__(self, service):
        self.service = service

    def probe_started(self, host_id: str) -> List[ProbeTarget]:
        return [
            ProbeTarget(h.id, h.ip, h.port)
            for h in self.service.probe_started(host_id)
        ]

    def probe_finished(self, host_id, results) -> None:
        self.service.probe_finished(host_id, results)

    def probe_failed(self, host_id, results) -> None:
        self.service.probe_failed(host_id, results)


class GrpcProbeSync:
    """One short-lived ``SyncProbes`` stream per probe cycle.

    The reference holds the stream open for started→finished of a single
    cycle too (network_topology.go:91-150); candidates arrive as the reply
    to the started request.
    """

    def __init__(self, target: str, tls=None):
        from dragonfly2_tpu_torch.rpc.client import ServiceClient
        from dragonfly2_tpu_torch.scheduler.rpcserver import SCHEDULER_SPEC

        self._client = ServiceClient(target, SCHEDULER_SPEC, tls=tls)

    def sync(self, host_id: str, measure) -> int:
        """started → candidates → measure() → finished/failed, one stream.

        ``measure`` maps List[ProbeTarget] → (ok, failed) ProbeResult
        lists. Returns the number of results reported.
        """
        import queue

        from dragonfly2_tpu_torch.scheduler.rpcserver import (
            WireProbeFinished,
            WireProbeResult,
            WireProbeStarted,
        )

        send: "queue.Queue" = queue.Queue()

        def requests():
            while True:
                item = send.get()
                if item is None:
                    return
                yield item

        responses = self._client.SyncProbes(requests())
        send.put(WireProbeStarted(host_id=host_id))
        try:
            candidates_msg = next(responses)
        except StopIteration:
            send.put(None)
            return 0
        targets = []
        for wire in candidates_msg.hosts:
            ip, _, port = wire.addr.rpartition(":")
            targets.append(ProbeTarget(wire.peer_id, ip, int(port)))
        ok, failed = measure(targets)
        if ok or failed:
            send.put(WireProbeFinished(host_id=host_id, results=[
                *(WireProbeResult(r.dest_host_id, r.rtt_seconds, ok=True)
                  for r in ok),
                *(WireProbeResult(r.dest_host_id, r.rtt_seconds, ok=False)
                  for r in failed),
            ]))
        send.put(None)
        # Drain so the server finishes the stream cleanly.
        for _ in responses:
            pass
        return len(ok) + len(failed)

    def close(self) -> None:
        self._client.close()


@dataclass
class ProbeConfig:
    """(client/config NetworkTopology options, trimmed)"""

    interval: float = 60.0
    probe_timeout: float = 1.0
    max_workers: int = 16


class Prober:
    """The daemon's probe ticker."""

    def __init__(self, host_id: str, sync, config: ProbeConfig | None = None,
                 metrics=None):
        """``sync`` is either a ProbeSync (three-method protocol) or a
        GrpcProbeSync (single ``sync`` method driving the stream)."""
        self.host_id = host_id
        self.sync = sync
        self.config = config or ProbeConfig()
        self.metrics = metrics  # DaemonMetrics or None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ------------------------------------------------------

    def serve(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="probe-sender", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.config.interval):
            try:
                self.probe_once()
            except Exception:  # noqa: BLE001 — the ticker must survive
                logger.exception("probe cycle failed")

    # -- one cycle ------------------------------------------------------

    def measure(self, targets: List[ProbeTarget]
                ) -> Tuple[List[ProbeResult], List[ProbeResult]]:
        rtts = ping_hosts(
            [(t.host_id, t.ip, t.port) for t in targets],
            timeout=self.config.probe_timeout,
            max_workers=self.config.max_workers,
        )
        ok = [ProbeResult(hid, rtt) for hid, rtt in rtts.items()
              if rtt is not None]
        failed = [ProbeResult(hid, 0.0) for hid, rtt in rtts.items()
                  if rtt is None]
        if self.metrics:
            self.metrics.probe_count.labels(outcome="ok").inc(len(ok))
            self.metrics.probe_count.labels(outcome="failed").inc(len(failed))
        return ok, failed

    def probe_once(self) -> int:
        """One started→ping→finished cycle; returns results reported."""
        if hasattr(self.sync, "sync"):
            return self.sync.sync(self.host_id, self.measure)
        targets = self.sync.probe_started(self.host_id)
        if not targets:
            return 0
        ok, failed = self.measure(targets)
        if ok:
            self.sync.probe_finished(self.host_id, ok)
        if failed:
            self.sync.probe_failed(self.host_id, failed)
        return len(ok) + len(failed)
