"""The scheduler's manager link — port of the manager block of
``dragonfly2_tpu/cmd/scheduler.py`` (``main``, the ``if args.manager``
branch).

:func:`connect_manager` does for a
:class:`~dragonfly2_tpu_torch.scheduler.service.SchedulerService` in this
process what JAX's ``df2-scheduler --manager`` does after it built its
service: it registers the instance on the manager's internal surface and
sends the first keepalive at once (registration alone leaves the row
inactive, and daemons' dynconfig lists only active instances); it binds
the ML evaluator's quarantine hook (a runtime guard trip escalates the
serving version to ``/internal/v1/models/quarantine``, a fleet-wide
rollback) and a ``TraceLog`` of its announce feature batches; it runs
the keepalive loop, which uploads the trace corpus every
``TRACE_UPLOAD_TICKS`` ticks for the validation gate to replay; and it
subscribes ``Scheduling.apply_dynconfig`` to a :class:`Dynconfig` on the
cluster's scheduler config, with its on-disk cache under ``data_dir``.

It differs from JAX's on purpose in one way: JAX's threads are daemons
that never stop; :class:`ManagerLink.stop` ends the keepalive loop and the
dynconfig ticker. The gRPC server (``build_scheduler``), the job plane's
``RemoteJobWorker`` and the announcer's trainer client wait for the RPC
layer (ROADMAP.md, Queue 1 item 4).
"""

from __future__ import annotations

import logging
import socket
import threading
from typing import Optional

from dragonfly2_tpu_torch.manager.client import ManagerHTTPClient
from dragonfly2_tpu_torch.manager.validation import TraceLog
from dragonfly2_tpu_torch.utils.dynconfig import Dynconfig

logger = logging.getLogger(__name__)

#: Keepalive ticks between two trace uploads: about once a minute at
#: the default 5 s interval.
TRACE_UPLOAD_TICKS = 12


class _ManagerAdapter:
    """Announcer's ManagerAnnounceClient over the HTTP client. Always
    speaks the advertised identity — keepalive must match the registered
    (hostname, ip) row exactly."""

    def __init__(self, client: ManagerHTTPClient, hostname: str, ip: str,
                 cluster_id: int):
        self.client = client
        self.hostname = hostname
        self.ip = ip
        self.cluster_id = cluster_id

    def update_scheduler(self, host_id, ip, hostname_, port):
        self.client.update_scheduler_instance(
            hostname=self.hostname, ip=self.ip, port=port,
            cluster_id=self.cluster_id)

    def keepalive(self, host_id):
        self.client.keepalive_scheduler(hostname=self.hostname, ip=self.ip,
                                        cluster_id=self.cluster_id)


class ManagerLink:
    """What :func:`connect_manager` started: the registered identity, the
    client, the announcer adapter, the trace log (None when the evaluator
    has no quarantine hook), the dynconfig and the keepalive thread."""

    def __init__(self, client: ManagerHTTPClient, adapter: _ManagerAdapter,
                 scheduler_id: int, trace_log: Optional[TraceLog],
                 dynconfig: Dynconfig, keepalive_interval: float):
        self.client = client
        self.adapter = adapter
        self.scheduler_id = scheduler_id
        self.trace_log = trace_log
        self.dynconfig = dynconfig
        self.keepalive_interval = keepalive_interval
        self.keepalives = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._keepalive_loop,
                                        daemon=True, name="manager-keepalive")

    @property
    def cluster_id(self) -> int:
        return self.adapter.cluster_id

    def upload_traces(self) -> bool:
        """Ship the recorded announce traces now; False when there are
        none to ship."""
        if self.trace_log is None or not len(self.trace_log):
            return False
        self.client.upload_announce_traces(self.scheduler_id,
                                           self.trace_log.to_bytes())
        return True

    def keepalive(self) -> None:
        self.adapter.keepalive("")
        self.keepalives += 1

    def start(self) -> None:
        """Start the keepalive loop."""
        self._thread.start()

    def _keepalive_loop(self) -> None:
        ticks = 0
        while not self._stop.wait(self.keepalive_interval):
            ticks += 1
            try:
                self.keepalive()
            except Exception:  # noqa: BLE001 — keepalive must not die
                logger.exception("manager keepalive failed")
            # Failures only cost gate freshness, never the keepalive.
            if ticks % TRACE_UPLOAD_TICKS == 0:
                try:
                    self.upload_traces()
                except Exception:  # noqa: BLE001
                    logger.exception("announce-trace upload failed")

    def stop(self) -> None:
        """End the keepalive loop and the dynconfig ticker."""
        self._stop.set()
        self._thread.join(timeout=5)
        self.dynconfig.stop()


def connect_manager(service, manager_url: str, *, port: int,
                    cluster_id: int = 0, scheduler_id: int = 0,
                    advertise_ip: str = "", hostname: str = "",
                    data_dir: str = ".", keepalive_interval: float = 5.0,
                    dynconfig_interval: float = 60.0) -> ManagerLink:
    """Register ``service`` with the manager at ``manager_url`` (its
    internal surface) and keep it registered; see the module docstring.

    ``advertise_ip`` is the routable address daemons receive through
    dynconfig (default: ``hostname`` resolved, else 127.0.0.1);
    ``hostname`` defaults to this host's name. ``scheduler_id`` 0 takes
    the registered row's id, which keys model uploads, quarantines and
    trace uploads. ``cluster_id`` 0 lets the manager pick its default
    cluster. Returns the :class:`ManagerLink`; call ``stop()`` on it."""
    mgr = ManagerHTTPClient(manager_url)
    hostname = hostname or socket.gethostname()
    if not advertise_ip:
        try:
            advertise_ip = socket.gethostbyname(hostname)
        except OSError:
            advertise_ip = "127.0.0.1"
    row = mgr.update_scheduler_instance(
        hostname=hostname, ip=advertise_ip, port=port, cluster_id=cluster_id)
    scheduler_id = scheduler_id or int(row["id"])
    cluster_id = int(row["scheduler_cluster_id"])
    logger.info("registered with manager as scheduler %s (cluster %s)",
                scheduler_id, cluster_id)
    adapter = _ManagerAdapter(mgr, hostname, advertise_ip, cluster_id)

    # Guarded model lifecycle wiring: an ML evaluator escalates runtime
    # guard trips to a registry quarantine (fleet-wide rollback), and
    # records its announce feature batches so the manager's validation
    # gate replays REAL traffic against future candidates. The evaluator
    # was built before this client existed, hence the late binding.
    trace_log = None
    evaluator = service.scheduling.evaluator
    if hasattr(evaluator, "set_quarantine_hook"):
        trace_log = TraceLog()
        evaluator.set_trace_log(trace_log)

        def quarantine_serving(reason):
            version = getattr(evaluator, "serving_version", "")
            if not version:
                return False  # version unknown yet: retry next trip
            mgr.quarantine_model_version(
                model_type=getattr(evaluator, "model_name", "mlp"),
                version=version, scheduler_id=scheduler_id,
                reason=f"scheduler runtime guard: {reason}")

        evaluator.set_quarantine_hook(quarantine_serving)

    dynconfig = Dynconfig(
        lambda: mgr.scheduler_cluster_config(cluster_id),
        cache_path=f"{data_dir}/dynconfig.json",
        refresh_interval=dynconfig_interval, name="scheduler-dynconfig")
    link = ManagerLink(mgr, adapter, scheduler_id, trace_log, dynconfig,
                       keepalive_interval)
    # First keepalive immediately: registration alone leaves the row
    # inactive, and daemons' dynconfig only lists active instances.
    link.keepalive()
    link.start()
    dynconfig.subscribe(service.scheduling.apply_dynconfig)
    dynconfig.refresh()
    dynconfig.serve()
    return link
