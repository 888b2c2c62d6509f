"""Job orchestration: preheat fan-out from manager to schedulers.

Reference counterparts: internal/job (machinery/Redis queues ``global`` /
``schedulers`` / ``scheduler_<id>``, constants.go:20-42),
manager/job/preheat.go:72-316 (image-manifest → layer URLs → group job) and
scheduler/job/job.go:49-222 (queue workers → seed-peer trigger). The broker
here is an in-process bus with the same queue topology; a Redis-backed bus
can slot behind the same interface for multi-host deployments.
"""

from __future__ import annotations

import base64
import json
import logging
import queue
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

QUEUE_GLOBAL = "global"
QUEUE_SCHEDULERS = "schedulers"


def scheduler_queue(scheduler_id: int) -> str:
    """(internal/job/constants.go GetSchedulerQueue)"""
    return f"scheduler_{scheduler_id}"


@dataclass
class PreheatRequest:
    """One URL for a seed peer to warm (manager/job/types PreheatRequest)."""

    url: str
    tag: str = ""
    filtered_query_params: List[str] = field(default_factory=list)
    headers: Dict[str, str] = field(default_factory=dict)
    # Geo cluster whose bridge seed should warm (docs/GEO.md); "" keeps
    # the classic single-site preheat against the default seed peer.
    cluster: str = ""


@dataclass
class Job:
    id: str
    type: str  # "preheat" | "sync_peers"
    payload: PreheatRequest | dict
    group_id: str = ""


@dataclass
class GroupStatus:
    group_id: str
    total: int
    succeeded: int = 0
    failed: int = 0
    errors: List[str] = field(default_factory=list)
    # Non-None handler return values (the machinery result backend role:
    # sync_peers workers return their peer lists through here).
    results: List = field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.succeeded + self.failed >= self.total

    @property
    def state(self) -> str:
        if not self.done:
            return "PENDING"
        return "SUCCESS" if self.failed == 0 else "FAILURE"


class JobBus:
    """Named queues + worker registration (the machinery broker role)."""

    def __init__(self) -> None:
        self._queues: Dict[str, "queue.Queue[Job]"] = {}
        self._lock = threading.Lock()
        self._groups: Dict[str, GroupStatus] = {}
        self._workers: List[threading.Thread] = []
        self._stop = threading.Event()

    def _queue(self, name: str) -> "queue.Queue[Job]":
        with self._lock:
            if name not in self._queues:
                self._queues[name] = queue.Queue()
            return self._queues[name]

    def post(self, queue_name: str, job: Job) -> None:
        self._queue(queue_name).put(job)

    def post_group(self, queue_names: List[str], make_job) -> GroupStatus:
        """One job per queue, tracked as a group
        (manager/job/job.go CreateGroupJob)."""
        group_id = uuid.uuid4().hex
        status = GroupStatus(group_id=group_id, total=len(queue_names))
        with self._lock:
            self._groups[group_id] = status
        for name in queue_names:
            job = make_job()
            job.group_id = group_id
            self.post(name, job)
        return status

    def report(self, job: Job, ok: bool, error: str = "",
               result=None) -> None:
        if not job.group_id:
            return
        with self._lock:
            status = self._groups.get(job.group_id)
            if status is None:
                return
            if ok:
                status.succeeded += 1
                if result is not None:
                    status.results.append(result)
            else:
                status.failed += 1
                status.errors.append(error)

    def group_status(self, group_id: str) -> Optional[GroupStatus]:
        with self._lock:
            return self._groups.get(group_id)

    def serve_worker(self, queue_name: str,
                     handler: Callable[[Job], None]) -> None:
        """Consume a queue on a daemon thread; the handler's exception state
        decides the group report (scheduler/job/job.go:122 Serve)."""

        def loop() -> None:
            q = self._queue(queue_name)
            while not self._stop.is_set():
                try:
                    job = q.get(timeout=0.2)
                except queue.Empty:
                    continue
                try:
                    result = handler(job)
                except Exception as exc:
                    logger.exception("job %s failed", job.id)
                    self.report(job, ok=False, error=str(exc))
                else:
                    self.report(job, ok=True, result=result)

        t = threading.Thread(target=loop, name=f"job-{queue_name}",
                             daemon=True)
        with self._lock:
            self._workers.append(t)
        t.start()

    def stop(self) -> None:
        self._stop.set()
        for t in self._workers:
            t.join(timeout=2)


# ----------------------------------------------------------------------
# Image-manifest resolution (manager/job/preheat.go:168-316)
# ----------------------------------------------------------------------

MANIFEST_ACCEPT = ", ".join([
    "application/vnd.docker.distribution.manifest.v2+json",
    "application/vnd.docker.distribution.manifest.list.v2+json",
    "application/vnd.oci.image.manifest.v1+json",
    "application/vnd.oci.image.index.v1+json",
])


@dataclass
class ImageRef:
    registry: str  # scheme://host[:port]
    name: str
    tag: str

    @classmethod
    def parse(cls, image_url: str) -> "ImageRef":
        """``http(s)://registry/v2/<name>/manifests/<tag>`` — the URL shape
        the reference's preheat accepts (preheat.go parseAccessURL)."""
        import urllib.parse

        parsed = urllib.parse.urlparse(image_url)
        parts = parsed.path.strip("/").split("/")
        if len(parts) < 4 or parts[0] != "v2" or parts[-2] != "manifests":
            raise ValueError(
                f"not a registry manifest URL: {image_url!r} "
                "(want /v2/<name>/manifests/<tag>)")
        name = "/".join(parts[1:-2])
        return cls(registry=f"{parsed.scheme}://{parsed.netloc}",
                   name=name, tag=parts[-1])

    def manifest_url(self, reference: str | None = None) -> str:
        return f"{self.registry}/v2/{self.name}/manifests/{reference or self.tag}"

    def blob_url(self, digest: str) -> str:
        return f"{self.registry}/v2/{self.name}/blobs/{digest}"


# The Bearer half of the Docker registry token dance
# (manager/job/preheat.go:168-246 getManifests → getAuthToken) — shared
# with the oras:// source client via utils/registryauth.
from dragonfly2_tpu_torch.utils.registryauth import (  # noqa: E402
    fetch_registry_token,
)


def resolve_image_layers_with_auth(
        image_url: str, *, timeout: float = 30.0,
        headers: Dict[str, str] | None = None,
        username: str = "", password: str = "",
) -> Tuple[List[str], Dict[str, str]]:
    """Manifest (incl. multi-arch index) → layer blob URLs, negotiating
    registry auth on a 401 (WWW-Authenticate Bearer token handshake, or
    Basic). Returns ``(urls, auth_headers)`` — the auth headers must ride
    along to the seed peers, which fetch the blobs with the same token
    (preheat.go builds the layer requests with it)."""
    from dragonfly2_tpu_torch.utils.registryauth import open_with_registry_auth

    ref = ImageRef.parse(image_url)
    auth_headers: Dict[str, str] = {}
    auth = ""

    def fetch(url: str) -> dict:
        nonlocal auth_headers, auth
        resp, auth = open_with_registry_auth(
            url, headers={"Accept": MANIFEST_ACCEPT, **(headers or {})},
            username=username, password=password, repository=ref.name,
            auth=auth, timeout=timeout)
        if auth:
            auth_headers = {"Authorization": auth}
        with resp:
            return json.loads(resp.read())

    manifest = fetch(ref.manifest_url())
    # Multi-arch: pick every platform's manifest (the reference fans out
    # all architectures, preheat.go:206-246).
    manifests = [manifest]
    if "manifests" in manifest:  # index / manifest list
        manifests = [fetch(ref.manifest_url(m["digest"]))
                     for m in manifest["manifests"]]
    urls = []
    for m in manifests:
        for layer in m.get("layers", []):
            urls.append(ref.blob_url(layer["digest"]))
    return urls, auth_headers


def resolve_image_layers(image_url: str, *, timeout: float = 30.0,
                         headers: Dict[str, str] | None = None) -> List[str]:
    """Manifest (incl. multi-arch index) → layer blob URLs."""
    urls, _ = resolve_image_layers_with_auth(
        image_url, timeout=timeout, headers=headers)
    return urls


# ----------------------------------------------------------------------
# Manager-side preheat service
# ----------------------------------------------------------------------


class PreheatService:
    """Creates preheat group jobs across the active schedulers
    (manager/job/preheat.go:90-166 CreatePreheat)."""

    def __init__(self, bus: JobBus, manager=None):
        self.bus = bus
        self.manager = manager  # ManagerService for scheduler discovery

    def _target_queues(self, scheduler_ids: List[int] | None) -> List[str]:
        if scheduler_ids:
            return [scheduler_queue(i) for i in scheduler_ids]
        if self.manager is not None:
            from dragonfly2_tpu_torch.manager.database import STATE_ACTIVE

            rows = self.manager.db.find("schedulers", state=STATE_ACTIVE)
            if rows:
                return [scheduler_queue(r.id) for r in rows]
        # The shared QUEUE_SCHEDULERS has competing consumers — exactly ONE
        # scheduler would warm the URL while the group still reported
        # SUCCESS for the fleet. Refuse instead of lying.
        raise ValueError(
            "no active schedulers known; pass scheduler_ids explicitly")

    def preheat_urls(self, urls: List[str], *, tag: str = "",
                     headers: Dict[str, str] | None = None,
                     scheduler_ids: List[int] | None = None,
                     clusters: List[str] | None = None) -> List[GroupStatus]:
        """``clusters`` turns one preheat into a cross-site warm-up
        (docs/GEO.md): each URL posts one job per target cluster, and
        the scheduler-side worker routes each to that cluster's
        registered bridge seed — one WAN transfer per remote site,
        after which intra-cluster dissemination is local. None/[] keeps
        the classic single-site job shape."""
        queues = self._target_queues(scheduler_ids)
        groups = []
        for url in urls:
            for cluster in (clusters or [""]):
                groups.append(self.bus.post_group(
                    queues,
                    lambda url=url, cluster=cluster: Job(
                        id=uuid.uuid4().hex, type="preheat",
                        payload=PreheatRequest(url=url, tag=tag,
                                               headers=dict(headers or {}),
                                               cluster=cluster),
                    ),
                ))
        return groups

    def preheat_image(self, image_url: str, *, tag: str = "",
                      headers: Dict[str, str] | None = None,
                      username: str = "", password: str = "",
                      scheduler_ids: List[int] | None = None) -> List[GroupStatus]:
        layers, auth_headers = resolve_image_layers_with_auth(
            image_url, headers=headers, username=username, password=password)
        if not layers:
            raise ValueError(f"image {image_url} resolved to no layers")
        # Seed peers fetch the blobs with the negotiated token
        # (preheat.go builds layer requests with it).
        return self.preheat_urls(layers, tag=tag,
                                 headers={**(headers or {}), **auth_headers},
                                 scheduler_ids=scheduler_ids)

    def wait(self, groups: List[GroupStatus], timeout: float = 120.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            # One query per group per poll: durable GroupHandles compute
            # done AND state from a single snapshot (their per-field
            # properties would each re-query the shared DB lock).
            states = [g.snapshot() if hasattr(g, "snapshot")
                      else {"done": g.done, "state": g.state}
                      for g in groups]
            if all(s["done"] for s in states):
                return all(s["state"] == "SUCCESS" for s in states)
            time.sleep(0.05)
        return False


# ----------------------------------------------------------------------
# Scheduler-side worker
# ----------------------------------------------------------------------


class SchedulerJobWorker:
    """Consumes the scheduler's queues and triggers seed-peer downloads
    (scheduler/job/job.go:152-222 preheat)."""

    def __init__(self, bus: JobBus, scheduler_service, scheduler_id: int = 0):
        self.bus = bus
        self.service = scheduler_service
        self.scheduler_id = scheduler_id

    def serve(self) -> None:
        for name in (QUEUE_GLOBAL, QUEUE_SCHEDULERS,
                     scheduler_queue(self.scheduler_id)):
            self.bus.serve_worker(name, self._handle)

    def _handle(self, job: Job):
        if job.type == "preheat":
            req: PreheatRequest = job.payload
            self.service.preheat(
                req.url, tag=req.tag,
                filtered_query_params=req.filtered_query_params,
                request_header=req.headers,
                cluster=getattr(req, "cluster", ""))
            return None
        if job.type == "sync_peers":
            return self._sync_peers()
        raise ValueError(f"unknown job type {job.type!r}")

    def _sync_peers(self) -> dict:
        """Snapshot this scheduler's host view for the manager's merge
        (scheduler/job/job.go:224 syncPeers). Duck-typed: anything with
        ``list_host_snapshot`` (SchedulerService) or a bare resource."""
        if hasattr(self.service, "list_host_snapshot"):
            hosts = self.service.list_host_snapshot()
        else:
            hosts = [{
                "host_id": h.id, "hostname": h.hostname, "ip": h.ip,
                "port": h.port, "download_port": h.download_port,
                "type": getattr(h.type, "value", str(h.type)),
                "idc": h.network.idc if getattr(h, "network", None) else "",
                "location": (h.network.location
                             if getattr(h, "network", None) else ""),
            } for h in self.service.resource.host_manager]
        return {"scheduler_id": self.scheduler_id, "hosts": hosts}


class SyncPeersService:
    """Manager-initiated peer-list reconciliation
    (manager/job/sync_peers.go:40-176): pull each scheduler's host
    snapshot, merge into the peers table, drop rows the scheduler no
    longer reports.

    Two transports: ``mode="rpc"`` (default for df2-manager) calls each
    registered scheduler's ``ListHosts`` gRPC directly — works across
    processes with no shared broker; ``mode="bus"`` rides the in-process
    JobBus (single-process deployments and tests)."""

    def __init__(self, bus: Optional[JobBus], manager, mode: str = "bus"):
        self.bus = bus
        self.manager = manager  # ManagerService
        self.mode = mode

    def _active_rows(self, scheduler_ids: List[int] | None):
        from dragonfly2_tpu_torch.manager.database import STATE_ACTIVE

        rows = self.manager.db.find("schedulers", state=STATE_ACTIVE)
        if scheduler_ids is not None:
            rows = [r for r in rows if r.id in set(scheduler_ids)]
        return rows

    def sync(self, scheduler_ids: List[int] | None = None,
             timeout: float = 60.0) -> dict:
        if self.mode == "rpc":
            return self._sync_rpc(scheduler_ids, timeout)
        return self._sync_bus(scheduler_ids, timeout)

    def _sync_rpc(self, scheduler_ids, timeout: float) -> dict:
        from dragonfly2_tpu_torch.rpc.client import ServiceClient
        from dragonfly2_tpu_torch.scheduler.rpcserver import SCHEDULER_SPEC

        rows = self._active_rows(scheduler_ids)
        if not rows:
            raise ValueError("no active schedulers to sync")
        merged, errors = 0, []
        for row in rows:
            cli = ServiceClient(f"{row.ip}:{row.port}", SCHEDULER_SPEC)
            try:
                from dragonfly2_tpu_torch.scheduler.rpcserver import Empty

                resp = cli.ListHosts(Empty(),
                                     timeout=min(timeout, 10.0))
                merged += self._merge(
                    {"scheduler_id": row.id, "hosts": resp.hosts})
            except Exception as exc:  # noqa: BLE001 — per-replica
                errors.append(f"{row.ip}:{row.port}: {exc}")
            finally:
                cli.close()
        return {"group_id": uuid.uuid4().hex,
                "state": "SUCCESS" if not errors else "PARTIAL",
                "schedulers": len(rows), "merged_peers": merged,
                "errors": errors}

    def _sync_bus(self, scheduler_ids, timeout: float) -> dict:
        if scheduler_ids is None:
            scheduler_ids = [r.id for r in self._active_rows(None)]
        if not scheduler_ids:
            raise ValueError("no active schedulers to sync")
        group = self.bus.post_group(
            [scheduler_queue(i) for i in scheduler_ids],
            lambda: Job(id=uuid.uuid4().hex, type="sync_peers", payload={}),
        )
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not group.done:
            time.sleep(0.05)
        merged = 0
        for snapshot in list(group.results):
            merged += self._merge(snapshot)
        return {"group_id": group.group_id, "state": group.state,
                "schedulers": len(scheduler_ids), "merged_peers": merged,
                "errors": list(group.errors)}

    def _merge(self, snapshot: dict) -> int:
        db = self.manager.db
        scheduler_id = snapshot["scheduler_id"]
        seen = set()
        for h in snapshot["hosts"]:
            seen.add(h["host_id"])
            existing = db.find_one("peers", host_id=h["host_id"],
                                   scheduler_id=scheduler_id)
            fields = dict(
                hostname=h["hostname"], ip=h["ip"], port=h["port"],
                download_port=h["download_port"], type=h["type"],
                idc=h["idc"], location=h["location"], state="active",
            )
            if existing is None:
                db.insert("peers", host_id=h["host_id"],
                          scheduler_id=scheduler_id, **fields)
            else:
                db.update("peers", existing.id, **fields)
        # Full reconciliation: rows this scheduler stopped reporting go.
        for row in db.find("peers", scheduler_id=scheduler_id):
            if row.host_id not in seen:
                db.delete("peers", row.id)
        return len(seen)
