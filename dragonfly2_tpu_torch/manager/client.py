"""Instance-side manager HTTP client (schedulers/daemons → manager).

Reference counterpart: pkg/rpc/manager/client (UpdateScheduler, KeepAlive,
ListSchedulers, GetSchedulerClusterConfig over gRPC). Instances talk to the
manager's ``/internal/v1`` surface — trusted-network service endpoints,
exempt from the user-facing JWT/RBAC exactly like the reference's gRPC
manager server (operators firewall it; mTLS is the hardening path).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional


class ManagerClientError(Exception):
    pass


class ManagerHTTPClient:
    def __init__(self, base_url: str, timeout: float = 10.0):
        if "://" not in base_url:
            base_url = "http://" + base_url
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _call(self, method: str, path: str, body: Optional[Dict] = None,
              query: Optional[Dict[str, str]] = None):
        url = self.base_url + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read() or b"null")
        except urllib.error.HTTPError as exc:
            detail = exc.read().decode(errors="replace")[:200]
            raise ManagerClientError(
                f"{method} {path}: HTTP {exc.code} {detail}") from exc
        except urllib.error.URLError as exc:
            raise ManagerClientError(f"{method} {path}: {exc.reason}") from exc

    # -- instance registration / keepalive ------------------------------

    def update_scheduler_instance(self, *, hostname: str, ip: str, port: int,
                                  cluster_id: int = 0) -> Dict:
        """Returns the scheduler row (its ``id`` keys model uploads)."""
        return self._call("POST", "/internal/v1/schedulers", {
            "hostname": hostname, "ip": ip, "port": port,
            "scheduler_cluster_id": cluster_id,
        })

    def keepalive_scheduler(self, *, hostname: str, ip: str,
                            cluster_id: int) -> None:
        self._call("POST", "/internal/v1/keepalive", {
            "source_type": "scheduler", "hostname": hostname, "ip": ip,
            "cluster_id": cluster_id,
        })

    # -- model lifecycle ------------------------------------------------

    def quarantine_model_version(self, *, model_type: str, version: str,
                                 scheduler_id: int = 0,
                                 reason: str = "") -> Optional[Dict]:
        """Runtime-guard escalation: quarantine a poisoned serving
        version at the registry (fleet-wide rollback — every sidecar's
        next watcher poll restores the previous good version). Returns
        the restored row, or None when nothing was restorable."""
        resp = self._call("POST", "/internal/v1/models/quarantine", {
            "type": model_type, "version": version,
            "scheduler_id": scheduler_id, "reason": reason,
        })
        return resp.get("restored")

    def upload_announce_traces(self, scheduler_id: int,
                               payload: bytes) -> None:
        """Ship recorded announce traces (validation.TraceLog bytes) so
        the manager's validation gate replays REAL traffic against
        future candidates of this scheduler."""
        import base64

        self._call("POST", "/internal/v1/models/traces", {
            "scheduler_id": scheduler_id,
            "payload": base64.b64encode(payload).decode(),
        })

    # -- job plane ------------------------------------------------------

    def lease_job(self, *, queues: List[str], worker_id: str,
                  lease_ttl: float | None = None) -> Optional[Dict]:
        """Claim the oldest runnable job in any of ``queues`` (None when
        all are empty)."""
        resp = self._call("POST", "/internal/v1/jobs/lease", {
            "queues": queues, "worker_id": worker_id,
            "lease_ttl": lease_ttl,
        })
        return resp.get("job")

    def complete_job(self, job_id: int, *, ok: bool, error: str = "",
                     result=None, worker_id: str = "") -> Dict:
        return self._call("POST", f"/internal/v1/jobs/{job_id}/complete", {
            "ok": ok, "error": error, "result": result,
            "worker_id": worker_id,
        })

    def renew_job(self, job_id: int, *, worker_id: str,
                  lease_ttl: float | None = None) -> bool:
        """Heartbeat a long-running job's lease; False = lease lost."""
        resp = self._call("POST", f"/internal/v1/jobs/{job_id}/renew", {
            "worker_id": worker_id, "lease_ttl": lease_ttl,
        })
        return bool(resp.get("renewed"))

    # -- dynconfig ------------------------------------------------------

    def daemon_dynconfig(self, *, ip: str = "",
                         hostname: str = "") -> Dict:
        """{schedulers: ["host:port", ...], client_config: {...}} for this
        daemon (client/config/dynconfig_manager.go's fetch)."""
        return self._call("GET", "/internal/v1/dynconfig/daemon",
                          query={"ip": ip, "hostname": hostname})

    def scheduler_cluster_config(self, cluster_id: int) -> Dict:
        return self._call(
            "GET", f"/internal/v1/dynconfig/scheduler/{cluster_id}")
