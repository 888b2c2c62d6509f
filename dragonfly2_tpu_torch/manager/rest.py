"""Manager REST API: JWT/PAT-authenticated, RBAC-guarded CRUD.

Reference counterpart: manager/router/router.go (route table),
manager/handlers/*.go (19 handler files), manager/middlewares/jwt.go +
rbac.go. Route → handler → service, with the middleware chain collapsed
into :meth:`RestApi.dispatch`: authenticate (Bearer JWT or ``dfp_`` PAT)
→ authorize (role policy on the first path segment: GET=read else write)
→ handle. ``/healthy`` and ``/api/v1/users/signin|signup`` are public,
matching the reference's unauthenticated routes.

Passing ``auth=None`` disables authentication (the embedded/in-process
mode used by older tests and single-box setups); ``df2-manager`` enables
it by default.
"""

from __future__ import annotations

import json
import logging
import re
import urllib.parse
from http.server import BaseHTTPRequestHandler
from typing import Callable, Dict, List, Optional, Tuple

from dragonfly2_tpu_torch.manager.auth import AuthError, AuthService, Identity
from dragonfly2_tpu_torch.manager.service import ManagerError, ManagerService
from dragonfly2_tpu_torch.utils.httpserver import ThreadedHTTPService

logger = logging.getLogger(__name__)

_PUBLIC = {("POST", "/api/v1/users/signin"),
           ("POST", "/api/v1/users/signup"),
           ("GET", "/healthy"),
           # Embedded console shell (manager.go:68-85): the page itself
           # is public; every API call it makes carries the JWT.
           ("GET", "/"),
           ("GET", "/console")}
# OAuth2 browser flow: redirect + callback are pre-auth by nature
# (router.go:104-105 registers them outside the jwt middleware).
_PUBLIC_PATTERNS = (
    re.compile(r"^/api/v1/users/signin/[\w-]+(/callback)?$"),
)


class HttpError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


class RawResponse:
    """A non-JSON payload (the embedded console's HTML); the HTTP shell
    writes ``body`` verbatim with ``content_type``."""

    def __init__(self, body: bytes, content_type: str):
        self.body = body
        self.content_type = content_type


def _row(r) -> dict:
    d = dict(r.data)
    d.pop("password_hash", None)
    d.pop("token_hash", None)
    # OAuth client secrets never leave the manager (handlers/oauth.go
    # returns the model, but our API-surface policy is redact-by-default).
    d.pop("client_secret", None)
    return d


class RestApi:
    """Routing + auth; transport-independent (the HTTP shell below binds
    it to a socket, tests may call :meth:`dispatch` directly)."""

    def __init__(self, service: ManagerService,
                 auth: Optional[AuthService] = None,
                 preheat=None, sync_peers=None, jobstore=None):
        self.service = service
        self.auth = auth
        self.preheat = preheat
        self.sync_peers = sync_peers
        # DurableJobStore when the cross-process job plane is wired;
        # group lookups then survive manager restarts.
        self.jobstore = jobstore
        self._groups: Dict[str, object] = {}
        # (method, compiled-path-regex) -> handler(identity, match, query, body)
        self.routes: List[Tuple[str, re.Pattern, Callable]] = []
        r = self._route
        r("GET", r"/healthy", lambda i, m, q, b: "OK")
        # embedded console (manager.go:68-85)
        r("GET", r"/", self._console)
        r("GET", r"/console", self._console)
        # users / auth (handlers/user.go, personal_access_token.go)
        r("POST", r"/api/v1/users/signup", self._signup)
        r("POST", r"/api/v1/users/signin", self._signin)
        # OAuth2 (handlers/oauth.go + router.go:104-105)
        r("GET", r"/api/v1/users/signin/(?P<name>[\w-]+)", self._oauth_signin)
        r("GET", r"/api/v1/users/signin/(?P<name>[\w-]+)/callback",
          self._oauth_callback)
        r("POST", r"/api/v1/oauth", self._create_oauth)
        r("GET", r"/api/v1/oauth", self._list_oauth)
        r("GET", r"/api/v1/oauth/(?P<id>\d+)", self._get_oauth)
        r("PATCH", r"/api/v1/oauth/(?P<id>\d+)", self._update_oauth)
        r("DELETE", r"/api/v1/oauth/(?P<id>\d+)", self._delete_in("oauths"))
        r("GET", r"/api/v1/users", self._list_users)
        r("POST", r"/api/v1/users/(?P<id>\d+)/roles", self._assign_role)
        r("DELETE", r"/api/v1/users/(?P<id>\d+)/roles/(?P<role>[\w-]+)",
          self._revoke_role)
        r("POST", r"/api/v1/personal-access-tokens", self._create_pat)
        r("GET", r"/api/v1/personal-access-tokens", self._list_pats)
        r("DELETE", r"/api/v1/personal-access-tokens/(?P<id>\d+)",
          self._revoke_pat)
        # scheduler clusters (handlers/scheduler_cluster.go)
        r("POST", r"/api/v1/scheduler-clusters", self._create_cluster)
        r("GET", r"/api/v1/scheduler-clusters", self._list_clusters)
        r("GET", r"/api/v1/scheduler-clusters/(?P<id>\d+)", self._get_cluster)
        r("PATCH", r"/api/v1/scheduler-clusters/(?P<id>\d+)",
          self._update_cluster)
        r("DELETE", r"/api/v1/scheduler-clusters/(?P<id>\d+)",
          self._delete_cluster)
        # schedulers / seed peers (handlers/scheduler.go, seed_peer.go)
        r("GET", r"/api/v1/schedulers", self._list_schedulers)
        r("DELETE", r"/api/v1/schedulers/(?P<id>\d+)",
          self._delete_in("schedulers"))
        r("GET", r"/api/v1/seed-peers", self._list_seed_peers)
        r("DELETE", r"/api/v1/seed-peers/(?P<id>\d+)",
          self._delete_in("seed_peers"))
        # applications (handlers/application.go)
        r("POST", r"/api/v1/applications", self._create_application)
        r("GET", r"/api/v1/applications", self._list_applications)
        r("DELETE", r"/api/v1/applications/(?P<id>\d+)",
          self._delete_in("applications"))
        # models (handlers/model.go)
        r("GET", r"/api/v1/models", self._list_models)
        r("GET", r"/api/v1/models/(?P<id>\d+)", self._get_model)
        r("PATCH", r"/api/v1/models/(?P<id>\d+)", self._update_model)
        r("POST", r"/api/v1/models/(?P<id>\d+)/rollback",
          self._rollback_model)
        r("DELETE", r"/api/v1/models/(?P<id>\d+)", self._delete_in("models"))
        # peers (sync-peers results; handlers/peer.go)
        r("GET", r"/api/v1/peers", self._list_peers)
        # jobs (handlers/job.go)
        r("POST", r"/api/v1/jobs", self._create_job)
        r("GET", r"/api/v1/jobs", self._list_jobs)
        r("GET", r"/api/v1/jobs/(?P<id>\w+)", self._get_job)
        r("POST", r"/api/v1/jobs/(?P<id>\d+)/requeue", self._requeue_job)
        # configs (handlers/config.go)
        r("POST", r"/api/v1/configs", self._set_config)
        r("GET", r"/api/v1/configs", self._list_configs)
        # internal service surface (the reference's gRPC manager server
        # role: instance registration, keepalive, dynconfig answers —
        # unauthenticated like the reference's rpcserver, and therefore
        # served ONLY from a listener bound with surface="internal"
        # (df2-manager --internal-port) so operators can firewall it
        # separately from the user-facing API; mTLS is the hardening path)
        r("POST", r"/internal/v1/schedulers", self._internal_update_scheduler)
        r("POST", r"/internal/v1/keepalive", self._internal_keepalive)
        # model lifecycle, instance-facing: a scheduler's runtime guard
        # escalates a poisoned serving version here (fleet-wide
        # rollback), and ships its recorded announce traces for the
        # validation gate's replay corpus (docs/SERVING.md)
        r("POST", r"/internal/v1/models/quarantine",
          self._internal_quarantine_model)
        r("POST", r"/internal/v1/models/traces",
          self._internal_record_traces)
        r("GET", r"/internal/v1/dynconfig/daemon", self._internal_daemon_cfg)
        r("GET", r"/internal/v1/dynconfig/scheduler/(?P<id>\d+)",
          self._internal_scheduler_cfg)
        # job plane: schedulers lease/complete jobs over the internal
        # surface (the machinery-broker role — internal/job/job.go:33-60)
        r("POST", r"/internal/v1/jobs/lease", self._internal_lease_job)
        r("POST", r"/internal/v1/jobs/(?P<id>\d+)/complete",
          self._internal_complete_job)
        r("POST", r"/internal/v1/jobs/(?P<id>\d+)/renew",
          self._internal_renew_job)

    def _route(self, method: str, pattern: str, handler: Callable) -> None:
        self.routes.append((method, re.compile(f"^{pattern}$"), handler))

    # -- middleware chain -------------------------------------------------

    def dispatch(self, method: str, path: str, query: Dict[str, str],
                 body: dict, authorization: str = "",
                 surface: str = "public") -> Tuple[int, object]:
        internal_path = path.startswith("/internal/v1/")
        if surface == "internal":
            # The instance listener serves ONLY the internal surface (and
            # liveness) — a user API exposed there would be auth-free.
            if not internal_path and path != "/healthy":
                return 404, {"error": "not an internal route"}
        elif internal_path:
            # And the public listener never serves internal routes, so
            # the unauthenticated surface is only reachable through the
            # separately-bindable (firewallable) internal port.
            return 404, {"error": "internal surface is on --internal-port"}
        identity: Optional[Identity] = None
        public = ((method, path) in _PUBLIC or internal_path
                  or (method == "GET" and any(
                      p.match(path) for p in _PUBLIC_PATTERNS)))
        if self.auth is not None and not public:
            identity = self.auth.authenticate(authorization)
            if identity is None:
                return 401, {"error": "authentication required"}
            obj = self._object_of(path)
            action = "read" if method in ("GET", "HEAD") else "write"
            if not identity.can(obj, action):
                return 403, {"error":
                             f"role lacks {action} permission on {obj}"}
        for route_method, pattern, handler in self.routes:
            if route_method != method:
                continue
            m = pattern.match(path)
            if m is None:
                continue
            try:
                return 200, handler(identity, m, query, body)
            except HttpError as exc:
                return exc.code, {"error": exc.message}
            except (AuthError, ManagerError, KeyError, ValueError) as exc:
                return 400, {"error": str(exc)}
        return 404, {"error": "unknown route"}

    @staticmethod
    def _object_of(path: str) -> str:
        parts = path.strip("/").split("/")
        return parts[2] if len(parts) >= 3 else parts[-1]

    # -- users ------------------------------------------------------------

    def _require_auth_configured(self):
        if self.auth is None:
            raise HttpError(503, "auth is not enabled on this manager")

    def _signup(self, identity, m, q, body):
        self._require_auth_configured()
        user = self.auth.signup(body["name"], body["password"],
                                email=body.get("email", ""))
        return _row(user)

    def _signin(self, identity, m, q, body):
        self._require_auth_configured()
        try:
            token = self.auth.signin(body["name"], body["password"])
        except AuthError as exc:
            raise HttpError(401, str(exc))
        return {"token": token}

    def _list_users(self, identity, m, q, body):
        self._require_auth_configured()
        return [dict(_row(u), roles=self.auth.roles_of(u.id))
                for u in self.service.db.find("users")]

    def _assign_role(self, identity, m, q, body):
        self._require_auth_configured()
        self.auth.assign_role(int(m.group("id")), body["role"])
        return {"ok": True}

    def _revoke_role(self, identity, m, q, body):
        self._require_auth_configured()
        self.auth.revoke_role(int(m.group("id")), m.group("role"))
        return {"ok": True}

    def _create_pat(self, identity, m, q, body):
        self._require_auth_configured()
        user_id = identity.user_id if identity else int(body["user_id"])
        raw = self.auth.create_pat(user_id, body.get("name", "token"),
                                   scopes=body.get("scopes"))
        return {"token": raw}

    def _list_pats(self, identity, m, q, body):
        rows = self.service.db.find("personal_access_tokens")
        if identity is not None:
            rows = [r for r in rows if r.user_id == identity.user_id]
        return [_row(r) for r in rows]

    def _revoke_pat(self, identity, m, q, body):
        self._require_auth_configured()
        self.auth.revoke_pat(int(m.group("id")))
        return {"ok": True}

    # -- console -----------------------------------------------------------

    def _console(self, identity, m, q, body):
        from dragonfly2_tpu_torch.manager.console import console_html

        return RawResponse(console_html(), "text/html; charset=utf-8")

    # -- OAuth2 (handlers/oauth.go, user.go OauthSignin*) ------------------

    def _oauth_signin(self, identity, m, q, body):
        self._require_auth_configured()
        try:
            return {"location": self.auth.oauth_signin(m.group("name"))}
        except AuthError as exc:
            raise HttpError(404, str(exc))

    def _oauth_callback(self, identity, m, q, body):
        self._require_auth_configured()
        code = q.get("code", "")
        if not code:
            raise HttpError(400, "missing code")
        try:
            token = self.auth.oauth_signin_callback(
                m.group("name"), code, state=q.get("state", ""))
        except AuthError as exc:
            raise HttpError(401, str(exc))
        return {"token": token}

    def _create_oauth(self, identity, m, q, body):
        from dragonfly2_tpu_torch.manager.oauth import OAuthError, new_provider
        try:  # validate the provider name up front (oauth.go New())
            new_provider(body["name"], body.get("client_id", ""),
                         body.get("client_secret", ""),
                         body.get("redirect_url", ""))
        except OAuthError as exc:
            raise HttpError(400, str(exc))
        if self.service.db.find_one("oauths", name=body["name"]) is not None:
            raise HttpError(409, f"oauth {body['name']!r} exists")
        row_id = self.service.db.insert(
            "oauths", name=body["name"], bio=body.get("bio", ""),
            client_id=body["client_id"], client_secret=body["client_secret"],
            redirect_url=body.get("redirect_url", ""),
            auth_url=body.get("auth_url", ""),
            token_url=body.get("token_url", ""),
            userinfo_url=body.get("userinfo_url", ""))
        return _row(self.service.db.get("oauths", row_id))

    def _list_oauth(self, identity, m, q, body):
        return [_row(r) for r in self.service.db.find("oauths")]

    def _get_oauth(self, identity, m, q, body):
        row = self.service.db.get("oauths", int(m.group("id")))
        if row is None:
            raise HttpError(404, "oauth not found")
        return _row(row)

    def _update_oauth(self, identity, m, q, body):
        allowed = {k: v for k, v in body.items()
                   if k in ("bio", "client_id", "client_secret",
                            "redirect_url", "auth_url", "token_url",
                            "userinfo_url")}
        if not allowed:
            raise HttpError(400, "no updatable fields")
        self.service.db.update("oauths", int(m.group("id")), **allowed)
        return self._get_oauth(identity, m, q, body)

    # -- clusters ----------------------------------------------------------

    def _create_cluster(self, identity, m, q, body):
        row = self.service.create_scheduler_cluster(
            body["name"], config=body.get("config"),
            client_config=body.get("client_config"),
            scopes=body.get("scopes"),
            is_default=body.get("is_default", False))
        return _row(row)

    def _list_clusters(self, identity, m, q, body):
        return [_row(c) for c in self.service.list_scheduler_clusters()]

    def _get_cluster(self, identity, m, q, body):
        row = self.service.db.get("scheduler_clusters", int(m.group("id")))
        if row is None:
            raise HttpError(404, "cluster not found")
        return _row(row)

    def _update_cluster(self, identity, m, q, body):
        allowed = {k: v for k, v in body.items()
                   if k in ("name", "config", "client_config", "scopes",
                            "is_default")}
        if not allowed:
            raise HttpError(400, "no updatable fields")
        self.service.db.update("scheduler_clusters", int(m.group("id")),
                               **allowed)
        return self._get_cluster(identity, m, q, body)

    def _delete_cluster(self, identity, m, q, body):
        self.service.db.delete("scheduler_clusters", int(m.group("id")))
        return {"ok": True}

    def _delete_in(self, table: str):
        def handler(identity, m, q, body):
            self.service.db.delete(table, int(m.group("id")))
            return {"ok": True}

        return handler

    # -- instances ---------------------------------------------------------

    def _list_schedulers(self, identity, m, q, body):
        if q.get("all"):
            return [_row(r) for r in self.service.db.find("schedulers")]
        rows = self.service.list_schedulers(
            ip=q.get("ip", ""), hostname=q.get("hostname", ""))
        return [_row(r) for r in rows]

    def _list_seed_peers(self, identity, m, q, body):
        return [_row(r) for r in self.service.db.find("seed_peers")]

    # -- applications ------------------------------------------------------

    def _create_application(self, identity, m, q, body):
        row = self.service.create_application(
            body["name"], url=body.get("url", ""), bio=body.get("bio", ""),
            priorities=body.get("priorities"))
        return _row(row)

    def _list_applications(self, identity, m, q, body):
        return [_row(r) for r in self.service.list_applications()]

    # -- models ------------------------------------------------------------

    def _list_models(self, identity, m, q, body):
        sid = int(q["scheduler_id"]) if "scheduler_id" in q else None
        return [_row(r) for r in self.service.list_models(sid)]

    def _get_model(self, identity, m, q, body):
        row = self.service.db.get("models", int(m.group("id")))
        if row is None:
            raise HttpError(404, "model not found")
        return _row(row)

    def _update_model(self, identity, m, q, body):
        state = body.get("state")
        if state not in ("active", "inactive"):
            # candidate/quarantined are lifecycle states the gate and
            # rollback APIs own — never settable by hand.
            raise HttpError(400, "state must be active|inactive")
        if self.service.db.get("models", int(m.group("id"))) is None:
            raise HttpError(404, "model not found")
        try:
            self.service.set_model_state(int(m.group("id")), state)
        except ManagerError as exc:
            # The only ManagerError left after the existence check is
            # quarantined-reactivation — refused with conflict
            # semantics, not a generic bad-request.
            raise HttpError(409, str(exc))
        return self._get_model(identity, m, q, body)

    def _rollback_model(self, identity, m, q, body):
        """Quarantine THIS version and (when it was active) restore the
        previous good one atomically — the operator's big red button
        (docs/SERVING.md rollback semantics)."""
        row = self.service.db.get("models", int(m.group("id")))
        if row is None:
            raise HttpError(404, "model not found")
        restored = self.service.quarantine_version(
            row.type, row.version, row.scheduler_id,
            reason=body.get("reason", "operator rollback via REST"))
        out = {"quarantined": _row(self.service.db.get("models", row.id))}
        out["restored"] = (
            _row(self.service.db.get("models", restored.id))
            if restored is not None else None)
        return out

    # -- peers -------------------------------------------------------------

    def _list_peers(self, identity, m, q, body):
        where = {}
        if "scheduler_id" in q:
            where["scheduler_id"] = int(q["scheduler_id"])
        return [_row(r) for r in self.service.db.find("peers", **where)]

    # -- jobs --------------------------------------------------------------

    def _create_job(self, identity, m, q, body):
        job_type = body.get("type")
        if job_type == "preheat":
            if self.preheat is None:
                raise HttpError(503, "preheat service not wired")
            preheat_args = body.get("args", {})
            if "url" not in preheat_args:
                raise HttpError(400, "args.url required")
            if "/manifests/" in preheat_args["url"]:
                groups = self.preheat.preheat_image(
                    preheat_args["url"],
                    headers=preheat_args.get("headers"),
                    username=preheat_args.get("username", ""),
                    password=preheat_args.get("password", ""),
                    scheduler_ids=body.get("scheduler_ids"))
            else:
                groups = self.preheat.preheat_urls(
                    [preheat_args["url"]],
                    headers=preheat_args.get("headers"),
                    scheduler_ids=body.get("scheduler_ids"),
                    # Cross-site warm-up (docs/GEO.md): one job per
                    # listed geo cluster, each routed to that site's
                    # bridge seed.
                    clusters=preheat_args.get("clusters"))
            for g in groups:
                self._groups[g.group_id] = g
            return {"ids": [g.group_id for g in groups]}
        if job_type == "sync_peers":
            if self.sync_peers is None:
                raise HttpError(503, "sync-peers service not wired")
            return self.sync_peers.sync(
                scheduler_ids=body.get("scheduler_ids"),
                timeout=float(body.get("timeout", 60.0)))
        raise HttpError(400, f"unsupported job type {job_type!r}")

    def _get_job(self, identity, m, q, body):
        status = self._groups.get(m.group("id"))
        if status is not None and not hasattr(status, "snapshot"):
            # In-process JobBus GroupStatus (plain dataclass fields).
            return {"id": status.group_id, "state": status.state,
                    "succeeded": status.succeeded, "failed": status.failed,
                    "errors": status.errors}
        if status is None and self.jobstore is not None:
            # Durable groups survive a manager restart.
            status = self.jobstore.group_status(m.group("id"))
        if status is None:
            raise HttpError(404, "unknown job")
        snap = status.snapshot()  # all fields from one query
        return {"id": snap["group_id"], "state": snap["state"],
                "succeeded": snap["succeeded"], "failed": snap["failed"],
                "errors": snap["errors"]}

    @staticmethod
    def _redact_job(row) -> dict:
        """Job rows carry whatever headers the preheat negotiated —
        registry Bearer tokens / Basic credentials must never reach a
        read-only API user."""
        d = _row(row)
        payload = d.get("payload")
        if isinstance(payload, dict):
            payload = dict(payload)
            headers = payload.get("headers")
            if isinstance(headers, dict):
                payload["headers"] = {
                    k: ("<redacted>" if k.lower() in
                        ("authorization", "proxy-authorization",
                         "x-registry-auth") else v)
                    for k, v in headers.items()}
            for secret in ("username", "password"):
                if payload.get(secret):
                    payload[secret] = "<redacted>"
            d["payload"] = payload
        return d

    def _list_jobs(self, identity, m, q, body):
        """Queue introspection incl. the dead-letter view
        (``?state=dead``)."""
        if self.jobstore is None:
            return []
        where = {}
        if "state" in q:
            where["state"] = q["state"]
        if "queue" in q:
            where["queue"] = q["queue"]
        return [self._redact_job(r)
                for r in self.jobstore.db.find("queued_jobs", **where)]

    def _requeue_job(self, identity, m, q, body):
        """Operator escape hatch: fresh attempts for a dead-lettered job."""
        if self.jobstore is None:
            raise HttpError(503, "job store not wired")
        if not self.jobstore.requeue_dead(int(m.group("id"))):
            raise HttpError(409, "job is not dead-lettered")
        return {"ok": True}

    def _internal_lease_job(self, identity, m, q, body):
        if self.jobstore is None:
            raise HttpError(503, "job store not wired")
        queues = body.get("queues") or []
        if not queues:
            raise HttpError(400, "queues required")
        job = self.jobstore.lease(
            queues, body.get("worker_id", ""),
            lease_ttl=body.get("lease_ttl"))
        return {"job": job}

    def _internal_complete_job(self, identity, m, q, body):
        if self.jobstore is None:
            raise HttpError(503, "job store not wired")
        return self.jobstore.complete(
            int(m.group("id")), ok=bool(body.get("ok")),
            error=body.get("error", ""), result=body.get("result"),
            worker_id=body.get("worker_id", ""))

    def _internal_renew_job(self, identity, m, q, body):
        if self.jobstore is None:
            raise HttpError(503, "job store not wired")
        renewed = self.jobstore.renew(
            int(m.group("id")), body.get("worker_id", ""),
            lease_ttl=body.get("lease_ttl"))
        return {"renewed": renewed}

    # -- configs -----------------------------------------------------------

    def _set_config(self, identity, m, q, body):
        existing = self.service.db.find_one("configs", name=body["name"])
        if existing is None:
            self.service.db.insert("configs", name=body["name"],
                                   value=body.get("value", ""))
        else:
            self.service.db.update("configs", existing.id,
                                   value=body.get("value", ""))
        return {"ok": True}

    def _list_configs(self, identity, m, q, body):
        return [_row(r) for r in self.service.db.find("configs")]

    # -- internal service surface -----------------------------------------

    def _default_cluster_id(self) -> int:
        row = (self.service.db.find_one("scheduler_clusters", is_default=1)
               or self.service.db.find_one("scheduler_clusters"))
        if row is not None:
            return row.id
        return self.service.create_scheduler_cluster(
            "default", is_default=True).id

    def _internal_update_scheduler(self, identity, m, q, body):
        cluster_id = (int(body.get("scheduler_cluster_id") or 0)
                      or self._default_cluster_id())
        row = self.service.update_scheduler(
            hostname=body["hostname"], ip=body["ip"],
            port=int(body["port"]), scheduler_cluster_id=cluster_id,
            features=body.get("features"))
        return _row(row)

    def _internal_keepalive(self, identity, m, q, body):
        self.service.keepalive(
            source_type=body["source_type"], hostname=body["hostname"],
            ip=body["ip"], cluster_id=int(body["cluster_id"]))
        return {"ok": True}

    def _internal_quarantine_model(self, identity, m, q, body):
        """Runtime-guard escalation from a scheduler: quarantine the
        named version; when it was active the previous good version is
        restored atomically and every sidecar's next watcher poll picks
        the rollback up."""
        restored = self.service.quarantine_version(
            body["type"], body["version"],
            int(body.get("scheduler_id", 0)),
            reason=body.get("reason", "scheduler guard escalation"))
        return {"restored": _row(self.service.db.get("models", restored.id))
                if restored is not None else None}

    def _internal_record_traces(self, identity, m, q, body):
        """Recorded announce traces (validation.TraceLog bytes, base64)
        from a scheduler — the gate replays these against future
        candidates of that scheduler instead of synthetic batches."""
        import base64

        self.service.record_announce_traces(
            int(body.get("scheduler_id", 0)),
            base64.b64decode(body["payload"]))
        return {"ok": True}

    def _internal_daemon_cfg(self, identity, m, q, body):
        rows = self.service.list_schedulers(
            ip=q.get("ip", ""), hostname=q.get("hostname", ""))
        cluster_cfg = {}
        if rows:
            cluster = self.service.db.get(
                "scheduler_clusters", rows[0].scheduler_cluster_id)
            if cluster is not None:
                cluster_cfg = dict(cluster.client_config or {})
        return {
            "schedulers": [f"{r.ip}:{r.port}" for r in rows],
            "client_config": cluster_cfg,
        }

    def _internal_scheduler_cfg(self, identity, m, q, body):
        return self.service.get_scheduler_cluster_config(int(m.group("id")))


class ManagerHTTPServer(ThreadedHTTPService):
    """HTTP shell binding :class:`RestApi` to a socket.

    ``surface`` picks which route set this listener serves: "public"
    (user API, JWT/RBAC) or "internal" (instance registration/dynconfig,
    unauthenticated — bind it where only instances can reach).
    """

    def __init__(self, api: RestApi, host: str = "127.0.0.1", port: int = 0,
                 surface: str = "public"):
        self.api = api
        self.surface = surface

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                logger.debug("manager-rest: " + fmt, *args)

            def _dispatch(self):
                parsed = urllib.parse.urlparse(self.path)
                query = {k: v[0] for k, v in
                         urllib.parse.parse_qs(parsed.query).items()}
                length = int(self.headers.get("Content-Length", 0))
                try:
                    body = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError:
                    code, payload = 400, {"error": "invalid JSON body"}
                else:
                    code, payload = api.dispatch(
                        self.command, parsed.path, query, body,
                        authorization=self.headers.get("Authorization", ""),
                        surface=surface)
                metrics = getattr(api.service, "metrics", None)
                if metrics:
                    metrics.request_count.labels(
                        method=self.command, status=str(code)).inc()
                if isinstance(payload, RawResponse):
                    data, content_type = payload.body, payload.content_type
                else:
                    data, content_type = (json.dumps(payload).encode(),
                                          "application/json")
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = do_PATCH = do_DELETE = do_PUT = _dispatch

        super().__init__(Handler, host=host, port=port, name="manager-http")
