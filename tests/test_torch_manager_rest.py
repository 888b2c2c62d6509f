"""The manager's REST surface: the same request scripts through
``dragonfly2_tpu``'s and ``dragonfly2_tpu_torch``'s ``RestApi.dispatch``
give equal status codes and bodies (tokens, OAuth states, model versions
and times normalised); on loopback, the port's ``ManagerHTTPClient``
against JAX's ``ManagerHTTPServer`` and JAX's client against the port's
server give the answers each package gives itself; and
``python -m dragonfly2_tpu_torch.cmd.manager`` starts, prints both
listeners, answers ``/healthy`` and stops on SIGTERM. The OAuth
identity provider is faked on loopback: no test leaves the host."""

from __future__ import annotations

import importlib
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("dragonfly2_tpu", "dragonfly2_tpu_torch")
VOLATILE = {"created_at", "updated_at", "last_keepalive", "expires_at"}
VALID_CODE = "authcode-42"
VALID_TOKEN = "provider-token-007"


class _FakeProvider(BaseHTTPRequestHandler):
    """Token + userinfo endpoints of a github-shaped identity provider."""

    userinfo = {"id": 583231, "login": "octocat", "name": "Mona Lisa",
                "email": "mona@example.com"}

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0))
        form = dict(urllib.parse.parse_qsl(self.rfile.read(length).decode()))
        if self.path != "/token" or form.get("code") != VALID_CODE:
            return self._json(200, {"error": "bad_verification_code"})
        self._json(200, {"access_token": VALID_TOKEN, "token_type": "bearer"})

    def do_GET(self):
        if self.headers.get("Authorization") != f"Bearer {VALID_TOKEN}":
            return self._json(401, {"error": "bad token"})
        self._json(200, self.userinfo)

    def _json(self, code, payload):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def provider_url():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _FakeProvider)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()


class Normaliser:
    """Replaces what differs run to run by construction: times, session
    and access tokens, OAuth states, model versions (uuids, numbered in
    order of first sight)."""

    def __init__(self):
        self.versions: dict = {}

    def version(self, v: str) -> str:
        return self.versions.setdefault(v, f"<v{len(self.versions)}>")

    def __call__(self, x):
        if isinstance(x, dict):
            out = {}
            for k, v in x.items():
                if k in VOLATILE:
                    out[k] = "<time>"
                elif k == "token" and isinstance(v, str):
                    out[k] = "<token>"
                elif k == "version" and isinstance(v, str):
                    out[k] = self.version(v)
                elif k == "location" and isinstance(v, str) and "state=" in v:
                    out[k] = v.split("state=")[0] + "state=<state>"
                else:
                    out[k] = self(v)
            return out
        if isinstance(x, (list, tuple)):
            return [self(v) for v in x]
        if isinstance(x, str):
            for v, tag in self.versions.items():
                x = x.replace(v, tag)
            return x
        return x


class Session:
    """One package's manager, auth and API, with a call recorder."""

    def __init__(self, pkg: str, tmp_path, provider_url: str):
        m = importlib.import_module(f"{pkg}.manager")
        self.auth_mod = importlib.import_module(f"{pkg}.manager.auth")
        self.rest = importlib.import_module(f"{pkg}.manager.rest")
        self.validation = importlib.import_module(f"{pkg}.manager.validation")
        self.pkg = pkg
        self.root = tmp_path / pkg
        self.root.mkdir(parents=True)
        self.service = m.ManagerService(
            m.Database(str(self.root / "manager.db")),
            m.FilesystemObjectStore(str(self.root / "objects")))
        self.api = self.rest.RestApi(self.service, auth=self.auth_mod.
                                     AuthService(self.service.db,
                                                 secret="test-secret"))
        self.provider_url = provider_url
        self.norm = Normaliser()
        self.log: list = []

    def call(self, method, path, body=None, token="", query=None,
             surface="public"):
        code, payload = self.api.dispatch(method, path, query or {},
                                          body or {}, authorization=token,
                                          surface=surface)
        if isinstance(payload, self.rest.RawResponse):
            payload = {"content_type": payload.content_type,
                       "bytes": len(payload.body)}
        self.log.append([method, path, code, self.norm(payload)])
        return code, payload

    def signin(self, name="root", password="dragonfly") -> str:
        code, payload = self.call("POST", "/api/v1/users/signin",
                                  {"name": name, "password": password})
        assert code == 200, payload
        return "Bearer " + payload["token"]

    def artifact(self, tag: str) -> str:
        d = self.root / f"artifact-{tag}"
        d.mkdir()
        (d / "model.bin").write_bytes(tag.encode() * 8)
        return str(d)

    def create_model(self, tag: str, model_type="mlp", scheduler_id=0):
        row = self.service.create_model(
            f"m-{tag}", model_type, "h", "10.0.0.1", "host", {"f1": 0.9},
            self.artifact(tag), scheduler_id=scheduler_id)
        self.norm.version(row.version)
        return row


def script_users(s: Session):
    s.call("GET", "/api/v1/models")
    s.call("GET", "/api/v1/models", token="Bearer junk")
    s.call("POST", "/api/v1/users/signin", {"name": "root",
                                            "password": "wrong"})
    root = s.signin()
    s.call("POST", "/api/v1/users/signup", {"name": "bob",
                                            "password": "pw12345",
                                            "email": "bob@x"})
    s.call("POST", "/api/v1/users/signup", {"name": "bob",
                                            "password": "pw12345"})
    bob = s.signin("bob", "pw12345")
    s.call("GET", "/api/v1/models", token=bob)
    s.call("POST", "/api/v1/scheduler-clusters", {"name": "c1"}, token=bob)
    s.call("GET", "/api/v1/users", token=bob)
    s.call("GET", "/api/v1/users", token=root)
    _, users = s.call("GET", "/api/v1/users", token=root)
    bob_id = next(u["id"] for u in users if u["name"] == "bob")
    s.call("POST", f"/api/v1/users/{bob_id}/roles", {"role": "root"},
           token=root)
    bob = s.signin("bob", "pw12345")
    s.call("POST", "/api/v1/scheduler-clusters", {"name": "c1"}, token=bob)
    s.call("DELETE", f"/api/v1/users/{bob_id}/roles/root", token=root)
    bob = s.signin("bob", "pw12345")
    s.call("POST", "/api/v1/scheduler-clusters", {"name": "c2"}, token=bob)
    s.call("GET", "/healthy")


def script_pats(s: Session):
    root = s.signin()
    _, full = s.call("POST", "/api/v1/personal-access-tokens",
                     {"name": "ci"}, token=root)
    _, scoped = s.call("POST", "/api/v1/personal-access-tokens",
                       {"name": "jobs-only", "scopes": ["jobs"]},
                       token=root)
    full, scoped = "Bearer " + full["token"], "Bearer " + scoped["token"]
    s.call("GET", "/api/v1/models", token=full)
    s.call("POST", "/api/v1/scheduler-clusters", {"name": "p"}, token=full)
    s.call("GET", "/api/v1/models", token=scoped)
    s.call("POST", "/api/v1/scheduler-clusters", {"name": "q"},
           token=scoped)
    s.call("POST", "/api/v1/jobs", {"type": "preheat",
                                    "args": {"url": "http://x/f"}},
           token=scoped)
    s.call("POST", "/api/v1/jobs", {"type": "sync_peers"}, token=scoped)
    s.call("POST", "/api/v1/jobs", {"type": "bogus"}, token=scoped)
    s.call("GET", "/api/v1/jobs", token=scoped)
    s.call("GET", "/api/v1/jobs/123", token=scoped)
    s.call("POST", "/api/v1/jobs/3/requeue", token=scoped)
    _, pats = s.call("GET", "/api/v1/personal-access-tokens", token=root)
    s.call("DELETE", f"/api/v1/personal-access-tokens/{pats[0]['id']}",
           token=root)
    s.call("GET", "/api/v1/models", token=full)
    s.call("POST", "/api/v1/configs", {"name": "k", "value": "1"},
           token=root)
    s.call("POST", "/api/v1/configs", {"name": "k", "value": "2"},
           token=root)
    s.call("GET", "/api/v1/configs", token=root)


def script_clusters(s: Session):
    root = s.signin()
    _, c1 = s.call("POST", "/api/v1/scheduler-clusters",
                   {"name": "c1", "is_default": True,
                    "scopes": {"cidrs": ["10.0.0.0/8"]},
                    "config": {"filter_parent_limit": 4},
                    "client_config": {"load_limit": 7}}, token=root)
    _, c2 = s.call("POST", "/api/v1/scheduler-clusters",
                   {"name": "c2", "scopes": {"cidrs": ["172.16.0.0/12"]}},
                   token=root)
    s.call("GET", f"/api/v1/scheduler-clusters/{c1['id']}", token=root)
    s.call("GET", "/api/v1/scheduler-clusters/99", token=root)
    s.call("PATCH", f"/api/v1/scheduler-clusters/{c1['id']}",
           {"name": "c1-renamed", "config": {"filter_parent_limit": 9}},
           token=root)
    s.call("PATCH", f"/api/v1/scheduler-clusters/{c1['id']}", {"x": 1},
           token=root)
    for i, cid in enumerate((c1["id"], c2["id"], c2["id"])):
        s.call("POST", "/internal/v1/schedulers",
               {"hostname": f"s{i}", "ip": f"10.1.0.{i}", "port": 8002,
                "scheduler_cluster_id": cid}, surface="internal")
        s.call("POST", "/internal/v1/keepalive",
               {"source_type": "scheduler", "hostname": f"s{i}",
                "ip": f"10.1.0.{i}", "cluster_id": cid}, surface="internal")
    s.call("POST", "/internal/v1/keepalive",
           {"source_type": "scheduler", "hostname": "ghost", "ip": "1.1.1.1",
            "cluster_id": c1["id"]}, surface="internal")
    for ip in ("10.2.3.4", "172.16.5.6", "8.8.8.8"):
        s.call("GET", "/internal/v1/dynconfig/daemon", query={"ip": ip},
               surface="internal")
        s.call("GET", "/api/v1/schedulers", query={"ip": ip}, token=root)
    s.call("GET", "/api/v1/schedulers", query={"all": "1"}, token=root)
    s.call("GET", f"/internal/v1/dynconfig/scheduler/{c1['id']}",
           surface="internal")
    s.call("GET", "/internal/v1/dynconfig/scheduler/99", surface="internal")
    s.call("POST", "/api/v1/applications",
           {"name": "app", "priorities": {"value": 2}}, token=root)
    _, apps = s.call("GET", "/api/v1/applications", token=root)
    s.call("DELETE", f"/api/v1/applications/{apps[0]['id']}", token=root)
    s.call("GET", "/api/v1/seed-peers", token=root)
    s.call("GET", "/api/v1/peers", token=root)
    s.call("DELETE", f"/api/v1/scheduler-clusters/{c2['id']}", token=root)
    s.call("GET", "/api/v1/scheduler-clusters", token=root)
    # The internal surface needs no token: a scheduler registering with
    # no cluster lands in the default one.
    s.call("POST", "/internal/v1/schedulers",
           {"hostname": "late", "ip": "10.9.9.9", "port": 1},
           surface="internal")


def script_models(s: Session):
    root = s.signin()
    v1 = s.create_model("a", scheduler_id=3)
    v2 = s.create_model("b", scheduler_id=3)
    s.call("GET", "/api/v1/models", token=root)
    s.call("GET", "/api/v1/models", query={"scheduler_id": "3"}, token=root)
    s.call("GET", f"/api/v1/models/{v1.id}", token=root)
    s.call("GET", "/api/v1/models/99", token=root)
    s.call("PATCH", f"/api/v1/models/{v1.id}", {"state": "active"},
           token=root)
    s.call("PATCH", f"/api/v1/models/{v2.id}", {"state": "active"},
           token=root)
    s.call("POST", f"/api/v1/models/{v2.id}/rollback",
           {"reason": "operator"}, token=root)
    s.call("PATCH", f"/api/v1/models/{v2.id}", {"state": "active"},
           token=root)
    s.call("PATCH", f"/api/v1/models/{v1.id}", {"state": "quarantined"},
           token=root)
    s.call("PATCH", "/api/v1/models/99", {"state": "inactive"}, token=root)
    s.call("POST", f"/api/v1/models/{v1.id}/rollback", {}, token=root)
    s.call("POST", "/api/v1/models/99/rollback", {}, token=root)
    v3 = s.create_model("c", scheduler_id=3)
    v4 = s.create_model("d", scheduler_id=3)
    s.call("POST", "/internal/v1/models/quarantine",
           {"type": "mlp", "version": v4.version, "scheduler_id": 3,
            "reason": "guard"}, surface="internal")
    s.call("POST", "/internal/v1/models/quarantine",
           {"type": "mlp", "version": v4.version, "scheduler_id": 3},
           surface="internal")
    s.call("POST", "/internal/v1/models/quarantine",
           {"type": "mlp", "version": "nope", "scheduler_id": 3},
           surface="internal")
    log = s.validation.TraceLog()
    rng = np.random.default_rng(0)
    for _ in range(3):
        log.record(rng.uniform(0, 1, (4, 11)).astype(np.float32))
    import base64

    s.call("POST", "/internal/v1/models/traces",
           {"scheduler_id": 3,
            "payload": base64.b64encode(log.to_bytes()).decode()},
           surface="internal")
    traces = s.service.load_announce_traces(3)
    s.log.append(["traces", len(traces), [t.tolist() for t in traces]])
    s.call("DELETE", f"/api/v1/models/{v3.id}", token=root)
    s.call("GET", "/api/v1/models", token=root)


def script_surfaces(s: Session):
    root = s.signin()
    s.call("POST", "/internal/v1/keepalive", {"source_type": "scheduler"})
    s.call("GET", "/internal/v1/dynconfig/daemon")
    s.call("GET", "/api/v1/models", token=root, surface="internal")
    s.call("POST", "/api/v1/users/signin",
           {"name": "root", "password": "dragonfly"}, surface="internal")
    s.call("GET", "/healthy", surface="internal")
    s.call("GET", "/", surface="internal")
    s.call("GET", "/")
    s.call("GET", "/console")
    s.call("GET", "/api/v1/nowhere", token=root)
    s.call("GET", "/internal/v1/nowhere", surface="internal")
    s.call("POST", "/internal/v1/jobs/lease", {"queues": ["a"]},
           surface="internal")
    s.call("POST", "/internal/v1/jobs/3/complete", {"ok": True},
           surface="internal")
    s.call("POST", "/internal/v1/jobs/3/renew", {}, surface="internal")


def script_oauth(s: Session):
    root = s.signin()
    url = s.provider_url
    config = {"name": "github", "client_id": "cid", "client_secret": "sec",
              "redirect_url": "http://manager/cb",
              "auth_url": f"{url}/authorize", "token_url": f"{url}/token",
              "userinfo_url": f"{url}/user"}
    _, created = s.call("POST", "/api/v1/oauth", config, token=root)
    s.call("POST", "/api/v1/oauth", config, token=root)
    s.call("POST", "/api/v1/oauth", {"name": "gitlab", "client_id": "x",
                                     "client_secret": "y"}, token=root)
    s.call("GET", "/api/v1/oauth", token=root)
    s.call("PATCH", f"/api/v1/oauth/{created['id']}", {"bio": "corp"},
           token=root)
    s.call("GET", "/api/v1/oauth/99", token=root)
    s.call("GET", "/api/v1/users/signin/google")
    for code in (VALID_CODE, VALID_CODE, "stolen", ""):
        _, redirect = s.call("GET", "/api/v1/users/signin/github")
        state = dict(urllib.parse.parse_qsl(urllib.parse.urlparse(
            redirect["location"]).query))["state"]
        _, out = s.call("GET", "/api/v1/users/signin/github/callback",
                        query={"state": state, "code": code})
    users = [u for u in s.service.db.find("users") if u.name == "Mona Lisa"]
    s.log.append(["oauth users", len(users), users[0].email,
                  users[0].oauth_provider])
    s.call("DELETE", f"/api/v1/oauth/{created['id']}", token=root)


SCRIPTS = {"users": script_users, "pats": script_pats,
           "clusters": script_clusters, "models": script_models,
           "surfaces": script_surfaces, "oauth": script_oauth}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_rest_script_matches(name, tmp_path, provider_url):
    logs = {}
    for pkg in PACKAGES:
        s = Session(pkg, tmp_path, provider_url)
        try:
            SCRIPTS[name](s)
        finally:
            s.service.db.close()
        logs[pkg] = s.log
    assert logs["dragonfly2_tpu_torch"] == logs["dragonfly2_tpu"]
    codes = {entry[2] for entry in logs["dragonfly2_tpu_torch"]
             if len(entry) == 4}
    assert 200 in codes


# -- the wire ------------------------------------------------------------


def wire_script(client_pkg: str, server_pkg: str, tmp_path) -> list:
    """A scheduler's and a daemon's calls through ``client_pkg``'s
    ManagerHTTPClient to ``server_pkg``'s ManagerHTTPServer (public and
    internal listeners) on loopback."""
    s = Session(server_pkg, tmp_path / f"{client_pkg}-{server_pkg}", "")
    client_mod = importlib.import_module(f"{client_pkg}.manager.client")
    public = s.rest.ManagerHTTPServer(s.api, host="127.0.0.1", port=0)
    internal = s.rest.ManagerHTTPServer(s.api, host="127.0.0.1", port=0,
                                        surface="internal")
    public.start()
    internal.start()
    out = []
    norm = s.norm
    try:
        client = client_mod.ManagerHTTPClient(f"127.0.0.1:{internal.port}")
        wrong = client_mod.ManagerHTTPClient(
            f"http://127.0.0.1:{public.port}")
        cluster = s.service.create_scheduler_cluster(
            "c", config={"candidate_parent_limit": 6},
            client_config={"load_limit": 3}, is_default=True)
        row = client.update_scheduler_instance(
            hostname="s", ip="10.0.0.1", port=8002, cluster_id=cluster.id)
        out.append(norm(row))
        out.append(norm(client.update_scheduler_instance(
            hostname="s", ip="10.0.0.1", port=9002)))
        out.append(client.daemon_dynconfig(ip="10.1.1.1"))
        client.keepalive_scheduler(hostname="s", ip="10.0.0.1",
                                   cluster_id=cluster.id)
        out.append(client.daemon_dynconfig(ip="10.1.1.1", hostname="d"))
        out.append(client.scheduler_cluster_config(cluster.id))
        for fn in (lambda: client.keepalive_scheduler(
                       hostname="ghost", ip="1.1.1.1", cluster_id=cluster.id),
                   lambda: client.scheduler_cluster_config(99),
                   lambda: wrong.daemon_dynconfig(ip="10.1.1.1"),
                   lambda: client.lease_job(queues=["q"], worker_id="w")):
            with pytest.raises(client_mod.ManagerClientError) as exc:
                fn()
            out.append(str(exc.value))
        v1 = s.create_model("a", scheduler_id=int(row["id"]))
        v2 = s.create_model("b", scheduler_id=int(row["id"]))
        out.append(norm(client.quarantine_model_version(
            model_type="mlp", version=v2.version,
            scheduler_id=int(row["id"]), reason="guard")))
        out.append(client.quarantine_model_version(
            model_type="mlp", version=v1.version,
            scheduler_id=int(row["id"])) is None)
        log = s.validation.TraceLog()
        log.record(np.arange(22, dtype=np.float32).reshape(2, 11))
        client.upload_announce_traces(int(row["id"]), log.to_bytes())
        out.append([t.tolist() for t in
                    s.service.load_announce_traces(int(row["id"]))])
        # The public listener answers a browser's signin over HTTP.
        req = urllib.request.Request(
            f"http://127.0.0.1:{public.port}/api/v1/users/signin",
            data=json.dumps({"name": "root",
                             "password": "dragonfly"}).encode(),
            method="POST", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            out.append(sorted(json.loads(resp.read())))
    finally:
        public.stop()
        internal.stop()
        s.service.db.close()
    return out


@pytest.mark.parametrize("client_pkg,server_pkg", [
    ("dragonfly2_tpu_torch", "dragonfly2_tpu"),
    ("dragonfly2_tpu", "dragonfly2_tpu_torch"),
    ("dragonfly2_tpu_torch", "dragonfly2_tpu_torch"),
], ids=["port-client-jax-server", "jax-client-port-server",
        "port-client-port-server"])
def test_wire_matches_jax(client_pkg, server_pkg, tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    want = wire_script("dragonfly2_tpu", "dragonfly2_tpu", tmp_path / "a")
    got = wire_script(client_pkg, server_pkg, tmp_path / "b")
    assert got == want
    assert want[3]["schedulers"] == ["10.0.0.1:9002"]


# -- the entry point ---------------------------------------------------------


def test_cmd_manager_serves_and_stops(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dragonfly2_tpu_torch.cmd.manager",
         "--host", "127.0.0.1", "--port", "0", "--internal-port", "0",
         "--db", str(tmp_path / "manager.db"),
         "--object-store-dir", str(tmp_path / "objects"), "--model-gate"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    # A child that hangs before printing is killed, so readline returns.
    watchdog = threading.Timer(60, proc.kill)
    watchdog.start()
    try:
        lines = [proc.stdout.readline() for _ in range(2)]
        assert lines[0].startswith("manager serving on 127.0.0.1:"), lines
        assert lines[0].rstrip().endswith("(auth on)")
        assert lines[1].startswith("manager internal surface on 127.0.0.1:")
        public = int(lines[0].split(":")[1].split()[0])
        internal = int(lines[1].rstrip().rsplit(":", 1)[1])
        for port in (public, internal):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthy", timeout=10) as resp:
                assert json.loads(resp.read()) == "OK"
        client = importlib.import_module(
            "dragonfly2_tpu_torch.manager.client").ManagerHTTPClient(
            f"127.0.0.1:{internal}")
        row = client.update_scheduler_instance(hostname="s", ip="10.0.0.1",
                                               port=8002)
        assert row["state"] == "inactive" and row["scheduler_cluster_id"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=20) == 0
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_manager_process_loads_no_torch():
    """The manager computes nothing on a device: its entry point, the
    REST surface, auth and the gate's config load without torch."""
    probe = ("import sys\n"
             "import dragonfly2_tpu_torch.cmd.manager, "
             "dragonfly2_tpu_torch.manager.rest\n"
             "from dragonfly2_tpu_torch.manager.validation import "
             "ValidationConfig\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('torch', 'jax', 'dragonfly2_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
