"""The port's job plane held to JAX's ``tests/test_jobplane.py``: the
durable store's machinery semantics (lease, retry with backoff,
dead-letter, lease-expiry reap, retention purge, stale-worker rejection,
the local worker), the manager's internal lease/renew/complete surface,
the scheduler's ``RemoteJobWorker`` heartbeat against a live manager
listener, and the Bearer-token handshake against a private registry —
each body run on both packages. A seeded sequence under an injected
clock leaves equal ``queued_jobs`` rows in both stores. Then the port's
manager, scheduler and seed as three processes: a REST preheat that the
scheduler child's job worker takes, and a ``sync_peers`` job that merges
the seed's host.
"""

from __future__ import annotations

import importlib
import json
import os
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from tests.test_jobplane import PrivateRegistry
from tests.test_preheat import write_registry

PKGS = ("dragonfly2_tpu", "dragonfly2_tpu_torch")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


class Plane:
    """One package's job-plane names."""

    def __init__(self, pkg: str):
        self.pkg = pkg
        self.Database = mod(pkg, "manager.database").Database
        jobplane = mod(pkg, "manager.jobplane")
        jobs = mod(pkg, "manager.jobs")
        self.jobplane, self.jobs = jobplane, jobs
        self.DurableJobStore = jobplane.DurableJobStore
        self.LocalJobStoreWorker = jobplane.LocalJobStoreWorker
        self.STATE_DEAD = jobplane.STATE_DEAD
        self.STATE_PENDING = jobplane.STATE_PENDING
        self.q = jobs.scheduler_queue

    def job(self, jtype="preheat", url="http://x/blob"):
        return self.jobs.Job(id="j", type=jtype,
                             payload=self.jobs.PreheatRequest(url=url))

    def rest_api(self, tmp_path, store, **kw):
        manager = mod(self.pkg, "manager")
        service = manager.ManagerService(
            store.db, manager.FilesystemObjectStore(str(tmp_path / "obj")))
        return mod(self.pkg, "manager.rest").RestApi(service, jobstore=store,
                                                     **kw)


# -- the durable store --------------------------------------------------------

def test_lease_complete_success(pkg):
    p = Plane(pkg)
    store = p.DurableJobStore(p.Database())
    group = store.post_group([p.q(1), p.q(2)], p.job)
    assert group.total == 2 and not group.done
    j1 = store.lease([p.q(1)], "w1")
    assert j1["type"] == "preheat"
    assert j1["payload"]["url"] == "http://x/blob"
    assert j1["attempts"] == 1
    assert store.lease([p.q(1)], "w2") is None
    store.complete(j1["id"], ok=True, result={"n": 3}, worker_id="w1")
    j2 = store.lease([p.q(2)], "w2")
    store.complete(j2["id"], ok=True, worker_id="w2")
    assert group.done and group.state == "SUCCESS"
    assert group.results == [{"n": 3}]


def test_retry_backoff_then_dead_letter(pkg):
    p = Plane(pkg)
    store = p.DurableJobStore(p.Database(), default_max_attempts=2,
                              retry_backoff=0.05)
    group = store.post_group([p.q(1)], p.job)
    j = store.lease([p.q(1)], "w")
    out = store.complete(j["id"], ok=False, error="boom", worker_id="w")
    assert out["state"] == p.STATE_PENDING and out["retry_in_s"] > 0
    assert store.lease([p.q(1)], "w") is None
    time.sleep(0.08)
    j = store.lease([p.q(1)], "w")
    assert j["attempts"] == 2
    out = store.complete(j["id"], ok=False, error="boom2", worker_id="w")
    assert out["state"] == p.STATE_DEAD
    assert group.done and group.state == "FAILURE"
    assert "boom2" in group.errors[0]
    dead = store.dead_letters()
    assert len(dead) == 1
    store.requeue_dead(dead[0].id)
    assert not group.done
    j = store.lease([p.q(1)], "w")
    store.complete(j["id"], ok=True, worker_id="w")
    assert group.state == "SUCCESS"


def test_lease_expiry_requeues_then_dead_letters(pkg):
    p = Plane(pkg)
    store = p.DurableJobStore(p.Database(), default_max_attempts=2)
    store.post(p.q(1), p.job())
    assert store.lease([p.q(1)], "w1", lease_ttl=0.01) is not None
    time.sleep(0.03)
    j = store.lease([p.q(1)], "w2", lease_ttl=0.01)
    assert j is not None and j["attempts"] == 2
    time.sleep(0.03)
    assert store.lease([p.q(1)], "w3") is None
    dead = store.dead_letters()
    assert len(dead) == 1 and "lease expired" in dead[0].error


def test_retention_purges_resolved_jobs(pkg):
    p = Plane(pkg)
    store = p.DurableJobStore(p.Database(), default_max_attempts=1,
                              retention_s=0.05)
    store.post(p.q(1), p.job())
    store.post(p.q(1), p.job())
    store.post(p.q(2), p.job())  # stays pending
    j = store.lease([p.q(1)], "w")
    store.complete(j["id"], ok=True, worker_id="w")
    j = store.lease([p.q(1)], "w")
    store.complete(j["id"], ok=False, error="x", worker_id="w")  # dead
    time.sleep(0.08)
    assert store.purge() == 2
    rows = store.db.find("queued_jobs")
    assert len(rows) == 1 and rows[0].state == p.STATE_PENDING


def test_stale_worker_completion_rejected(pkg):
    p = Plane(pkg)
    store = p.DurableJobStore(p.Database())
    store.post(p.q(1), p.job())
    j = store.lease([p.q(1)], "w1", lease_ttl=0.01)
    time.sleep(0.03)
    j2 = store.lease([p.q(1)], "w2")
    assert j2 is not None
    out = store.complete(j["id"], ok=True, worker_id="w1")
    assert not out["ok"] and "lease lost" in out["error"]
    assert store.complete(j2["id"], ok=True, worker_id="w2")["ok"]


def test_local_worker_drains_and_survives_bad_result(pkg):
    p = Plane(pkg)
    store = p.DurableJobStore(p.Database(), default_max_attempts=1)
    seen = []

    def handler(job):
        seen.append(job.type)
        if job.type == "sync_peers":
            return {"hosts": set()}  # not JSON-serializable
        return None

    worker = p.LocalJobStoreWorker(store, handler, [p.q(1)])
    worker.serve()
    try:
        g1 = store.post_group([p.q(1)], lambda: p.job("sync_peers"))
        g2 = store.post_group([p.q(1)], p.job)
        deadline = time.monotonic() + 5
        while not (g1.done and g2.done) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert g2.state == "SUCCESS"
        assert g1.state == "SUCCESS"
    finally:
        worker.stop()


class Clock:
    """``time`` for a job-plane module: ``time()`` reads ``now``."""

    def __init__(self):
        self.now = 1_000_000.0

    def as_module(self):
        return types.SimpleNamespace(time=lambda: self.now,
                                     monotonic=time.monotonic,
                                     sleep=time.sleep)


ROW_FIELDS = ("queue", "type", "payload", "state", "attempts",
              "max_attempts", "not_before", "lease_expires_at", "worker_id",
              "error", "result")


def seeded_sequence(p: Plane, seed: int, monkeypatch) -> tuple:
    """Posts, leases, renewals, completions and clock steps drawn from
    ``seed`` on ``p``'s store under an injected clock: (answers, rows)."""
    clock = Clock()
    monkeypatch.setattr(p.jobplane, "time", clock.as_module())
    store = p.DurableJobStore(p.Database(), default_max_attempts=3,
                              lease_ttl=5.0, retry_backoff=1.5,
                              retention_s=300.0)
    rng = np.random.default_rng(seed)
    queues = [p.q(i) for i in (1, 2, 3)]
    workers = ["w0", "w1", "w2"]
    leased, answers = [], []
    for step in range(400):
        op = rng.choice(["post", "group", "lease", "renew", "complete",
                         "tick"], p=[.15, .1, .25, .1, .25, .15])
        if op == "post":
            store.post(queues[rng.integers(3)],
                       p.job(url=f"http://o/{step}"),
                       max_attempts=int(rng.integers(1, 4)))
            answers.append(op)
        elif op == "group":
            n = int(rng.integers(1, 4))
            store.post_group(queues[:n], lambda: p.job("sync_peers"))
            answers.append(op)
        elif op == "lease":
            n = int(rng.integers(1, 4))
            ttl = float(rng.choice([0.5, 2.0, 5.0]))
            got = store.lease(queues[3 - n:], workers[rng.integers(3)],
                              lease_ttl=ttl)
            if got is not None:
                leased.append((got["id"], got["attempts"]))
                answers.append(("lease", {k: got[k] for k in (
                    "id", "queue", "type", "payload", "attempts",
                    "max_attempts", "lease_expires_at")}))
            else:
                answers.append(("lease", None))
        elif op == "renew" and leased:
            job_id = leased[rng.integers(len(leased))][0]
            answers.append(("renew", store.renew(
                job_id, workers[rng.integers(3)],
                lease_ttl=float(rng.choice([1.0, 4.0])))))
        elif op == "complete" and leased:
            job_id = leased.pop(rng.integers(len(leased)))[0]
            ok = bool(rng.random() < 0.6)
            answers.append(("complete", store.complete(
                job_id, ok=ok, error="" if ok else f"boom-{step}",
                result={"step": step} if ok else None,
                worker_id=workers[rng.integers(3)])))
        else:
            clock.now += float(rng.choice([0.25, 1.0, 3.0, 70.0]))
            answers.append(("tick", clock.now))
    rows = [tuple(getattr(r, k) for k in ROW_FIELDS)
            for r in store.db.find("queued_jobs")]
    return answers, rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_sequence_leaves_equal_rows(seed, monkeypatch):
    jax = seeded_sequence(Plane("dragonfly2_tpu"), seed, monkeypatch)
    port = seeded_sequence(Plane("dragonfly2_tpu_torch"), seed, monkeypatch)
    assert port[0] == jax[0]
    assert port[1] == jax[1]
    states = {row[3] for row in port[1]}
    assert {"succeeded", "dead", "pending"} <= states


# -- the manager's REST surface -----------------------------------------------

@pytest.fixture()
def api(pkg, tmp_path):
    p = Plane(pkg)
    store = p.DurableJobStore(p.Database(), default_max_attempts=1)
    service_api = p.rest_api(tmp_path, store)
    service_api.preheat = p.jobs.PreheatService(store, service_api.service)
    service_api.plane = p
    return service_api


def test_lease_complete_over_internal_surface(api):
    p = api.plane
    api.jobstore.post(p.q(1), p.job())
    code, resp = api.dispatch(
        "POST", "/internal/v1/jobs/lease", {},
        {"queues": [p.q(1)], "worker_id": "w"}, surface="internal")
    assert code == 200 and resp["job"]["type"] == "preheat"
    job_id = resp["job"]["id"]
    code, out = api.dispatch(
        "POST", f"/internal/v1/jobs/{job_id}/complete", {},
        {"ok": True, "worker_id": "w"}, surface="internal")
    assert code == 200 and out["state"] == "succeeded"
    code, resp = api.dispatch(
        "POST", "/internal/v1/jobs/lease", {},
        {"queues": [p.q(1)], "worker_id": "w"}, surface="internal")
    assert resp["job"] is None


def test_group_lookup_survives_restart(api, tmp_path):
    p = api.plane
    group = api.jobstore.post_group([p.q(1)], p.job)
    j = api.jobstore.lease([p.q(1)], "w")
    api.jobstore.complete(j["id"], ok=True, worker_id="w")
    api2 = p.rest_api(tmp_path / "again",
                      p.DurableJobStore(api.jobstore.db))
    code, out = api2.dispatch("GET", f"/api/v1/jobs/{group.group_id}", {},
                              {})
    assert code == 200 and out["state"] == "SUCCESS"


def test_dead_letter_listing_and_requeue(api):
    p = api.plane
    api.jobstore.post(p.q(1), p.job())
    j = api.jobstore.lease([p.q(1)], "w")
    api.jobstore.complete(j["id"], ok=False, error="x", worker_id="w")
    code, rows = api.dispatch("GET", "/api/v1/jobs", {"state": "dead"}, {})
    assert code == 200 and len(rows) == 1
    code, _ = api.dispatch(
        "POST", f"/api/v1/jobs/{rows[0]['id']}/requeue", {}, {})
    assert code == 200
    assert api.jobstore.lease([p.q(1)], "w") is not None


def test_internal_routes_not_on_public_surface(api):
    code, _ = api.dispatch("POST", "/internal/v1/jobs/lease", {},
                           {"queues": ["q"]}, surface="public")
    assert code == 404


def test_job_listing_redacts_credentials(api):
    p = api.plane
    api.jobstore.post(p.q(1), p.jobs.Job(
        id="j", type="preheat",
        payload=p.jobs.PreheatRequest(
            url="http://reg/v2/x/blobs/sha256:aa",
            headers={"Authorization": "Bearer sekret-token",
                     "Accept": "application/json"})))
    code, rows = api.dispatch("GET", "/api/v1/jobs", {}, {})
    assert code == 200 and len(rows) == 1
    headers = rows[0]["payload"]["headers"]
    assert headers["Authorization"] == "<redacted>"
    assert headers["Accept"] == "application/json"
    assert "sekret-token" not in json.dumps(rows)


def test_requeue_non_dead_job_conflicts(api):
    p = api.plane
    api.jobstore.post(p.q(1), p.job())
    j = api.jobstore.lease([p.q(1)], "w")
    code, _ = api.dispatch("POST", f"/api/v1/jobs/{j['id']}/requeue", {}, {})
    assert code == 409


def test_renew_extends_live_lease_only(api):
    p = api.plane
    api.jobstore.post(p.q(1), p.job())
    j = api.jobstore.lease([p.q(1)], "w", lease_ttl=0.2)
    code, out = api.dispatch(
        "POST", f"/internal/v1/jobs/{j['id']}/renew", {},
        {"worker_id": "w", "lease_ttl": 30.0}, surface="internal")
    assert code == 200 and out["renewed"]
    code, out = api.dispatch(
        "POST", f"/internal/v1/jobs/{j['id']}/renew", {},
        {"worker_id": "thief"}, surface="internal")
    assert not out["renewed"]
    api.jobstore.db.update("queued_jobs", j["id"],
                           lease_expires_at=time.time() - 1)
    assert not api.jobstore.renew(j["id"], "w")


# -- the scheduler's remote worker --------------------------------------------

def test_heartbeat_keeps_long_job_alive(pkg, tmp_path):
    """A handler slower than one lease_ttl completes exactly once: the
    worker's renewals keep the lease from being reaped."""
    p = Plane(pkg)
    store = p.DurableJobStore(p.Database())
    api = p.rest_api(tmp_path, store)
    rest = mod(pkg, "manager.rest")
    http = rest.ManagerHTTPServer(api, host="127.0.0.1", port=0,
                                  surface="internal")
    http.start()
    calls = []

    class SlowService:
        def preheat(self, url, **kw):
            calls.append(url)
            time.sleep(0.9)  # ≫ lease_ttl below

    worker = mod(pkg, "scheduler.jobworker").RemoteJobWorker(
        mod(pkg, "manager.client").ManagerHTTPClient(
            f"127.0.0.1:{http.port}"), SlowService(),
        scheduler_id=5, poll_interval=0.05, lease_ttl=0.3)
    worker.serve()
    try:
        group = store.post_group([p.q(5)], p.job)
        deadline = time.monotonic() + 15
        while not group.done and time.monotonic() < deadline:
            time.sleep(0.05)
        snap = group.snapshot()
        assert snap["state"] == "SUCCESS", snap
        assert len(calls) == 1 and worker.handled == 1
        assert worker.queues == ["global", "schedulers", "scheduler_5"]
    finally:
        worker.stop()
        http.stop()


# -- registry auth ------------------------------------------------------------

def test_token_handshake_resolves_layers(pkg, tmp_path):
    jobs = mod(pkg, "manager.jobs")
    layers = {f"sha256:{i:064x}": os.urandom(64) for i in range(2)}
    name = write_registry(tmp_path, layers)
    reg = PrivateRegistry(str(tmp_path))
    try:
        url = f"http://127.0.0.1:{reg.port}/v2/{name}/manifests/latest"
        urls, auth = jobs.resolve_image_layers_with_auth(
            url, username=reg.USER, password=reg.PASSWORD)
        assert len(urls) == 2
        assert auth == {"Authorization": f"Bearer {reg.TOKEN}"}
        assert "service=fake-registry" in reg.token_requests[0]
        req = urllib.request.Request(urls[0], headers=auth)
        with urllib.request.urlopen(req, timeout=5) as resp:
            assert resp.status == 200
    finally:
        reg.close()


def test_wrong_password_fails(pkg, tmp_path):
    jobs = mod(pkg, "manager.jobs")
    name = write_registry(tmp_path, {"sha256:" + "0" * 64: b"x"})
    reg = PrivateRegistry(str(tmp_path))
    try:
        url = f"http://127.0.0.1:{reg.port}/v2/{name}/manifests/latest"
        with pytest.raises(urllib.error.HTTPError):
            jobs.resolve_image_layers_with_auth(
                url, username=reg.USER, password="wrong")
    finally:
        reg.close()


def test_challenge_parse_and_scope_default(pkg):
    jobs = mod(pkg, "manager.jobs")
    with pytest.raises(ValueError):
        jobs.fetch_registry_token('Digest realm="x"')
    with pytest.raises(ValueError):
        jobs.fetch_registry_token("Bearer service=only")


# -- three processes ----------------------------------------------------------

def _http_json(method: str, url: str, body=None):
    req = urllib.request.Request(
        url, method=method, headers={"Content-Type": "application/json"},
        data=None if body is None else json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _scrape(port: int) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as resp:
        return resp.read().decode()


def _sample(text: str, name: str, **labels) -> float:
    """Sum of ``name``'s samples whose labels include ``labels``."""
    from prometheus_client.parser import text_string_to_metric_families

    return sum(s.value for f in text_string_to_metric_families(text)
               for s in f.samples if s.name == name
               and all(s.labels.get(k) == v for k, v in labels.items()))


def test_manager_scheduler_seed_processes(tmp_path):
    """``cmd.manager``, ``cmd.scheduler --manager`` and ``cmd.dfdaemon
    --type super`` of the port as processes: ``POST /api/v1/jobs``
    preheats a file, which the scheduler child's job worker has the seed
    back-source (the origin serves its bytes once); with the origin
    closed a peer here still gets them; a ``sync_peers`` job merges the
    seed's host; each child's ``/metrics`` counts what happened; each
    exits 0 on SIGTERM."""
    from dragonfly2_tpu_torch.client.daemon import Daemon, DaemonConfig
    from dragonfly2_tpu_torch.scheduler.rpcserver import GrpcSchedulerClient
    from tests.test_torch_p2p_processes import Child, CountingOrigin, free_port

    ports = {n: free_port() for n in ("public", "internal", "scheduler",
                                      "seed", "sched_metrics",
                                      "mgr_metrics")}
    payload = np.random.default_rng(26).bytes(2 * 1024 * 1024 + 17)
    (tmp_path / "www").mkdir()
    (tmp_path / "www" / "model.bin").write_bytes(payload)
    origin = CountingOrigin(str(tmp_path / "www"))
    children = []
    try:
        children.append(Child(
            "manager", "dragonfly2_tpu_torch.cmd.manager",
            ["--host", "127.0.0.1", "--port", ports["public"],
             "--internal-port", ports["internal"], "--no-auth",
             "--db", tmp_path / "manager.db",
             "--object-store-dir", tmp_path / "objects",
             "--metrics-port", ports["mgr_metrics"]],
            tmp_path, "manager internal surface on "))
        children.append(Child(
            "scheduler", "dragonfly2_tpu_torch.cmd.scheduler",
            ["--host", "127.0.0.1", "--port", ports["scheduler"],
             "--data-dir", tmp_path / "sched-data", "--device", "cpu",
             "--manager", f"127.0.0.1:{ports['internal']}",
             "--advertise-ip", "127.0.0.1",
             "--seed-peer", f"127.0.0.1:{ports['seed']}",
             "--job-poll-interval", "0.1",
             "--metrics-port", ports["sched_metrics"]],
            tmp_path, "job worker polling queues "))
        scheduler_id = int(children[1].lines[-2].split()[5])
        assert children[1].lines[-1].rstrip().endswith(
            f"'scheduler_{scheduler_id}']")
        children.append(Child(
            "seed", "dragonfly2_tpu_torch.cmd.dfdaemon",
            ["--scheduler", f"127.0.0.1:{ports['scheduler']}",
             "--rpc-port", ports["seed"],
             "--storage-dir", tmp_path / "seed-data", "--type", "super",
             "--hostname", "seed-e2e", "--ip", "127.0.0.1"],
            tmp_path, "daemon rpc on "))
        base = f"http://127.0.0.1:{ports['public']}"
        rows = _http_json("GET", f"{base}/api/v1/schedulers")
        assert [(r["id"], r["state"]) for r in rows] == [
            (scheduler_id, "active")]

        url = origin.url("model.bin")
        group_ids = _http_json("POST", f"{base}/api/v1/jobs", {
            "type": "preheat", "args": {"url": url}})["ids"]
        assert len(group_ids) == 1
        deadline, status = time.monotonic() + 60, {"state": "PENDING"}
        while status["state"] == "PENDING" and time.monotonic() < deadline:
            status = _http_json("GET", f"{base}/api/v1/jobs/{group_ids[0]}")
            time.sleep(0.1)
        assert status["state"] == "SUCCESS", status
        assert origin.served["/model.bin"] == len(payload)
        origin.close()

        peer = Daemon(GrpcSchedulerClient(f"127.0.0.1:{ports['scheduler']}"),
                      DaemonConfig(storage_root=str(tmp_path / "peer-data"),
                                   hostname="late-peer"))
        peer.start()
        try:
            result = peer.download_file(url)
            assert result.success, result.error
            assert result.read_all() == payload
        finally:
            peer.stop()

        synced = _http_json("POST", f"{base}/api/v1/jobs",
                            {"type": "sync_peers"})
        assert synced["state"] == "SUCCESS" and synced["errors"] == []
        assert synced["merged_peers"] >= 1
        peers = _http_json("GET", f"{base}/api/v1/peers")
        assert {"seed-e2e"} <= {p["hostname"] for p in peers}
        assert {p["scheduler_id"] for p in peers} == {scheduler_id}

        sched = _scrape(ports["sched_metrics"])
        assert _sample(sched,
                       "dragonfly_scheduler_register_peer_total") >= 2
        assert _sample(sched, "dragonfly_scheduler_resource_hosts") >= 2
        assert _sample(sched, "dragonfly_scheduler_traffic_bytes_total") \
            >= len(payload)
        assert "df2_process_threads" in sched
        mgr = _scrape(ports["mgr_metrics"])
        assert _sample(mgr, "dragonfly_manager_keepalive_total") >= 1
        assert _sample(mgr, "dragonfly_manager_request_total",
                       method="POST") >= 2
    finally:
        codes = {c.name: c.stop() for c in reversed(children)}
        origin.close()
    assert codes == {"seed": 0, "scheduler": 0, "manager": 0}, [
        (c.name, c.stderr()) for c in children]
