"""The manager plane as a whole, run once with ``dragonfly2_tpu``'s modules
and once with ``dragonfly2_tpu_torch``'s: a manager (REST public and
internal listeners on loopback, auth on) and a trainer-side registry on
one sqlite file; a scheduler in this process linked to the manager
(``cmd.scheduler.connect_manager`` in the port; JAX's ``df2-scheduler``
manager block, rebuilt here from JAX's modules); an inference service
watching the registry, which the scheduler's ``RemoteMLEvaluator``
scores through. The script:

- the link registers the scheduler, whose row turns active;
- a cluster config PATCHed over the public API reaches
  ``Scheduling.apply_dynconfig``;
- MLP v1 passes the gate and serves; v2 is published past the gate with
  a ``model.weights`` CORRUPT rule planted, serves NaN scores, and the
  evaluator's runtime guard escalates through the link's hook to
  ``/internal/v1/models/quarantine``: v2 is quarantined, v1 restored,
  and the watcher's ``reload_from_manager`` serves v1 again;
- the recorded announce traces are uploaded, and the next candidate's
  gate replays them.

Both runs must end in the same registry states, the same restored
version and the same gate verdict; the restored MLP's scores (the same
parameters, an orbax artifact in JAX and ``train/checkpoint.py``'s npz in
the port) agree within the serving tests' bf16 tolerance."""

from __future__ import annotations

import importlib
import json
import socket
import time
import urllib.request

import numpy as np
import pytest

PACKAGES = ("dragonfly2_tpu", "dragonfly2_tpu_torch")
# Both packages serve the MLP in bf16 on the same params
# (tests/test_torch_lifecycle.py's tolerance).
BF16_TOL = 6e-2
SCHEDULER_ID = 7
CANDIDATES = 12
WARM_DECISIONS = 5
TICK_S = 0.05


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The rule-distilled MLP (trained once by the JAX package) as an
    artifact dir in each package's format."""
    from dragonfly2_tpu.inference.guardbench import (
        train_rule_distilled_mlp,
        write_model_artifact,
    )
    from dragonfly2_tpu_torch.train.checkpoint import (
        ModelMetadata,
        mlp_tree,
        save_model,
    )

    base = tmp_path_factory.mktemp("loop-models")
    result = train_rule_distilled_mlp(seed=3, samples=768)
    params = {"params": {k: {n: np.asarray(v) for n, v in layer.items()}
                         for k, layer in result.params["params"].items()}}
    port_dir = str(base / "port")
    save_model(port_dir, mlp_tree(params, result.normalizer,
                                  result.target_norm),
               ModelMetadata(model_id="df2-mlp-loop", model_type="mlp",
                             evaluation={"mae": float(result.mae)},
                             config={"hidden": [32]}))
    return {"dragonfly2_tpu": write_model_artifact(str(base / "jax"),
                                                   result, "good"),
            "dragonfly2_tpu_torch": port_dir}


class Host:
    def __init__(self, rng):
        self.type = int(rng.random() < 0.1)
        self.upload_count = int(rng.poisson(50))
        self.upload_failed_count = int(rng.binomial(self.upload_count, 0.1))
        self.concurrent_upload_limit = 50
        self.concurrent_upload_count = int(rng.integers(0, 50))
        region, zone = (int(v) for v in rng.integers(0, (4, 4)))
        self.idc = f"idc-{region}"
        self.location = f"r{region}|z{zone}"

    def free_upload_count(self) -> int:
        return self.concurrent_upload_limit - self.concurrent_upload_count


class Peer:
    def __init__(self, rng, name: str):
        self.id = name
        self.host = Host(rng)
        self._state = str(rng.choice(["Running", "Succeeded"]))
        self._finished = int(rng.integers(0, 256))

    def state(self) -> str:
        return self._state

    def finished_piece_count(self) -> int:
        return self._finished

    def piece_costs(self):
        return [0.05, 0.06, 0.05]


def decisions(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [([Peer(rng, f"p{d}-{i}") for i in range(CANDIDATES)],
             Peer(rng, f"c{d}"), 256) for d in range(n)]


class Ctx:
    def abort(self, code, details):
        raise RuntimeError(f"{code.name}: {details}")


class JaxLocalClient:
    """``model_infer_full`` on JAX's InferenceService in this process."""

    def __init__(self, sidecar_mod, service):
        self.sidecar = sidecar_mod
        self.service = service

    def model_infer_full(self, name, inputs):
        resp = self.service.ModelInfer(
            self.sidecar.ModelInferRequest(model_name=name, inputs=inputs),
            Ctx())
        return np.asarray(resp.outputs), resp.model_version


class JaxLink:
    """JAX's ``df2-scheduler`` manager block (cmd/scheduler.py:343-448)
    with JAX's client, TraceLog and Dynconfig, its keepalive loop at
    ``interval`` and stoppable for the test."""

    def __init__(self, service, url, *, port, cluster_id, scheduler_id,
                 advertise_ip, hostname, data_dir, interval):
        import threading

        from dragonfly2_tpu.manager.client import ManagerHTTPClient
        from dragonfly2_tpu.manager.validation import TraceLog
        from dragonfly2_tpu.utils.dynconfig import Dynconfig

        mgr = ManagerHTTPClient(url)
        row = mgr.update_scheduler_instance(
            hostname=hostname, ip=advertise_ip, port=port,
            cluster_id=cluster_id)
        self.scheduler_id = scheduler_id or int(row["id"])
        cluster_id = int(row["scheduler_cluster_id"])
        mgr.keepalive_scheduler(hostname=hostname, ip=advertise_ip,
                                cluster_id=cluster_id)
        evaluator = service.scheduling.evaluator
        self.trace_log = TraceLog()
        evaluator.set_trace_log(self.trace_log)

        def quarantine_serving(reason):
            version = getattr(evaluator, "serving_version", "")
            if not version:
                return False
            mgr.quarantine_model_version(
                model_type=getattr(evaluator, "model_name", "mlp"),
                version=version, scheduler_id=self.scheduler_id,
                reason=f"scheduler runtime guard: {reason}")

        evaluator.set_quarantine_hook(quarantine_serving)
        self.client = mgr
        self._stop = threading.Event()

        def loop():
            while not self._stop.wait(interval):
                mgr.keepalive_scheduler(hostname=hostname, ip=advertise_ip,
                                        cluster_id=cluster_id)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        self.dynconfig = Dynconfig(
            lambda: mgr.scheduler_cluster_config(cluster_id),
            cache_path=f"{data_dir}/dynconfig.json",
            refresh_interval=interval, name="scheduler-dynconfig")
        self.dynconfig.subscribe(service.scheduling.apply_dynconfig)
        self.dynconfig.refresh()
        self.dynconfig.serve()

    def upload_traces(self) -> bool:
        self.client.upload_announce_traces(self.scheduler_id,
                                           self.trace_log.to_bytes())
        return True

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
        self.dynconfig.stop()


def wait_for(what: str, predicate, timeout_s: float = 20.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not predicate():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def http(method: str, url: str, body=None, token: str = ""):
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        method=method, headers={"Content-Type": "application/json",
                                "Authorization": token})
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read())


def run_loop(pkg: str, artifact_dir: str, tmp_path) -> dict:
    port_side = pkg == "dragonfly2_tpu_torch"
    m = importlib.import_module(f"{pkg}.manager")
    auth_mod = importlib.import_module(f"{pkg}.manager.auth")
    rest = importlib.import_module(f"{pkg}.manager.rest")
    validation = importlib.import_module(f"{pkg}.manager.validation")
    sidecar_mod = importlib.import_module(f"{pkg}.inference.sidecar")
    faultplan = importlib.import_module(f"{pkg}.utils.faultplan")
    stats_mod = importlib.import_module(f"{pkg}.utils.servingstats")
    resource = importlib.import_module(f"{pkg}.scheduler.resource.resource")
    core = importlib.import_module(f"{pkg}.scheduler.scheduling.core")
    sched_mod = importlib.import_module(f"{pkg}.scheduler.service")
    storage = importlib.import_module(f"{pkg}.scheduler.storage.storage")
    device = {"device": "cpu"} if port_side else {}
    root = tmp_path / pkg
    root.mkdir()
    db_path, objects = str(root / "manager.db"), str(root / "objects")

    # The manager process's service and its two listeners.
    service = m.ManagerService(m.Database(db_path),
                               m.FilesystemObjectStore(objects))
    api = rest.RestApi(service, auth=auth_mod.AuthService(service.db,
                                                          secret="s"))
    public = rest.ManagerHTTPServer(api, host="127.0.0.1", port=0)
    internal = rest.ManagerHTTPServer(api, host="127.0.0.1", port=0,
                                      surface="internal")
    public.start()
    internal.start()
    base = f"http://127.0.0.1:{public.port}"
    # The trainer side's registry with the gate, on the same file.
    stats = stats_mod.ServingStats()
    trainer = m.ManagerService(
        m.Database(db_path), m.FilesystemObjectStore(objects),
        validation=validation.ValidationConfig(), serving_stats=stats,
        **device)
    sidecar = sidecar_mod.InferenceService(
        manager=trainer, scheduler_id=SCHEDULER_ID, reload_interval=TICK_S,
        micro_batch=False, shadow_mode=False, serving_stats=stats, **device)
    client = (sidecar_mod.LocalInferenceClient(sidecar) if port_side
              else JaxLocalClient(sidecar_mod, sidecar))
    evaluator = sidecar_mod.RemoteMLEvaluator(client, stats=stats,
                                              guard_trip_limit=3)
    scheduler = sched_mod.SchedulerService(
        resource=resource.Resource(),
        scheduling=core.Scheduling(evaluator),
        storage=storage.Storage(str(root / "datasets")))
    versions: list = []
    link = None
    plan = faultplan.install(faultplan.FaultPlan(seed=0))
    try:
        token = "Bearer " + http("POST", f"{base}/api/v1/users/signin",
                                 {"name": "root",
                                  "password": "dragonfly"})["token"]
        cluster = http("POST", f"{base}/api/v1/scheduler-clusters",
                       {"name": "c", "is_default": True,
                        "config": {"filter_parent_limit": 4}}, token)
        kw = dict(port=8002, cluster_id=cluster["id"],
                  scheduler_id=SCHEDULER_ID, advertise_ip="127.0.0.1",
                  hostname="sched-loop", data_dir=str(root))
        url = f"127.0.0.1:{internal.port}"
        if port_side:
            from dragonfly2_tpu_torch.cmd.scheduler import connect_manager

            link = connect_manager(scheduler, url, keepalive_interval=TICK_S,
                                   dynconfig_interval=TICK_S, **kw)
        else:
            link = JaxLink(scheduler, url, interval=TICK_S, **kw)
        rows = http("GET", f"{base}/api/v1/schedulers?all=1", token=token)
        row_state = [(r["hostname"], r["state"]) for r in rows]
        applied = [scheduler.scheduling.config.filter_parent_limit]
        http("PATCH", f"{base}/api/v1/scheduler-clusters/{cluster['id']}",
             {"config": {"filter_parent_limit": 7}}, token)
        wait_for("the PATCHed config",
                 lambda: scheduler.scheduling.config.filter_parent_limit == 7)
        applied.append(scheduler.scheduling.config.filter_parent_limit)

        def create(**kw):
            row = trainer.create_model("df2-mlp-loop", "mlp", "h",
                                       "127.0.0.1", "hn", {}, artifact_dir,
                                       scheduler_id=SCHEDULER_ID, **kw)
            versions.append(row.version)
            return row

        v1 = create()
        sidecar.reload_from_manager()
        sidecar.serve_watcher()
        for parents, child, total in decisions(0, WARM_DECISIONS):
            evaluator.evaluate_parents(parents, child, total)
        warm = evaluator.scored_count
        plan.add("model.weights", faultplan.FaultKind.CORRUPT, every_nth=1,
                 max_fires=1, match="mlp")
        v2 = create(skip_validation=True)
        wait_for("v2 serving",
                 lambda: sidecar.serving_version("mlp") == v2.version)
        trips = 0
        for parents, child, total in decisions(1, 3):
            evaluator.evaluate_parents(parents, child, total)
            trips += 1
        wait_for("v1 restored",
                 lambda: sidecar.serving_version("mlp") == v1.version)
        probe = np.asarray(validation.synthetic_traces(
            seed=5, batches=1, rows=CANDIDATES)[0], np.float32)
        scores = np.asarray(sidecar.ModelInfer(
            sidecar_mod.ModelInferRequest(model_name="mlp", inputs=probe),
            Ctx()).outputs, np.float64)
        uploaded = link.upload_traces()
        traces = trainer.load_announce_traces(SCHEDULER_ID)
        v3 = create()
        report = v3.evaluation["validation"]
        index = {v: i for i, v in enumerate(versions)}
        return {
            "row_state": row_state, "applied": applied, "warm": warm,
            "trips": [trips, evaluator.guard_trips],
            "reported": stats.get("ml_quarantines_reported"),
            "restored": index[sidecar.serving_version("mlp")],
            "registry": sorted((index[r.version], r.state)
                               for r in trainer.list_models()),
            "uploaded": uploaded, "traces": len(traces or []),
            "gate": {k: report[k] for k in ("passed", "batches",
                                            "trace_source", "checks")},
            "scores": scores,
        }
    finally:
        faultplan.uninstall()
        if link is not None:
            link.stop()
        sidecar.stop()
        public.stop()
        internal.stop()


def test_manager_loop_matches_jax(artifacts, tmp_path):
    got = {pkg: run_loop(pkg, artifacts[pkg], tmp_path) for pkg in PACKAGES}
    jax_run, port = got["dragonfly2_tpu"], got["dragonfly2_tpu_torch"]
    jax_scores, port_scores = jax_run.pop("scores"), port.pop("scores")
    assert port == jax_run
    assert port["row_state"] == [("sched-loop", "active")]
    assert port["applied"] == [4, 7]
    assert port["warm"] == WARM_DECISIONS and port["reported"] == 1
    assert port["restored"] == 0
    # v3 passes the gate on the recorded traces and takes over from v1.
    assert port["registry"] == [(0, "inactive"), (1, "quarantined"),
                                (2, "active")]
    assert port["gate"]["passed"]
    assert port["traces"] == WARM_DECISIONS + 3
    assert port["gate"]["trace_source"] == "recorded"
    assert port["gate"]["batches"] == WARM_DECISIONS + 3
    assert np.isfinite(port_scores).all()
    assert np.abs(port_scores - jax_scores).max() <= BF16_TOL


def test_connect_manager_stop_ends_its_threads(tmp_path):
    """JAX's link threads never stop; the port's handle ends them."""
    import threading

    from dragonfly2_tpu_torch.cmd.scheduler import connect_manager
    from dragonfly2_tpu_torch.manager import (
        Database,
        FilesystemObjectStore,
        ManagerService,
    )
    from dragonfly2_tpu_torch.manager.rest import ManagerHTTPServer, RestApi
    from dragonfly2_tpu_torch.scheduler.evaluator.base import BaseEvaluator
    from dragonfly2_tpu_torch.scheduler.resource.resource import Resource
    from dragonfly2_tpu_torch.scheduler.scheduling.core import Scheduling
    from dragonfly2_tpu_torch.scheduler.service import SchedulerService
    from dragonfly2_tpu_torch.scheduler.storage.storage import Storage

    service = ManagerService(Database(str(tmp_path / "m.db")),
                             FilesystemObjectStore(str(tmp_path / "o")))
    internal = ManagerHTTPServer(RestApi(service), host="127.0.0.1",
                                 port=0, surface="internal")
    internal.start()
    scheduler = SchedulerService(resource=Resource(),
                                 scheduling=Scheduling(BaseEvaluator()),
                                 storage=Storage(str(tmp_path / "ds")))
    try:
        link = connect_manager(
            scheduler, f"127.0.0.1:{internal.port}", port=8002,
            advertise_ip="127.0.0.1", hostname=socket.gethostname(),
            data_dir=str(tmp_path), keepalive_interval=TICK_S,
            dynconfig_interval=TICK_S)
        # A rule evaluator has no quarantine hook: no trace log, and
        # nothing to upload.
        assert link.trace_log is None and not link.upload_traces()
        row = service.db.find_one("schedulers", id=link.scheduler_id)
        assert row.state == "active"
        assert link.cluster_id == row.scheduler_cluster_id
        wait_for("keepalives", lambda: link.keepalives >= 3)
        names = {"manager-keepalive", "scheduler-dynconfig-refresh"}
        assert names <= {t.name for t in threading.enumerate()}
        link.stop()
        assert not names & {t.name for t in threading.enumerate()}
        done = link.keepalives
        time.sleep(3 * TICK_S)
        assert link.keepalives == done
        with open(tmp_path / "dynconfig.json") as fh:
            assert json.load(fh) == {}
    finally:
        internal.stop()


def test_trace_upload_every_twelfth_tick(tmp_path, monkeypatch):
    """The keepalive loop ships the trace corpus every
    TRACE_UPLOAD_TICKS ticks, and only when it holds traces."""
    from dragonfly2_tpu_torch.cmd import scheduler as link_mod
    from dragonfly2_tpu_torch.manager.validation import TraceLog

    monkeypatch.setattr(link_mod, "TRACE_UPLOAD_TICKS", 3)
    sent = []

    class Client:
        def keepalive_scheduler(self, **kw):
            pass

        def upload_announce_traces(self, scheduler_id, payload):
            sent.append((scheduler_id, TraceLog.from_bytes(payload)
                         .batches()))

    log = TraceLog()
    adapter = link_mod._ManagerAdapter(Client(), "h", "127.0.0.1", 1)
    dyn = link_mod.Dynconfig(lambda: {}, name="t")
    link = link_mod.ManagerLink(Client(), adapter, 5, log, dyn, TICK_S)
    link.start()
    try:
        wait_for("six ticks", lambda: link.keepalives >= 6)
        assert sent == []  # an empty log is never shipped
        log.record(np.ones((4, 11), np.float32))
        wait_for("an upload", lambda: sent)
    finally:
        link.stop()
    assert sent[0][0] == 5 and len(sent[0][1]) == 1
