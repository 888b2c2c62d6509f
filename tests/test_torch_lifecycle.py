"""Model-lifecycle parity: the port's registry (``manager/``), validation
gate, inference service (shadow/canary, quarantine, rollback, reload
memoization) and fault sites against the JAX package's.

Each scenario is a script of registry events — ``tests/
test_model_lifecycle.py``'s ``TestSidecarLifecycle``,
``TestModelFaultSites``, ``TestRegistryInvariants`` and gate cases — run
once against the JAX ``ManagerService`` + ``InferenceService`` (orbax
artifacts from ``guardbench.write_model_artifact``) and once against the
port's (npz artifacts of the same params through ``mlp_tree`` /
``save_model``). Each run asserts the JAX tests' expectations and
returns what it observed: the serving version's index sequence (versions
are random ids; an index is the order of creation), the registry's
states, ``ServingStats`` snapshots, ``ValidationReport`` verdicts, and
ModelInfer outputs. The two runs must observe the same; outputs agree
within BF16_TOL (both packages serve the MLP in bf16).

The framework-free helpers (``spearman``, ``synthetic_traces``,
``TraceLog``, ``params_guard_reason``/``poison_params``, a seeded
``FaultPlan``'s fire sequence) must agree bit for bit.
"""

from __future__ import annotations

import json
import threading
import types
import urllib.request

import numpy as np
import pytest
import torch

from dragonfly2_tpu import manager as jax_manager
from dragonfly2_tpu.inference import modelguard as jax_guard
from dragonfly2_tpu.inference import sidecar as jax_sidecar
from dragonfly2_tpu.manager import database as jax_database
from dragonfly2_tpu.manager import service as jax_service
from dragonfly2_tpu.manager import validation as jax_validation
from dragonfly2_tpu.utils import faultplan as jax_faultplan
from dragonfly2_tpu.utils.servingstats import ServingStats as JaxServingStats
from dragonfly2_tpu_torch import manager as port_manager
from dragonfly2_tpu_torch.device import DeviceFault, is_device_fault
from dragonfly2_tpu_torch.inference import modelguard as port_guard
from dragonfly2_tpu_torch.inference import sidecar as port_sidecar
from dragonfly2_tpu_torch.manager import database as port_database
from dragonfly2_tpu_torch.manager import service as port_service
from dragonfly2_tpu_torch.manager import validation as port_validation
from dragonfly2_tpu_torch.scheduler.evaluator.scoring import FEATURE_DIM
from dragonfly2_tpu_torch.utils import faultplan as port_faultplan
from dragonfly2_tpu_torch.utils.servingstats import ServingStats

# Both packages serve the MLP in bf16 on the same params
# (tests/test_torch_serving.py's tolerance).
BF16_TOL = 6e-2
# Mean per-batch Spearman correlations of two bf16 scorings of the same
# batches: a swapped near-tie moves one batch's correlation by ~0.01.
CORR_TOL = 0.05
DISTILLED_HIDDEN = [32]


@pytest.fixture(scope="module")
def distilled(tmp_path_factory):
    """The rule-distilled MLP (trained once by the JAX package) as good,
    NaN- and zero-poisoned artifact dirs in each package's format."""
    from dragonfly2_tpu.inference.guardbench import (
        train_rule_distilled_mlp,
        write_model_artifact,
    )
    from dragonfly2_tpu_torch.train.checkpoint import (
        ModelMetadata,
        mlp_tree,
        save_model,
    )

    base = tmp_path_factory.mktemp("lifecycle-models")
    result = train_rule_distilled_mlp(seed=3, samples=768)
    params = {"params": {k: {n: np.asarray(v) for n, v in layer.items()}
                         for k, layer in result.params["params"].items()}}
    dirs = {"jax": {}, "port": {}}
    for tag, poison in (("good", None), ("nan", "nan"), ("zero", "zero")):
        dirs["jax"][tag] = write_model_artifact(
            str(base / "jax"), result, tag, poison=poison)
        path = str(base / "port" / f"artifact-{tag}")
        save_model(path, mlp_tree(
            params if poison is None else port_guard.poison_params(
                params, poison),
            result.normalizer, result.target_norm),
            ModelMetadata(model_id=f"df2-mlp-guard-{tag}", model_type="mlp",
                          evaluation={"mae": float(result.mae)},
                          config={"hidden": DISTILLED_HIDDEN}))
        dirs["port"][tag] = path
    return dirs


class Ctx:
    """A call context whose abort raises with the status code's name, so
    both packages' codes compare."""

    def abort(self, code, details):
        raise Aborted(code.name, details)


class Aborted(Exception):
    def __init__(self, code: str, details: str):
        super().__init__(f"{code}: {details}")
        self.code = code


class Env:
    """One package's lifecycle surface, plus a recorder mapping each
    created version to its creation index."""

    def __init__(self, name, dirs, tmp_path):
        self.name = name
        self.dirs = dirs[name]
        self.tmp = tmp_path / name
        self.tmp.mkdir()
        jax_side = name == "jax"
        self.manager_mod = jax_manager if jax_side else port_manager
        self.service_mod = jax_service if jax_side else port_service
        self.validation = jax_validation if jax_side else port_validation
        self.sidecar = jax_sidecar if jax_side else port_sidecar
        self.faultplan = jax_faultplan if jax_side else port_faultplan
        self.guard = jax_guard if jax_side else port_guard
        self.ServingStats = JaxServingStats if jax_side else ServingStats
        db = jax_database if jax_side else port_database
        self.ACTIVE, self.INACTIVE = db.STATE_ACTIVE, db.STATE_INACTIVE
        self.QUARANTINED = db.STATE_QUARANTINED
        self.device = {} if jax_side else {"device": "cpu"}
        self.versions: dict = {}
        self._n = 0

    def make_manager(self, *, gate: bool = True, stats=None, **config_kw):
        self._n += 1
        validation = (self.validation.ValidationConfig(**config_kw)
                      if gate else None)
        return self.manager_mod.ManagerService(
            self.manager_mod.Database(),
            self.manager_mod.FilesystemObjectStore(
                str(self.tmp / f"objects{self._n}")),
            validation=validation, serving_stats=stats or self.ServingStats(),
            **self.device)

    def service(self, **kw):
        return self.sidecar.InferenceService(**kw, **self.device)

    def create(self, manager, tag, name="m", model_type="mlp", **kw):
        path = self.dirs.get(tag, tag)
        row = manager.create_model(name, model_type, "h", "1.1.1.1", "hn",
                                   {}, path, **kw)
        self.versions.setdefault(row.version, len(self.versions))
        return row

    def v(self, version):
        return None if version is None else self.versions.get(version, "?")

    def states(self, manager):
        return sorted((self.v(r.version), r.state)
                      for r in manager.list_models())

    def garbage_dir(self, tag):
        path = self.tmp / tag
        path.mkdir()
        (path / "params.npz").write_bytes(b"not a checkpoint")
        return str(path)


def report_view(report: dict) -> dict:
    """A persisted ValidationReport, with load/scoring failure details
    (each package's own exception text) cut to their prefix."""
    return {
        "passed": report["passed"],
        "reasons": [r.split(":")[0] if r.startswith(
            ("artifact load failed", "scoring raised")) else r
            for r in report["reasons"]],
        "checks": report["checks"],
        "batches": report["batches"],
        "scored_rows": report["scored_rows"],
        "trace_source": report["trace_source"],
        "rank_correlation": report["rank_correlation"],
    }


# -- gate scenarios (TestValidationGate) ------------------------------------


def gate_good_promotes_poison_quarantines(env):
    stats = env.ServingStats()
    manager = env.make_manager(stats=stats, min_rank_correlation=0.5)
    good = env.create(manager, "good")
    assert good.state == env.ACTIVE
    report = good.evaluation["validation"]
    assert report["passed"] and report["trace_source"] == "synthetic"
    assert report["rank_correlation"] >= 0.5
    out = [report_view(report)]
    for tag, reason in (("nan", "nonfinite"), ("zero", "constant")):
        row = env.create(manager, tag)
        assert row.state == env.QUARANTINED
        assert reason in ";".join(row.evaluation["validation"]["reasons"])
        out.append(report_view(row.evaluation["validation"]))
    assert stats.get("model_validation_rejections") == 2
    assert env.v(manager.get_active_model_version("mlp", 0)) == 0
    return out, env.states(manager), stats.snapshot()


def gate_replays_recorded_traces(env):
    manager = env.make_manager(min_rank_correlation=0.2)
    log = env.validation.TraceLog()
    rng = np.random.default_rng(0)
    for batch in env.validation.synthetic_traces(seed=9, batches=6, rows=8):
        log.record(batch + rng.normal(0, 0.01, batch.shape))
    manager.record_announce_traces(0, log.to_bytes())
    row = env.create(manager, "good")
    assert row.state == env.ACTIVE
    view = report_view(row.evaluation["validation"])
    assert view["trace_source"] == "recorded" and view["batches"] == 6
    return view, env.states(manager)


def gate_rejects_unloadable_and_skips(env):
    manager = env.make_manager()
    row = env.create(manager, env.garbage_dir("garbage"))
    assert row.state == env.QUARANTINED
    assert row.evaluation["validation"]["checks"]["load"] == "failed"
    skipped = env.create(manager, "nan", skip_validation=True)
    assert skipped.state == env.ACTIVE
    art = env.tmp / "gnn-art"
    art.mkdir()
    (art / "blob.bin").write_bytes(b"x" * 16)
    gnn = env.create(manager, str(art), name="g", model_type="gnn")
    assert gnn.state == env.ACTIVE
    assert "servable" in gnn.evaluation["validation"]["checks"]
    return (report_view(row.evaluation["validation"]),
            report_view(gnn.evaluation["validation"]), env.states(manager))


# -- registry invariants (TestRegistryInvariants) ----------------------------


def concurrent_create_single_active(env):
    out = []
    for gate in (False, True):
        manager = env.make_manager(gate=gate)
        errors = []

        def worker(i, manager=manager, errors=errors):
            try:
                env.create(manager, "good", name=f"m{i}")
            except Exception as exc:  # noqa: BLE001 — collected
                errors.append(exc)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert not errors
        rows = manager.list_models()
        active = [r for r in rows if r.state == env.ACTIVE]
        assert len(rows) == 4 and len(active) == 1
        out.append((len(rows), len(active)))
    return out


def quarantined_never_reactivates(env):
    manager = env.make_manager()
    env.create(manager, "good")
    bad = env.create(manager, "nan")
    assert bad.state == env.QUARANTINED
    refused = []
    for call in (lambda: manager.set_model_state(bad.id, env.ACTIVE),
                 lambda: manager.promote_model(bad.id),
                 lambda: manager.set_model_state(bad.id, env.INACTIVE)):
        with pytest.raises(env.service_mod.ManagerError, match="quarantined"):
            call()
        refused.append(True)
    return refused, env.states(manager)


def stranded_candidate_only_the_gate_promotes(env):
    manager = env.make_manager()
    real_validate = manager.validate_model_row
    manager.validate_model_row = lambda *a, **kw: (_ for _ in ()).throw(
        ConnectionError("object store down"))
    with pytest.raises(ConnectionError):
        env.create(manager, "good")
    manager.validate_model_row = real_validate
    stranded = manager.list_models()[0]
    assert stranded.state == "candidate"
    with pytest.raises(env.service_mod.ManagerError, match="candidate"):
        manager.set_model_state(stranded.id, env.ACTIVE)
    report = manager.validate_model_row(stranded.id)
    assert report.passed
    assert manager.promote_model(stranded.id).state == env.ACTIVE
    restored = manager.rollback("mlp", 0, reason="test")
    assert restored is None
    assert manager.get_active_model_version("mlp", 0) is None
    return (report.passed, sorted(report.checks.items()),
            [r.state for r in manager.list_models()])


def rollback_restores_previous(env):
    stats = env.ServingStats()
    manager = env.make_manager(gate=False, stats=stats)
    v1 = env.create(manager, "good")
    v2 = env.create(manager, "good")
    restored = manager.quarantine_version("mlp", v2.version, 0,
                                          reason="guard trips")
    assert restored is not None and restored.version == v1.version
    assert manager.quarantine_version("mlp", v2.version, 0) is None
    assert env.v(manager.get_active_model_version("mlp", 0)) == 0
    # Manual re-activation keeps the single-active invariant.
    v3 = env.create(manager, "good")
    manager.set_model_state(v1.id, env.ACTIVE)
    active = [r for r in manager.list_models() if r.state == env.ACTIVE]
    assert len(active) == 1 and active[0].id == v1.id
    # Quarantining the only version of another scheduler restores nothing.
    only = env.create(manager, "good", name="o", scheduler_id=7)
    assert manager.quarantine_version("mlp", only.version, 7) is None
    return env.states(manager), env.v(v3.version), stats.snapshot()


def concurrent_quarantine_single_restore(env):
    manager = env.make_manager(gate=False)
    env.create(manager, "good")
    env.create(manager, "good")
    bad = env.create(manager, "good")
    results = []

    def report():
        results.append(manager.quarantine_version("mlp", bad.version, 0))

    threads = [threading.Thread(target=report) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert sum(1 for r in results if r is not None) == 1
    return env.states(manager)


# -- the inference service (TestSidecarLifecycle) ----------------------------


def sidecar_env(env, **kw):
    stats = env.ServingStats()
    manager = env.make_manager(gate=False, stats=stats)
    service = env.service(
        manager=manager, canary_batches=2, canary_probe_grace_s=0.0,
        serving_stats=stats, reload_grace_s=0.2, **kw)
    return manager, service, stats


def poisoned_shadow_rejected_and_rolled_back(env):
    manager, service, stats = sidecar_env(env)
    try:
        env.create(manager, "good")
        assert service.reload_from_manager()
        seq = [env.v(service.serving_version("mlp"))]
        bad = env.create(manager, "nan")
        assert service.reload_from_manager()
        seq.append(env.v(service.serving_version("mlp")))
        assert env.v(service.shadow_stats()["mlp"]["version"]) == 1
        service.process_shadows()
        assert service.shadow_stats() == {}
        assert stats.get("canary_rollbacks") == 1
        assert stats.get("shadow_guard_trips") == 1
        assert manager.get_model_version_state(
            "mlp", bad.version) == env.QUARANTINED
        assert service.reload_from_manager() is False
        seq.append(env.v(service.serving_version("mlp")))
        return seq, env.states(manager), stats.snapshot()
    finally:
        service.stop()


def healthy_shadow_promotes_on_live_batches(env):
    manager, service, stats = sidecar_env(env)
    try:
        good = env.create(manager, "good")
        service.reload_from_manager()
        env.create(manager, "good")
        service.reload_from_manager()
        shadow = service._shadows["mlp"]
        rng = np.random.default_rng(0)
        outputs = []
        for _ in range(2):
            batch = rng.uniform(0, 50, (6, FEATURE_DIM)).astype(np.float32)
            incumbent = service._models["mlp"].scorer.score(batch)
            outputs.append(np.asarray(incumbent))
            shadow["queue"].append((batch, incumbent))
        service.process_shadows()
        assert env.v(service.serving_version("mlp")) == 1
        assert stats.get("canary_promotions") == 1
        assert stats.get("shadow_batches") == 2
        assert good.version in service._known_good
        return (env.v(service.serving_version("mlp")), stats.snapshot(),
                outputs)
    finally:
        service.stop()


def model_infer_mirrors_to_shadow(env):
    manager, service, stats = sidecar_env(env)
    try:
        env.create(manager, "good")
        service.reload_from_manager()
        env.create(manager, "good")
        service.reload_from_manager()
        features = np.random.default_rng(1).uniform(
            0, 50, (5, FEATURE_DIM)).astype(np.float32)
        resp = service.ModelInfer(
            env.sidecar.ModelInferRequest(model_name="mlp", inputs=features),
            Ctx())
        assert resp.model_version == service.serving_version("mlp")
        assert len(service._shadows["mlp"]["queue"]) == 1
        return env.v(resp.model_version), [np.asarray(resp.outputs)]
    finally:
        service.stop()


def latency_blowout_rejects_shadow(env):
    manager, service, stats = sidecar_env(env)
    try:
        env.create(manager, "good")
        service.reload_from_manager()

        class SlowScorer:
            def score(self, batch):
                import time

                time.sleep(0.05)
                return np.arange(len(batch), dtype=np.float32)

        service.canary_latency_budget_s = 0.01
        service._shadows["mlp"] = env.sidecar._new_shadow(
            "mlp", "slow-v", SlowScorer())
        service.process_shadows()
        assert service.shadow_stats() == {}
        assert stats.get("canary_rollbacks") == 1
        assert service._failed_versions["mlp"] == "slow-v"
        # The parked reason carries the measured latency: compare its kind.
        return stats.snapshot(), [(name, version, reason.split(" ")[0])
                                  for name, version, reason
                                  in service._pending_quarantines]
    finally:
        service.stop()


def failed_quarantine_parked_and_retried(env):
    manager, service, stats = sidecar_env(env)
    try:
        good = env.create(manager, "good")
        service.reload_from_manager()
        bad = env.create(manager, "nan", skip_validation=True)
        service.reload_from_manager()
        real_quarantine = manager.quarantine_version
        outage = {"on": True}

        def flaky_quarantine(*a, **kw):
            if outage["on"]:
                raise ConnectionError("manager unreachable")
            return real_quarantine(*a, **kw)

        manager.quarantine_version = flaky_quarantine
        service.process_shadows()
        assert service._pending_quarantines == [
            ("mlp", bad.version, "guard trip: nonfinite")]
        assert manager.get_active_model_version("mlp", 0) == bad.version
        assert service.serving_version("mlp") == good.version
        service.retry_pending_quarantines()
        parked = len(service._pending_quarantines)
        outage["on"] = False
        service.retry_pending_quarantines()
        assert service._pending_quarantines == []
        assert manager.get_active_model_version("mlp", 0) == good.version
        return parked, env.states(manager), stats.snapshot()
    finally:
        service.stop()


def reload_memoizes_failing_version(env):
    stats = env.ServingStats()
    manager = env.make_manager(gate=False, stats=stats)
    env.create(manager, "good")
    fetches = []
    real_get = manager.get_active_model

    def counting_get(name, scheduler_id=0):
        fetches.append(name)
        return real_get(name, scheduler_id)

    manager.get_active_model = counting_get
    service = env.service(manager=manager, serving_stats=stats,
                          reload_grace_s=0.2, canary_batches=2,
                          canary_probe_grace_s=0.0)
    try:
        service.reload_from_manager()
        seq = [env.v(service.serving_version("mlp"))]
        baseline = len(fetches)
        env.create(manager, env.garbage_dir("corrupt"))
        assert service.reload_from_manager() is False
        assert stats.get("model_reload_failures") == 1
        for _ in range(3):
            assert service.reload_from_manager() is False
        assert len(fetches) == baseline + 1
        seq.append(env.v(service.serving_version("mlp")))
        env.create(manager, "good")
        assert service.reload_from_manager() is True
        service.process_shadows()
        seq.append(env.v(service.serving_version("mlp")))
        assert seq == [0, 0, 2]
        return seq, stats.snapshot()
    finally:
        service.stop()


def deactivate_all_keeps_incumbent(env):
    manager, service, stats = sidecar_env(env)
    try:
        good = env.create(manager, "good")
        service.reload_from_manager()
        manager.set_model_state(good.id, env.INACTIVE)
        assert manager.get_active_model_version("mlp", 0) is None
        assert service.reload_from_manager() is False
        return env.v(service.serving_version("mlp")), env.states(manager)
    finally:
        service.stop()


def rollback_replace_skips_shadow(env):
    manager, service, stats = sidecar_env(env)
    try:
        env.create(manager, "good")
        service.reload_from_manager()
        v2 = env.create(manager, "nan", skip_validation=True)
        service.shadow_mode = False
        service.reload_from_manager()
        seq = [env.v(service.serving_version("mlp"))]
        manager.quarantine_version("mlp", v2.version, 0, reason="guard")
        assert service.reload_from_manager() is True
        seq.append(env.v(service.serving_version("mlp")))
        assert seq == [1, 0]
        assert service.shadow_stats() == {}
        return seq, stats.snapshot()
    finally:
        service.stop()


# -- fault sites (TestModelFaultSites) ----------------------------------------


def artifact_truncate_fails_cleanly(env):
    stats = env.ServingStats()
    manager = env.make_manager(gate=False, stats=stats)
    env.create(manager, "good")
    service = env.service(manager=manager, serving_stats=stats,
                          reload_grace_s=0.2)
    plan = env.faultplan.FaultPlan(seed=0)
    plan.add("model.artifact", env.faultplan.FaultKind.TRUNCATE,
             every_nth=1, match="mlp")
    env.faultplan.install(plan)
    try:
        assert service.reload_from_manager() is False
        assert stats.get("model_reload_failures") == 1
        assert service.serving_version("mlp") is None
        return plan.snapshot(), stats.snapshot()
    finally:
        env.faultplan.uninstall()
        service.stop()


def weights_poison_loads_but_guards_catch(env):
    artifact = env.service_mod._tar_directory(env.dirs["good"])
    features = env.validation.synthetic_traces(batches=1, rows=8)[0]
    out = []
    for kind, reason in (("CORRUPT", "nonfinite"), ("SCALE", "constant")):
        plan = env.faultplan.FaultPlan(seed=0)
        plan.add("model.weights", getattr(env.faultplan.FaultKind, kind),
                 every_nth=1)
        env.faultplan.install(plan)
        try:
            scorer = env.sidecar._scorer_from_artifact(artifact, **env.device)
        finally:
            env.faultplan.uninstall()
        assert env.guard.guard_reason(scorer.score(features)) == reason
        out.append((reason, plan.history))
    return out


def model_infer_fault_site(env):
    """``infer.model_infer``: UNAVAILABLE and DEADLINE abort with their
    codes on the fired visits, STALL delays and answers."""
    service = env.service()
    service.install_scorer("mlp", env.sidecar._scorer_from_artifact(
        env.service_mod._tar_directory(env.dirs["good"]), **env.device))
    fp = env.faultplan
    plan = fp.FaultPlan(seed=1)
    plan.add("infer.model_infer", fp.FaultKind.UNAVAILABLE, every_nth=3)
    plan.add("infer.model_infer", fp.FaultKind.DEADLINE, every_nth=4)
    plan.add("infer.model_infer", fp.FaultKind.STALL, probability=0.3,
             delay_s=0.001)
    fp.install(plan)
    codes = []
    try:
        features = env.validation.synthetic_traces(batches=1, rows=8)[0]
        for _ in range(12):
            try:
                service.ModelInfer(env.sidecar.ModelInferRequest(
                    model_name="mlp", inputs=features), Ctx())
                codes.append("OK")
            except Aborted as exc:
                codes.append(exc.code)
    finally:
        fp.uninstall()
        service.stop()
    assert {"UNAVAILABLE", "DEADLINE_EXCEEDED", "OK"} <= set(codes)
    return codes, plan.history


SCENARIOS = [
    gate_good_promotes_poison_quarantines,
    gate_replays_recorded_traces,
    gate_rejects_unloadable_and_skips,
    concurrent_create_single_active,
    quarantined_never_reactivates,
    stranded_candidate_only_the_gate_promotes,
    rollback_restores_previous,
    concurrent_quarantine_single_restore,
    poisoned_shadow_rejected_and_rolled_back,
    healthy_shadow_promotes_on_live_batches,
    model_infer_mirrors_to_shadow,
    latency_blowout_rejects_shadow,
    failed_quarantine_parked_and_retried,
    reload_memoizes_failing_version,
    deactivate_all_keeps_incumbent,
    rollback_replace_skips_shadow,
    artifact_truncate_fails_cleanly,
    weights_poison_loads_but_guards_catch,
    model_infer_fault_site,
]


def assert_same(got, ref, path="out"):
    """Structural equality, numpy arrays within BF16_TOL and rank
    correlations within CORR_TOL."""
    if isinstance(ref, np.ndarray):
        np.testing.assert_allclose(got, ref, rtol=0, atol=BF16_TOL,
                                   err_msg=path)
    elif isinstance(ref, dict):
        assert sorted(got) == sorted(ref), path
        for k in ref:
            if k == "rank_correlation" and isinstance(ref[k], float):
                assert abs(got[k] - ref[k]) <= CORR_TOL, (path, k)
            else:
                assert_same(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same(g, r, f"{path}[{i}]")
    else:
        assert got == ref, path


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_lifecycle_matches_jax(scenario, distilled, tmp_path):
    ref = scenario(Env("jax", distilled, tmp_path))
    got = scenario(Env("port", distilled, tmp_path))
    assert_same(got, ref)


# -- framework-free helpers, bit for bit ----------------------------------------


def test_spearman_and_synthetic_traces_bit_identical():
    for seed in range(3):
        ref = jax_validation.synthetic_traces(seed=seed, batches=5, rows=9)
        got = port_validation.synthetic_traces(seed=seed, batches=5, rows=9)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 12, 64):
        a = rng.integers(0, 5, n).astype(np.float32)  # ties included
        b = rng.standard_normal(n)
        assert port_validation.spearman(a, b) == \
            jax_validation.spearman(a, b)
    assert port_validation.spearman([1, 2, 3, 4], [4, 3, 2, 1]) == \
        pytest.approx(-1.0)
    assert port_validation.spearman([1, 2, 3], [1, 1, 1]) == 0.0


def test_trace_log_round_trips_both_ways():
    log = port_validation.TraceLog(capacity=3)
    for i in range(5):
        log.record(np.full((2, FEATURE_DIM), i, np.float32))
    log.record(np.zeros((0, FEATURE_DIM), np.float32))
    assert len(log) == 3
    for src, dst in ((port_validation, jax_validation),
                     (jax_validation, port_validation)):
        first = src.TraceLog(capacity=3)
        for b in log.batches():
            first.record(b)
        clone = dst.TraceLog.from_bytes(first.to_bytes())
        got = clone.batches()
        assert len(got) == 3 and got[-1][0, 0] == 4.0
        for a, b in zip(got, log.batches()):
            np.testing.assert_array_equal(a, b)


def test_params_guard_and_poison_bit_identical():
    tree = {"w": np.arange(6, dtype=np.float32).reshape(3, 2),
            "nested": {"b": np.ones(4, np.float64)},
            "idx": np.arange(5), "seq": [np.ones(2, np.float32)]}
    for mode in ("nan", "zero"):
        got = port_guard.poison_params(tree, mode)
        ref = jax_guard.poison_params(tree, mode)
        np.testing.assert_array_equal(got["w"], ref["w"])
        np.testing.assert_array_equal(got["nested"]["b"],
                                      ref["nested"]["b"])
        np.testing.assert_array_equal(got["idx"], tree["idx"])
        np.testing.assert_array_equal(got["seq"][0], ref["seq"][0])
        assert port_guard.params_guard_reason(got) == \
            jax_guard.params_guard_reason(ref)
    assert port_guard.params_guard_reason(tree) is None
    inf_tree = {"w": np.array([1.0, np.inf])}
    assert port_guard.params_guard_reason(inf_tree) == "nonfinite" == \
        jax_guard.params_guard_reason(inf_tree)
    with pytest.raises(ValueError):
        port_guard.poison_params(tree, "nope")


def test_fault_plan_fire_sequence_bit_identical():
    """A seeded plan over the serving sites, visited in one fixed order:
    the same fire history and snapshot in both packages."""
    rules = [
        ("model.artifact", "CORRUPT", {"probability": 0.3, "match": "mlp"}),
        ("model.artifact", "TRUNCATE", {"every_nth": 4}),
        ("model.weights", "SCALE", {"probability": 0.5, "max_fires": 3}),
        ("infer.model_infer", "STALL", {"every_nth": 5, "delay_s": 0.0}),
        ("infer.model_infer", "UNAVAILABLE", {"probability": 0.2}),
    ]
    histories = {}
    for name, fp in (("jax", jax_faultplan), ("port", port_faultplan)):
        plan = fp.FaultPlan(seed=42)
        for site, kind, kw in rules:
            plan.add(site, getattr(fp.FaultKind, kind), **kw)
        for i in range(200):
            plan.check("model.artifact", context=("mlp:v" if i % 3 else
                                                  "gat:v"))
            plan.check("model.weights", context="mlp")
            plan.check("infer.model_infer", context="mlp")
        histories[name] = (plan.history, plan.snapshot())
    assert histories["port"] == histories["jax"]
    assert len(histories["port"][0]) > 20


# -- /debug/vars ---------------------------------------------------------------


def test_debug_vars_serving_scheduler_and_batcher_blocks():
    from dragonfly2_tpu.utils import debugmon as jax_debugmon
    from dragonfly2_tpu_torch.scheduler import controlstats
    from dragonfly2_tpu_torch.utils import debugmon, servingstats

    before = debugmon.debug_vars()["serving"]
    servingstats.SERVING.tick("ml_guard_trips")
    after = debugmon.debug_vars()["serving"]
    assert after["ml_guard_trips"] == before["ml_guard_trips"] + 1
    assert sorted(after) == sorted(
        jax_debugmon.debug_vars()["serving"])
    assert debugmon.debug_vars()["scheduler"] == controlstats.STATS.snapshot()
    assert set(debugmon.process_vars()) >= {"uptime_seconds", "threads",
                                            "gc_counts", "python", "torch"}

    service = port_sidecar.InferenceService()
    service.install_scorer("mlp", types.SimpleNamespace(
        max_batch=8, score=lambda f: np.asarray(f).sum(1)))
    debugmon.register_debug_var("inference_batcher_stats",
                                service.batcher_stats)
    monitor = debugmon.DebugMonitor("127.0.0.1", 0)
    monitor.start()
    try:
        service.ModelInfer(port_sidecar.ModelInferRequest(
            "mlp", np.ones((3, FEATURE_DIM), np.float32)), Ctx())
        with urllib.request.urlopen(
                f"http://{monitor.address}/debug/vars", timeout=10) as resp:
            body = json.loads(resp.read())
        with urllib.request.urlopen(
                f"http://{monitor.address}/healthy", timeout=10) as resp:
            assert resp.read() == b"OK"
    finally:
        monitor.stop()
        service.stop()
        # Drop the process-wide block's reference to this test's service.
        debugmon.register_debug_var("inference_batcher_stats", dict)
    block = body["inference_batcher_stats"]["mlp"]
    assert block["coalesced_requests"] == 1
    assert len(block["per_lane"]) == 2
    assert {"serving", "scheduler", "torch"} <= set(body)


# -- a fault of the card is not the artifact's (port only) --------------------


@pytest.mark.parametrize("exc, fault", [
    (DeviceFault("graph_flash_attention: CUDA error 700"), True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB"), True),
    (RuntimeError("CUDA error: an illegal memory access"), True),
    (RuntimeError("CUBLAS_STATUS_EXECUTION_FAILED"), True),
    (RuntimeError("Error(s) in loading state_dict"), False),
    (ValueError("not a checkpoint"), False),
    (KeyError("params"), False),
], ids=["device_fault", "oom", "cuda_runtime", "cublas", "state_dict",
        "value", "key"])
def test_is_device_fault(exc, fault):
    assert is_device_fault(exc) is fault


def card_fault(*args, **kwargs):
    raise DeviceFault("table_gather: CUDA error 719 (unspecified launch "
                      "failure)")


@pytest.mark.parametrize("model_type, loader", [
    ("mlp", "_scorer_from_artifact"),
    ("cost", "_cost_scorer_from_artifact"),
    ("gat", "_gat_scorer_from_artifact"),
])
def test_gate_propagates_card_faults(model_type, loader, monkeypatch):
    """A candidate whose build fails on the card raises out of the gate
    (its row stays a candidate); a loader's other errors stay a verdict."""
    config = port_validation.ValidationConfig()
    monkeypatch.setattr(port_sidecar, loader, card_fault)
    with pytest.raises(DeviceFault):
        port_validation.validate_artifact(model_type, b"", None, config,
                                          device="cpu")

    def bad_artifact(*args, **kwargs):
        raise ValueError("not a checkpoint")

    monkeypatch.setattr(port_sidecar, loader, bad_artifact)
    report = port_validation.validate_artifact(model_type, b"", None,
                                               config, device="cpu")
    assert not report.passed
    assert report.checks == {"load": "failed"}


def test_create_model_leaves_a_candidate_on_card_faults(distilled, tmp_path,
                                                       monkeypatch):
    env = Env("port", distilled, tmp_path)
    stats = ServingStats()
    manager = env.make_manager(stats=stats)
    monkeypatch.setattr(port_sidecar, "_scorer_from_artifact", card_fault)
    with pytest.raises(DeviceFault):
        env.create(manager, "good")
    assert [r.state for r in manager.list_models()] == ["candidate"]
    assert stats.get("model_quarantines") == 0
    assert manager.get_active_model_version("mlp") is None


def test_reload_retries_card_faults_without_memoizing(distilled, tmp_path,
                                                      monkeypatch):
    """A card fault while the watcher builds the active version is
    neither memoized nor counted as a failed load: the next poll builds
    it again and installs it once the fault clears."""
    env = Env("port", distilled, tmp_path)
    stats = ServingStats()
    manager = env.make_manager(gate=False, stats=stats)
    row = env.create(manager, "good")
    real = port_sidecar._scorer_from_artifact
    calls = []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) <= 2:
            card_fault()
        return real(*args, **kwargs)

    monkeypatch.setattr(port_sidecar, "_scorer_from_artifact", flaky)
    service = env.service(manager=manager, serving_stats=stats)
    try:
        assert service.reload_from_manager() is False
        assert service.reload_from_manager() is False
        assert stats.get("model_reload_failures") == 0
        assert service.serving_version("mlp") is None
        assert service.reload_from_manager() is True
        assert service.serving_version("mlp") == row.version
        assert len(calls) == 3
    finally:
        service.stop()


def test_shadow_not_rejected_for_card_faults():
    """A card fault while a shadow scores a mirrored batch raises out of
    ``process_shadows`` and leaves the shadow in place; another scoring
    error rejects it."""
    stats = ServingStats()
    service = port_sidecar.InferenceService(serving_stats=stats,
                                            device="cpu")
    service.install_scorer("mlp", types.SimpleNamespace(
        max_batch=8, score=lambda f: np.asarray(f).sum(1)), version="v1")
    batch = np.ones((4, FEATURE_DIM), np.float32)

    def broken(features):
        raise ValueError("shape mismatch")

    try:
        for score, raises in ((card_fault, DeviceFault), (broken, None)):
            shadow = port_sidecar._new_shadow(
                "mlp", "v2", types.SimpleNamespace(max_batch=8, score=score))
            shadow["queue"].append((batch, batch.sum(1)))
            service._shadows["mlp"] = shadow
            if raises is None:
                service.process_shadows()
                assert "mlp" not in service._shadows
            else:
                with pytest.raises(raises):
                    service.process_shadows()
                assert service._shadows["mlp"] is shadow
                assert stats.get("canary_rollbacks") == 0
        assert stats.get("canary_rollbacks") == 1
    finally:
        service.stop()
