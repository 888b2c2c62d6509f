"""Poisoned-model chaos rung — the guarded model lifecycle's proof.

A REAL loopback swarm — in-process scheduler + three peer daemons + an
HTTP origin — whose scheduling decisions flow through the full ML
serving stack: ``RemoteMLEvaluator`` → ``LocalInferenceClient`` →
inference sidecar (its MLP on the card) → manager model registry, with
the live reload watcher running.
Mid-swarm, a poisoned model (NaN weights — loadable, degenerate) is
published THREE ways and must be a non-event every time:

1. **Offline gate** — ``create_model`` through the validation gate,
   replaying announce traces RECORDED from this very swarm: the gate
   must quarantine the candidate before it ever activates.
2. **Shadow/canary** — the same poison force-published past the gate
   (the operator-error / compromised-trainer path): the sidecar loads
   it in SHADOW, the canary trips on mirrored live traffic, rejects it,
   and quarantines it back to the manager — the incumbent never stops
   taking decisions.
3. **Runtime guard** — shadow mode disabled and poison force-published
   again: the sidecar serves it, the scheduler-side guard rejects every
   poisoned score batch (decisions degrade to rules, never to noise),
   escalates to a manager quarantine after ``guard_trip_limit`` trips,
   and the watcher's next poll restores the previous good version
   fleet-wide.

Documented bounds (docs/CHAOS.md): **100 % task success throughout,
decision quality never below the rule baseline (no guard-tripped batch
ever orders parents; tracked mean/window-min quality ≥**
:data:`QUALITY_FLOOR`\\ **), and automatic rollback within 2 ×
reload_interval of the poisoned version reaching the sidecar** —
counters prove guard-trip → quarantine → rollback fired.
:func:`check_mlguard_regression` holds a fresh run to those bounds,
beside the best ``mlguard_run_*.json`` record under a state dir.

The JAX package's rung (``dragonfly2_tpu.inference.guardbench``) in
PyTorch, departing from it in three ways only: the evaluator reaches
the sidecar through :class:`~dragonfly2_tpu_torch.inference.sidecar.
LocalInferenceClient` in this process (the gRPC transport is not
ported); ``device`` (``None``: the card) is where the distilled MLP
trains, the gate builds candidates and the sidecar serves; and a fault
of the card (:func:`~dragonfly2_tpu_torch.device.is_device_fault`)
propagates instead of landing in ``report["error"]`` — a missing card
is no verdict on the lifecycle.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
import threading
import time
from typing import Optional

import numpy as np

#: Decision-quality floor (rule-normalized score of the chosen parent,
#: 1.0 == the rule baseline's own pick): the rung's good model is a
#: rule-distilled MLP, so healthy decisions sit near 1.0 and every
#: guarded decision IS the rule baseline.
QUALITY_FLOOR = 0.8
#: Rollback bound, in units of the sidecar reload interval, measured
#: from the poisoned version REACHING the sidecar (shadow install /
#: serving swap) to the previous good version restored.
ROLLBACK_BOUND_INTERVALS = 2.0

SCHEDULER_ID = 7


def train_rule_distilled_mlp(seed: int = 0, samples: int = 1536,
                             device=None):
    """A small MLP distilled from the RULE evaluator over synthetic
    feature batches: a genuinely trained artifact that clears the
    gate's rank-correlation floor by construction — the rung measures
    lifecycle machinery, not model research. Trains on ``device``
    (``None``: the card)."""
    from dragonfly2_tpu_torch.manager.validation import synthetic_traces
    from dragonfly2_tpu_torch.scheduler.evaluator import scoring
    from dragonfly2_tpu_torch.train.mlp_trainer import (
        MLPTrainConfig,
        train_mlp,
    )

    batches = synthetic_traces(seed=seed, batches=samples // 12, rows=12)
    X = np.concatenate(batches).astype(np.float32)
    y = np.asarray(scoring.rule_scores(X), dtype=np.float32)
    return train_mlp(
        X, y,
        MLPTrainConfig(hidden=(32,), epochs=30, batch_size=128,
                       eval_fraction=0.2),
        device)


def write_model_artifact(base_dir: str, result, tag: str,
                         poison: Optional[str] = None) -> str:
    """Save a (possibly poisoned) MLP checkpoint dir ready for
    ``create_model``. ``poison`` is a modelguard mode ("nan"/"zero")."""
    from dragonfly2_tpu_torch.inference.modelguard import poison_params
    from dragonfly2_tpu_torch.train.checkpoint import (
        ModelMetadata,
        mlp_tree,
        save_model,
    )

    params = result.params
    if poison is not None:
        params = poison_params(params, poison)
    path = os.path.join(base_dir, f"artifact-{tag}")
    save_model(
        path,
        mlp_tree(params, result.normalizer, result.target_norm),
        ModelMetadata(model_id=f"df2-mlp-guard-{tag}", model_type="mlp",
                      evaluation={"mae": float(result.mae)},
                      config={"hidden": [32]}),
    )
    return path


def _await(predicate, deadline_s: float, poll_s: float = 0.02):
    """Poll until ``predicate()`` is truthy; returns (value, seconds) —
    value None when the deadline expired."""
    t0 = time.perf_counter()
    while True:
        value = predicate()
        if value:
            return value, time.perf_counter() - t0
        if time.perf_counter() - t0 > deadline_s:
            return None, time.perf_counter() - t0
        time.sleep(poll_s)


class _SwarmTraffic:
    """Background download generator: each cycle mints a fresh blob,
    seeds it through one daemon and pulls it through the other two —
    every pull announces through the scheduler, so the ML evaluator
    keeps scoring candidate sets for as long as the rung needs live
    traffic. Every byte is md5-verified."""

    def __init__(self, daemons, origin, blob_bytes: int = 48 << 10):
        self.daemons = daemons
        self.origin = origin
        self.blob_bytes = blob_bytes
        self.downloads = 0
        self.failures: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mlguard-traffic")
        self._cycle = 0

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)

    def _loop(self) -> None:
        rng = np.random.default_rng(1234)
        while not self._stop.is_set():
            i = self._cycle
            self._cycle += 1
            path = f"/mlguard/blob-{i}"
            blob = rng.bytes(self.blob_bytes)
            self.origin.blobs[path] = blob
            want = hashlib.md5(blob).hexdigest()
            order = [self.daemons[i % 3], self.daemons[(i + 1) % 3],
                     self.daemons[(i + 2) % 3]]
            for daemon in order:
                if self._stop.is_set():
                    return
                try:
                    result = daemon.download_file(self.origin.url(path))
                except Exception as exc:  # noqa: BLE001 — counted
                    self.downloads += 1
                    self.failures.append(f"{path}: raised {exc!r}")
                    continue
                self.downloads += 1
                if not result.success:
                    self.failures.append(f"{path}: {result.error}")
                elif (hashlib.md5(result.read_all()).hexdigest() != want):
                    self.failures.append(f"{path}: md5 mismatch")
            # Bound origin-side memory on a long rung.
            stale = f"/mlguard/blob-{i - 8}"
            self.origin.blobs.pop(stale, None)
            self._stop.wait(0.01)


def run_mlguard_rung(seed: int = 0, reload_interval: float = 2.0,
                     guard_trip_limit: int = 3, canary_batches: int = 4,
                     root: str | None = None, device=None) -> dict:
    """Run the poisoned-model rung; returns the report dict (every
    consumer-read key present from the start — an early failure must
    carry its own diagnostics, not KeyError the stage). ``device``
    (``None``: the card) trains the good model, builds the gate's
    candidates and serves; a fault of the card raises."""
    from dragonfly2_tpu_torch.client.chaosbench import MultiBlobServer
    from dragonfly2_tpu_torch.client.daemon import Daemon, DaemonConfig
    from dragonfly2_tpu_torch.device import is_device_fault
    from dragonfly2_tpu_torch.utils.servingstats import ServingStats
    from dragonfly2_tpu_torch.inference.sidecar import (
        InferenceService,
        LocalInferenceClient,
        RemoteMLEvaluator,
    )
    from dragonfly2_tpu_torch.manager import (
        Database,
        FilesystemObjectStore,
        ManagerService,
    )
    from dragonfly2_tpu_torch.manager.database import (
        STATE_ACTIVE,
        STATE_QUARANTINED,
    )
    from dragonfly2_tpu_torch.manager.validation import (
        TraceLog,
        ValidationConfig,
    )
    from dragonfly2_tpu_torch.scheduler.resource.resource import Resource
    from dragonfly2_tpu_torch.scheduler.scheduling.core import (
        Scheduling,
        SchedulingConfig,
    )
    from dragonfly2_tpu_torch.scheduler.service import SchedulerService
    from dragonfly2_tpu_torch.scheduler.storage.storage import Storage

    bound_s = ROLLBACK_BOUND_INTERVALS * reload_interval
    report: dict = {
        "seed": seed,
        "reload_interval_s": reload_interval,
        "rollback_bound_s": round(bound_s, 3),
        "guard_trip_limit": guard_trip_limit,
        "quality_floor": QUALITY_FLOOR,
        "downloads": 0,
        "failures": [],
        "success_rate": 0.0,
        "gate": {"rejected_offline": False, "trace_source": None,
                 "reasons": []},
        "shadow_phase": {"exposed": False, "rolled_back": False,
                         "rollback_s": None, "incumbent_held": False},
        "guard_phase": {"exposed": False, "rolled_back": False,
                        "rollback_s": None, "quality_min": None,
                        "quality_samples": 0},
        "quality_mean": None,
        "quality_min": None,
        "counters": {},
        "registry": {},
        "verdict_pass": False,
        "error": None,
    }

    tmp = root or tempfile.mkdtemp(prefix="df2-mlguard-")
    stats = ServingStats()
    trace_log = TraceLog(capacity=64)

    manager = ManagerService(
        Database(), FilesystemObjectStore(os.path.join(tmp, "objects")),
        validation=ValidationConfig(min_rank_correlation=0.5),
        serving_stats=stats, device=device)

    sidecar = InferenceService(
        manager=manager, scheduler_id=SCHEDULER_ID,
        reload_interval=reload_interval, canary_batches=canary_batches,
        canary_probe_grace_s=reload_interval, serving_stats=stats,
        reload_grace_s=2.0, device=device)
    evaluator = None
    service = None
    daemons = []
    traffic = None
    try:
        # --- good model through the gate (synthetic traces: nothing
        # recorded yet) ---------------------------------------------------
        result = train_rule_distilled_mlp(seed=seed, device=device)
        good_row = manager.create_model(
            "df2-mlp-guard-good", "mlp", "h", "127.0.0.1", "mlguard",
            {"mae": float(result.mae)},
            write_model_artifact(tmp, result, "good"),
            scheduler_id=SCHEDULER_ID)
        report["registry"]["good_version"] = good_row.version
        if good_row.state != STATE_ACTIVE:
            report["error"] = (
                "good model failed the gate: "
                f"{(good_row.evaluation or {}).get('validation')}")
            return report
        good_version = good_row.version

        sidecar.reload_from_manager()  # first load: direct install
        sidecar.serve_watcher()

        def quarantine_serving(reason: str):
            version = evaluator.serving_version
            if not version:
                return False  # unknown yet: evaluator retries next trip
            manager.quarantine_version("mlp", version, SCHEDULER_ID,
                                       reason=f"evaluator guard: {reason}")

        evaluator = RemoteMLEvaluator(
            LocalInferenceClient(sidecar),
            stats=stats, guard_trip_limit=guard_trip_limit,
            on_quarantine=quarantine_serving, trace_log=trace_log,
            track_quality=True)

        service = SchedulerService(
            resource=Resource(),
            scheduling=Scheduling(
                evaluator, SchedulingConfig(retry_interval=0.01)),
            storage=Storage(os.path.join(tmp, "datasets")),
        )
        daemons = [
            Daemon(service, DaemonConfig(
                storage_root=os.path.join(tmp, name), hostname=name,
                keep_storage=False))
            for name in ("guard-a", "guard-b", "guard-c")
        ]
        for d in daemons:
            d.start()

        with MultiBlobServer({}) as origin:
            traffic = _SwarmTraffic(daemons, origin)
            traffic.start()

            # --- warm phase: real scored decisions + recorded traces --
            scored, _ = _await(lambda: evaluator.scored_count >= 8,
                               deadline_s=60.0)
            if not scored:
                report["error"] = ("warm swarm produced no ML-scored "
                                   "decisions")
                return report
            manager.record_announce_traces(SCHEDULER_ID,
                                           trace_log.to_bytes())

            # --- 1. offline gate rejects the poison, on REAL traces ---
            poison_gate_row = manager.create_model(
                "df2-mlp-guard-poison", "mlp", "h", "127.0.0.1",
                "mlguard", {},
                write_model_artifact(tmp, result, "poison-gate",
                                     poison="nan"),
                scheduler_id=SCHEDULER_ID)
            gate_report = (poison_gate_row.evaluation or {}).get(
                "validation", {})
            report["gate"] = {
                "rejected_offline":
                    poison_gate_row.state == STATE_QUARANTINED,
                "trace_source": gate_report.get("trace_source"),
                "reasons": gate_report.get("reasons", []),
            }
            report["registry"]["gate_poison_version"] = \
                poison_gate_row.version
            # The gate rejection must not have dethroned the good model.
            if manager.get_active_model_version(
                    "mlp", SCHEDULER_ID) != good_version:
                report["error"] = "gate rejection disturbed the active row"
                return report

            # --- 2. shadow/canary: force-publish poison mid-swarm -----
            shadow_row = manager.create_model(
                "df2-mlp-guard-poison", "mlp", "h", "127.0.0.1",
                "mlguard", {},
                write_model_artifact(tmp, result, "poison-shadow",
                                     poison="nan"),
                scheduler_id=SCHEDULER_ID, skip_validation=True)
            report["registry"]["shadow_poison_version"] = shadow_row.version
            exposed, _ = _await(
                lambda: sidecar.shadow_stats().get("mlp", {}).get(
                    "version") == shadow_row.version,
                deadline_s=4 * reload_interval)
            report["shadow_phase"]["exposed"] = bool(exposed)
            if exposed:
                restored, rollback_s = _await(
                    lambda: manager.get_active_model_version(
                        "mlp", SCHEDULER_ID) == good_version,
                    deadline_s=4 * reload_interval)
                report["shadow_phase"]["rolled_back"] = bool(restored)
                report["shadow_phase"]["rollback_s"] = round(rollback_s, 3)
                # The incumbent must have kept serving throughout.
                report["shadow_phase"]["incumbent_held"] = (
                    sidecar.serving_version("mlp") == good_version)

            # --- 3. runtime guard: shadow off, poison goes LIVE -------
            sidecar.shadow_mode = False
            q_before = len(evaluator.quality_samples)
            live_row = manager.create_model(
                "df2-mlp-guard-poison", "mlp", "h", "127.0.0.1",
                "mlguard", {},
                write_model_artifact(tmp, result, "poison-live",
                                     poison="nan"),
                scheduler_id=SCHEDULER_ID, skip_validation=True)
            report["registry"]["live_poison_version"] = live_row.version
            exposed, _ = _await(
                lambda: sidecar.serving_version("mlp") == live_row.version,
                deadline_s=4 * reload_interval)
            report["guard_phase"]["exposed"] = bool(exposed)
            if exposed:
                restored, rollback_s = _await(
                    lambda: sidecar.serving_version("mlp") == good_version,
                    deadline_s=4 * reload_interval)
                report["guard_phase"]["rolled_back"] = bool(restored)
                report["guard_phase"]["rollback_s"] = round(rollback_s, 3)
                window = list(evaluator.quality_samples)[q_before:]
                report["guard_phase"]["quality_samples"] = len(window)
                if window:
                    report["guard_phase"]["quality_min"] = round(
                        float(min(window)), 4)

            # Let the swarm settle a beat on the restored model, then
            # freeze traffic for the verdict.
            time.sleep(reload_interval / 2)
            traffic.stop()

            report["downloads"] = traffic.downloads
            report["failures"] = traffic.failures[:5]
            report["success_rate"] = round(
                (traffic.downloads - len(traffic.failures))
                / max(traffic.downloads, 1), 4)
    except Exception as exc:  # noqa: BLE001 — the report IS the output
        if is_device_fault(exc):
            raise
        report["error"] = f"{type(exc).__name__}: {exc}"
        return report
    finally:
        if traffic is not None:
            traffic.stop()
        for d in daemons:
            try:
                d.stop()
            except Exception:  # noqa: BLE001 — teardown best effort
                pass
        sidecar.stop()
        if root is None:
            shutil.rmtree(tmp, ignore_errors=True)

    qualities = list(evaluator.quality_samples)
    if qualities:
        report["quality_mean"] = round(float(np.mean(qualities)), 4)
        report["quality_min"] = round(float(min(qualities)), 4)
    report["counters"] = {
        "scored": evaluator.scored_count,
        "fallbacks": evaluator.fallback_count,
        # NOTE: evaluator.guard_trips is the LIVE count and auto-resets
        # when the restored version starts serving — the cumulative
        # evidence is the ml_guard_trips stat below.
        **stats.snapshot(),
    }
    rows = manager.list_models(SCHEDULER_ID)
    report["registry"]["states"] = {r.version: r.state for r in rows}
    active = [r for r in rows if r.state == STATE_ACTIVE]
    guard_quality = report["guard_phase"]["quality_min"]
    report["verdict_pass"] = bool(
        report["success_rate"] == 1.0
        and report["gate"]["rejected_offline"]
        and report["shadow_phase"]["rolled_back"]
        and report["shadow_phase"]["incumbent_held"]
        and report["shadow_phase"]["rollback_s"] is not None
        and report["shadow_phase"]["rollback_s"] <= bound_s
        and report["guard_phase"]["rolled_back"]
        and report["guard_phase"]["rollback_s"] is not None
        and report["guard_phase"]["rollback_s"] <= bound_s
        and stats.get("ml_guard_trips") >= guard_trip_limit
        and stats.get("ml_quarantines_reported") >= 1
        and stats.get("canary_rollbacks") >= 1
        and stats.get("model_rollbacks") >= 2
        and stats.get("model_quarantines") >= 3
        and (report["quality_mean"] or 0.0) >= QUALITY_FLOOR
        and (guard_quality is None or guard_quality >= QUALITY_FLOOR)
        and report["guard_phase"]["quality_samples"] > 0
        and len(active) == 1
        and active[0].version == report["registry"]["good_version"]
    )
    return report


def best_recorded_mlguard(state_dir: str) -> Optional[dict]:
    """Best persisted green mlguard run (fastest guard-phase rollback);
    skipped artifacts never count."""
    import glob
    import json

    best = None
    for path in glob.glob(os.path.join(state_dir, "mlguard_run_*.json")):
        try:
            with open(path) as f:
                run = json.load(f)
        except (OSError, ValueError):
            continue
        if run.get("skipped") or not run.get("verdict_pass"):
            continue
        if best is None or (
                (run.get("guard_phase", {}).get("rollback_s") or 1e9)
                < (best.get("guard_phase", {}).get("rollback_s") or 1e9)):
            best = run
    return best


def check_mlguard_regression(state_dir: str, device=None) -> dict:
    """A FRESH poisoned-model rung (on ``device``; ``None``: the card)
    must hold the absolute bounds (the verdict already encodes
    them — rollback ≤ 2 × reload_interval, 100 % success, quality
    floor); the best persisted record rides along for trend reading.
    The bounds are absolute, so unlike the throughput gates there is no
    fraction-of-record comparison to tune."""
    best = best_recorded_mlguard(state_dir)
    fresh = run_mlguard_rung(seed=0, device=device)
    out = {
        "fresh_verdict_pass": fresh["verdict_pass"],
        "fresh_error": fresh.get("error"),
        "fresh_shadow_rollback_s": fresh["shadow_phase"]["rollback_s"],
        "fresh_guard_rollback_s": fresh["guard_phase"]["rollback_s"],
        "fresh_success_rate": fresh["success_rate"],
        "fresh_quality_mean": fresh["quality_mean"],
        "rollback_bound_s": fresh["rollback_bound_s"],
        "best_recorded": best,
        "passed": bool(fresh["verdict_pass"]),
    }
    if best is None:
        out["note"] = ("no persisted record; gate covers the absolute "
                       "rung bounds only")
    return out
