"""Inference service — port of ``dragonfly2_tpu/inference/sidecar.py``.

:class:`InferenceService` serves scorers over the KServe-style
four-method surface (ModelInfer / ModelReady / ServerLive / ServerReady).
Each installed scorer sits behind a
:class:`~dragonfly2_tpu_torch.inference.batcher.MicroBatcher` (lanes,
bounded admission; a shed answers RESOURCE_EXHAUSTED). With a
``manager`` (:class:`~dragonfly2_tpu_torch.manager.ManagerService`) the
service pulls each model type's ACTIVE version and a watcher thread
hot-reloads when it changes: the first version installs directly, a
later one loads in SHADOW — scored on mirrored live batches and
synthetic probes while the incumbent keeps answering — and is promoted
after ``canary_batches`` clean batches, or rejected and quarantined at
the registry on a guard trip or a latency blow-out. A replaced batcher
closes after a grace window, with the bound :class:`HealthService`
reporting NOT_SERVING while a window is open. Fault plans reach the
service at the ``infer.model_infer``, ``model.artifact`` and
``model.weights`` sites (``utils/faultplan.py``).

The ``*_from_artifact`` loaders turn a port model.tar
(``train/checkpoint.py``) into a scorer on the card (or the ``device``
given): ``mlp`` and ``cost`` artifacts share one checkpoint layout and
one loader (:func:`_mlp_checkpoint_from_artifact`).

The service is served over the port's wire as JAX's is over gRPC
(``serve([(INFERENCE_SPEC, service)])``, ``rpc/service.py``): the same
service name, methods and codec-tagged messages. A method's ``context``
only needs ``abort(code, details)`` taking a :class:`StatusCode` and
raising, as gRPC's does; :class:`CallContext` is the in-process one
(``rpc/status.py``; re-exported here).

:class:`RemoteMLEvaluator` is JAX's: the ``ml`` evaluator over a client
of an inference service, with a circuit breaker and the serving version
a guard trip escalates. Its client is :class:`InferenceClient` over the
wire, or :class:`LocalInferenceClient`, the same calls on a service in
this process.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from dragonfly2_tpu_torch.device import default_device, is_device_fault
from dragonfly2_tpu_torch.inference.batcher import (
    BatcherSaturatedError,
    MicroBatcher,
)
from dragonfly2_tpu_torch.inference.modelguard import (
    guard_reason,
    poison_params,
)
from dragonfly2_tpu_torch.inference.scorer import (
    CostScorer,
    GATParentScorer,
    MLEvaluator,
    ParentScorer,
)
from dragonfly2_tpu_torch.models.graph_transformer import GraphTransformer
from dragonfly2_tpu_torch.models.mlp import FEATURE_DIM, MLPBandwidthPredictor
from dragonfly2_tpu_torch.parallel.mesh import LOCAL
from dragonfly2_tpu_torch.rpc.codec import message
from dragonfly2_tpu_torch.rpc.health import NOT_SERVING, SERVING
from dragonfly2_tpu_torch.rpc.service import MethodKind, ServiceSpec
from dragonfly2_tpu_torch.rpc.status import (  # noqa: F401 — re-exported
    CallContext,
    RpcAbort,
)
from dragonfly2_tpu_torch.rpc.status import RpcError, StatusCode
from dragonfly2_tpu_torch.train.checkpoint import (
    gat_from_tree,
    gat_state_dict_from_flax,
    load_artifact,
    mlp_from_tree,
    mlp_state_dict_from_flax,
)
from dragonfly2_tpu_torch.utils import faultplan
from dragonfly2_tpu_torch.utils.servingstats import SERVING as SERVING_STATS

logger = logging.getLogger(__name__)

MODEL_NAME_MLP = "mlp"
MODEL_NAME_GAT = "gat"
MODEL_NAME_COST = "cost"


@message("inference.ModelInferRequest")
@dataclass
class ModelInferRequest:
    model_name: str = ""
    # [batch, FEATURE_DIM] features (mlp) or [batch, 2] host indexes (gat).
    inputs: Optional[np.ndarray] = None


@message("inference.ModelInferResponse")
@dataclass
class ModelInferResponse:
    model_name: str = ""
    model_version: str = ""
    outputs: Optional[np.ndarray] = None


@message("inference.ModelReadyRequest")
@dataclass
class ModelReadyRequest:
    name: str = ""


@message("inference.ModelReadyResponse")
@dataclass
class ModelReadyResponse:
    ready: bool = False
    version: str = ""


@message("inference.ServerLiveRequest")
@dataclass
class ServerLiveRequest:
    pass


@message("inference.ServerLiveResponse")
@dataclass
class ServerLiveResponse:
    live: bool = True


@message("inference.ServerReadyRequest")
@dataclass
class ServerReadyRequest:
    pass


@message("inference.ServerReadyResponse")
@dataclass
class ServerReadyResponse:
    ready: bool = False


INFERENCE_SPEC = ServiceSpec(
    name="df2.inference.GRPCInferenceService",
    methods={
        "ModelInfer": MethodKind.UNARY_UNARY,
        "ModelReady": MethodKind.UNARY_UNARY,
        "ServerLive": MethodKind.UNARY_UNARY,
        "ServerReady": MethodKind.UNARY_UNARY,
    },
)


@dataclass
class _LoadedModel:
    version: str
    scorer: object  # ParentScorer | GATParentScorer
    batcher: Optional[MicroBatcher] = None  # None without micro_batch

    @property
    def max_rows(self) -> int:
        """The EFFECTIVE per-request row limit: the batcher clamps to
        ``min(batch_max_rows, scorer.max_batch)``, so ModelInfer's validation
        must check the same number — a request sized between the two
        would otherwise pass the scorer check and surface as an internal
        ValueError from the batcher instead of INVALID_ARGUMENT."""
        return (self.batcher.max_rows if self.batcher is not None
                else self.scorer.max_batch)

    def score(self, inputs):
        return (self.batcher.score(inputs) if self.batcher is not None
                else self.scorer.score(inputs))


class InferenceService:
    """Serves scorers, reloaded from the manager registry when one is
    given.

    ``micro_batch`` (default on) coalesces concurrent ModelInfer calls
    into one padded device dispatch, so latency does not grow with
    scheduler concurrency. The batcher is
    pipelined — batch N+1 is staged while N executes — and sharded into
    ``batch_lanes`` independent lanes (queue + worker + in-flight slot
    each) with per-lane bounded admission: ``batch_queue_depth`` caps
    each lane's queue, and a request whose lane is full is shed with
    RESOURCE_EXHAUSTED so the scheduler degrades to rule scoring instead
    of queueing multi-ms. Window knobs thread through here:
    ``batch_max_wait_s`` holds every batch open (remote-device
    throughput mode), ``batch_adaptive_wait_s`` opens the window only
    under detected queue growth (the default: idle requests keep the
    zero-wait path), ``batch_max_rows`` caps rows per dispatch (None =
    the scorer's largest warm bucket). ``device`` is where artifacts
    pulled from the manager load (``None``: the card)."""

    def __init__(self, manager=None, scheduler_id: int = 0,
                 reload_interval: float = 30.0, micro_batch: bool = True,
                 batch_max_wait_s: float = 0.0,
                 batch_adaptive_wait_s: float = 0.0005,
                 batch_max_rows: Optional[int] = None,
                 batch_lanes: int = 2,
                 batch_queue_depth: int = 32,
                 reload_grace_s: float = 35.0,
                 shadow_mode: bool = True,
                 canary_batches: int = 8,
                 canary_latency_budget_s: float = 0.25,
                 canary_probe_grace_s: Optional[float] = None,
                 serving_stats=None, device=None):
        self.manager = manager  # ManagerService or None (push-only mode)
        self.scheduler_id = scheduler_id
        self.reload_interval = reload_interval
        self.micro_batch = micro_batch
        self.batch_max_wait_s = batch_max_wait_s
        self.batch_adaptive_wait_s = batch_adaptive_wait_s
        self.batch_max_rows = batch_max_rows
        self.batch_lanes = batch_lanes
        self.batch_queue_depth = batch_queue_depth
        self.reload_grace_s = reload_grace_s
        self.device = device
        # Guarded-rollout knobs: a NEW active version replacing a serving
        # incumbent loads in SHADOW first — scored on mirrored live
        # traffic while decisions stay with the incumbent — and promotes
        # only after ``canary_batches`` clean batches; a guard trip or a
        # latency blow-out rolls it back and quarantines the version at
        # the manager. ``canary_probe_grace_s`` (default: one reload
        # interval) is how long a shadow waits for live traffic before
        # deterministic synthetic probe batches drive the decision — an
        # idle sidecar must still converge.
        self.shadow_mode = shadow_mode
        self.canary_batches = canary_batches
        self.canary_latency_budget_s = canary_latency_budget_s
        self.canary_probe_grace_s = (
            canary_probe_grace_s if canary_probe_grace_s is not None
            else reload_interval)
        self.serving_stats = (serving_stats if serving_stats is not None
                              else SERVING_STATS)
        self._models: Dict[str, _LoadedModel] = {}
        self._shadows: Dict[str, dict] = {}
        # Versions this process has SERVED (or promoted): a rollback
        # restoring one re-installs directly — it was already proven,
        # and shadow-delaying recovery would extend the incident.
        self._known_good: set = set()
        # (name → version) of artifact loads that failed: the watcher
        # skips a memoized-bad version until the active version changes
        # instead of re-downloading + re-failing it every poll.
        self._failed_versions: Dict[str, str] = {}
        # Quarantine reports that failed to reach the manager; retried
        # each watcher tick (the memoized skip means there is no other
        # re-detection path on this process).
        self._pending_quarantines: list = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._watcher: Optional[threading.Thread] = None
        self._grace_timers: list = []
        # HealthService (rpc/health.py) of the hosting server:
        # NOT_SERVING while any hot-reload grace window is open, so
        # health-aware clients drain to a replica instead of racing the
        # batcher swap.
        self._health = None
        self._grace_active = 0

    # -- model management --------------------------------------------------

    def install_scorer(self, name: str, scorer,
                       version: str = "local") -> None:
        """Install (or replace) the scorer served under ``name``."""
        batcher = None
        if self.micro_batch:
            batcher = MicroBatcher(
                scorer,
                max_rows=self.batch_max_rows,
                max_wait_s=self.batch_max_wait_s,
                adaptive_wait_s=self.batch_adaptive_wait_s,
                lanes=self.batch_lanes,
                queue_depth=self.batch_queue_depth,
            )
        with self._lock:
            old = self._models.get(name)
            self._models[name] = _LoadedModel(version, scorer, batcher)
            # A version that serves is (by definition) the rollback
            # target of whatever replaces it; installs also clear any
            # memoized load failure and supersede a pending shadow of a
            # DIFFERENT version (the registry moved on under it).
            self._known_good.add(version)
            self._failed_versions.pop(name, None)
            shadow = self._shadows.get(name)
            if shadow is not None and shadow["version"] != version:
                self._shadows.pop(name, None)
            # Prune fired (or cancelled) grace timers on every install:
            # a long-lived sidecar hot-reloads periodically, and keeping
            # every spent Timer until stop() grows the list unboundedly.
            self._grace_timers = [t for t in self._grace_timers
                                  if not t.finished.is_set()]
            if old is not None and old.batcher is not None:
                # Grace-close: a ModelInfer thread may have grabbed the
                # old model just before the swap; keep its batcher
                # serving until any such in-flight request has
                # comfortably finished, like the pre-batcher code kept
                # serving on the old scorer. The timer is daemonized and
                # tracked so shutdown neither waits out the grace nor
                # leaks it. While ANY grace window is open the health
                # service reports NOT_SERVING (drain signal for
                # health-aware clients); SERVING returns when the last
                # window closes.
                self._grace_active += 1
                if self._health is not None:
                    self._health.set_status("", NOT_SERVING)
                timer = threading.Timer(self.reload_grace_s,
                                        self._end_grace, args=(old.batcher,))
                timer.daemon = True
                self._grace_timers.append(timer)
                timer.start()

    def set_health(self, health) -> None:
        """Bind the hosting server's HealthService so hot-reload grace
        windows surface as NOT_SERVING."""
        self._health = health

    def _end_grace(self, batcher) -> None:
        try:
            batcher.close()
        finally:
            with self._lock:
                self._grace_active = max(self._grace_active - 1, 0)
                last = self._grace_active == 0
            if last and self._health is not None and not self._stop.is_set():
                self._health.set_status("", SERVING)

    def serving_version(self, name: str) -> Optional[str]:
        """Version currently TAKING DECISIONS for a model type (None
        when nothing is loaded). A shadow-loaded candidate is not it."""
        with self._lock:
            model = self._models.get(name)
        return model.version if model is not None else None

    def batcher_stats(self) -> Dict[str, dict]:
        """Per-model micro-batcher pipeline counters (coalesce factor,
        in-flight depth, stage/dispatch overlap, per-bucket hits) for
        operators chasing the serving path's latency budget."""
        with self._lock:
            models = dict(self._models)
        return {name: model.batcher.stats()
                for name, model in models.items()
                if model.batcher is not None}

    def reload_from_manager(self) -> bool:
        """Pull every servable model type whose active version changed.
        Returns True when any (re)load happened — direct install or a
        SHADOW install (the incumbent keeps taking decisions until the
        canary promotes). The steady-state poll is metadata-only:
        artifacts are fetched only after a version check, and a
        (type, version) whose artifact already failed to load is
        memoized and skipped until the active version moves on. Raises
        when the load device is the card and there is none: a missing
        card must not read as a bad artifact."""
        if self.manager is None:
            return False
        device = default_device(self.device)
        reloaded = False
        for name, builder in ((MODEL_NAME_MLP, _scorer_from_artifact),
                              (MODEL_NAME_GAT, _gat_scorer_from_artifact)):
            # Per-model isolation: one corrupt artifact must not block
            # the OTHER type's hot-reloads on every subsequent poll.
            try:
                version = self.manager.get_active_model_version(
                    name, self.scheduler_id
                )
                if version is None:
                    continue
                with self._lock:
                    current = self._models.get(name)
                    shadow = self._shadows.get(name)
                    if current is not None and current.version == version:
                        # Serving IS the active version; a shadow of a
                        # different version was superseded upstream (a
                        # rollback landed while it waited) — drop it.
                        if (shadow is not None
                                and shadow["version"] != version):
                            self._shadows.pop(name, None)
                        continue
                    if shadow is not None and shadow["version"] == version:
                        continue  # already canarying this version
                    if self._failed_versions.get(name) == version:
                        continue  # memoized known-bad artifact
                    current_version = (current.version if current is not None
                                       else None)
                active = self.manager.get_active_model(
                    name, self.scheduler_id)
                if active is None:
                    continue
                artifact = active.artifact
                plan = faultplan.ACTIVE
                if plan is not None:
                    rule = plan.check("model.artifact",
                                      context=f"{name}:{active.version}")
                    if rule is not None:
                        artifact = _fault_artifact(artifact, rule)
                try:
                    scorer = builder(artifact, device=device)
                except Exception as exc:  # noqa: BLE001 — a bad artifact
                    # is a memoized verdict, not a poll-cadence retry
                    # loop; a fault of the card is not the artifact's and
                    # is retried on the next poll.
                    if is_device_fault(exc):
                        raise
                    with self._lock:
                        self._failed_versions[name] = version
                    self.serving_stats.tick("model_reload_failures")
                    logger.exception(
                        "load of %s version %s failed; memoized — the "
                        "watcher will not retry until the active version "
                        "changes", name, version)
                    continue
                if (current is None or not self.shadow_mode
                        or version in self._known_good
                        or self._incumbent_quarantined(name,
                                                       current_version)):
                    # Direct install: first model of this type, shadowing
                    # disabled, a rollback restoring a version this
                    # process already proved, or a replace of an
                    # incumbent the manager has condemned (it must not be
                    # a shadow baseline).
                    self.install_scorer(name, scorer,
                                        version=active.version)
                    logger.info("inference sidecar loaded %s version %s",
                                name, active.version)
                else:
                    with self._lock:
                        self._shadows[name] = _new_shadow(
                            name, active.version, scorer)
                    logger.info(
                        "inference sidecar loaded %s version %s in SHADOW "
                        "mode (incumbent %s keeps serving until the "
                        "canary promotes)", name, active.version,
                        current_version)
                reloaded = True
            except Exception:  # noqa: BLE001 — keep serving + polling
                logger.exception("reload of %s model failed; keeping the "
                                 "previous version", name)
        return reloaded

    def _incumbent_quarantined(self, name: str,
                               version: Optional[str]) -> bool:
        """True when the manager has quarantined the version this
        process is serving — the incoming active version is then a
        ROLLBACK-REPLACE and must install directly (comparing a
        candidate against a condemned baseline proves nothing)."""
        if version is None:
            return False
        state_of = getattr(self.manager, "get_model_version_state", None)
        if state_of is None:
            return False
        try:
            return state_of(name, version, self.scheduler_id) == "quarantined"
        except Exception:  # noqa: BLE001 — unknown is "not quarantined"
            return False

    def serve_watcher(self) -> None:
        if self._watcher is not None and self._watcher.is_alive():
            if not self._stop.is_set():
                return  # already running
            # Stop was requested but the thread is still draining a slow
            # reload; wait it out before starting the replacement.
            self._watcher.join(timeout=5)
            if self._watcher.is_alive():
                logger.warning("previous model watcher still draining; "
                               "restart deferred")
                return
        self._stop.clear()  # allow restart after stop()
        self._watcher = threading.Thread(
            target=self._watch_loop, name="model-watcher", daemon=True
        )
        self._watcher.start()

    def stop(self) -> None:
        self._stop.set()
        if self._health is not None:
            self._health.set_status("", NOT_SERVING)
        for timer in self._grace_timers:
            # Close what the timer would have closed: a cancelled grace
            # window must not leave its batcher's lanes (and through them
            # the replaced scorer's device memory) alive. close() drains
            # and is idempotent, so a timer that already fired is fine.
            timer.cancel()
            timer.args[0].close()
        self._grace_timers.clear()
        with self._lock:
            self._grace_active = 0
            self._shadows.clear()
        stats = self.batcher_stats()
        if stats:
            # The operators' record of how the serving pipeline behaved
            # this run (coalesce factor, overlap, bucket hits).
            logger.info("inference micro-batch pipeline stats: %s", stats)
        with self._lock:
            models = list(self._models.values())
        for model in models:
            if model.batcher is not None:
                model.batcher.close()
        if self._watcher is not None:
            self._watcher.join(timeout=5)
            if not self._watcher.is_alive():
                self._watcher = None
            # A still-alive watcher (stuck reload) keeps its slot so a
            # restart cannot double it; it exits at the next loop check.

    def _watch_loop(self) -> None:
        while not self._stop.wait(self.reload_interval):
            try:
                self.retry_pending_quarantines()
            except Exception:
                logger.exception("pending quarantine retry failed")
            try:
                self.reload_from_manager()
            except Exception:
                logger.exception("model reload failed")
            try:
                self.process_shadows()
            except Exception:
                logger.exception("canary processing failed")

    # -- shadow / canary ---------------------------------------------------

    def shadow_stats(self) -> Dict[str, dict]:
        """Per-model shadow/canary progress (version, clean batches,
        rank agreement with the incumbent, latency) for operators
        watching a rollout."""
        with self._lock:
            shadows = dict(self._shadows)
            # Snapshot the per-shadow rings under the same lock the
            # canary appends under — a bare list() racing an append
            # raises "deque mutated during iteration".
            rings = {name: list(sh["agreements"])
                     for name, sh in shadows.items()}
        out = {}
        for name, sh in shadows.items():
            agreements = rings[name]
            out[name] = {
                "version": sh["version"],
                "clean_batches": sh["clean"],
                "needed_batches": self.canary_batches,
                "live_batches": sh["live_batches"],
                "probe_batches": sh["probe_batches"],
                "age_s": round(time.monotonic() - sh["installed_at"], 3),
                "agreement_mean": (
                    round(float(np.mean(agreements)), 4)
                    if agreements else None),
                "max_latency_s": round(sh["max_latency_s"], 4),
            }
        return out

    def process_shadows(self) -> None:
        """Drain mirrored live batches through every shadow and decide:
        promote after ``canary_batches`` clean batches; reject (and
        quarantine at the manager) on a guard trip or a latency blow-out.
        Deterministic synthetic probe batches top up the clean-batch
        budget once mirrored traffic alone hasn't decided by tick time —
        and, after ``canary_probe_grace_s`` with NO live traffic at all,
        drive the decision outright — so an idle or lightly-loaded
        sidecar still converges within ~one reload interval. Called
        from the watcher tick; callable directly by tests and benches."""
        with self._lock:
            shadows = list(self._shadows.items())
        for name, sh in shadows:
            decided = False
            while not decided:
                try:
                    inputs, incumbent_scores = sh["queue"].popleft()
                except IndexError:
                    break
                sh["live_batches"] += 1
                self.serving_stats.tick("shadow_batches")
                decided = self._canary_step(name, sh, inputs,
                                            incumbent_scores)
            if decided:
                continue
            # No (more) live traffic: after the grace window, probe.
            age = time.monotonic() - sh["installed_at"]
            if (sh["live_batches"] == 0
                    and age < self.canary_probe_grace_s):
                continue
            probes = _probe_batches(
                name, sh["scorer"],
                seed=zlib.crc32(sh["version"].encode()),
                batches=max(self.canary_batches - sh["clean"], 0))
            for batch in probes:
                sh["probe_batches"] += 1
                self.serving_stats.tick("shadow_probe_batches")
                if self._canary_step(name, sh, batch, None):
                    break

    def _canary_step(self, name: str, sh: dict, inputs,
                     incumbent_scores) -> bool:
        """Score one batch through the shadow and update the verdict.
        Returns True when the canary DECIDED (promoted or rejected)."""
        if name == MODEL_NAME_GAT and getattr(inputs, "ndim", 2) == 2 \
                and inputs.shape[1] != 2:
            return False  # feature probe against a pair scorer: skip
        t0 = time.perf_counter()
        try:
            scores = np.asarray(sh["scorer"].score(inputs))
        except Exception as exc:  # noqa: BLE001 — a scoring crash rejects
            if is_device_fault(exc):
                raise  # the card's fault: the shadow waits for a later tick
            self._reject_shadow(name, sh, f"scoring raised: {exc!r}")
            return True
        latency = time.perf_counter() - t0
        sh["max_latency_s"] = max(sh["max_latency_s"], latency)
        reason = guard_reason(scores, features=inputs)
        if reason is not None:
            self.serving_stats.tick("shadow_guard_trips")
            self._reject_shadow(name, sh, f"guard trip: {reason}")
            return True
        if latency > self.canary_latency_budget_s:
            self._reject_shadow(
                name, sh, f"latency {latency:.3f}s over the "
                f"{self.canary_latency_budget_s}s canary budget")
            return True
        if incumbent_scores is not None and len(scores) >= 3:
            from dragonfly2_tpu_torch.manager.validation import spearman

            agreement = spearman(scores, incumbent_scores)
            with self._lock:
                sh["agreements"].append(agreement)
        sh["clean"] += 1
        if sh["clean"] >= self.canary_batches:
            self._promote_shadow(name, sh)
            return True
        return False

    def _promote_shadow(self, name: str, sh: dict) -> None:
        with self._lock:
            if self._shadows.get(name) is not sh:
                return  # superseded while scoring
            self._shadows.pop(name, None)
        self.serving_stats.tick("canary_promotions")
        # Through install_scorer: batcher rebuild + incumbent grace-drain
        # + known-good registration, the same swap path a direct install
        # takes.
        self.install_scorer(name, sh["scorer"], version=sh["version"])
        logger.info(
            "canary PROMOTED %s version %s after %d clean batches "
            "(%d live / %d probe, agreement_mean=%s)",
            name, sh["version"], sh["clean"], sh["live_batches"],
            sh["probe_batches"],
            (round(float(np.mean(list(sh["agreements"]))), 4)
             if sh["agreements"] else None))

    def _reject_shadow(self, name: str, sh: dict, reason: str) -> None:
        with self._lock:
            if self._shadows.get(name) is not sh:
                return
            self._shadows.pop(name, None)
            # Memoize: the registry still lists this version active
            # until the quarantine lands — the next poll must not
            # re-shadow it.
            self._failed_versions[name] = sh["version"]
        self.serving_stats.tick("canary_rollbacks")
        logger.warning(
            "canary REJECTED %s version %s (%s) after %d clean batches; "
            "incumbent keeps serving", name, sh["version"], reason,
            sh["clean"])
        self._quarantine_to_manager(name, sh["version"], reason)

    def _quarantine_to_manager(self, name: str, version: str,
                               reason: str) -> None:
        """Report a condemned version back to the registry so the
        rollback is FLEET-wide, not just this process's. A failed
        report (transient manager outage) parks in a pending list the
        watcher retries every tick — the local memoization means this
        sidecar would otherwise never re-detect the version, and the
        registry would list the poison active forever."""
        quarantine = getattr(self.manager, "quarantine_version", None)
        if quarantine is None:
            return
        try:
            quarantine(name, version, self.scheduler_id, reason=reason)
        except Exception:  # noqa: BLE001 — the local rejection stands
            with self._lock:
                entry = (name, version, reason)
                if entry not in self._pending_quarantines:
                    self._pending_quarantines.append(entry)
            logger.exception(
                "quarantine of %s version %s at the manager failed; "
                "parked for retry on the next watcher tick", name,
                version)

    def retry_pending_quarantines(self) -> None:
        """Re-deliver parked quarantine reports (watcher tick)."""
        with self._lock:
            pending = list(self._pending_quarantines)
        for name, version, reason in pending:
            try:
                self.manager.quarantine_version(
                    name, version, self.scheduler_id, reason=reason)
            except Exception:  # noqa: BLE001 — keep it parked
                continue
            with self._lock:
                try:
                    self._pending_quarantines.remove(
                        (name, version, reason))
                except ValueError:
                    pass

    # -- the RPC surface --------------------------------------------------

    def ModelInfer(self, request: ModelInferRequest, context):  # noqa: N802
        plan = faultplan.ACTIVE
        if plan is not None:
            rule = plan.check("infer.model_infer",
                              context=request.model_name)
            if rule is not None:
                if rule.kind is faultplan.FaultKind.STALL:
                    time.sleep(rule.delay_s)
                elif rule.kind is faultplan.FaultKind.UNAVAILABLE:
                    context.abort(StatusCode.UNAVAILABLE,
                                  "injected UNAVAILABLE (fault plan)")
                elif rule.kind is faultplan.FaultKind.DEADLINE:
                    context.abort(StatusCode.DEADLINE_EXCEEDED,
                                  "injected DEADLINE_EXCEEDED (fault plan)")
        with self._lock:
            model = self._models.get(request.model_name)
        if model is None:
            context.abort(StatusCode.NOT_FOUND,
                          f"model {request.model_name!r} not loaded")
        inputs = request.inputs
        if inputs is None or np.asarray(inputs).size == 0:
            context.abort(StatusCode.INVALID_ARGUMENT, "empty inputs")
        if request.model_name == MODEL_NAME_GAT:
            # Pair scorer: [batch, 2] int host indexes, not feature rows.
            inputs = np.asarray(inputs)
            if inputs.ndim != 2 or inputs.shape[1] != 2:
                context.abort(
                    StatusCode.INVALID_ARGUMENT,
                    f"gat inputs must be [batch, 2] host-index pairs, "
                    f"got {inputs.shape}",
                )
            # Range-check BEFORE the int32 cast (an int64 index past
            # 2^31 would wrap back INTO range) and before enqueueing
            # (inside the micro-batcher a bad index's ValueError would
            # fan out to every coalesced request as an internal error).
            n_real = getattr(model.scorer, "n_real", None)
            if n_real is not None and (
                    (inputs < 0).any() or (inputs >= n_real).any()):
                context.abort(
                    StatusCode.INVALID_ARGUMENT,
                    f"host index out of range for the {n_real}-host "
                    "embedding table",
                )
            inputs = inputs.astype(np.int32)
        else:
            inputs = np.asarray(inputs, dtype=np.float32)
            if inputs.ndim != 2 or inputs.shape[1] != FEATURE_DIM:
                context.abort(
                    StatusCode.INVALID_ARGUMENT,
                    f"inputs must be [batch, {FEATURE_DIM}], "
                    f"got {inputs.shape}",
                )
        # Validate against the EFFECTIVE limit (the batcher's clamped
        # max_rows when micro-batching, the scorer's max_batch
        # otherwise): a request sized between batch_max_rows and
        # scorer.max_batch must fail INVALID_ARGUMENT here, not surface
        # as an internal ValueError from MicroBatcher.score.
        if inputs.shape[0] > model.max_rows:
            context.abort(
                StatusCode.INVALID_ARGUMENT,
                f"batch {inputs.shape[0]} exceeds max {model.max_rows}",
            )
        try:
            scores = model.score(inputs)
        except BatcherSaturatedError as exc:
            # Bounded admission shed: the assigned lane's queue is at
            # its depth cap. RESOURCE_EXHAUSTED tells the scheduler-side
            # evaluator to degrade to rule scoring for this decision
            # instead of queueing behind a saturated serving plane.
            context.abort(StatusCode.RESOURCE_EXHAUSTED, str(exc))
        with self._lock:
            shadow = self._shadows.get(request.model_name)
        if shadow is not None:
            # Mirror live traffic to the canary: copies, because the
            # decision is returned NOW and the shadow scores on the
            # watcher tick. The response stays the incumbent's.
            shadow["queue"].append(
                (np.asarray(inputs).copy(), np.asarray(scores).copy()))
        return ModelInferResponse(
            model_name=request.model_name, model_version=model.version,
            outputs=np.asarray(scores),
        )

    def ModelReady(self, request: ModelReadyRequest, context):  # noqa: N802
        with self._lock:
            model = self._models.get(request.name)
        return ModelReadyResponse(
            ready=model is not None,
            version=model.version if model else "",
        )

    def ServerLive(self, request, context):  # noqa: N802
        return ServerLiveResponse(live=True)

    def ServerReady(self, request, context):  # noqa: N802
        with self._lock:
            ready = bool(self._models)
        return ServerReadyResponse(ready=ready)


class InferenceClient:
    """Scheduler-side client (pkg/rpc/inference/client/client_v1.go:81-106
    surface over the port's wire)."""

    def __init__(self, target: str, timeout: float = 1.0):
        from dragonfly2_tpu_torch.rpc.client import ServiceClient

        self._client = ServiceClient(target, INFERENCE_SPEC)
        self.timeout = timeout

    def model_infer(self, model_name: str, inputs: np.ndarray) -> np.ndarray:
        return self.model_infer_full(model_name, inputs)[0]

    def model_infer_full(self, model_name: str,
                         inputs: np.ndarray) -> tuple:
        """(scores, serving model version) — the version is what a
        guard-trip escalation quarantines back to the manager."""
        resp = self._client.ModelInfer(
            ModelInferRequest(model_name=model_name, inputs=inputs),
            timeout=self.timeout,
        )
        return np.asarray(resp.outputs), resp.model_version

    def model_ready(self, name: str) -> bool:
        return bool(self._client.ModelReady(
            ModelReadyRequest(name=name), timeout=self.timeout).ready)

    def server_live(self) -> bool:
        return bool(self._client.ServerLive(
            ServerLiveRequest(), timeout=self.timeout).live)

    def server_ready(self) -> bool:
        return bool(self._client.ServerReady(
            ServerReadyRequest(), timeout=self.timeout).ready)

    def close(self) -> None:
        self._client.close()


class LocalInferenceClient:
    """:class:`InferenceClient`'s ``model_infer_full`` on an
    :class:`InferenceService` in this process, without the wire. An abort
    raises :class:`RpcAbort` where the wire raises :class:`RpcError`."""

    def __init__(self, service: InferenceService):
        self.service = service

    def model_infer_full(self, model_name: str,
                         inputs: np.ndarray) -> "tuple[np.ndarray, str]":
        """(scores, serving model version) — the version is what a
        guard-trip escalation must quarantine."""
        resp = self.service.ModelInfer(
            ModelInferRequest(model_name, inputs), CallContext())
        return np.asarray(resp.outputs), resp.model_version


class CircuitOpenError(RuntimeError):
    """Raised instead of a remote call while the breaker cools down."""


def _is_resource_exhausted(exc: Exception) -> bool:
    """True when a call ended with RESOURCE_EXHAUSTED (the service's
    bounded-admission shed status), over the wire or in process."""
    if isinstance(exc, RpcError):
        return exc.code() is StatusCode.RESOURCE_EXHAUSTED
    return (isinstance(exc, RpcAbort)
            and exc.code is StatusCode.RESOURCE_EXHAUSTED)


class _RemoteScorer:
    """Service-backed ``score()`` with an open-after-failure circuit
    breaker: while open, calls fail instantly (→ rule fallback) instead of
    eating the client retry/timeout ladder on every scheduling decision."""

    def __init__(self, client, model_name: str, cooldown: float = 5.0):
        self.client = client
        self.model_name = model_name
        self.cooldown = cooldown
        self._open_until = 0.0
        self._lock = threading.Lock()
        # The version the last successful score came from — what a
        # guard-trip escalation must quarantine.
        self.last_version = ""

    def score(self, features: np.ndarray) -> np.ndarray:
        with self._lock:
            if time.monotonic() < self._open_until:
                raise CircuitOpenError("inference service circuit open")
        try:
            scores, version = self.client.model_infer_full(
                self.model_name, np.asarray(features, dtype=np.float32))
        except Exception as exc:
            if _is_resource_exhausted(exc):
                # The service is alive but shedding (bounded admission):
                # surface it as the batcher's own saturation error so
                # MLEvaluator counts a shed and rule-falls-back, and do
                # NOT open the breaker — the next decision may land on a
                # lane with room.
                raise BatcherSaturatedError(
                    "inference service saturated (lane queue at depth "
                    "cap)") from exc
            with self._lock:
                self._open_until = time.monotonic() + self.cooldown
            raise
        with self._lock:
            self._open_until = 0.0
            if version:
                self.last_version = version
        return scores


class RemoteMLEvaluator(MLEvaluator):
    """The ``ml`` evaluator backed by an inference service — fills the
    reference's MLAlgorithm TODO (evaluator.go:48). Delegates ranking,
    fallback counting, guard trips, and loud first-failure logging to
    :class:`MLEvaluator`; the remote scorer adds transport, the circuit
    breaker, and serving-version tracking (``serving_version`` is what a
    guard-trip escalation quarantines back to the manager)."""

    def __init__(self, client, model_name: str = MODEL_NAME_MLP,
                 cooldown: float = 5.0, **guard_kwargs):
        super().__init__(_RemoteScorer(client, model_name, cooldown),
                         **guard_kwargs)
        self.client = client

    @property
    def serving_version(self) -> str:
        """Version of the model behind the last successful score."""
        return self._scorer.last_version

    @property
    def model_name(self) -> str:
        """Registry model type this evaluator scores with."""
        return self._scorer.model_name


def _new_shadow(name: str, version: str, scorer) -> dict:
    """Canary state for one shadow-loaded candidate version."""
    return {
        "name": name,
        "version": version,
        "scorer": scorer,
        "clean": 0,
        "live_batches": 0,
        "probe_batches": 0,
        # Mirrored (inputs, incumbent_scores) batches; bounded — the
        # canary needs a sample of traffic, not all of it.
        "queue": collections.deque(maxlen=4),
        # Spearman rank AGREEMENT with the incumbent per mirrored batch
        # (1.0 = ranks identically; -1.0 = inverts the ranking).
        "agreements": collections.deque(maxlen=64),
        "max_latency_s": 0.0,
        "installed_at": time.monotonic(),
    }


def _probe_batches(name: str, scorer, seed: int, batches: int) -> list:
    """Deterministic synthetic batches shaped for the model type —
    feature matrices for the MLP scorer, valid index pairs for the GAT
    pair scorer."""
    if batches <= 0:
        return []
    if name == MODEL_NAME_GAT:
        rng = np.random.default_rng(seed)
        n = max(int(getattr(scorer, "n_real", 2)), 2)
        return [rng.integers(0, n, size=(12, 2)).astype(np.int32)
                for _ in range(batches)]
    from dragonfly2_tpu_torch.manager.validation import synthetic_traces

    return synthetic_traces(seed=seed, batches=batches, rows=12)


def _fault_artifact(artifact: bytes, rule) -> bytes:
    """Apply a ``model.artifact`` FaultPlan rule to the fetched tar
    payload — the wire-level poisoning shapes (flipped header byte,
    truncated download) the load path must fail CLEANLY on (memoized
    skip, previous version keeps serving)."""
    if rule.kind is faultplan.FaultKind.CORRUPT and artifact:
        mutated = bytearray(artifact)
        mutated[0] ^= 0xFF
        mutated[len(mutated) // 2] ^= 0xFF
        return bytes(mutated)
    if rule.kind is faultplan.FaultKind.TRUNCATE:
        return artifact[: max(len(artifact) // 2, 1)]
    return artifact


def _maybe_poison_weights(params, context: str):
    """``model.weights`` fault site: poison a freshly loaded checkpoint's
    flax-layout params AT LOAD — CORRUPT fills the float leaves with NaN,
    SCALE zeroes them. The model stays loadable; only the guards can
    catch it."""
    plan = faultplan.ACTIVE
    if plan is None:
        return params
    rule = plan.check("model.weights", context=context)
    if rule is None:
        return params
    if rule.kind is faultplan.FaultKind.CORRUPT:
        return poison_params(params, "nan")
    if rule.kind is faultplan.FaultKind.SCALE:
        return poison_params(params, "zero")
    return params


def _mlp_checkpoint_from_artifact(artifact: bytes, poison_context: str,
                                  device=None):
    """The one load path of every MLP-layout checkpoint (the bandwidth
    scorer and the cost predictor share it) → ``(ParentScorer,
    target_norm)``, loaded and warmed up on ``device``."""
    tree, metadata = load_artifact(artifact)
    params, normalizer, target_norm = mlp_from_tree(tree)
    params = _maybe_poison_weights(params, poison_context)
    hidden = tuple(metadata.config.get("hidden", (128, 128, 64)))
    model = MLPBandwidthPredictor(hidden=hidden,
                                  in_features=len(normalizer.mean))
    model.load_state_dict(mlp_state_dict_from_flax(params))
    return ParentScorer(model, normalizer, target_norm,
                        device=device), target_norm


def _scorer_from_artifact(artifact: bytes, device=None) -> ParentScorer:
    """model.tar (MLP layout) → ParentScorer (load + warm-up)."""
    return _mlp_checkpoint_from_artifact(artifact, MODEL_NAME_MLP, device)[0]


def _cost_scorer_from_artifact(artifact: bytes, version: str = "",
                               device=None) -> CostScorer:
    """model.tar (type ``cost``) → CostScorer: the bandwidth MLP's
    checkpoint layout, wrapped so ``score`` ranks by NEGATED predicted
    cost and ``predict_cost_s`` feeds the learned bad-node threshold.
    The target normalizer's mean is the training corpus's typical
    log1p(cost): ``expm1`` of it is the absolute bad-node baseline."""
    scorer, target_norm = _mlp_checkpoint_from_artifact(
        artifact, MODEL_NAME_COST, device)
    typical = float(np.expm1(float(target_norm.mean[0])))
    return CostScorer(scorer, version=version,
                      typical_cost_s=max(typical, 0.0))


def _gat_scorer_from_artifact(artifact: bytes,
                              device=None) -> GATParentScorer:
    """model.tar (GraphTransformer layout) → GATParentScorer: one
    full-graph embedding pass at load, pair-gather scoring per request."""
    tree, metadata = load_artifact(artifact)
    (params, node_features, neighbors, neighbor_vals,
     node_ids) = gat_from_tree(tree)
    params = _maybe_poison_weights(params, MODEL_NAME_GAT)
    cfg = metadata.config
    model = GraphTransformer(
        in_features=int(node_features.shape[1]),
        hidden=int(cfg.get("hidden", 128)),
        embed=int(cfg.get("embed", 64)),
        layers=int(cfg.get("layers", 2)),
        heads=int(cfg.get("heads", 4)),
        attention=str(cfg.get("attention", "gather")),
        chunk=int(cfg.get("chunk", 1024)),
        dtype=torch.bfloat16,
        group=LOCAL,
    )
    model.load_state_dict(gat_state_dict_from_flax(params))
    return GATParentScorer(model, node_features, neighbors, neighbor_vals,
                           node_ids=node_ids, device=device)
