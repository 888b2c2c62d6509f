"""Manager service — port of ``dragonfly2_tpu/manager/service.py``
(upstream: manager_server_v2.go CreateModel :816,
manager/service/model.go:109-190 single-active-version activation).

A trained artifact dir is tarred into the object store under
``<model>/<version>/model.tar``; with no validation gate the new version
becomes the single active one of its (type, scheduler) pair. With a gate
(:class:`~dragonfly2_tpu_torch.manager.validation.ValidationConfig`) it
ingests as CANDIDATE, the gate builds it on ``device`` (the card unless
the caller asks for the CPU) and replays announce traces through it, and
only a passing report promotes it; a failing one quarantines it.
Quarantine is terminal and restores the previous good version in the
same transaction — the fleet-wide rollback the inference service's
watcher picks up on its next poll.

The cluster half (upstream: UpdateScheduler :290, UpdateSeedPeer :180,
ListSchedulers :500, KeepAlive :968) is JAX's: scheduler and seed-peer
cluster CRUD, instance upserts, keepalive with its expiry sweep, the
searcher's dynconfig answer behind a read-through cache, and
applications, with JAX's ``metrics`` hooks (a ``ManagerMetrics`` or
None: keepalives, searcher calls and ingested models). The artifact's
unpacking is
``train.checkpoint.untar_to_directory``, reached through
:func:`untar_to_directory` here. The module loads no torch: the
manager's own process (``cmd/manager.py``) builds nothing on a device.
"""

from __future__ import annotations

import io
import json
import logging
import os
import tarfile
import time
import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional

from dragonfly2_tpu_torch.manager import validation as validation_mod
from dragonfly2_tpu_torch.manager.cache import ReadThroughCache
from dragonfly2_tpu_torch.manager.database import (
    STATE_ACTIVE,
    STATE_CANDIDATE,
    STATE_INACTIVE,
    STATE_QUARANTINED,
    Database,
    Row,
)
from dragonfly2_tpu_torch.manager.objectstore import ObjectStore
from dragonfly2_tpu_torch.manager.searcher import Searcher
from dragonfly2_tpu_torch.utils.servingstats import SERVING

__all__ = ["ActiveModel", "DEFAULT_KEEPALIVE_TTL", "ManagerError",
           "ManagerService", "untar_to_directory"]

logger = logging.getLogger(__name__)

MODELS_BUCKET = "models"
MODEL_FILE_NAME = "model.tar"          # types/model.go:25 model.graphdef
MODEL_CONFIG_FILE_NAME = "config.json"  # types/model.go:28 config.pbtxt
DEFAULT_SERVING_PLATFORM = "pytorch_cuda"

DEFAULT_KEEPALIVE_TTL = 60.0


class ManagerError(Exception):
    pass


def make_model_file_key(model_name: str, version: str) -> str:
    """(types/model.go:66-69 MakeObjectKeyOfModelFile)"""
    return f"{model_name}/{version}/{MODEL_FILE_NAME}"


def make_model_config_key(model_name: str) -> str:
    """(types/model.go:71-73 MakeObjectKeyOfModelConfigFile)"""
    return f"{model_name}/{MODEL_CONFIG_FILE_NAME}"


@dataclass
class ActiveModel:
    name: str
    type: str
    version: str
    evaluation: Dict
    scheduler_id: int
    artifact: bytes  # model.tar payload


class ManagerService:
    """The scheduler-cluster control plane (clusters, instances,
    keepalive, dynconfig answers, applications) and the model registry
    (ingest, gate, promote, quarantine, roll back, and the active-version
    answers the inference service polls)."""

    def __init__(self, database: Database, object_store: ObjectStore,
                 keepalive_ttl: float = DEFAULT_KEEPALIVE_TTL, metrics=None,
                 cache_ttl: float = 5.0, validation=None,
                 serving_stats=None, device=None):
        self.db = database
        self.store = object_store
        self.searcher = Searcher()
        self.keepalive_ttl = keepalive_ttl
        self.metrics = metrics  # ManagerMetrics or None
        # None keeps the reference's direct-activate behaviour
        # (model.go:109-150) for deployments without a serving path to
        # protect.
        self.validation = validation
        self.serving_stats = (serving_stats if serving_stats is not None
                              else SERVING)
        # Where the gate builds candidates; None means the card.
        self.device = device
        # Read-through cache for fleet-polled dynconfig answers
        # (manager/cache two-tier role; single tier — sqlite is local).
        self.cache = ReadThroughCache(ttl=cache_ttl)
        self.store.create_bucket(MODELS_BUCKET)

    # ------------------------------------------------------------------
    # Cluster CRUD (manager/service/scheduler_cluster.go, seed_peer_cluster)
    # ------------------------------------------------------------------

    def create_scheduler_cluster(self, name: str, *, config: Dict | None = None,
                                 client_config: Dict | None = None,
                                 scopes: Dict | None = None,
                                 is_default: bool = False) -> Row:
        cluster_id = self.db.insert(
            "scheduler_clusters", name=name, config=config or {},
            client_config=client_config or {}, scopes=scopes or {},
            is_default=int(is_default),
        )
        return self.db.get("scheduler_clusters", cluster_id)

    def create_seed_peer_cluster(self, name: str,
                                 config: Dict | None = None) -> Row:
        cluster_id = self.db.insert(
            "seed_peer_clusters", name=name, config=config or {}
        )
        return self.db.get("seed_peer_clusters", cluster_id)

    def list_scheduler_clusters(self) -> List[Row]:
        return self.db.find("scheduler_clusters")

    # ------------------------------------------------------------------
    # Instance registration (UpdateScheduler/UpdateSeedPeer upserts)
    # ------------------------------------------------------------------

    def update_scheduler(self, *, hostname: str, ip: str, port: int,
                         scheduler_cluster_id: int,
                         features: List[str] | None = None) -> Row:
        existing = self.db.find_one(
            "schedulers", hostname=hostname, ip=ip,
            scheduler_cluster_id=scheduler_cluster_id,
        )
        if existing is not None:
            self.db.update("schedulers", existing.id, port=port,
                           features=features or [])
            # Invalidate AFTER the write: before it, a concurrent reader
            # could re-cache the pre-write rows for a full TTL.
            self.cache.invalidate_prefix("list_schedulers")
            return self.db.get("schedulers", existing.id)
        row_id = self.db.insert(
            "schedulers", hostname=hostname, ip=ip, port=port,
            scheduler_cluster_id=scheduler_cluster_id,
            features=features or [], state=STATE_INACTIVE,
        )
        self.cache.invalidate_prefix("list_schedulers")
        return self.db.get("schedulers", row_id)

    def update_seed_peer(self, *, hostname: str, ip: str, port: int,
                         download_port: int, seed_peer_cluster_id: int,
                         type: str = "super", idc: str = "",
                         location: str = "") -> Row:
        existing = self.db.find_one(
            "seed_peers", hostname=hostname, ip=ip,
            seed_peer_cluster_id=seed_peer_cluster_id,
        )
        if existing is not None:
            self.db.update("seed_peers", existing.id, port=port,
                           download_port=download_port, type=type,
                           idc=idc, location=location)
            return self.db.get("seed_peers", existing.id)
        row_id = self.db.insert(
            "seed_peers", hostname=hostname, ip=ip, port=port,
            download_port=download_port, type=type, idc=idc,
            location=location, seed_peer_cluster_id=seed_peer_cluster_id,
            state=STATE_INACTIVE,
        )
        return self.db.get("seed_peers", row_id)

    # ------------------------------------------------------------------
    # Keepalive (manager_server_v2.go:968-1050)
    # ------------------------------------------------------------------

    def keepalive(self, *, source_type: str, hostname: str, ip: str,
                  cluster_id: int) -> None:
        """Mark the instance active and stamp the keepalive time; the
        expiry sweep flips instances inactive after ``keepalive_ttl``."""
        table = "schedulers" if source_type == "scheduler" else "seed_peers"
        cluster_col = ("scheduler_cluster_id" if table == "schedulers"
                       else "seed_peer_cluster_id")
        row = self.db.find_one(
            table, hostname=hostname, ip=ip, **{cluster_col: cluster_id}
        )
        if row is None:
            raise ManagerError(f"{source_type} {hostname}/{ip} not registered")
        if self.metrics:
            self.metrics.keepalive_count.inc()
        self.db.update(table, row.id, state=STATE_ACTIVE,
                       last_keepalive=time.time())
        # Invalidate AFTER the write and only on a state flip —
        # steady-state keepalives would otherwise defeat the cache.
        if row.state != STATE_ACTIVE:
            self.cache.invalidate_prefix("list_schedulers")

    def sweep_keepalive(self) -> int:
        """Expire silent instances (the stream-drop path of KeepAlive)."""
        cutoff = time.time() - self.keepalive_ttl
        flipped = 0
        for table in ("schedulers", "seed_peers"):
            for row in self.db.query(
                f"SELECT * FROM {table} WHERE state=? AND last_keepalive<?",
                [STATE_ACTIVE, cutoff],
            ):
                self.db.update(table, row.id, state=STATE_INACTIVE)
                flipped += 1
        if flipped:
            self.cache.invalidate_prefix("list_schedulers")
        return flipped

    # ------------------------------------------------------------------
    # Dynconfig answers (ListSchedulers :500 / ListApplications / configs)
    # ------------------------------------------------------------------

    def list_schedulers(self, *, ip: str = "", hostname: str = "",
                        conditions: Dict[str, str] | None = None) -> List[Row]:
        """Active schedulers of the best-matching cluster for this daemon —
        the searcher path of ListSchedulers (manager_server_v2.go:500-560).
        Cached a few seconds: every daemon polls this on its dynconfig
        ticker."""
        key = f"list_schedulers:{ip}|{hostname}|{sorted((conditions or {}).items())}"
        return self.cache.get(
            key, lambda: self._list_schedulers(
                ip=ip, hostname=hostname, conditions=conditions))

    def _list_schedulers(self, *, ip: str, hostname: str,
                         conditions: Dict[str, str] | None) -> List[Row]:
        clusters = self.db.find("scheduler_clusters")
        counts = {
            r.scheduler_cluster_id: r.n
            for r in self.db.query(
                "SELECT scheduler_cluster_id, COUNT(*) AS n FROM schedulers "
                "WHERE state=? GROUP BY scheduler_cluster_id",
                [STATE_ACTIVE],
            )
        }
        if self.metrics:
            self.metrics.search_scheduler_cluster_count.inc()
        ranked = self.searcher.find_scheduler_clusters(
            clusters, ip, hostname, conditions,
            has_active_schedulers=lambda c: counts.get(c.id, 0) > 0,
        )
        if not ranked:
            return []
        return self.db.query(
            "SELECT * FROM schedulers WHERE scheduler_cluster_id=? AND state=?",
            [ranked[0].id, STATE_ACTIVE],
        )

    def list_seed_peers(self, seed_peer_cluster_id: int | None = None) -> List[Row]:
        if seed_peer_cluster_id is None:
            return self.db.query(
                "SELECT * FROM seed_peers WHERE state=?", [STATE_ACTIVE]
            )
        return self.db.query(
            "SELECT * FROM seed_peers WHERE seed_peer_cluster_id=? AND state=?",
            [seed_peer_cluster_id, STATE_ACTIVE],
        )

    def get_scheduler_cluster_config(self, cluster_id: int) -> Dict:
        cluster = self.db.get("scheduler_clusters", cluster_id)
        if cluster is None:
            raise ManagerError(f"scheduler cluster {cluster_id} not found")
        return dict(cluster.config or {})

    # ------------------------------------------------------------------
    # Applications (priority config used by schedulers)
    # ------------------------------------------------------------------

    def create_application(self, name: str, *, url: str = "", bio: str = "",
                           priorities: Dict | None = None) -> Row:
        row_id = self.db.insert("applications", name=name, url=url, bio=bio,
                                priorities=priorities or {})
        return self.db.get("applications", row_id)

    def list_applications(self) -> List[Row]:
        return self.db.find("applications")

    # ------------------------------------------------------------------
    # Model registry (manager_server_v2.go:816-965 CreateModel;
    # manager/service/model.go:109-190 activation invariant)
    # ------------------------------------------------------------------

    def create_model(self, model_id: str, model_type: str, host_id: str,
                     ip: str, hostname: str, evaluation: Dict,
                     artifact_dir: str, scheduler_id: int = 0,
                     skip_validation: bool = False, traces=None) -> Row:
        """trainer.ModelRegistry protocol: ingest a trained model.

        The artifact dir is tarred into the object store under the
        versioned key. With no validation gate configured (or
        ``skip_validation``) the new version becomes the single active
        one for its (type, scheduler) pair atomically — the reference's
        direct-activate behavior. With a gate, the version ingests as
        CANDIDATE, the gate replays announce traces against it
        (``traces`` overrides the recorded/synthetic lookup), and only a
        passing report promotes it; a failing one quarantines it so it
        can never activate. Either way the returned row carries the
        final state — callers check ``row.state``.
        """
        version = uuid.uuid4().hex[:12]
        artifact = _tar_directory(artifact_dir)
        file_key = make_model_file_key(model_id, version)
        self.store.put_object(MODELS_BUCKET, file_key, artifact)
        # Per-model serving config — the reference writes a Triton
        # config.pbtxt pinning the served version (model.go:153-190
        # updateModelConfig); ours pins it for the inference service.
        self.store.put_object(
            MODELS_BUCKET, make_model_config_key(model_id),
            json.dumps({
                "name": model_id,
                "platform": DEFAULT_SERVING_PLATFORM,
                "version_policy": {"specific": {"versions": [version]}},
            }).encode(),
        )
        gate = None if skip_validation else self.validation
        ingest_state = STATE_ACTIVE if gate is None else STATE_CANDIDATE
        with self.db.transaction() as txn:
            if gate is None:
                # Single-active is per (type, scheduler) — NOT per model
                # name: model ids are host-derived (idgen
                # gnn/mlp_model_id_v1), so filtering by name would leave
                # one active model per host. Only ACTIVE rows flip —
                # candidate/quarantined rows keep their lifecycle state.
                txn.execute(
                    "UPDATE models SET state=?, updated_at=? "
                    "WHERE type=? AND scheduler_id=? AND state=?",
                    [STATE_INACTIVE, time.time(), model_type, scheduler_id,
                     STATE_ACTIVE],
                )
            now = time.time()
            cur = txn.execute(
                "INSERT INTO models (name, type, bio, version, state, "
                "evaluation, scheduler_id, object_key, created_at, updated_at) "
                "VALUES (?,?,?,?,?,?,?,?,?,?)",
                [model_id, model_type, f"{hostname}/{ip}/{host_id}", version,
                 ingest_state, json.dumps(evaluation), scheduler_id,
                 file_key, now, now],
            )
            row_id = int(cur.lastrowid)
        if self.metrics:
            self.metrics.model_created_count.labels(type=model_type).inc()
        if gate is None:
            logger.info("model %s type=%s version=%s activated",
                        model_id, model_type, version)
            return self.db.get("models", row_id)
        report = self.validate_model_row(row_id, traces=traces)
        if report.passed:
            self.promote_model(row_id)
            self.serving_stats.tick("models_promoted")
            logger.info("model %s type=%s version=%s passed validation "
                        "and was promoted", model_id, model_type, version)
        else:
            self._set_row_state(row_id, STATE_QUARANTINED)
            self.serving_stats.tick("model_validation_rejections")
            self.serving_stats.tick("model_quarantines")
            logger.warning(
                "model %s type=%s version=%s REJECTED by the validation "
                "gate and quarantined: %s", model_id, model_type, version,
                "; ".join(report.reasons))
        return self.db.get("models", row_id)

    def validate_model_row(self, row_id: int, traces=None):
        """Run the offline validation gate against a registered version;
        the report is also persisted into the row's ``evaluation`` JSON
        under ``"validation"`` so operators can read WHY a version was
        (not) promoted from the ordinary model listing."""
        row = self.db.get("models", row_id)
        if row is None:
            raise ManagerError(f"model row {row_id} not found")
        config = self.validation or validation_mod.ValidationConfig()
        if traces is None:
            traces = self.load_announce_traces(row.scheduler_id)
        artifact = self.store.get_object(MODELS_BUCKET, row.object_key)
        report = validation_mod.validate_artifact(
            row.type, artifact, traces, config, device=self.device)
        evaluation = dict(row.evaluation or {})
        evaluation["validation"] = report.to_dict()
        self.db.update("models", row_id, evaluation=evaluation)
        return report

    def promote_model(self, row_id: int) -> Row:
        """Atomically make a version THE active one for its (type,
        scheduler) pair. Quarantined versions never re-activate."""
        row = self.db.get("models", row_id)
        if row is None:
            raise ManagerError(f"model row {row_id} not found")
        if row.state == STATE_QUARANTINED:
            raise ManagerError(
                f"model {row.name} version {row.version} is quarantined "
                "and can never re-activate")
        with self.db.transaction() as txn:
            txn.execute(
                "UPDATE models SET state=?, updated_at=? "
                "WHERE type=? AND scheduler_id=? AND state=?",
                [STATE_INACTIVE, time.time(), row.type, row.scheduler_id,
                 STATE_ACTIVE],
            )
            txn.execute(
                "UPDATE models SET state=?, updated_at=? WHERE id=?",
                [STATE_ACTIVE, time.time(), row_id],
            )
        return self.db.get("models", row_id)

    def quarantine_version(self, model_type: str, version: str,
                           scheduler_id: int = 0,
                           reason: str = "") -> Optional[Row]:
        """Mark a version quarantined (terminal); if it was the active
        one, atomically restore the previous good version — the
        fleet-wide rollback the sidecar watcher picks up on its next
        poll. Idempotent: several sidecars reporting the same bad
        version quarantine it once. Returns the RESTORED row (None when
        nothing was restorable or the version was not active)."""
        restored = None
        with self.db.transaction() as txn:
            # State is read INSIDE the transaction: two sidecars
            # quarantining the same version concurrently must not both
            # observe "active" and each restore a different predecessor
            # (that would leave two active rows).
            cur = txn.execute(
                "SELECT id, state FROM models WHERE type=? AND version=? "
                "AND scheduler_id=?",
                [model_type, version, scheduler_id],
            )
            row = cur.fetchone()
            if row is None:
                raise ManagerError(
                    f"model type={model_type} version={version} "
                    f"scheduler_id={scheduler_id} not found")
            if row["state"] == STATE_QUARANTINED:
                return None
            was_active = row["state"] == STATE_ACTIVE
            txn.execute(
                "UPDATE models SET state=?, updated_at=? WHERE id=?",
                [STATE_QUARANTINED, time.time(), row["id"]],
            )
            if was_active:
                restored = self._restore_previous_locked(
                    txn, model_type, scheduler_id)
        self.serving_stats.tick("model_quarantines")
        if restored is not None:
            # Only an ACTUAL restore counts as a rollback — quarantining
            # the only-ever version leaves evaluators on rules, which
            # the counter contract must not report as a rollback.
            self.serving_stats.tick("model_rollbacks")
        logger.warning(
            "model version %s (type=%s scheduler=%s) quarantined%s%s",
            version, model_type, scheduler_id,
            f": {reason}" if reason else "",
            (f"; rolled back to version {restored.version}"
             if restored is not None else
             ("; NO previous version to restore — evaluators degrade "
              "to rules" if was_active else "")))
        return restored

    def rollback(self, model_type: str, scheduler_id: int = 0,
                 reason: str = "") -> Optional[Row]:
        """Operator/runtime rollback: quarantine the ACTIVE version of
        (type, scheduler) and restore the previous good one atomically.
        Returns the restored row, or None when there is no active
        version or nothing restorable (evaluators then rule-fall-back —
        the deactivate-all contract)."""
        active = self.db.find_one("models", type=model_type,
                                  scheduler_id=scheduler_id,
                                  state=STATE_ACTIVE)
        if active is None:
            return None
        return self.quarantine_version(model_type, active.version,
                                       scheduler_id, reason=reason)

    def _restore_previous_locked(self, txn, model_type: str,
                                 scheduler_id: int) -> Optional[Row]:
        """Inside a transaction: re-activate the most recently
        deactivated non-quarantined version. Candidates never restore
        (they were never proven) and quarantined rows never return."""
        cur = txn.execute(
            "SELECT id, version FROM models WHERE type=? AND scheduler_id=? "
            "AND state=? ORDER BY updated_at DESC, id DESC LIMIT 1",
            [model_type, scheduler_id, STATE_INACTIVE],
        )
        prev = cur.fetchone()
        if prev is None:
            return None
        txn.execute(
            "UPDATE models SET state=?, updated_at=? WHERE id=?",
            [STATE_ACTIVE, time.time(), prev["id"]],
        )
        return Row({"id": prev["id"], "version": prev["version"]})

    def get_model_version_state(self, model_type: str, version: str,
                                scheduler_id: int = 0) -> Optional[str]:
        """Lifecycle state of one version (the sidecar asks this to tell
        a rollback-replace from an ordinary upgrade: a quarantined
        incumbent must never be a shadow baseline)."""
        row = self.db.find_one("models", type=model_type, version=version,
                               scheduler_id=scheduler_id)
        return row.state if row is not None else None

    def _set_row_state(self, row_id: int, state: str) -> None:
        self.db.update("models", row_id, state=state)

    # -- announce traces (validation-gate replay corpus) -------------------

    def record_announce_traces(self, scheduler_id: int,
                               payload: bytes) -> None:
        """Store a serialized TraceLog (validation.TraceLog.to_bytes)
        for one scheduler — the real-traffic corpus the gate replays
        against future candidates of that scheduler."""
        self.store.put_object(
            MODELS_BUCKET, f"traces/{scheduler_id}.npz", payload)

    def load_announce_traces(self, scheduler_id: int):
        """Recorded trace batches for a scheduler, or None (gate falls
        back to synthetic traces)."""
        try:
            payload = self.store.get_object(
                MODELS_BUCKET, f"traces/{scheduler_id}.npz")
        except Exception:  # noqa: BLE001 — any miss means "none recorded"
            return None
        try:
            return validation_mod.TraceLog.from_bytes(payload).batches()
        except Exception:  # noqa: BLE001 — a corrupt corpus must not
            logger.exception("recorded announce traces for scheduler %s "
                             "unreadable; gate falls back to synthetic",
                             scheduler_id)
            return None

    def list_models(self, scheduler_id: int | None = None) -> List[Row]:
        if scheduler_id is None:
            return self.db.find("models")
        return self.db.find("models", scheduler_id=scheduler_id)

    def get_active_model_version(self, model_type: str,
                                 scheduler_id: int = 0) -> Optional[str]:
        """Metadata-only poll target for the sidecar's reload watcher —
        no artifact fetch."""
        row = self.db.find_one("models", type=model_type,
                               scheduler_id=scheduler_id, state=STATE_ACTIVE)
        return row.version if row is not None else None

    def get_active_model(self, model_type: str,
                         scheduler_id: int = 0) -> Optional[ActiveModel]:
        """What the inference sidecar loads (the Triton-bucket handoff)."""
        row = self.db.find_one("models", type=model_type,
                               scheduler_id=scheduler_id, state=STATE_ACTIVE)
        if row is None:
            return None
        return ActiveModel(
            name=row.name, type=row.type, version=row.version,
            evaluation=row.evaluation or {}, scheduler_id=row.scheduler_id,
            artifact=self.store.get_object(MODELS_BUCKET, row.object_key),
        )

    def set_model_state(self, row_id: int, state: str) -> None:
        """REST UpdateModel (handlers/model.go): manual (de)activation,
        preserving the single-active invariant. Quarantined rows are
        terminal — manual re-activation of a version the gate or the
        runtime guards condemned is exactly the operator error the
        lifecycle exists to prevent."""
        row = self.db.get("models", row_id)
        if row is None:
            raise ManagerError(f"model row {row_id} not found")
        if row.state == STATE_QUARANTINED:
            # Terminal means terminal: even quarantined→inactive is
            # refused — allowing it would launder the row back into the
            # restorable set (freshest updated_at makes it the NEXT
            # rollback target) and re-open the manual-activation door.
            raise ManagerError(
                f"model {row.name} version {row.version} is quarantined "
                "and can never change state")
        if state == STATE_ACTIVE and row.state == STATE_CANDIDATE:
            # A candidate (possibly stranded by a gate exception) has
            # never been validated — manual activation would bypass the
            # gate entirely; re-run it via validate_model_row/promote.
            raise ManagerError(
                f"model {row.name} version {row.version} is an "
                "unvalidated candidate; only the validation gate "
                "promotes candidates")
        with self.db.transaction() as txn:
            if state == STATE_ACTIVE:
                # Only ACTIVE rows demote — a candidate mid-validation or
                # a quarantined version must keep its lifecycle state.
                txn.execute(
                    "UPDATE models SET state=? WHERE type=? AND "
                    "scheduler_id=? AND state=?",
                    [STATE_INACTIVE, row.type, row.scheduler_id,
                     STATE_ACTIVE],
                )
            txn.execute(
                "UPDATE models SET state=?, updated_at=? WHERE id=?",
                [state, time.time(), row_id],
            )



def untar_to_directory(artifact: bytes, directory: str) -> None:
    """Unpack a model.tar payload (sidecar side):
    ``train.checkpoint.untar_to_directory``, imported on use."""
    from dragonfly2_tpu_torch.train import checkpoint

    checkpoint.untar_to_directory(artifact, directory)


def _tar_directory(directory: str) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        for name in sorted(os.listdir(directory)):
            tar.add(os.path.join(directory, name), arcname=name)
    return buf.getvalue()
