"""Manager service — port of the model-registry half of
``dragonfly2_tpu/manager/service.py`` (upstream: manager_server_v2.go
CreateModel :816, manager/service/model.go:109-190 single-active-version
activation).

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

The cluster, keepalive and application methods, the read-through cache
and the metrics wait for the manager's cluster half. The artifact's
unpacking is ``train.checkpoint.untar_to_directory``, re-exported here.
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
from dragonfly2_tpu_torch.manager.database import (
    STATE_ACTIVE,
    STATE_CANDIDATE,
    STATE_INACTIVE,
    STATE_QUARANTINED,
    Database,
    Row,
)
from dragonfly2_tpu_torch.manager.objectstore import ObjectStore
from dragonfly2_tpu_torch.train.checkpoint import untar_to_directory
from dragonfly2_tpu_torch.utils.servingstats import SERVING

__all__ = ["ActiveModel", "ManagerError", "ManagerService",
           "untar_to_directory"]

logger = logging.getLogger(__name__)

MODELS_BUCKET = "models"
MODEL_FILE_NAME = "model.tar"          # types/model.go:25 model.graphdef
MODEL_CONFIG_FILE_NAME = "config.json"  # types/model.go:28 config.pbtxt
DEFAULT_SERVING_PLATFORM = "pytorch_cuda"


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
    """The model registry: ingest, gate, promote, quarantine, roll back,
    and the active-version answers the inference service polls."""

    def __init__(self, database: Database, object_store: ObjectStore,
                 validation=None, serving_stats=None, device=None):
        self.db = database
        self.store = object_store
        # None keeps the reference's direct-activate behaviour
        # (model.go:109-150) for deployments without a serving path to
        # protect.
        self.validation = validation
        self.serving_stats = (serving_stats if serving_stats is not None
                              else SERVING)
        # Where the gate builds candidates; None means the card.
        self.device = device
        self.store.create_bucket(MODELS_BUCKET)

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



def _tar_directory(directory: str) -> bytes:
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        for name in sorted(os.listdir(directory)):
            tar.add(os.path.join(directory, name), arcname=name)
    return buf.getvalue()
