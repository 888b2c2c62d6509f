"""Training orchestration: dataset files → models on the card → the
manager's registry — port of ``dragonfly2_tpu/trainer/training.py``.

It fills the reference's stub (trainer/training/training.go:60-98): the
four steps it intended (load, preprocess, train, upload to the manager)
become CSV segments → numpy columns → feature arrays → the port's
trainers on ``device`` → a port artifact → ``create_model`` (the
manager's validation gate builds serving candidates on the card). The
jobs run back to back on the one device: GraphSAGE, the MLP, the opt-in
GraphTransformer and the cost model. One topology graph, built once a
cycle, feeds both graph jobs. A job's exception is recorded in
``TrainOutcome.errors`` and the others still run; the files trained from
are deleted at the end.

``group`` makes every job data-parallel over a ``torch.distributed``
process group, as ``mesh`` does in the reference: every rank runs
``train`` on the same dataset files and trains the same models. Rank 0
alone writes each artifact and calls ``create_model``; the other ranks
fill the same outcome and upload nothing. The reference runs its upload
in every process, but its orbax writer saves a replicated tree from the
primary process (process 0) only, so process 0's is its one complete
artifact; the port's npz writer has no such coordination, and N
uploads of one model id would put N versions through the gate.
"""

from __future__ import annotations

import logging
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Protocol

from dragonfly2_tpu_torch.data.features import (
    graph_from_table,
    pair_examples_from_table,
)
from dragonfly2_tpu_torch.parallel.mesh import DataParallel
from dragonfly2_tpu_torch.schema import Download, NetworkTopology
from dragonfly2_tpu_torch.schema.io import records_to_table
from dragonfly2_tpu_torch.train.checkpoint import (
    ModelMetadata,
    flax_from_gat_state_dict,
    flax_from_gnn_state_dict,
    gat_tree,
    gnn_tree,
    mlp_tree,
    save_model,
)
from dragonfly2_tpu_torch.train.cost_trainer import (
    MIN_COST_EXAMPLES,
    CostTrainConfig,
    cost_examples_from_corpus,
    cost_tree,
    train_cost,
)
from dragonfly2_tpu_torch.train.gat_trainer import GATTrainConfig, train_gat
from dragonfly2_tpu_torch.train.gnn_trainer import GNNTrainConfig, train_gnn
from dragonfly2_tpu_torch.train.mlp_trainer import MLPTrainConfig, train_mlp
from dragonfly2_tpu_torch.trainer.storage import TrainerStorage
from dragonfly2_tpu_torch.utils.idgen import (
    cost_model_id_v1,
    gat_model_id_v1,
    gnn_model_id_v1,
    mlp_model_id_v1,
)

logger = logging.getLogger(__name__)

MODEL_TYPE_GNN = "gnn"
MODEL_TYPE_MLP = "mlp"
MODEL_TYPE_GAT = "gat"
MODEL_TYPE_COST = "cost"


class ModelRegistry(Protocol):
    """The manager-facing upload hook (manager CreateModel gRPC,
    manager/rpcserver/manager_server_v2.go:816-914); the port's
    ``manager.service.ManagerService`` is one."""

    def create_model(
        self,
        model_id: str,
        model_type: str,
        host_id: str,
        ip: str,
        hostname: str,
        evaluation: dict,
        artifact_dir: str,
        scheduler_id: int = 0,
    ) -> None: ...


@dataclass
class TrainingConfig:
    gnn: GNNTrainConfig = field(default_factory=GNNTrainConfig)
    mlp: MLPTrainConfig = field(default_factory=MLPTrainConfig)
    # Config #3 (GraphTransformer) as an opt-in third job: the reference
    # trainer runs two (training.go trainGNN/trainMLP).
    gat: GATTrainConfig = field(default_factory=GATTrainConfig)
    train_gat_model: bool = False
    # The learned piece-cost predictor over replay decision segments,
    # trained whenever such segments arrive.
    cost: CostTrainConfig = field(default_factory=CostTrainConfig)
    # Minimum records before a model is trained at all (tiny datasets
    # make garbage models that would evict good ones in the registry).
    min_gnn_records: int = 8
    min_mlp_records: int = 8
    min_gat_records: int = 8
    min_cost_records: int = MIN_COST_EXAMPLES


@dataclass
class TrainOutcome:
    host_id: str
    gnn_model_id: Optional[str] = None
    mlp_model_id: Optional[str] = None
    gat_model_id: Optional[str] = None
    cost_model_id: Optional[str] = None
    gnn_evaluation: dict = field(default_factory=dict)
    mlp_evaluation: dict = field(default_factory=dict)
    gat_evaluation: dict = field(default_factory=dict)
    cost_evaluation: dict = field(default_factory=dict)
    errors: list = field(default_factory=list)


class Training:
    """``device=None`` trains on the card (the CPU only when asked);
    ``metrics`` is any object with the trainer metrics' two families,
    ``training_duration`` and ``train_samples_per_sec`` (``.labels(model=
    ...)`` then ``.observe`` / ``.set``), or None; ``group`` is the
    jobs' data-parallel process group (``parallel/mesh.py``; the module
    docstring says which rank registers)."""

    def __init__(
        self,
        storage: TrainerStorage,
        registry: Optional[ModelRegistry] = None,
        config: Optional[TrainingConfig] = None,
        device=None,
        metrics=None,
        group=None,
    ) -> None:
        self.storage = storage
        self.registry = registry
        self.config = config or TrainingConfig()
        self.device = device
        self.metrics = metrics
        self.group = group
        # One training job at a time: the device is not shared.
        self._train_lock = threading.Lock()

    def _observe_job(self, model: str, seconds: float,
                     samples_per_sec: float) -> None:
        if self.metrics:
            self.metrics.training_duration.labels(model=model).observe(seconds)
            self.metrics.train_samples_per_sec.labels(model=model).set(
                samples_per_sec)

    def train(self, ip: str, hostname: str, host_id: str,
              scheduler_id: int = 0) -> TrainOutcome:
        """training.go:60-78 — run every job, then delete exactly the
        dataset files that were trained from. A concurrent ingest
        stream's open segments are left out of the snapshot, so files
        being written are never read or deleted; they feed the next round.

        ``scheduler_id`` keys the registry upload: the manager's
        single-active rule is per (type, scheduler_id), so every cluster
        uploads under its own id (manager/models/model.go:44)."""
        outcome = TrainOutcome(host_id=host_id)
        with self._train_lock:
            (download_files, topology_files,
             replay_files) = self.storage.snapshot(host_id)
            # Both graph jobs train on the same topology snapshot: parse
            # the records and build the Graph once a cycle.
            n_topology, graph = 0, None
            try:
                records = self.storage.list_network_topology(
                    host_id, topology_files)
                n_topology = len(records)
                thresholds = [self.config.min_gnn_records]
                if self.config.train_gat_model:
                    thresholds.append(self.config.min_gat_records)
                if n_topology >= min(thresholds):
                    graph = graph_from_table(
                        records_to_table(NetworkTopology, records))
            except Exception as exc:  # noqa: BLE001 — job isolation
                logger.exception("topology parse failed for %s", host_id)
                outcome.errors.append(f"topology: {exc}")
            try:
                self._train_gnn(ip, hostname, host_id, scheduler_id,
                                n_topology, graph, outcome)
            except Exception as exc:  # noqa: BLE001 — job isolation
                logger.exception("trainGNN failed for %s", host_id)
                outcome.errors.append(f"gnn: {exc}")
            try:
                self._train_mlp(ip, hostname, host_id, scheduler_id,
                                download_files, outcome)
            except Exception as exc:  # noqa: BLE001
                logger.exception("trainMLP failed for %s", host_id)
                outcome.errors.append(f"mlp: {exc}")
            if self.config.train_gat_model:
                try:
                    self._train_gat(ip, hostname, host_id, scheduler_id,
                                    n_topology, graph, outcome)
                except Exception as exc:  # noqa: BLE001
                    logger.exception("trainGAT failed for %s", host_id)
                    outcome.errors.append(f"gat: {exc}")
            try:
                self._train_cost(ip, hostname, host_id, scheduler_id,
                                 replay_files, outcome)
            except Exception as exc:  # noqa: BLE001
                logger.exception("trainCost failed for %s", host_id)
                outcome.errors.append(f"cost: {exc}")
            self.storage.discard_files(
                download_files + topology_files + replay_files)
        return outcome

    # -- jobs -----------------------------------------------------------------

    def _train_gnn(self, ip, hostname, host_id, scheduler_id,
                   n_records, graph, outcome: TrainOutcome) -> None:
        if n_records < self.config.min_gnn_records:
            logger.info("skip GNN for %s: %d records < %d",
                        host_id, n_records, self.config.min_gnn_records)
            return
        if graph is None:
            # Enough records, but the shared topology parse failed: the
            # 'topology:' entry in outcome.errors carries the cause.
            logger.info("skip GNN for %s: topology graph unavailable",
                        host_id)
            return
        job_start = time.monotonic()
        result = train_gnn(graph, self.config.gnn, self.device,
                           group=self.group)
        self._observe_job("gnn", time.monotonic() - job_start,
                          result.samples_per_sec)
        evaluation = {
            "precision": result.precision,
            "recall": result.recall,
            "f1": result.f1,
            "n_samples": n_records,
        }
        model_id = gnn_model_id_v1(ip, hostname)
        self._register(
            model_id, MODEL_TYPE_GNN, host_id, ip, hostname, scheduler_id,
            evaluation,
            tree=gnn_tree(flax_from_gnn_state_dict(result.state_dict),
                          result.node_features),
            config={"hidden": result.config.hidden,
                    "embed": result.config.embed,
                    "fanouts": list(result.config.fanouts)},
        )
        outcome.gnn_model_id = model_id
        outcome.gnn_evaluation = evaluation

    def _train_gat(self, ip, hostname, host_id, scheduler_id,
                   n_records, graph, outcome: TrainOutcome) -> None:
        if n_records < self.config.min_gat_records:
            logger.info("skip GAT for %s: %d records < %d",
                        host_id, n_records, self.config.min_gat_records)
            return
        if graph is None:
            logger.info("skip GAT for %s: topology graph unavailable",
                        host_id)
            return
        job_start = time.monotonic()
        result = train_gat(graph, self.config.gat, self.device,
                           group=self.group)
        self._observe_job("gat", time.monotonic() - job_start,
                          result.samples_per_sec)
        evaluation = {
            "precision": result.precision,
            "recall": result.recall,
            "f1": result.f1,
            "n_samples": n_records,
        }
        model_id = gat_model_id_v1(ip, hostname)
        self._register(
            model_id, MODEL_TYPE_GAT, host_id, ip, hostname, scheduler_id,
            evaluation,
            tree=gat_tree(flax_from_gat_state_dict(result.state_dict),
                          result.node_features, result.neighbors,
                          result.neighbor_vals, node_ids=graph.node_ids),
            config={"hidden": result.config.hidden,
                    "embed": result.config.embed,
                    "layers": result.config.layers,
                    "heads": result.config.heads,
                    "attention": result.config.attention,
                    # chunk is structural for blocks and ring mode:
                    # serving rebuilds with the block size the padded
                    # row count was sized for.
                    "chunk": result.config.chunk},
        )
        outcome.gat_model_id = model_id
        outcome.gat_evaluation = evaluation

    def _train_mlp(self, ip, hostname, host_id, scheduler_id, files,
                   outcome: TrainOutcome) -> None:
        records = self.storage.list_download(host_id, files)
        if len(records) < self.config.min_mlp_records:
            logger.info("skip MLP for %s: %d records < %d",
                        host_id, len(records), self.config.min_mlp_records)
            return
        X, y = pair_examples_from_table(records_to_table(Download, records))
        if len(X) < self.config.min_mlp_records:
            logger.info("skip MLP for %s: %d pair examples", host_id, len(X))
            return
        job_start = time.monotonic()
        result = train_mlp(X, y, self.config.mlp, self.device,
                           group=self.group)
        self._observe_job("mlp", time.monotonic() - job_start,
                          result.samples_per_sec)
        evaluation = {"mse": result.mse, "mae": result.mae,
                      "n_samples": len(X)}
        model_id = mlp_model_id_v1(ip, hostname)
        self._register(
            model_id, MODEL_TYPE_MLP, host_id, ip, hostname, scheduler_id,
            evaluation,
            tree=mlp_tree(result.params, result.normalizer,
                          result.target_norm),
            config={"hidden": list(result.config.hidden)},
        )
        outcome.mlp_model_id = model_id
        outcome.mlp_evaluation = evaluation

    def _train_cost(self, ip, hostname, host_id, scheduler_id, files,
                    outcome: TrainOutcome) -> None:
        """Replay decision events → (features, realized cost) examples →
        the cost predictor, registered as type 'cost' (the manager's gate
        decides whether it ever serves)."""
        if not files:
            return
        records = self.storage.list_replay(host_id, files)
        X, y = cost_examples_from_corpus(records)
        if len(X) < self.config.min_cost_records:
            logger.info("skip cost model for %s: %d examples < %d",
                        host_id, len(X), self.config.min_cost_records)
            return
        job_start = time.monotonic()
        result = train_cost(X, y, self.config.cost, self.device,
                            group=self.group)
        self._observe_job("cost", time.monotonic() - job_start,
                          result.samples_per_sec)
        evaluation = {"mse": result.mse, "mae": result.mae,
                      "n_samples": len(X)}
        model_id = cost_model_id_v1(ip, hostname)
        self._register(
            model_id, MODEL_TYPE_COST, host_id, ip, hostname, scheduler_id,
            evaluation,
            tree=cost_tree(result),
            config={"hidden": list(result.config.hidden)},
        )
        outcome.cost_model_id = model_id
        outcome.cost_evaluation = evaluation

    def _register(self, model_id, model_type, host_id, ip, hostname,
                  scheduler_id, evaluation, tree, config) -> None:
        if DataParallel(self.group).rank != 0:
            return
        tmp = tempfile.mkdtemp(prefix=f"df2-model-{model_type}-")
        try:
            save_model(tmp, tree, ModelMetadata(
                model_id=model_id, model_type=model_type,
                evaluation=evaluation, config=config))
            if self.registry is not None:
                self.registry.create_model(
                    model_id=model_id,
                    model_type=model_type,
                    host_id=host_id,
                    ip=ip,
                    hostname=hostname,
                    evaluation=evaluation,
                    artifact_dir=tmp,
                    scheduler_id=scheduler_id,
                )
            else:
                logger.info("no registry configured; model %s trained only",
                            model_id)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
