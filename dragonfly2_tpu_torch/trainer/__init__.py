"""The trainer: per-host dataset segments, the training orchestrator
that turns them into registered models on the card, the ingest service
that the scheduler's announcer streams its datasets to, and the
crash-safe federated round coordinator — port of
``dragonfly2_tpu/trainer`` without its gRPC transport."""

from dragonfly2_tpu_torch.trainer.federation import (
    FederationConfig,
    FederationCoordinator,
    FederationQuorumError,
    LocalClusterEndpoint,
    RoundReport,
    endpoints_from_storage,
)
from dragonfly2_tpu_torch.trainer.service import (
    TrainCostRequest,
    TrainerService,
    TrainGnnRequest,
    TrainMlpRequest,
    TrainRequest,
    TrainResponse,
)
from dragonfly2_tpu_torch.trainer.storage import TrainerStorage
from dragonfly2_tpu_torch.trainer.training import (
    ModelRegistry,
    Training,
    TrainingConfig,
    TrainOutcome,
)

__all__ = [
    "FederationConfig",
    "FederationCoordinator",
    "FederationQuorumError",
    "LocalClusterEndpoint",
    "ModelRegistry",
    "RoundReport",
    "TrainCostRequest",
    "TrainerService",
    "TrainerStorage",
    "TrainGnnRequest",
    "Training",
    "TrainingConfig",
    "TrainMlpRequest",
    "TrainOutcome",
    "TrainRequest",
    "TrainResponse",
    "endpoints_from_storage",
]
