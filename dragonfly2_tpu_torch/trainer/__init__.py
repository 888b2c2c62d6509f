"""The trainer: per-host dataset segments and the training orchestrator
that turns them into registered models on the card — port of
``dragonfly2_tpu/trainer`` without its gRPC ingest service."""

from dragonfly2_tpu_torch.trainer.storage import TrainerStorage
from dragonfly2_tpu_torch.trainer.training import (
    ModelRegistry,
    Training,
    TrainingConfig,
    TrainOutcome,
)

__all__ = [
    "ModelRegistry",
    "TrainerStorage",
    "Training",
    "TrainingConfig",
    "TrainOutcome",
]
