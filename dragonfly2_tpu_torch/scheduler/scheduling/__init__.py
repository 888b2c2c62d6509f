"""Scheduling core (reference: scheduler/scheduling/scheduling.go)."""

from dragonfly2_tpu_torch.scheduler.scheduling.core import (
    SchedulingConfig,
    Scheduling,
    ScheduleError,
)

__all__ = ["Scheduling", "SchedulingConfig", "ScheduleError"]
