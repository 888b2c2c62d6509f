"""Probe store + topology snapshotting (reference: scheduler/networktopology/)."""

from dragonfly2_tpu_torch.scheduler.networktopology.antientropy import ReplicaSyncer
from dragonfly2_tpu_torch.scheduler.networktopology.store import (
    NetworkTopologyConfig,
    NetworkTopologyStore,
    Probe,
)

__all__ = ["NetworkTopologyConfig", "NetworkTopologyStore", "Probe",
           "ReplicaSyncer"]
