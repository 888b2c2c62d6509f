"""The manager: the scheduler-cluster control plane (clusters, instances,
keepalive, the searcher's dynconfig answers), the model registry with
its validation gate, the sqlite database and the artifact object store.
The REST surface is ``manager.rest``, its client ``manager.client``."""

from dragonfly2_tpu_torch.manager.database import Database
from dragonfly2_tpu_torch.manager.objectstore import (
    FilesystemObjectStore,
    ObjectStore,
)
from dragonfly2_tpu_torch.manager.searcher import Scopes, Searcher
from dragonfly2_tpu_torch.manager.service import ManagerService

__all__ = [
    "Database",
    "FilesystemObjectStore",
    "ManagerService",
    "ObjectStore",
    "Scopes",
    "Searcher",
]
