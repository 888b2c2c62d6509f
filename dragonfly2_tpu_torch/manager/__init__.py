"""The manager's model registry: the sqlite database, the artifact
object store, the validation gate and the registry service."""

from dragonfly2_tpu_torch.manager.database import Database
from dragonfly2_tpu_torch.manager.objectstore import (
    FilesystemObjectStore,
    ObjectStore,
)
from dragonfly2_tpu_torch.manager.service import ManagerService

__all__ = [
    "Database",
    "FilesystemObjectStore",
    "ManagerService",
    "ObjectStore",
]
