"""Dataset sink (reference: scheduler/storage/)."""

from dragonfly2_tpu_torch.scheduler.storage.storage import Storage, StorageConfig

__all__ = ["Storage", "StorageConfig"]
