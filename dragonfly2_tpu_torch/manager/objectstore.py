"""Object storage for model artifacts — port of ``ObjectStore`` and
``FilesystemObjectStore`` from ``dragonfly2_tpu/manager/objectstore.py``
(upstream: pkg/objectstorage), trimmed to the operations the model
registry uses. The S3, OSS and OBS backends are not ported.
"""

from __future__ import annotations

import os


class ObjectStoreError(Exception):
    pass


class ObjectStore:
    """The operations the model registry uses (pkg/objectstorage
    ObjectStorage interface, trimmed)."""

    def create_bucket(self, bucket: str) -> None:
        raise NotImplementedError

    def put_object(self, bucket: str, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get_object(self, bucket: str, key: str) -> bytes:
        raise NotImplementedError


class FilesystemObjectStore(ObjectStore):
    """Bucket = directory, object = file; keys may contain '/'."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _bucket_dir(self, bucket: str) -> str:
        if not bucket or "/" in bucket or bucket in (".", ".."):
            raise ObjectStoreError(f"invalid bucket name {bucket!r}")
        return os.path.join(self.root, bucket)

    def _object_path(self, bucket: str, key: str) -> str:
        path = os.path.normpath(os.path.join(self._bucket_dir(bucket), key))
        if not path.startswith(self._bucket_dir(bucket) + os.sep):
            raise ObjectStoreError(f"key {key!r} escapes bucket")
        return path

    def create_bucket(self, bucket: str) -> None:
        os.makedirs(self._bucket_dir(bucket), exist_ok=True)

    def put_object(self, bucket: str, key: str, data: bytes) -> None:
        path = self._object_path(bucket, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def get_object(self, bucket: str, key: str) -> bytes:
        try:
            with open(self._object_path(bucket, key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise ObjectStoreError(f"{bucket}/{key} not found") from None
