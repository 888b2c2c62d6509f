"""Object storage for model artifacts and preheat payloads.

Reference counterpart: pkg/objectstorage (S3/OSS/OBS behind one interface,
objectstorage.go:215 factory). The filesystem backend is the hermetic
default; :class:`S3ObjectStore` (pkg/objectstorage/s3.go:304) speaks
SigV4-signed S3 REST to AWS or S3-compatibles (MinIO);
:class:`OSSObjectStore` (oss.go) and :class:`OBSObjectStore` (obs.go)
speak the same REST verb set behind the providers' HMAC-SHA1 header
signatures (``utils/hmacsig.py``) with v1-style list pagination.
:func:`new_object_store` is the objectstorage.go:215 name→backend factory.
"""

from __future__ import annotations

import os
import shutil
from typing import Iterator, List, Optional


class ObjectStoreError(Exception):
    pass


class ObjectStore:
    """(pkg/objectstorage/objectstorage.go ObjectStorage interface, trimmed
    to the operations the manager uses)."""

    def create_bucket(self, bucket: str) -> None:
        raise NotImplementedError

    def is_bucket_exist(self, bucket: str) -> bool:
        raise NotImplementedError

    def put_object(self, bucket: str, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get_object(self, bucket: str, key: str) -> bytes:
        raise NotImplementedError

    def is_object_exist(self, bucket: str, key: str) -> bool:
        raise NotImplementedError

    def object_size(self, bucket: str, key: str) -> int:
        raise NotImplementedError

    def delete_object(self, bucket: str, key: str) -> None:
        raise NotImplementedError

    def list_objects(self, bucket: str, prefix: str = "") -> List[str]:
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

    def is_bucket_exist(self, bucket: str) -> bool:
        return os.path.isdir(self._bucket_dir(bucket))

    def delete_bucket(self, bucket: str) -> None:
        shutil.rmtree(self._bucket_dir(bucket), ignore_errors=True)

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

    def is_object_exist(self, bucket: str, key: str) -> bool:
        return os.path.isfile(self._object_path(bucket, key))

    def object_size(self, bucket: str, key: str) -> int:
        try:
            return os.path.getsize(self._object_path(bucket, key))
        except OSError:
            raise ObjectStoreError(f"{bucket}/{key} not found") from None

    def delete_object(self, bucket: str, key: str) -> None:
        try:
            os.remove(self._object_path(bucket, key))
        except FileNotFoundError:
            pass

    def list_objects(self, bucket: str, prefix: str = "") -> List[str]:
        bucket_dir = self._bucket_dir(bucket)
        if not os.path.isdir(bucket_dir):
            return []
        out = []
        for dirpath, _, filenames in os.walk(bucket_dir):
            for name in filenames:
                key = os.path.relpath(os.path.join(dirpath, name), bucket_dir)
                key = key.replace(os.sep, "/")
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)


class S3ObjectStore(ObjectStore):
    """S3 REST backend (pkg/objectstorage/s3.go:304) — SigV4-signed
    stdlib HTTP, path-style against ``endpoint_url`` (MinIO/Ceph) or
    virtual-hosted AWS when no endpoint is set."""

    provider = "s3"

    def __init__(self, access_key: str = "", secret_key: str = "",
                 region: str = "us-east-1", endpoint_url: str = "",
                 timeout: float = 30.0):
        self.access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID", "")
        self.secret_key = secret_key or os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        self.region = region
        self.endpoint_url = (endpoint_url
                             or os.environ.get("AWS_ENDPOINT_URL", ""))
        self.timeout = timeout

    def _url(self, bucket: str, key: str = "", query: str = "") -> str:
        import urllib.parse

        if self.endpoint_url:
            base = f"{self.endpoint_url.rstrip('/')}/{bucket}"
        else:
            base = f"https://{bucket}.s3.{self.region}.amazonaws.com"
        url = base + ("/" + urllib.parse.quote(key) if key else "/")
        return url + (("?" + query) if query else "")

    def _sign_headers(self, method: str, url: str, bucket: str, key: str,
                      data: bytes) -> dict:
        import hashlib

        from dragonfly2_tpu_torch.utils.awssig import EMPTY_SHA256, sign_request

        payload_hash = (hashlib.sha256(data).hexdigest() if data
                        else EMPTY_SHA256)
        return sign_request(method, url, region=self.region,
                            access_key=self.access_key,
                            secret_key=self.secret_key,
                            payload_hash=payload_hash)

    def _call(self, method: str, bucket: str, key: str = "",
              query: str = "", data: bytes = b"",
              ok: tuple = (200,), tolerate: tuple = ()):
        import urllib.error
        import urllib.request

        url = self._url(bucket, key, query)
        headers = self._sign_headers(method, url, bucket, key, data)
        req = urllib.request.Request(url, data=data or None, headers=headers,
                                     method=method)
        try:
            resp = urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.HTTPError as exc:
            if exc.code in tolerate:
                return exc
            raise ObjectStoreError(
                f"{self.provider} {method} {bucket}/{key}: HTTP {exc.code}") from exc
        except urllib.error.URLError as exc:
            raise ObjectStoreError(
                f"{self.provider} {method} {bucket}/{key}: {exc.reason}") from exc
        if resp.status not in ok:
            raise ObjectStoreError(
                f"{self.provider} {method} {bucket}/{key}: HTTP {resp.status}")
        return resp

    def create_bucket(self, bucket: str) -> None:
        # 409 BucketAlreadyOwnedByYou is the idempotent-create answer.
        self._call("PUT", bucket, ok=(200,), tolerate=(409,))

    def is_bucket_exist(self, bucket: str) -> bool:
        try:
            self._call("HEAD", bucket)
            return True
        except ObjectStoreError:
            return False

    def put_object(self, bucket: str, key: str, data: bytes) -> None:
        self._call("PUT", bucket, key, data=data)

    def get_object(self, bucket: str, key: str) -> bytes:
        resp = self._call("GET", bucket, key)
        try:
            return resp.read()
        finally:
            resp.close()

    def is_object_exist(self, bucket: str, key: str) -> bool:
        try:
            self._call("HEAD", bucket, key)
            return True
        except ObjectStoreError:
            return False

    def object_size(self, bucket: str, key: str) -> int:
        resp = self._call("HEAD", bucket, key)
        try:
            return int(resp.headers.get("Content-Length", -1))
        finally:
            resp.close()

    def delete_object(self, bucket: str, key: str) -> None:
        self._call("DELETE", bucket, key, ok=(200, 204), tolerate=(404,))

    def list_objects(self, bucket: str, prefix: str = "") -> List[str]:
        import urllib.parse
        import xml.etree.ElementTree as ET

        keys: List[str] = []
        token = ""
        while True:
            query = "list-type=2"
            if prefix:
                query += "&prefix=" + urllib.parse.quote(prefix, safe="")
            if token:
                query += ("&continuation-token="
                          + urllib.parse.quote(token, safe=""))
            resp = self._call("GET", bucket, query=query)
            root = ET.fromstring(resp.read())
            ns = root.tag.partition("}")[0] + "}" if "}" in root.tag else ""
            keys.extend(e.text for e in root.iter(f"{ns}Key"))
            truncated = root.findtext(f"{ns}IsTruncated") == "true"
            token = root.findtext(f"{ns}NextContinuationToken") or ""
            if not truncated or not token:
                return sorted(keys)


class OSSObjectStore(S3ObjectStore):
    """Aliyun OSS backend (pkg/objectstorage/oss.go) — same REST verbs,
    ``OSS <ak>:<sig>`` HMAC-SHA1 header auth, v1 list pagination
    (prefix/marker/NextMarker). ``endpoint_url`` (path-style) targets
    fakes/self-hosted gateways; the default is the region's
    virtual-hosted endpoint."""

    provider = "oss"
    _auth_word = "OSS"
    _meta_prefix = "x-oss-"

    def __init__(self, access_key: str = "", secret_key: str = "",
                 region: str = "oss-cn-hangzhou", endpoint_url: str = "",
                 timeout: float = 30.0):
        super().__init__(access_key=access_key, secret_key=secret_key,
                         region=region, endpoint_url=endpoint_url,
                         timeout=timeout)
        self.access_key = access_key or os.environ.get("OSS_ACCESS_KEY_ID", "")
        self.secret_key = (secret_key
                           or os.environ.get("OSS_ACCESS_KEY_SECRET", ""))
        # Never inherit the S3 path's AWS_ENDPOINT_URL fallback — an
        # OSS-signed request against a MinIO endpoint set for s3 would
        # fail confusingly (or hit the wrong store).
        self.endpoint_url = (endpoint_url
                             or os.environ.get("OSS_ENDPOINT_URL", ""))

    def _url(self, bucket: str, key: str = "", query: str = "") -> str:
        import urllib.parse

        if self.endpoint_url:
            base = f"{self.endpoint_url.rstrip('/')}/{bucket}"
        else:
            base = f"https://{bucket}.{self.region}.aliyuncs.com"
        url = base + ("/" + urllib.parse.quote(key) if key else "/")
        return url + (("?" + query) if query else "")

    def _sign_headers(self, method: str, url: str, bucket: str, key: str,
                      data: bytes) -> dict:
        from dragonfly2_tpu_torch.utils.hmacsig import sign_header_auth

        # The signature covers Content-Type, so pin it explicitly —
        # urllib would otherwise inject its form-encoded default on
        # bodied requests and break verification server-side.
        headers = {"Content-Type": "application/octet-stream"} if data else {}
        signed, _ = sign_header_auth(
            method, bucket, key, headers,
            access_key=self.access_key, secret_key=self.secret_key,
            auth_word=self._auth_word, meta_prefix=self._meta_prefix)
        return signed

    def list_objects(self, bucket: str, prefix: str = "") -> List[str]:
        import urllib.parse
        import xml.etree.ElementTree as ET

        keys: List[str] = []
        marker = ""
        while True:
            parts = []
            if prefix:
                parts.append("prefix=" + urllib.parse.quote(prefix, safe=""))
            if marker:
                parts.append("marker=" + urllib.parse.quote(marker, safe=""))
            resp = self._call("GET", bucket, query="&".join(parts))
            root = ET.fromstring(resp.read())
            ns = root.tag.partition("}")[0] + "}" if "}" in root.tag else ""
            page = [e.text for e in root.iter(f"{ns}Key")]
            keys.extend(page)
            truncated = root.findtext(f"{ns}IsTruncated") == "true"
            if not truncated:
                return sorted(keys)
            # Providers only guarantee NextMarker when a delimiter is set;
            # without it, continue from the last key of this page rather
            # than silently returning a partial listing.
            next_marker = root.findtext(f"{ns}NextMarker") or (
                page[-1] if page else "")
            if not next_marker or next_marker <= marker:
                # Empty page, or a server that ignores the marker param
                # and re-serves the same page — fail loudly rather than
                # loop forever or return partial keys.
                raise ObjectStoreError(
                    f"{bucket}: truncated listing did not advance past "
                    f"marker {marker!r} — refusing to return partial keys")
            marker = next_marker


class OBSObjectStore(OSSObjectStore):
    """Huawei OBS backend (pkg/objectstorage/obs.go) — the OSS wire shape
    with ``OBS <ak>:<sig>`` auth and ``x-obs-`` metadata headers."""

    provider = "obs"
    _auth_word = "OBS"
    _meta_prefix = "x-obs-"

    def __init__(self, access_key: str = "", secret_key: str = "",
                 region: str = "cn-north-1", endpoint_url: str = "",
                 timeout: float = 30.0):
        super().__init__(access_key=access_key, secret_key=secret_key,
                         region=region, endpoint_url=endpoint_url,
                         timeout=timeout)
        self.access_key = access_key or os.environ.get("OBS_ACCESS_KEY_ID", "")
        self.secret_key = (secret_key
                           or os.environ.get("OBS_SECRET_ACCESS_KEY", ""))
        self.endpoint_url = (endpoint_url
                             or os.environ.get("OBS_ENDPOINT_URL", ""))

    def _url(self, bucket: str, key: str = "", query: str = "") -> str:
        import urllib.parse

        if self.endpoint_url:
            base = f"{self.endpoint_url.rstrip('/')}/{bucket}"
        else:
            base = f"https://{bucket}.obs.{self.region}.myhuaweicloud.com"
        url = base + ("/" + urllib.parse.quote(key) if key else "/")
        return url + (("?" + query) if query else "")


def new_object_store(name: str, **kwargs) -> ObjectStore:
    """objectstorage.go:215 New(): backend name → client. Names: ``fs``
    (hermetic default), ``s3``, ``oss``, ``obs``."""
    backends = {"fs": FilesystemObjectStore, "s3": S3ObjectStore,
                "oss": OSSObjectStore, "obs": OBSObjectStore}
    cls = backends.get(name)
    if cls is None:
        raise ObjectStoreError(f"unknown object storage name {name!r}")
    return cls(**kwargs)
