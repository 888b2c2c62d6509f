"""Object-storage gateway: S3-ish HTTP API on the daemon, P2P-accelerated.

Reference counterpart: client/daemon/objectstorage (routes
``GET/PUT/DELETE/HEAD /buckets/:id/objects/*key``, objectstorage.go:187-199)
— GETs download through the peer mesh (so N nodes fetching one object hit
the backend once), PUTs write through to backend object storage. The
backend here is any :class:`~dragonfly2_tpu_torch.manager.objectstore.ObjectStore`;
for the filesystem backend the P2P back-source URL is the object's
``file://`` path, for cloud backends it is the signed object URL — either
way the peer engine treats it as an ordinary source.
"""

from __future__ import annotations

import logging
import pathlib
import urllib.parse
from http.server import BaseHTTPRequestHandler

from dragonfly2_tpu_torch.manager.objectstore import (
    FilesystemObjectStore,
    ObjectStore,
    ObjectStoreError,
)
from dragonfly2_tpu_torch.utils.httpserver import ThreadedHTTPService

logger = logging.getLogger(__name__)


class ObjectStorageGateway(ThreadedHTTPService):
    def __init__(self, daemon, backend: ObjectStore,
                 host: str = "127.0.0.1", port: int = 0):
        self.daemon = daemon
        self.backend = backend
        gateway = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                logger.debug("objectstorage: " + fmt, *args)

            def do_GET(self):  # noqa: N802
                gateway._dispatch(self)

            do_PUT = do_GET
            do_DELETE = do_GET
            do_HEAD = do_GET

        super().__init__(Handler, host=host, port=port,
                         name="objectstorage-gw")

    # -- routing -----------------------------------------------------------

    @staticmethod
    def _parse(path: str):
        # /buckets/<bucket>/objects/<key...>
        parts = urllib.parse.urlparse(path).path.split("/", 4)
        if len(parts) < 5 or parts[1] != "buckets" or parts[3] != "objects":
            return None
        return parts[2], urllib.parse.unquote(parts[4])

    def _dispatch(self, req: BaseHTTPRequestHandler) -> None:
        parsed = self._parse(req.path)
        if parsed is None:
            req.send_error(404, "expected /buckets/{bucket}/objects/{key}")
            return
        bucket, key = parsed
        try:
            if req.command in ("GET", "HEAD"):
                self._get(req, bucket, key)
            elif req.command == "PUT":
                self._put(req, bucket, key)
            elif req.command == "DELETE":
                self._delete(req, bucket, key)
        except ObjectStoreError as exc:
            req.send_error(404, str(exc))
        except Exception as exc:
            logger.exception("objectstorage %s failed", req.command)
            req.send_error(500, str(exc))

    def _source_url(self, bucket: str, key: str) -> str:
        if isinstance(self.backend, FilesystemObjectStore):
            path = self.backend._object_path(bucket, key)
            return pathlib.Path(path).as_uri()
        raise ObjectStoreError(
            "backend does not expose back-source URLs")

    def _version_tag(self, bucket: str, key: str) -> str:
        """Task identity must change when the object changes: the task id
        folds in a cheap backend version stamp (mtime+size), so an
        overwritten object is a NEW task mesh-wide — no daemon or scheduler
        holds stale bytes for it."""
        import os

        if isinstance(self.backend, FilesystemObjectStore):
            st = os.stat(self.backend._object_path(bucket, key))
            return f"v{st.st_mtime_ns}-{st.st_size}"
        return ""

    def _get(self, req, bucket: str, key: str) -> None:
        if not self.backend.is_object_exist(bucket, key):
            req.send_error(404, f"{bucket}/{key} not found")
            return
        if req.command == "HEAD":
            # Metadata answer from the backend — existence checks must not
            # pull the object through the mesh.
            req.send_response(200)
            req.send_header("Content-Length",
                            str(self.backend.object_size(bucket, key)))
            req.end_headers()
            return
        # P2P path: the object's source URL becomes a task; every other
        # daemon fetching the same object rides the mesh.
        result = self.daemon.download_file(
            self._source_url(bucket, key),
            tag=self._version_tag(bucket, key))
        if not result.success:
            req.send_error(500, result.error)
            return
        length = (len(result.direct_bytes) if result.direct_bytes is not None
                  else result.storage.meta.content_length)
        req.send_response(200)
        req.send_header("Content-Length", str(max(length, 0)))
        req.end_headers()
        if req.command == "HEAD":
            return
        if result.direct_bytes is not None:
            req.wfile.write(result.direct_bytes)
        else:
            for chunk in result.storage.iter_content():
                req.wfile.write(chunk)

    def _put(self, req, bucket: str, key: str) -> None:
        # Server-side copy (dfstore.go CopyObject): a PUT naming a source
        # key moves bytes inside the backend without a client round trip.
        copy_source = req.headers.get("X-Df2-Copy-Source", "")
        length = int(req.headers.get("Content-Length", 0))
        if copy_source:
            # Drain any body regardless — leaving it unread desyncs the
            # keep-alive connection for the next request.
            if length:
                req.rfile.read(length)
            data = self.backend.get_object(bucket,
                                           urllib.parse.unquote(copy_source))
        else:
            data = req.rfile.read(length)
        self.backend.create_bucket(bucket)
        self.backend.put_object(bucket, key, data)
        req.send_response(200)
        req.send_header("Content-Length", "0")
        req.end_headers()

    def _delete(self, req, bucket: str, key: str) -> None:
        self.backend.delete_object(bucket, key)
        req.send_response(204)
        req.send_header("Content-Length", "0")
        req.end_headers()


class DfstoreClient:
    """S3-style client for the gateway
    (client/dfstore/dfstore.go:121-809, trimmed to the core verbs)."""

    def __init__(self, endpoint: str, timeout: float = 60.0):
        self.endpoint = endpoint.rstrip("/")
        self.timeout = timeout

    def _url(self, bucket: str, key: str) -> str:
        return (f"{self.endpoint}/buckets/{bucket}/objects/"
                f"{urllib.parse.quote(key)}")

    def put_object(self, bucket: str, key: str, data: bytes) -> None:
        import urllib.request

        req = urllib.request.Request(
            self._url(bucket, key), data=data, method="PUT")
        urllib.request.urlopen(req, timeout=self.timeout).close()

    def get_object(self, bucket: str, key: str) -> bytes:
        import urllib.request

        with urllib.request.urlopen(
                self._url(bucket, key), timeout=self.timeout) as resp:
            return resp.read()

    def is_object_exist(self, bucket: str, key: str) -> bool:
        import urllib.error
        import urllib.request

        req = urllib.request.Request(self._url(bucket, key), method="HEAD")
        try:
            urllib.request.urlopen(req, timeout=self.timeout).close()
            return True
        except urllib.error.HTTPError as exc:
            if exc.code == 404:
                return False
            raise

    def copy_object(self, bucket: str, src_key: str, dst_key: str) -> None:
        """Server-side copy (dfstore.go CopyObject)."""
        import urllib.request

        req = urllib.request.Request(
            self._url(bucket, dst_key), data=b"", method="PUT",
            headers={"X-Df2-Copy-Source": urllib.parse.quote(src_key)})
        urllib.request.urlopen(req, timeout=self.timeout).close()

    def delete_object(self, bucket: str, key: str) -> None:
        import urllib.error
        import urllib.request

        req = urllib.request.Request(self._url(bucket, key), method="DELETE")
        try:
            urllib.request.urlopen(req, timeout=self.timeout).close()
        except urllib.error.HTTPError as exc:
            if exc.code != 404:
                raise

    def copy_object(self, bucket: str, src_key: str, dst_key: str) -> None:
        self.put_object(bucket, dst_key, self.get_object(bucket, src_key))
