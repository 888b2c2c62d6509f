"""Shared base for signed object-store source clients (s3://, oss://).

Both providers expose the same REST surface for the ResourceClient
operations — ranged GET, HEAD metadata, ETag/Last-Modified expiry,
prefix listing — and differ only in URL layout and request signing.
Subclasses supply ``_http_url``, ``_signed_headers``, ``_make_store``
(for listing), and ``scheme``; everything else lives here once, so a
fix to e.g. the Range/206 check or expiry semantics lands in every
provider at once.

Reference counterpart: pkg/source/clients/{s3protocol,ossprotocol} —
which duplicate exactly this logic per provider around their SDKs.
"""

from __future__ import annotations

import email.utils
import urllib.error
import urllib.parse
import urllib.request

from dragonfly2_tpu_torch.client.source import (
    Request,
    ResourceClient,
    Response,
    SourceError,
    UNKNOWN_SOURCE_FILE_LEN,
)


class SignedHttpSourceClient(ResourceClient):
    scheme = "?"
    timeout = 30.0

    # -- provider hooks --------------------------------------------------

    def _http_url(self, bucket: str, key: str) -> str:
        raise NotImplementedError

    def _signed_headers(self, method: str, url: str, bucket: str,
                        key: str, headers: dict) -> dict:
        raise NotImplementedError

    def _make_store(self):
        """ObjectStore speaking this provider's wire (for list())."""
        raise NotImplementedError

    # -- shared machinery ------------------------------------------------

    def _bucket_key(self, request: Request) -> tuple:
        parsed = urllib.parse.urlparse(request.url)
        # Unquote before re-quoting downstream: URLs from list() carry
        # encoded keys, and quoting them again would double-encode.
        bucket = parsed.netloc
        key = urllib.parse.unquote(parsed.path.lstrip("/"))
        if not bucket or not key:
            raise SourceError(
                f"malformed {self.scheme} url {request.url!r}")
        return bucket, key

    def _open(self, request: Request, method: str = "GET",
              extra_header=None):
        bucket, key = self._bucket_key(request)
        url = self._http_url(bucket, key)
        headers = dict(extra_header or {})
        if request.rng is not None and method == "GET":
            headers["Range"] = request.rng.http_header()
        signed = self._signed_headers(method, url, bucket, key, headers)
        req = urllib.request.Request(url, headers=signed, method=method)
        try:
            return urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.HTTPError as exc:
            raise SourceError(f"{request.url}: HTTP {exc.code}") from exc
        except urllib.error.URLError as exc:
            raise SourceError(f"{request.url}: {exc.reason}") from exc

    def get_content_length(self, request: Request) -> int:
        resp = self._open(request, method="HEAD")
        try:
            length = resp.headers.get("Content-Length")
            return (int(length) if length is not None
                    else UNKNOWN_SOURCE_FILE_LEN)
        finally:
            resp.close()

    def is_support_range(self, request: Request) -> bool:
        return True  # object-store GETs always honor Range

    def is_expired(self, request: Request, last_modified: str,
                   etag: str) -> bool:
        if not etag and not last_modified:
            return True
        try:
            resp = self._open(request, method="HEAD")
        except SourceError:
            return True
        try:
            if etag:
                return resp.headers.get("ETag", "") != etag
            return resp.headers.get("Last-Modified", "") != last_modified
        finally:
            resp.close()

    def download(self, request: Request) -> Response:
        resp = self._open(request)
        if request.rng is not None and resp.status != 206:
            resp.close()
            raise SourceError(
                f"{request.url}: endpoint ignored Range "
                f"(status {resp.status})")
        length = resp.headers.get("Content-Length")
        return Response(
            body=resp,
            content_length=int(length) if length is not None else -1,
            status=resp.status,
            header={k: v for k, v in resp.headers.items()},
        )

    def get_last_modified(self, request: Request) -> int:
        resp = self._open(request, method="HEAD")
        try:
            lm = resp.headers.get("Last-Modified")
            if not lm:
                return -1
            return int(email.utils.parsedate_to_datetime(
                lm).timestamp() * 1000)
        finally:
            resp.close()

    def list(self, request: Request) -> list:
        """scheme://bucket/prefix/ → child object URLs via the shared
        object-store backend (same signer, provider pagination)."""
        parsed = urllib.parse.urlparse(request.url)
        bucket = parsed.netloc
        prefix = urllib.parse.unquote(parsed.path.lstrip("/"))
        # Directory semantics, not raw prefix match: 'data' must not
        # sweep in a sibling 'database/'.
        if prefix and not prefix.endswith("/"):
            prefix += "/"
        store = self._make_store()
        # Keys are percent-encoded into the URL (consumers unquote), so
        # '%'/'#'/'?' in object names survive the round trip.
        return [f"{self.scheme}://{bucket}/{urllib.parse.quote(key)}"
                for key in store.list_objects(bucket, prefix=prefix)]


def register_env_sources() -> None:
    """Install every extra back-to-source scheme the environment
    enables — the one registration path shared by the daemon and the
    ephemeral-peer CLIs (dfget), mirroring the reference's
    clients-from-init registration (pkg/source/clients):

    - s3://   when AWS_ACCESS_KEY_ID is set (AWS_* env config)
    - oss://  when OSS_ACCESS_KEY_ID is set (OSS_* env config)
    - oras:// always (creds come from ~/.docker/config.json)
    - hdfs:// always (simple-auth user from DF2_HDFS_USER)
    """
    import os

    if os.environ.get("AWS_ACCESS_KEY_ID"):
        from dragonfly2_tpu_torch.client.source_s3 import register_s3

        register_s3()
    if os.environ.get("OSS_ACCESS_KEY_ID"):
        from dragonfly2_tpu_torch.client.source_oss import register_oss

        register_oss()
    from dragonfly2_tpu_torch.client.source_hdfs import HDFSConfig, register_hdfs
    from dragonfly2_tpu_torch.client.source_oras import register_oras

    register_oras()
    register_hdfs(HDFSConfig(user=os.environ.get("DF2_HDFS_USER", "")))
