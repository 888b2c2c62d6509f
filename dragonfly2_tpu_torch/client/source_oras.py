"""``oras://`` back-to-source client: OCI registry artifacts as files.

Reference counterpart: pkg/source/clients/orasprotocol/
oras_source_client.go — the image-acceleration story's artifact path:
``oras://registry/repo:tag`` resolves tag → OCI manifest → the first
layer blob, which is the artifact payload (that's how ``oras push``
stores a file). Auth follows the registry token dance with credentials
from config or ~/.docker/config.json (fetchAuthInfo in the reference);
resolution results (blob digest + token) are cached per URL so the
piece-level range reads the peer engine issues don't re-resolve the
manifest every time (the reference threads them through headers —
X-Dragonfly-Oras-Token — for the same reason).
"""

from __future__ import annotations

import email.utils
import json
import threading
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from dragonfly2_tpu_torch.client.source import (
    Request,
    ResourceClient,
    Response,
    SourceError,
)
from dragonfly2_tpu_torch.utils.registryauth import (
    docker_config_auth,
    open_with_registry_auth,
)

OCI_MANIFEST_ACCEPT = ", ".join([
    "application/vnd.oci.image.manifest.v1+json",
    "application/vnd.docker.distribution.manifest.v2+json",
])


@dataclass
class ORASConfig:
    username: str = ""
    password: str = ""
    # OCI registries are https; local/test registries are plain http.
    plain_http: bool = False
    timeout: float = 30.0
    docker_config_path: str = ""  # "" = ~/.docker/config.json


class ORASSourceClient(ResourceClient):
    def __init__(self, config: ORASConfig | None = None):
        self.config = config or ORASConfig()
        self._lock = threading.Lock()
        # url → (blob_url, auth_header, size) resolution cache.
        self._resolved: Dict[str, Tuple[str, str, int]] = {}

    # -- URL anatomy -----------------------------------------------------

    @staticmethod
    def _parse(url: str) -> Tuple[str, str, str]:
        """oras://host[:port]/repo[:tag] → (host, repo, tag)."""
        parsed = urllib.parse.urlparse(url)
        host = parsed.netloc
        path = parsed.path.lstrip("/")
        if not host or not path:
            raise SourceError(f"malformed oras URL {url!r} "
                              "(want oras://registry/repo[:tag])")
        repo, sep, tag = path.rpartition(":")
        if not sep:
            repo, tag = path, "latest"
        return host, repo, tag or "latest"

    def _credentials(self, host: str) -> Tuple[str, str]:
        if self.config.username or self.config.password:
            return self.config.username, self.config.password
        return docker_config_auth(host, self.config.docker_config_path)

    def _base(self, host: str) -> str:
        scheme = "http" if self.config.plain_http else "https"
        return f"{scheme}://{host}"

    # -- resolution ------------------------------------------------------

    def _resolve(self, request: Request) -> Tuple[str, str, int]:
        """(blob_url, auth_header, size) for the artifact layer behind
        the oras URL; cached per URL."""
        with self._lock:
            hit = self._resolved.get(request.url)
        if hit is not None:
            return hit
        host, repo, tag = self._parse(request.url)
        username, password = self._credentials(host)
        manifest_url = f"{self._base(host)}/v2/{repo}/manifests/{tag}"
        try:
            resp, auth = open_with_registry_auth(
                manifest_url, headers={"Accept": OCI_MANIFEST_ACCEPT},
                username=username, password=password, repository=repo,
                timeout=self.config.timeout)
        except urllib.error.HTTPError as exc:
            raise SourceError(
                f"oras manifest fetch {manifest_url}: HTTP {exc.code}")
        except urllib.error.URLError as exc:
            raise SourceError(f"oras manifest fetch: {exc.reason}")
        with resp:
            manifest = json.loads(resp.read())
        layers = manifest.get("layers", [])
        if not layers:
            raise SourceError(
                f"oras artifact {request.url} has no layers")
        # The artifact payload is the first layer (oras push semantics;
        # reference oras_source_client.go fetchManifest takes layer[0]).
        digest = layers[0]["digest"]
        size = int(layers[0].get("size", -1))
        blob_url = f"{self._base(host)}/v2/{repo}/blobs/{digest}"
        with self._lock:
            self._resolved[request.url] = (blob_url, auth, size)
        return blob_url, auth, size

    def _open_blob(self, request: Request, method: str = "GET"):
        blob_url, auth, _ = self._resolve(request)
        host, repo, _tag = self._parse(request.url)
        username, password = self._credentials(host)
        headers = dict(request.header)
        headers.pop("Authorization", None)
        if request.rng is not None and method == "GET":
            headers["Range"] = f"bytes={request.rng.start}-{request.rng.end}"
        try:
            resp, _ = open_with_registry_auth(
                blob_url, headers=headers, username=username,
                password=password, repository=repo, auth=auth,
                method=method, timeout=self.config.timeout)
            return resp
        except urllib.error.HTTPError as exc:
            if exc.code == 401:
                # Token expired between resolution and fetch: drop the
                # cache so the next attempt renegotiates.
                with self._lock:
                    self._resolved.pop(request.url, None)
            raise SourceError(f"oras blob fetch: HTTP {exc.code}")
        except urllib.error.URLError as exc:
            raise SourceError(f"oras blob fetch: {exc.reason}")

    # -- ResourceClient surface -------------------------------------------

    def get_content_length(self, request: Request) -> int:
        _, _, size = self._resolve(request)
        if size >= 0:
            return size
        resp = self._open_blob(request, method="HEAD")
        with resp:
            return int(resp.headers.get("Content-Length", -1))

    def is_support_range(self, request: Request) -> bool:
        # Registry blobs are content-addressed and range-readable
        # (the reference returns true unconditionally).
        return True

    def is_expired(self, request: Request, last_modified: str,
                   etag: str) -> bool:
        # Content-addressed by digest — a resolved artifact never goes
        # stale (reference: IsExpired returns false).
        return False

    def download(self, request: Request) -> Response:
        resp = self._open_blob(request)
        if request.rng is not None and resp.status != 206:
            # Same invariant as the base HTTP client: a server that
            # ignored Range returned the WHOLE blob — treating it as the
            # slice would silently corrupt the reassembled artifact.
            resp.close()
            raise SourceError(
                f"oras registry ignored Range (status {resp.status})")
        length = int(resp.headers.get("Content-Length", -1))
        return Response(body=resp, content_length=length,
                        status=resp.status,
                        header=dict(resp.headers.items()))

    def get_last_modified(self, request: Request) -> int:
        resp = self._open_blob(request, method="HEAD")
        with resp:
            raw = resp.headers.get("Last-Modified", "")
        if not raw:
            return -1
        try:
            return int(email.utils.parsedate_to_datetime(raw).timestamp())
        except (TypeError, ValueError):
            return -1


def register_oras(config: Optional[ORASConfig] = None,
                  replace: bool = True) -> ORASSourceClient:
    from dragonfly2_tpu_torch.client import source

    client = ORASSourceClient(config)
    source.register("oras", client, replace=replace)
    return client
