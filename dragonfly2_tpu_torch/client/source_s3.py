"""``s3://`` back-to-source client (SigV4, stdlib HTTP).

Reference counterpart: pkg/source/clients/s3protocol (aws-sdk-go S3
GetObject/HeadObject behind the ResourceClient interface). URLs are
``s3://bucket/key``; endpoint/region/credentials come from the config or
the standard AWS env vars, so MinIO-style S3-compatibles work with
``endpoint_url`` pointing at them (the reference e2e suite runs minio,
test/testdata/k8s). The REST machinery (ranged GETs, expiry, listing)
is shared with oss:// in ``source_signedhttp.py``; this module supplies
only the S3 URL layout and SigV4 signer.
"""

from __future__ import annotations

import os
import urllib.parse
from dataclasses import dataclass

from dragonfly2_tpu_torch.client.source_signedhttp import SignedHttpSourceClient
from dragonfly2_tpu_torch.utils.awssig import sign_request


@dataclass
class S3Config:
    access_key: str = ""
    secret_key: str = ""
    region: str = "us-east-1"
    # Empty = AWS virtual-hosted style <bucket>.s3.<region>.amazonaws.com;
    # set for S3-compatibles (path-style: <endpoint>/<bucket>/<key>).
    endpoint_url: str = ""
    timeout: float = 30.0

    @classmethod
    def from_env(cls) -> "S3Config":
        return cls(
            access_key=os.environ.get("AWS_ACCESS_KEY_ID", ""),
            secret_key=os.environ.get("AWS_SECRET_ACCESS_KEY", ""),
            region=os.environ.get("AWS_REGION", "us-east-1"),
            endpoint_url=os.environ.get("AWS_ENDPOINT_URL", ""),
        )


class S3SourceClient(SignedHttpSourceClient):
    scheme = "s3"

    def __init__(self, config: S3Config | None = None):
        self.config = config or S3Config.from_env()
        self.timeout = self.config.timeout

    def _http_url(self, bucket: str, key: str) -> str:
        cfg = self.config
        if cfg.endpoint_url:
            return (f"{cfg.endpoint_url.rstrip('/')}/{bucket}/"
                    f"{urllib.parse.quote(key)}")
        return (f"https://{bucket}.s3.{cfg.region}.amazonaws.com/"
                f"{urllib.parse.quote(key)}")

    def _signed_headers(self, method: str, url: str, bucket: str,
                        key: str, headers: dict) -> dict:
        cfg = self.config
        return sign_request(method, url, region=cfg.region,
                            access_key=cfg.access_key,
                            secret_key=cfg.secret_key, headers=headers)

    def _make_store(self):
        from dragonfly2_tpu_torch.manager.objectstore import S3ObjectStore

        cfg = self.config
        return S3ObjectStore(access_key=cfg.access_key,
                             secret_key=cfg.secret_key, region=cfg.region,
                             endpoint_url=cfg.endpoint_url,
                             timeout=cfg.timeout)


def register_s3(config: S3Config | None = None, replace: bool = True) -> None:
    """Install the s3 scheme (source_client.go:267 registration)."""
    from dragonfly2_tpu_torch.client import source

    source.register("s3", S3SourceClient(config), replace=replace)
