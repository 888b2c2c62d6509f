"""``oss://`` back-to-source client (Aliyun OSS, HMAC-SHA1 header auth).

Reference counterpart: pkg/source/clients/ossprotocol (aliyun-oss-go-sdk
GetObject/GetObjectMeta behind the ResourceClient interface). URLs are
``oss://bucket/key``; endpoint/region/credentials come from the config
or the ``OSS_*`` env vars. The REST machinery (ranged GETs, expiry,
listing) is shared with s3:// in ``source_signedhttp.py``; this module
supplies only the OSS URL layout and signer.
"""

from __future__ import annotations

import os
import urllib.parse
from dataclasses import dataclass

from dragonfly2_tpu_torch.client.source_signedhttp import SignedHttpSourceClient
from dragonfly2_tpu_torch.utils.hmacsig import sign_oss_request


@dataclass
class OSSConfig:
    access_key: str = ""
    secret_key: str = ""
    region: str = "oss-cn-hangzhou"
    # Empty = virtual-hosted <bucket>.<region>.aliyuncs.com; set for
    # fakes/self-hosted gateways (path-style <endpoint>/<bucket>/<key>).
    endpoint_url: str = ""
    timeout: float = 30.0

    @classmethod
    def from_env(cls) -> "OSSConfig":
        return cls(
            access_key=os.environ.get("OSS_ACCESS_KEY_ID", ""),
            secret_key=os.environ.get("OSS_ACCESS_KEY_SECRET", ""),
            region=os.environ.get("OSS_REGION", "oss-cn-hangzhou"),
            endpoint_url=os.environ.get("OSS_ENDPOINT_URL", ""),
        )


class OSSSourceClient(SignedHttpSourceClient):
    scheme = "oss"

    def __init__(self, config: OSSConfig | None = None):
        self.config = config or OSSConfig.from_env()
        self.timeout = self.config.timeout

    def _http_url(self, bucket: str, key: str) -> str:
        cfg = self.config
        if cfg.endpoint_url:
            return (f"{cfg.endpoint_url.rstrip('/')}/{bucket}/"
                    f"{urllib.parse.quote(key)}")
        return (f"https://{bucket}.{cfg.region}.aliyuncs.com/"
                f"{urllib.parse.quote(key)}")

    def _signed_headers(self, method: str, url: str, bucket: str,
                        key: str, headers: dict) -> dict:
        # Range is not part of the OSS string-to-sign (it is neither a
        # canonical header nor an x-oss- one), so signing the base
        # request keeps ranged piece reads valid.
        cfg = self.config
        signed, _ = sign_oss_request(method, bucket, key, headers,
                                     access_key=cfg.access_key,
                                     secret_key=cfg.secret_key)
        return signed

    def _make_store(self):
        from dragonfly2_tpu_torch.manager.objectstore import OSSObjectStore

        cfg = self.config
        return OSSObjectStore(access_key=cfg.access_key,
                              secret_key=cfg.secret_key,
                              region=cfg.region,
                              endpoint_url=cfg.endpoint_url,
                              timeout=cfg.timeout)


def register_oss(config: OSSConfig | None = None,
                 replace: bool = True) -> None:
    """Install the oss scheme (ossprotocol's init() registration)."""
    from dragonfly2_tpu_torch.client import source

    source.register("oss", OSSSourceClient(config), replace=replace)
