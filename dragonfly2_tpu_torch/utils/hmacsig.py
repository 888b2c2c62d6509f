"""HMAC-SHA1 header signatures for Aliyun OSS and Huawei OBS.

Reference counterpart: pkg/objectstorage/oss.go (aliyun-oss-go-sdk signer)
and obs.go (huaweicloud-sdk-go-obs signer). Both providers use the same
S3-v1-era scheme — base64(HMAC-SHA1(secret, string-to-sign)) over::

    VERB \n Content-MD5 \n Content-Type \n Date \n
    {canonicalized x-<provider>- headers}{canonicalized resource}

with the provider-specific metadata prefix (``x-oss-`` / ``x-obs-``) and
auth word (``OSS`` / ``OBS``). Stdlib only; exposed as a standalone
function so tests can verify canonicalization against the documented
layout with an independently computed HMAC (no circular signer oracle —
the awssig lesson from ADVICE r3).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
from email.utils import formatdate
from typing import Dict, Tuple

# Named subresources that participate in the canonical resource (both
# providers share the S3 v1 list). Plain list parameters (prefix, marker,
# max-keys) deliberately do NOT.
_SUBRESOURCES = frozenset({
    "acl", "append", "cors", "delete", "lifecycle", "location", "logging",
    "position", "referer", "response-content-type", "restore", "symlink",
    "tagging", "uploadId", "uploads", "versionId", "versioning", "website",
})


def string_to_sign(method: str, bucket: str, key: str,
                   headers: Dict[str, str], *, meta_prefix: str,
                   subresources: Dict[str, str] | None = None) -> str:
    """The documented canonical layout. ``headers`` are the request
    headers about to be sent (case-insensitive lookup here)."""
    lower = {k.lower(): v.strip() for k, v in headers.items()}
    canonical_headers = "".join(
        f"{name}:{lower[name]}\n"
        for name in sorted(n for n in lower if n.startswith(meta_prefix)))
    resource = "/" + bucket + ("/" + key if key else "/")
    if subresources:
        named = sorted(k for k in subresources if k in _SUBRESOURCES)
        if named:
            resource += "?" + "&".join(
                k if subresources[k] == "" else f"{k}={subresources[k]}"
                for k in named)
    return "\n".join([
        method.upper(),
        lower.get("content-md5", ""),
        lower.get("content-type", ""),
        lower.get("date", ""),
    ]) + "\n" + canonical_headers + resource


def sign_header_auth(method: str, bucket: str, key: str,
                     headers: Dict[str, str], *, access_key: str,
                     secret_key: str, auth_word: str, meta_prefix: str,
                     subresources: Dict[str, str] | None = None,
                     ) -> Tuple[Dict[str, str], str]:
    """Returns (headers-with-Date-and-Authorization, string_to_sign).
    The string-to-sign is returned for observability/tests."""
    out = dict(headers)
    if not any(k.lower() == "date" for k in out):
        out["Date"] = formatdate(usegmt=True)
    sts = string_to_sign(method, bucket, key, out, meta_prefix=meta_prefix,
                         subresources=subresources)
    digest = hmac.new(secret_key.encode(), sts.encode(), hashlib.sha1)
    signature = base64.b64encode(digest.digest()).decode()
    out["Authorization"] = f"{auth_word} {access_key}:{signature}"
    return out, sts


def sign_oss_request(method: str, bucket: str, key: str,
                     headers: Dict[str, str], *, access_key: str,
                     secret_key: str,
                     subresources: Dict[str, str] | None = None):
    """Aliyun OSS: ``Authorization: OSS <ak>:<sig>``, ``x-oss-`` metadata."""
    return sign_header_auth(method, bucket, key, headers,
                            access_key=access_key, secret_key=secret_key,
                            auth_word="OSS", meta_prefix="x-oss-",
                            subresources=subresources)


def sign_obs_request(method: str, bucket: str, key: str,
                     headers: Dict[str, str], *, access_key: str,
                     secret_key: str,
                     subresources: Dict[str, str] | None = None):
    """Huawei OBS: ``Authorization: OBS <ak>:<sig>``, ``x-obs-`` metadata."""
    return sign_header_auth(method, bucket, key, headers,
                            access_key=access_key, secret_key=secret_key,
                            auth_word="OBS", meta_prefix="x-obs-",
                            subresources=subresources)
