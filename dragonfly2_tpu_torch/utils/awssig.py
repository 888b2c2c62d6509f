"""AWS Signature Version 4 request signing (stdlib only).

Reference counterpart: the aws-sdk-go signing used by
pkg/objectstorage/s3.go:304 and pkg/source/clients/s3protocol. boto3 is
not in this image, and SigV4 is a small, fully-documented algorithm
(https://docs.aws.amazon.com/IAM/latest/UserGuide/create-signed-request.html)
— canonical request → string-to-sign → derived HMAC chain — so the
framework carries its own implementation instead of gating the feature.
Works against AWS S3 and S3-compatibles (MinIO, Ceph RGW).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.parse
from typing import Dict, Tuple

EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _canonical_query(query: str) -> str:
    pairs = urllib.parse.parse_qsl(query, keep_blank_values=True)
    encoded = sorted(
        (urllib.parse.quote(k, safe="-_.~"),
         urllib.parse.quote(v, safe="-_.~"))
        for k, v in pairs
    )
    return "&".join(f"{k}={v}" for k, v in encoded)


def _canonical_uri(path: str) -> str:
    # S3 style: the canonical URI is the wire path verbatim — callers
    # percent-encode keys exactly once when building the URL, and AWS
    # S3 signs that once-encoded form without re-encoding or
    # normalizing (re-quoting here would double-encode '%' and produce
    # SignatureDoesNotMatch on any key with spaces/'+'/unicode).
    return path or "/"


def sign_request(
    method: str,
    url: str,
    *,
    region: str,
    access_key: str,
    secret_key: str,
    service: str = "s3",
    headers: Dict[str, str] | None = None,
    payload_hash: str = EMPTY_SHA256,
    now: datetime.datetime | None = None,
) -> Dict[str, str]:
    """Returns the headers to send (input headers + Host, x-amz-date,
    x-amz-content-sha256, Authorization)."""
    parsed = urllib.parse.urlparse(url)
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")

    out = dict(headers or {})
    out["Host"] = parsed.netloc
    out["x-amz-date"] = amz_date
    out["x-amz-content-sha256"] = payload_hash

    lower = {k.lower(): " ".join(str(v).split()) for k, v in out.items()}
    signed_names = ";".join(sorted(lower))
    canonical_headers = "".join(f"{k}:{lower[k]}\n" for k in sorted(lower))
    canonical_request = "\n".join([
        method.upper(),
        _canonical_uri(parsed.path),
        _canonical_query(parsed.query),
        canonical_headers,
        signed_names,
        payload_hash,
    ])
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256",
        amz_date,
        scope,
        hashlib.sha256(canonical_request.encode()).hexdigest(),
    ])
    k_date = _hmac(("AWS4" + secret_key).encode(), datestamp)
    k_region = _hmac(k_date, region)
    k_service = _hmac(k_region, service)
    k_signing = _hmac(k_service, "aws4_request")
    signature = hmac.new(k_signing, string_to_sign.encode(),
                         hashlib.sha256).hexdigest()
    out["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_names}, Signature={signature}"
    )
    return out


def parse_authorization(header: str) -> Tuple[str, str, str]:
    """(access_key, scope, signature) from an Authorization header — the
    server half used by the test fake and signature verification."""
    if not header.startswith("AWS4-HMAC-SHA256 "):
        raise ValueError("not a SigV4 Authorization header")
    fields = {}
    for part in header[len("AWS4-HMAC-SHA256 "):].split(","):
        k, _, v = part.strip().partition("=")
        fields[k] = v
    credential = fields["Credential"]
    access_key, _, scope = credential.partition("/")
    return access_key, scope, fields["Signature"]
