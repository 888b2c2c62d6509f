"""Docker/OCI registry auth: WWW-Authenticate challenge → Bearer token.

Shared by the manager's preheat manifest resolution
(manager/job/preheat.go:168-246 in the reference) and the ``oras://``
back-to-source client (pkg/source/clients/orasprotocol). Stdlib only.
"""

from __future__ import annotations

import base64
import json
import os
import re
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, Optional, Tuple


def parse_challenge(header: str) -> Tuple[str, Dict[str, str]]:
    """``WWW-Authenticate: Bearer realm="...",service="...",scope="..."``
    → ("bearer", params). Also recognizes Basic."""
    scheme, _, rest = header.strip().partition(" ")
    params = {}
    for m in re.finditer(r'(\w+)="([^"]*)"|(\w+)=([^",\s]+)', rest):
        if m.group(1):
            params[m.group(1).lower()] = m.group(2)
        else:
            params[m.group(3).lower()] = m.group(4)
    return scheme.lower(), params


def fetch_registry_token(challenge: str, *, username: str = "",
                         password: str = "", timeout: float = 30.0,
                         repository: str = "") -> str:
    """The Bearer half of the registry token dance: GET the challenge's
    realm with service+scope (Basic credentials if given) and return the
    issued token."""
    scheme, params = parse_challenge(challenge)
    if scheme != "bearer":
        raise ValueError(f"unsupported auth challenge scheme {scheme!r}")
    realm = params.get("realm", "")
    if not realm:
        raise ValueError("Bearer challenge without realm")
    query = {}
    if params.get("service"):
        query["service"] = params["service"]
    scope = params.get("scope") or (
        f"repository:{repository}:pull" if repository else "")
    if scope:
        query["scope"] = scope
    url = realm + ("?" + urllib.parse.urlencode(query) if query else "")
    req_headers = {}
    if username or password:
        cred = base64.b64encode(f"{username}:{password}".encode()).decode()
        req_headers["Authorization"] = f"Basic {cred}"
    req = urllib.request.Request(url, headers=req_headers)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        body = json.loads(resp.read())
    token = body.get("token") or body.get("access_token") or ""
    if not token:
        raise ValueError(f"token endpoint {realm} returned no token")
    return token


def docker_config_auth(registry_host: str,
                       config_path: str = "") -> Tuple[str, str]:
    """(username, password) for a registry from ~/.docker/config.json —
    the credential source the reference's oras client reads
    (oras_source_client.go fetchAuthInfo). ("", "") when absent."""
    path = config_path or os.path.expanduser("~/.docker/config.json")
    try:
        with open(path) as f:
            auths = json.load(f).get("auths", {})
    except (OSError, json.JSONDecodeError):
        return "", ""
    entry = auths.get(registry_host) or auths.get(
        f"https://{registry_host}") or {}
    blob = entry.get("auth", "")
    if not blob:
        return "", ""
    try:
        user, _, pw = base64.b64decode(blob).decode().partition(":")
        return user, pw
    except Exception:  # noqa: BLE001 — malformed entry: anonymous
        return "", ""


def open_with_registry_auth(
    url: str, *, headers: Optional[Dict[str, str]] = None,
    username: str = "", password: str = "", repository: str = "",
    auth: str = "", method: str = "GET", timeout: float = 30.0,
):
    """urlopen with the 401→token→retry dance. Returns
    (http_response, auth_header_value) — callers reuse the Authorization
    value ("Bearer <tok>" / "Basic <cred>", "" if anonymous worked) for
    subsequent requests to the same repository (manifest then blobs)."""
    merged = dict(headers or {})
    if auth:
        merged["Authorization"] = auth
    req = urllib.request.Request(url, headers=merged, method=method)
    try:
        return urllib.request.urlopen(req, timeout=timeout), auth
    except urllib.error.HTTPError as exc:
        if exc.code != 401 or "Authorization" in merged:
            raise
        challenge = exc.headers.get("WWW-Authenticate", "")
        scheme = challenge.split(" ", 1)[0].lower()
        if scheme == "bearer":
            token = fetch_registry_token(
                challenge, username=username, password=password,
                timeout=timeout, repository=repository)
            auth = f"Bearer {token}"
        elif scheme == "basic" and (username or password):
            cred = base64.b64encode(
                f"{username}:{password}".encode()).decode()
            auth = f"Basic {cred}"
        else:
            raise
        merged["Authorization"] = auth
    req = urllib.request.Request(url, headers=merged, method=method)
    return urllib.request.urlopen(req, timeout=timeout), auth
