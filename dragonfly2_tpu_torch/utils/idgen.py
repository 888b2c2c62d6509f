"""Deterministic ID generation for tasks, peers, hosts, and models.

Reference counterpart: pkg/idgen/ (task_id.go:37-102, peer_id.go,
host_id.go, model_id.go). IDs are deterministic SHA-256 digests of request
identity so that every service derives the same ID independently — this is
what makes the consistent-hash scheduler affinity and piece reuse work.
"""

from __future__ import annotations

import os
import uuid
from typing import Iterable, Sequence
from urllib.parse import parse_qsl, urlencode, urlsplit, urlunsplit

from dragonfly2_tpu_torch.utils.digest import sha256_from_strings

URL_FILTER_SEPARATOR = "&"


def filter_query(url: str, filtered_query_params: Sequence[str] | None) -> str:
    """Drop the named query parameters from ``url``.

    Mirrors pkg/net/url FilterQuery: parameters whose *name* appears in
    ``filtered_query_params`` are removed so that e.g. signed-URL tokens do
    not fragment task identity. Surviving parameters are re-encoded in
    sorted key order — Go's ``url.Values.Encode()`` sorts keys, and task IDs
    hash the encoded URL, so key order must match for cross-implementation
    ID stability.
    """
    if not filtered_query_params:
        return url
    parts = urlsplit(url)
    if not parts.query:
        return url
    drop = set(filtered_query_params)
    kept = [(k, v) for k, v in parse_qsl(parts.query, keep_blank_values=True) if k not in drop]
    kept.sort(key=lambda kv: kv[0])  # stable: same-key values keep appearance order
    return urlunsplit(parts._replace(query=urlencode(kept)))


def task_id_v1(
    url: str,
    *,
    digest: str = "",
    tag: str = "",
    application: str = "",
    url_range: str = "",
    filters: str = "",
    ignore_range: bool = False,
) -> str:
    """V1 task ID (reference: pkg/idgen/task_id.go:37-83 taskIDV1).

    ``filters`` is the raw '&'-separated filter string from request metadata.
    The hash covers (filtered url, digest?, range?, tag?, application?) —
    empty fields are omitted entirely, matching the reference's conditional
    appends.
    """
    filter_list = filters.split(URL_FILTER_SEPARATOR) if filters.strip() else None
    try:
        u = filter_query(url, filter_list)
    except ValueError:
        u = ""
    data = [u]
    if digest:
        data.append(digest)
    if not ignore_range and url_range:
        data.append(url_range)
    if tag:
        data.append(tag)
    if application:
        data.append(application)
    return sha256_from_strings(*data)


def parent_task_id_v1(url: str, **kwargs) -> str:
    """Task ID ignoring the range field — identifies the whole-file parent
    task for ranged requests (reference: task_id.go ParentTaskIDV1)."""
    kwargs["ignore_range"] = True
    return task_id_v1(url, **kwargs)


def task_id_v2(
    url: str,
    digest: str = "",
    tag: str = "",
    application: str = "",
    piece_length: int = 0,
    filtered_query_params: Iterable[str] | None = None,
) -> str:
    """V2 task ID (reference: task_id.go:95-102 TaskIDV2) — always hashes all
    five fields (piece length stringified), unlike v1's conditional appends."""
    try:
        u = filter_query(url, list(filtered_query_params or []))
    except ValueError:
        u = ""
    return sha256_from_strings(u, digest, tag, application, str(piece_length))


def peer_id_v1(ip: str) -> str:
    """``<ip>-<pid>-<uuid4>`` (reference: peer_id.go PeerIDV1)."""
    return f"{ip}-{os.getpid()}-{uuid.uuid4()}"


def seed_peer_id_v1(ip: str) -> str:
    return f"{peer_id_v1(ip)}_Seed"


def peer_id_v2() -> str:
    return str(uuid.uuid4())


def host_id_v1(hostname: str, port: int) -> str:
    """``<hostname>-<port>`` (reference: host_id.go HostIDV1)."""
    return f"{hostname}-{port}"


def host_id_v2(ip: str, hostname: str) -> str:
    return sha256_from_strings(ip, hostname)


def gnn_model_id_v1(ip: str, hostname: str) -> str:
    """Model IDs bind a trained model to its source scheduler host
    (reference: pkg/idgen/model_id.go:32-38)."""
    return sha256_from_strings(ip, hostname, "GNN")


def mlp_model_id_v1(ip: str, hostname: str) -> str:
    return sha256_from_strings(ip, hostname, "MLP")


def gat_model_id_v1(ip: str, hostname: str) -> str:
    """Config #3 (GraphTransformer) follows the same binding scheme."""
    return sha256_from_strings(ip, hostname, "GAT")


def cost_model_id_v1(ip: str, hostname: str) -> str:
    """Learned piece-cost predictor (replay plane, docs/REPLAY.md)."""
    return sha256_from_strings(ip, hostname, "COST")
