"""Deterministic IDs for tasks, peers, hosts and models — port copy of
the parts of ``dragonfly2_tpu/utils/idgen.py`` that the record path and
the training orchestrator use (reference: pkg/idgen/task_id.go:95-102,
peer_id.go, host_id.go, model_id.go:32-38).

IDs are SHA-256 digests of request identity, so every service derives
the same ID independently. A model ID binds a trained model to its
source scheduler host: the registry keeps one active version per
(type, scheduler), and a host's retrained model replaces its own.
"""

from __future__ import annotations

import uuid
from typing import Iterable, Sequence
from urllib.parse import parse_qsl, urlencode, urlsplit, urlunsplit

from dragonfly2_tpu_torch.utils.digest import sha256_from_strings


def filter_query(url: str, filtered_query_params: Sequence[str] | None) -> str:
    """Drop the named query parameters from ``url`` (pkg/net/url
    FilterQuery). Surviving parameters are re-encoded in sorted key
    order, as Go's ``url.Values.Encode()`` does: task IDs hash the
    encoded URL, so key order must match across implementations."""
    if not filtered_query_params:
        return url
    parts = urlsplit(url)
    if not parts.query:
        return url
    drop = set(filtered_query_params)
    kept = [(k, v) for k, v in parse_qsl(parts.query, keep_blank_values=True)
            if k not in drop]
    kept.sort(key=lambda kv: kv[0])  # stable: same-key values keep order
    return urlunsplit(parts._replace(query=urlencode(kept)))


def task_id_v2(
    url: str,
    digest: str = "",
    tag: str = "",
    application: str = "",
    piece_length: int = 0,
    filtered_query_params: Iterable[str] | None = None,
) -> str:
    """V2 task ID (task_id.go:95-102 TaskIDV2): always hashes all five
    fields, the piece length stringified."""
    try:
        u = filter_query(url, list(filtered_query_params or []))
    except ValueError:
        u = ""
    return sha256_from_strings(u, digest, tag, application, str(piece_length))


def peer_id_v2() -> str:
    return str(uuid.uuid4())


def host_id_v1(hostname: str, port: int) -> str:
    """``<hostname>-<port>`` (host_id.go HostIDV1)."""
    return f"{hostname}-{port}"


def host_id_v2(ip: str, hostname: str) -> str:
    return sha256_from_strings(ip, hostname)


def gnn_model_id_v1(ip: str, hostname: str) -> str:
    """Model IDs bind a trained model to its source scheduler host
    (model_id.go:32-38)."""
    return sha256_from_strings(ip, hostname, "GNN")


def mlp_model_id_v1(ip: str, hostname: str) -> str:
    return sha256_from_strings(ip, hostname, "MLP")


def gat_model_id_v1(ip: str, hostname: str) -> str:
    """Config #3 (GraphTransformer) follows the same binding scheme."""
    return sha256_from_strings(ip, hostname, "GAT")


def cost_model_id_v1(ip: str, hostname: str) -> str:
    """The learned piece-cost predictor."""
    return sha256_from_strings(ip, hostname, "COST")
