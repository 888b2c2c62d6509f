"""Feature extraction: dataset tables → training arrays — port of
``dragonfly2_tpu/data/features.py``, numpy over the column dict of
``schema.io.records_to_table`` in place of pandas over an arrow table.

- (parent, child) pair examples in the canonical ``FEATURE_NAMES``
  layout with achieved-bandwidth labels → the MLP (BASELINE config #1);
- a probe graph (node features, edge index, edge RTTs) → GraphSAGE and
  the GraphTransformer (configs #2 and #3).

Each step is the pandas version's, on the same dtypes in the same order
(``.astype(str)`` → unicode columns, ``.str.lower()`` → ``np.char.lower``,
``isin`` → ``np.isin``), so both packages give bit-identical arrays for
the same records.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

from dragonfly2_tpu_torch.scheduler.evaluator.scoring import (
    FEATURE_DIM,
    location_matches,
)
from dragonfly2_tpu_torch.schema import (
    MAX_DEST_HOSTS,
    MAX_PARENTS,
    MAX_PIECES_PER_PARENT,
)

# Labels are bandwidth in MB/s (bytes/ns * 1e3); keeps values O(1..1000).
PAIR_LABEL_SCALE = 1e6

# Peer states in which a parent serves pieces (seed_ready flag).
_SERVING_STATES = ("ReceivedNormal", "Running")

NODE_FEATURE_DIM = 8


def _hash_bucket(values, buckets: int = 16) -> np.ndarray:
    """Deterministic string → [0,1) bucket feature (crc32-based; stable
    across processes, unlike Python's salted hash())."""
    return np.array(
        [(zlib.crc32(v.encode()) % buckets) / buckets for v in values],
        dtype=np.float32)


def _location_element(values, i: int) -> list[str]:
    out = []
    for v in values:
        parts = v.split("|")
        out.append(parts[i] if i < len(parts) else "")
    return out


def _location_matches_vec(dst, src) -> np.ndarray:
    """``scoring.location_matches`` applied pairwise over string arrays."""
    return np.array([location_matches(d, s) for d, s in zip(dst, src)],
                    dtype=np.float32)


def _str(table: dict, name: str) -> np.ndarray:
    return np.asarray(table[name]).astype(str)


def pair_examples_from_table(table: dict) -> tuple[np.ndarray, np.ndarray]:
    """(features [n, FEATURE_DIM], bandwidth-MB/s labels [n]) from a
    Download column dict.

    One example per (download, parent-with-pieces) pair: the features are
    the scheduler's view of the parent at selection time, the label the
    bandwidth achieved from that parent (sum of piece lengths over sum of
    piece costs). Rows go parent slot by parent slot, each slot's
    downloads in table order; the first slot no download fills ends the
    walk.
    """
    n_rows = len(table["parents.len"])
    feats, labels = [], []
    parents_len = table["parents.len"]
    child_done = table["finished_piece_count"].astype(np.float64)
    total = table["task.total_piece_count"].astype(np.float64)
    child_idc = _str(table, "host.network.idc")
    child_loc = _str(table, "host.network.location")

    for i in range(MAX_PARENTS):
        p = f"parents.{i}"
        active = parents_len > i
        if not active.any():
            break
        piece_len = np.zeros(n_rows)
        piece_cost = np.zeros(n_rows)
        pieces_n = table[f"{p}.pieces.len"]
        for j in range(MAX_PIECES_PER_PARENT):
            has = pieces_n > j
            piece_len += np.where(has, table[f"{p}.pieces.{j}.length"], 0)
            piece_cost += np.where(has, table[f"{p}.pieces.{j}.cost"], 0)
        usable = active & (piece_cost > 0)
        if not usable.any():
            continue
        is_seed = _str(table, f"{p}.host.type") != "normal"
        serving = np.isin(_str(table, f"{p}.state"), _SERVING_STATES)
        limit = table[f"{p}.host.concurrent_upload_limit"].astype(np.float64)
        busy = table[f"{p}.host.concurrent_upload_count"].astype(np.float64)
        f = np.stack(
            [
                table[f"{p}.finished_piece_count"].astype(np.float64),
                child_done,
                total,
                table[f"{p}.host.upload_count"].astype(np.float64),
                table[f"{p}.host.upload_failed_count"].astype(np.float64),
                limit - busy,
                limit,
                is_seed.astype(np.float64),
                (is_seed & serving).astype(np.float64),
                ((np.char.lower(_str(table, f"{p}.host.network.idc"))
                  == np.char.lower(child_idc))
                 & (child_idc != "")).astype(np.float64),
                _location_matches_vec(
                    _str(table, f"{p}.host.network.location"), child_loc),
            ],
            axis=1,
        )
        bw = np.divide(piece_len, piece_cost, out=np.zeros(n_rows),
                       where=piece_cost > 0)
        feats.append(f[usable])
        labels.append(bw[usable] * 1e9 / PAIR_LABEL_SCALE)  # bytes/ns → MB/s

    if not feats:
        return (np.zeros((0, FEATURE_DIM), np.float32),
                np.zeros((0,), np.float32))
    return (
        np.concatenate(feats).astype(np.float32),
        np.concatenate(labels).astype(np.float32),
    )


@dataclass
class Graph:
    """A probe graph in array form. ``node_features`` rows are observable
    host features only; parent quality is the GNN's to infer."""

    node_ids: np.ndarray        # [n_nodes] str — host IDs
    node_features: np.ndarray   # [n_nodes, 8] float32
    edge_src: np.ndarray        # [n_edges] int32
    edge_dst: np.ndarray        # [n_edges] int32
    edge_rtt_ns: np.ndarray     # [n_edges] int64

    @property
    def n_nodes(self) -> int:
        return len(self.node_ids)

    @property
    def n_edges(self) -> int:
        return len(self.edge_src)

    def edge_labels(self, rtt_threshold_ns: int = 5_000_000) -> np.ndarray:
        """Binary edge quality: 1 = RTT under threshold (a good parent
        path), the GraphTransformer's classification target."""
        return (self.edge_rtt_ns < rtt_threshold_ns).astype(np.int32)


def _node_feature_rows(types, idcs, locs) -> np.ndarray:
    is_seed = np.array([t != "normal" for t in types], dtype=np.float32)
    return np.stack(
        [
            is_seed,
            np.where(is_seed > 0, 3.0, 0.5),  # upload-limit class proxy
            _hash_bucket(idcs),
            _hash_bucket(_location_element(locs, 0)),
            _hash_bucket(_location_element(locs, 1)),
            _hash_bucket(_location_element(locs, 2)),
            np.zeros(len(types), np.float32),
            np.ones(len(types), np.float32),
        ],
        axis=1,
    ).astype(np.float32)


def graph_from_table(table: dict) -> Graph:
    """A global probe graph from a NetworkTopology column dict.

    Each row contributes ≤ MAX_DEST_HOSTS directed edges src → dest with
    the probed average RTT. Node identity is the host ID, in sorted
    order; a host seen more than once keeps its first sighting's features
    (sources first, then destination slot by slot).
    """
    src_ids = _str(table, "host.id")
    dest_len = table["dest_hosts.len"]

    all_ids = [src_ids]
    all_types = [_str(table, "host.type")]
    all_idcs = [_str(table, "host.network.idc")]
    all_locs = [_str(table, "host.network.location")]
    edge_src_ids, edge_dst_ids, edge_rtts = [], [], []

    for i in range(MAX_DEST_HOSTS):
        d = f"dest_hosts.{i}"
        mask = dest_len > i
        if not mask.any():
            break
        ids = _str(table, f"{d}.id")
        all_ids.append(ids[mask])
        all_types.append(_str(table, f"{d}.type")[mask])
        all_idcs.append(_str(table, f"{d}.network.idc")[mask])
        all_locs.append(_str(table, f"{d}.network.location")[mask])
        edge_src_ids.append(src_ids[mask])
        edge_dst_ids.append(ids[mask])
        edge_rtts.append(table[f"{d}.probes.average_rtt"][mask])

    ids_flat = np.concatenate(all_ids)
    uniq, first_idx = np.unique(ids_flat, return_index=True)
    types_flat = np.concatenate(all_types)[first_idx]
    idcs_flat = np.concatenate(all_idcs)[first_idx]
    locs_flat = np.concatenate(all_locs)[first_idx]
    index_of = {h: i for i, h in enumerate(uniq)}

    if edge_src_ids:
        e_src = np.array(
            [index_of[h] for h in np.concatenate(edge_src_ids)], dtype=np.int32)
        e_dst = np.array(
            [index_of[h] for h in np.concatenate(edge_dst_ids)], dtype=np.int32)
        e_rtt = np.concatenate(edge_rtts).astype(np.int64)
    else:
        e_src = np.zeros(0, np.int32)
        e_dst = np.zeros(0, np.int32)
        e_rtt = np.zeros(0, np.int64)

    return Graph(
        node_ids=uniq,
        node_features=_node_feature_rows(types_flat, idcs_flat, locs_flat),
        edge_src=e_src,
        edge_dst=e_dst,
        edge_rtt_ns=e_rtt,
    )
