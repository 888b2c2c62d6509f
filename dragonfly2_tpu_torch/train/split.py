"""Train/eval edge split — port of ``edge_split`` from
``dragonfly2_tpu/train/gnn_trainer.py``; the same ids for the same seed."""

from __future__ import annotations

import numpy as np

from dragonfly2_tpu_torch.data.features import Graph


def edge_split(graph: Graph, eval_fraction: float, seed: int):
    """Split edges by (src, dst) PAIR, not edge id → (train_ids, eval_ids).

    Probe datasets repeat sightings of one ordered pair; a split by edge
    id would leave a same-pair train edge in the message graph of most
    eval edges. Splitting by pair keeps every sighting of an eval pair out
    of training.
    """
    pair_key = graph.edge_src.astype(np.int64) * graph.n_nodes + graph.edge_dst
    uniq_pairs, pair_idx = np.unique(pair_key, return_inverse=True)
    order = np.random.default_rng((seed, 1)).permutation(len(uniq_pairs))
    n_eval_pairs = int(len(uniq_pairs) * eval_fraction)
    eval_pair_mask = np.zeros(len(uniq_pairs), bool)
    eval_pair_mask[order[:n_eval_pairs]] = True
    is_eval = eval_pair_mask[pair_idx]
    all_ids = np.arange(graph.n_edges)
    return all_ids[~is_eval], all_ids[is_eval]
