"""One tiny data-parallel step of every trainer over a process group —
the port's twin of ``__graft_entry__.dryrun_multichip``.

Run it in every rank of a group (``init_multihost`` first, or any
initialized default group): GraphSAGE with sampling on the device, the
MLP, and the GraphTransformer in gather and in blocks mode each train
one epoch of a few steps on a tiny seeded problem, with the batch
sharded over the group and the gradients all-reduced. Every rank must
end with the same parameters, which :func:`agree` checks through a
digest. The JAX twin's ring-attention and tensor-parallel steps have no
counterpart here: ring attention across ranks and tensor parallelism
are not ported (ROADMAP.md Queue 1 item 8b).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from dragonfly2_tpu_torch.data import SyntheticCluster
from dragonfly2_tpu_torch.parallel.mesh import group_size_rank
from dragonfly2_tpu_torch.parallel.multihost import agree


def state_digest(state_dict: dict) -> np.ndarray:
    """The first 8 bytes of the SHA-256 of every tensor's bytes, in key
    order, as an int64 [1]: equal digests mean bit-equal parameters."""
    h = hashlib.sha256()
    for key in sorted(state_dict):
        h.update(key.encode())
        h.update(state_dict[key].detach().cpu().contiguous().numpy()
                 .tobytes())
    return np.frombuffer(h.digest()[:8], np.int64).copy()


def dryrun_data_parallel(group=None, device=None) -> dict:
    """Train each model one tiny epoch over ``group`` on ``device``
    (``None``: the card) and return ``{name: mean loss of the epoch}``.
    Raises when a run did not take exactly one epoch or when the ranks'
    parameters differ."""
    from dragonfly2_tpu_torch.train.checkpoint import mlp_state_dict_from_flax
    from dragonfly2_tpu_torch.train.gat_trainer import (
        GATTrainConfig,
        train_gat,
    )
    from dragonfly2_tpu_torch.train.gnn_trainer import (
        GNNTrainConfig,
        train_gnn,
    )
    from dragonfly2_tpu_torch.train.mlp_trainer import (
        MLPTrainConfig,
        train_mlp,
    )

    world, _ = group_size_rank(group)
    cluster = SyntheticCluster(n_hosts=16, seed=0)
    graph = cluster.probe_graph(8 * world)
    X, y = cluster.pair_example_columns(8 * world)
    states = {}
    gnn = train_gnn(graph, GNNTrainConfig(
        hidden=8, embed=4, fanouts=(3, 2), epochs=1, batch_size=2 * world,
        eval_fraction=0.25), device, group=group)
    states["graphsage"] = (gnn.history, gnn.state_dict)
    mlp = train_mlp(X, y, MLPTrainConfig(
        hidden=(8,), epochs=1, batch_size=2 * world, eval_fraction=0.25),
        device, group=group)
    states["mlp"] = (mlp.history, mlp_state_dict_from_flax(mlp.params))
    # K1 takes heads · head_dim in {32, …, 512} on the card.
    for mode in ("gather", "blocks"):
        gat = train_gat(graph, GATTrainConfig(
            hidden=32, embed=16, layers=1, heads=2, epochs=1,
            edge_batch_size=2 * world, eval_fraction=0.25, attention=mode),
            device, group=group)
        states[f"gat_{mode}"] = (gat.history, gat.state_dict)
    losses = {}
    for name, (history, state) in states.items():
        if len(history) != 1:
            raise AssertionError(f"{name}: {len(history)} epochs, not 1")
        digests = agree(state_digest(state), group=group)
        if not (digests == digests[0]).all():
            raise AssertionError(f"{name}: ranks' parameters differ "
                                 f"({digests.ravel().tolist()})")
        losses[name] = history[0]
    return losses
