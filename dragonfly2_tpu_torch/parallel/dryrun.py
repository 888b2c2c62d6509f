"""One tiny step of every trainer and parallel layout over a process
group — the port's twin of ``__graft_entry__.dryrun_multichip``.

Run it in every rank of a group (``init_multihost`` first, or any
initialized default group): GraphSAGE with sampling on the device, the
MLP, and the GraphTransformer in gather, blocks and ring mode each train
one epoch of a few steps on a tiny seeded problem, with the batch
sharded over the group and the gradients all-reduced (ring mode also
shards the rows); every rank must end with the same parameters, which
:func:`agree` checks through a digest. Then ring attention, the
pipeline and the experts each take a forward and a gradient at the JAX
twin's shapes, every rank holding its shard, stage or expert, and their
losses and gradients must be finite. In an even world of two or more
the GraphTransformer also trains one epoch tensor-parallel on an
``(n/2 × 2)`` grid (the JAX twin's Megatron step): a rank's parameter
bytes must come out below the replicated model's, and the gathered
parameters agree across every rank.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from dragonfly2_tpu_torch.data import SyntheticCluster
from dragonfly2_tpu_torch.device import default_device
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
    from dragonfly2_tpu_torch.parallel.mesh import grid_groups
    from dragonfly2_tpu_torch.train.checkpoint import mlp_state_dict_from_flax
    from dragonfly2_tpu_torch.train.gat_trainer import (
        GATTrainConfig,
        GATTrainer,
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

    world, rank = group_size_rank(group)
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
    # K1 takes heads · head_dim in {32, …, 512} on the card; ring mode's
    # 4-row chunk is the JAX twin's.
    for mode in ("gather", "blocks", "ring"):
        gat = train_gat(graph, GATTrainConfig(
            hidden=32, embed=16, layers=1, heads=2, epochs=1,
            edge_batch_size=2 * world, eval_fraction=0.25, attention=mode,
            chunk=4 if mode == "ring" else 1024), device, group=group)
        states[f"gat_{mode}"] = (gat.history, gat.state_dict)
    if world >= 2 and world % 2 == 0:
        # Tensor parallelism: the attention block's Dense layers split
        # over a model axis of 2, the rows over the data axis.
        trainer = GATTrainer(graph, GATTrainConfig(
            hidden=8, embed=4, layers=1, heads=2, epochs=1,
            edge_batch_size=2 * world, eval_fraction=0.25), device,
            grid=grid_groups(2, group))
        gat = trainer.fit()
        states["gat_tp"] = (gat.history, gat.state_dict)
        mine = sum(p.numel() * p.element_size()
                   for p in trainer.model.parameters())
        whole = sum(t.numel() * t.element_size()
                    for t in gat.state_dict.values())
        if not mine < whole:
            raise AssertionError(f"gat_tp: a rank holds {mine} parameter "
                                 f"bytes of {whole}")
    losses = {}
    for name, (history, state) in states.items():
        if len(history) != 1:
            raise AssertionError(f"{name}: {len(history)} epochs, not 1")
        digests = agree(state_digest(state), group=group)
        if not (digests == digests[0]).all():
            raise AssertionError(f"{name}: ranks' parameters differ "
                                 f"({digests.ravel().tolist()})")
        losses[name] = history[0]
    losses.update(_layouts(group, default_device(device), world, rank))
    return losses


def _layouts(group, device, world: int, rank: int) -> dict:
    """Ring attention (causal, 8 rows a rank, 2 heads of 4), the pipeline
    (a tanh(x @ w) stage a rank, 4 rows a rank, width 8) and the experts
    (an expert a rank, 4 tokens a rank, capacity factor 4): the global
    loss (out²).sum() of each and its gradients, which must be finite."""
    from dragonfly2_tpu_torch.parallel import (
        moe_apply,
        pipeline_apply,
        ring_attention,
    )

    rng = np.random.default_rng(0)
    d = 8

    def tensor(shape, rows=None, scale=1.0):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        t = torch.from_numpy(a if rows is None else a[rows])
        return t.to(device).requires_grad_()

    def tanh_stage(p, x):
        return torch.tanh(x @ p["w"])

    mine = slice(rank * 8, (rank + 1) * 8)
    q, k, v = (tensor((8 * world, 2, 4), mine) for _ in range(3))
    out = ring_attention(q, k, v, group=group, causal=True)
    ring = (out ** 2).sum()
    ring.backward()
    grads = {"ring_attention": [q.grad, k.grad, v.grad]}

    stages = {"w": tensor((world, d, d), scale=d ** -0.5)}
    x = torch.from_numpy(rng.standard_normal((4 * world, d)).astype(
        np.float32)).to(device)
    pipe = (pipeline_apply(tanh_stage, stages, x, group=group) ** 2).sum()
    pipe.backward()
    grads["pipeline"] = [stages["w"].grad]

    experts = {"w": tensor((world, d, d), scale=d ** -0.5)}
    tokens = slice(rank * 4, (rank + 1) * 4)
    xe = torch.from_numpy(rng.standard_normal((4 * world, d)).astype(
        np.float32)[tokens]).to(device)
    ge = torch.from_numpy(rng.standard_normal((4 * world, world)).astype(
        np.float32)[tokens]).to(device)
    moe = (moe_apply(tanh_stage, experts, xe, ge, group=group,
                     capacity_factor=4.0) ** 2).sum()
    moe.backward()
    grads["moe"] = [experts["w"].grad]

    # The ring's and the experts' losses are a rank's part of the global
    # loss; the pipeline's output is replicated, so its loss is whole.
    parts = agree(np.array([float(ring), float(moe)]), group=group)
    losses = {"ring_attention": float(parts[:, 0].sum()),
              "pipeline": float(pipe), "moe": float(parts[:, 1].sum())}
    for name, gs in grads.items():
        if not (np.isfinite(losses[name])
                and all(bool(torch.isfinite(g).all()) for g in gs)):
            raise AssertionError(f"{name}: loss or gradients not finite")
    return losses
