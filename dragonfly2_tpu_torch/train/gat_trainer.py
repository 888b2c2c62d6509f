"""Full-graph GraphTransformer training (BASELINE config #3) on one device —
port of ``dragonfly2_tpu/train/gat_trainer.py``.

Gather mode is the card's path: the neighbor gather's backward is the
``table_scatter_add`` kernel over the inverse index, built once per graph
(``build_inverse_index``) and placed on the device once. Blocks and flash
modes train on the CPU only (their kernel has no backward on the card
yet); ring mode and meshes belong to the parallel slice (ROADMAP.md
Queue 1).

The loop is the JAX trainer's: the attention structure is built from
TRAIN edges only (an eval edge's RTT, a function of its label, never
reaches the message structure), the same seeded batch order, AdamW under
optax's warmup-cosine schedule, mean sigmoid BCE, and an exact eval in
fixed-size chunks. ``steps_per_call`` groups steps for the budget's
accounting only; PyTorch runs each step eagerly, so the trajectory does
not depend on it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from dragonfly2_tpu_torch.data.features import Graph
from dragonfly2_tpu_torch.device import default_device
from dragonfly2_tpu_torch.models.graph_transformer import (
    GraphTransformer,
    build_inverse_index,
    build_neighbor_lists,
    pad_graph_sparse,
    pad_multiple,
)
from dragonfly2_tpu_torch.train.metrics import (
    metrics_from_confusion,
    padded_chunks,
)
from dragonfly2_tpu_torch.train.split import edge_split
from dragonfly2_tpu_torch.train.step_budget import (
    StepBudget,
    block_until_ready,
)


@dataclass(frozen=True)
class GATTrainConfig:
    hidden: int = 128
    embed: int = 64
    layers: int = 2
    heads: int = 4
    learning_rate: float = 3e-3
    weight_decay: float = 1e-4
    edge_batch_size: int = 4096
    epochs: int = 5
    seed: int = 0
    eval_fraction: float = 0.1
    rtt_threshold_ns: int = 20_000_000
    # Key-block width of the blocks modes and per-node neighbor cap
    # (best-K by RTT bias; self always survives).
    chunk: int = 1024
    neighbor_cap: int = 128
    # "gather" (the card's path) | "blocks" | "flash" (CPU only here).
    attention: str = "gather"
    # Steps per budget tick, as the JAX trainer's steps per dispatch.
    steps_per_call: int = 1
    # Wall cap for the step loop plus incremental publishing hooks.
    max_seconds: float | None = None
    progress_callback: object = None
    compile_callback: object = None


@dataclass
class GATTrainResult:
    state_dict: dict           # GraphTransformer state dict, f32, on the CPU
    config: GATTrainConfig
    node_features: np.ndarray  # padded
    neighbors: np.ndarray      # [N, K] int32 (PAD_ID padded)
    neighbor_vals: np.ndarray  # [N, K] float32 RTT biases
    n_real_nodes: int
    precision: float
    recall: float
    f1: float
    accuracy: float
    samples_per_sec: float
    history: list = field(default_factory=list)      # mean loss per epoch
    step_losses: list = field(default_factory=list)  # loss of every step

    @property
    def model(self) -> GraphTransformer:
        """A bf16 GraphTransformer on the CPU holding the trained weights."""
        cfg = self.config
        model = GraphTransformer(
            in_features=self.node_features.shape[1], hidden=cfg.hidden,
            embed=cfg.embed, layers=cfg.layers, heads=cfg.heads,
            chunk=cfg.chunk, attention=cfg.attention)
        model.load_state_dict(self.state_dict)
        return model


def warmup_cosine_lr(step: int, peak: float, warmup_steps: int,
                     decay_steps: int) -> float:
    """optax ``warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps)`` at ``step``: linear from 0 over the warmup, then a
    cosine down to 0 over the remaining steps."""
    if step < warmup_steps:
        frac = 1.0 - min(max(step, 0), warmup_steps) / warmup_steps
        return -peak * frac + peak
    span = decay_steps - warmup_steps
    count = min(step - warmup_steps, span)
    return peak * 0.5 * (1.0 + math.cos(math.pi * count / span))


class GATTrainer:
    """One training run: the graph, model and optimizer on ``device``.
    :meth:`fit` is the whole run; :meth:`step` is one optimizer step."""

    def __init__(self, graph: Graph, config: GATTrainConfig = GATTrainConfig(),
                 device=None, init_state: dict | None = None):
        if config.attention == "ring":
            raise NotImplementedError(
                "ring attention needs a mesh of several devices; it comes "
                "with the parallel slice (ROADMAP.md Queue 1)")
        self.device = default_device(device)
        if self.device.type == "cuda" and config.attention != "gather":
            raise NotImplementedError(
                f"attention={config.attention!r} trains on the CPU only: the "
                "graph_flash_attention kernel has no backward on the card "
                "yet (ROADMAP.md Queue 1); train in gather mode")
        self.config = config
        # Pair-level split: every sighting of an eval (src, dst) pair
        # stays out of training AND out of the attention bias.
        self.train_ids, self.eval_ids = edge_split(
            graph, config.eval_fraction, config.seed)
        nbr, val = build_neighbor_lists(
            graph.n_nodes, graph.edge_src[self.train_ids],
            graph.edge_dst[self.train_ids], graph.edge_rtt_ns[self.train_ids],
            cap=config.neighbor_cap)
        # Blocks modes pad rows to whole key blocks; gather mode on one
        # device needs no padding.
        multiple = (pad_multiple(1, config.chunk, graph.n_nodes)
                    if config.attention == "blocks" else 1)
        self.node_features, self.nbr, self.val, self.n_real = pad_graph_sparse(
            graph.node_features, nbr, val, multiple)

        gen = (None if init_state is not None
               else torch.Generator().manual_seed(config.seed))
        self.model = GraphTransformer(
            in_features=self.node_features.shape[1], hidden=config.hidden,
            embed=config.embed, layers=config.layers, heads=config.heads,
            chunk=config.chunk, attention=config.attention, generator=gen)
        if init_state is not None:
            self.model.load_state_dict(init_state)
        self.model.to(self.device)
        self.optimizer = torch.optim.AdamW(
            self.model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=config.weight_decay)

        self.batch = min(config.edge_batch_size, len(self.train_ids))
        self.steps_per_epoch = max(len(self.train_ids) // self.batch, 1)
        self.total_steps = max(config.epochs * self.steps_per_epoch, 2)
        self.warmup_steps = min(100, self.total_steps // 10 + 1)
        self.step_count = 0

        # Graph tensors, the inverse index (gather mode) and the edge
        # arrays go to the device once; a step sends only its edge ids.
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(  # noqa: E731
            self.device)
        self.g_feat, self.g_nbr, self.g_val = (
            put(a) for a in (self.node_features, self.nbr, self.val))
        self.g_inv = (put(build_inverse_index(self.nbr))
                      if config.attention == "gather" else None)
        self.g_src = put(graph.edge_src.astype(np.int32))
        self.g_dst = put(graph.edge_dst.astype(np.int32))
        self.g_y = put(graph.edge_labels(config.rtt_threshold_ns).astype(
            np.float32))

    def _edges(self, ids: np.ndarray):
        ids = torch.from_numpy(np.asarray(ids, np.int64)).to(self.device)
        return self.g_src[ids], self.g_dst[ids], self.g_y[ids]

    def step(self, ids: np.ndarray) -> torch.Tensor:
        """One AdamW step on the edges ``ids``; returns the loss (a 0-d
        tensor on the device, not waited for). The learning rate is the
        schedule at the step count before the update, as optax's."""
        lr = warmup_cosine_lr(self.step_count, self.config.learning_rate,
                              self.warmup_steps, self.total_steps)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        src, dst, y = self._edges(ids)
        self.optimizer.zero_grad(set_to_none=True)
        logits = self.model(self.g_feat, self.g_nbr, self.g_val, src, dst,
                            inv=self.g_inv)
        loss = F.binary_cross_entropy_with_logits(logits, y)
        loss.backward()
        self.optimizer.step()
        self.step_count += 1
        return loss.detach()

    @torch.no_grad()
    def evaluate(self) -> dict:
        """Exact eval over the eval edges in fixed-size chunks with a
        zero-weighted tail → precision/recall/f1/accuracy."""
        cm = torch.zeros(4, dtype=torch.float32, device=self.device)
        for ids, weights in padded_chunks(self.eval_ids, self.batch):
            src, dst, y = self._edges(ids)
            w = torch.from_numpy(weights).to(self.device)
            logits = self.model(self.g_feat, self.g_nbr, self.g_val, src, dst)
            pred = (logits > 0).float()
            cm += torch.stack([(w * pred * y).sum(),
                               (w * pred * (1 - y)).sum(),
                               (w * (1 - pred) * y).sum(),
                               (w * (1 - pred) * (1 - y)).sum()])
        return metrics_from_confusion(cm.cpu().numpy().astype(np.float64))

    def fit(self) -> GATTrainResult:
        config, batch = self.config, self.batch
        rng = np.random.default_rng((config.seed, 7))
        budget = StepBudget(config.max_seconds,
                            on_compile=config.compile_callback,
                            on_progress=config.progress_callback)
        k = max(min(int(config.steps_per_call), self.steps_per_epoch), 1)
        group_sizes = [k] * (self.steps_per_epoch // k)
        if self.steps_per_epoch % k:
            group_sizes.append(self.steps_per_epoch % k)
        history, step_losses = [], []
        stop = False
        for _ in range(config.epochs):
            order = rng.permutation(self.train_ids)
            losses = []
            offset = 0
            for gk in group_sizes:
                ids = order[offset * batch:(offset + gk) * batch]
                offset += gk
                if len(ids) < gk * batch:
                    break
                for ids_1 in ids.reshape(gk, batch):
                    losses.append(self.step(ids_1))
                if budget.tick(gk * batch, losses[-1]):
                    stop = True
                    break
            if losses:
                epoch = torch.stack(losses)
                history.append(float(epoch.mean()))
                step_losses.extend(epoch.tolist())
            if stop:
                break
        block_until_ready(next(self.model.parameters()))
        budget.finish()
        metrics = self.evaluate()
        return GATTrainResult(
            state_dict={name: t.detach().cpu().clone()
                        for name, t in self.model.state_dict().items()},
            config=config,
            node_features=self.node_features,
            neighbors=self.nbr,
            neighbor_vals=self.val,
            n_real_nodes=self.n_real,
            precision=metrics["precision"],
            recall=metrics["recall"],
            f1=metrics["f1"],
            accuracy=metrics["accuracy"],
            samples_per_sec=budget.samples_per_sec(batch),
            history=history,
            step_losses=step_losses,
        )


def train_gat(graph: Graph, config: GATTrainConfig = GATTrainConfig(),
              device=None, init_state: dict | None = None) -> GATTrainResult:
    """Train a GraphTransformer on ``graph``. ``device=None`` means the
    card; ``init_state`` is a GraphTransformer state dict to start from
    (else a seeded init)."""
    return GATTrainer(graph, config, device, init_state).fit()
