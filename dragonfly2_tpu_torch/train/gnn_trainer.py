"""Data-parallel GraphSAGE training (BASELINE config #2) — port of
``dragonfly2_tpu/train/gnn_trainer.py``.

The loop is the JAX trainer's: a pair-level train/eval split, a message
graph of TRAIN edges only (an eval edge's RTT, a function of its label,
never reaches a sampled neighborhood), each epoch's order from
``default_rng((seed, epoch))`` with the remainder dropped, AdamW under
optax's warmup-cosine schedule, mean sigmoid BCE, and an exact eval in
fixed-size chunks with a zero-weighted tail.

Two sampling paths, as in the JAX package:

- ``device_sample=True`` (default): the CSR tables and the node features
  live on the device, a step ships its edge ids, and fanout sampling runs
  there (``train/fused_sampling.py``). The two salts of a step (and of an
  eval chunk) come from seeded ``torch.Generator``s on the host, not from
  threefry, so the sampled neighborhoods differ from the JAX trainer's;
  the trajectories agree in distribution.
- ``device_sample=False``: the host samples each batch with
  ``default_rng((seed, epoch, step, 3))`` (eval ``(seed, 2, first id)``),
  bit-identical to the JAX trainer's batches, in prefetch threads. The
  device path has no host work to overlap and places each step's ids on
  the calling thread.

Both gather the node features on the device through ``table_gather``,
one launch a forward (the K2a kernel on the card). ``steps_per_call``
groups steps for the budget's accounting only; PyTorch runs each step
eagerly, so the trajectory does not depend on it (the JAX trainer scans
K steps a dispatch and drops an epoch's remainder group).

Data parallelism over ``group`` (``parallel/mesh.py``), the JAX mesh's
``data`` axis: every rank holds the tables and draws the same epoch
order and salts from ``config.seed`` (never from its rank); the global
batch is rounded to a multiple of the world as the JAX trainer rounds
it, and each rank takes its contiguous share of every global batch. On
the device path a rank samples its rows with their global positions in
the counter hash, so the world's neighborhoods are the world-of-one's;
on the host path each rank samples the whole global batch with the
step's generator and keeps its rows, as the JAX trainer's ``put_batch``
places them. One all-reduce a step averages the gradients and the loss;
the initial parameters are rank 0's; eval chunks split the same way and
the confusion counts are summed over the group. Pipeline and expert
parallelism are layouts of their own (``parallel/pipeline.py``,
``parallel/moe.py``), which this trainer, like the JAX package's, does
not use.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from dragonfly2_tpu_torch.data.features import Graph
from dragonfly2_tpu_torch.data.graph_sampler import CSRGraph, EdgeBatchSampler
from dragonfly2_tpu_torch.data.prefetch import prefetch
from dragonfly2_tpu_torch.device import default_device
from dragonfly2_tpu_torch.models.graphsage import GraphSAGE
from dragonfly2_tpu_torch.parallel.mesh import DataParallel, global_batch
from dragonfly2_tpu_torch.train.fused_sampling import (
    apply_indexed,
    put_edge_tables,
    put_graph_tables,
    sample_and_apply,
    train_step,
)
from dragonfly2_tpu_torch.train.metrics import (
    confusion,
    metrics_from_confusion,
    padded_chunks,
)
from dragonfly2_tpu_torch.train.schedule import warmup_cosine_lr
from dragonfly2_tpu_torch.train.split import edge_split
from dragonfly2_tpu_torch.train.step_budget import (
    StepBudget,
    block_until_ready,
)


@dataclass(frozen=True)
class GNNTrainConfig:
    hidden: int = 128
    embed: int = 64
    fanouts: tuple = (10, 5)
    learning_rate: float = 5e-3
    weight_decay: float = 1e-4
    batch_size: int = 4096
    epochs: int = 5
    seed: int = 0
    eval_fraction: float = 0.1
    # 20 ms separates same-region paths from cross-region WAN.
    rtt_threshold_ns: int = 20_000_000
    # Wall cap for the step loop (the first step excluded).
    max_seconds: Optional[float] = None
    # Publishing hooks: (steps, samples/s) every 25 budget ticks, and the
    # first step's seconds once.
    progress_callback: Optional[Callable[[int, float], None]] = None
    compile_callback: Optional[Callable[[float], None]] = None
    device_sample: bool = True
    # Steps per budget tick, as the JAX trainer's steps per dispatch.
    steps_per_call: int = 1


@dataclass
class GNNTrainResult:
    state_dict: dict           # GraphSAGE state dict, f32, on the CPU
    config: GNNTrainConfig
    node_features: np.ndarray
    precision: float
    recall: float
    f1: float
    accuracy: float
    samples_per_sec: float     # steady state, the first step excluded
    history: list = field(default_factory=list)      # mean loss per epoch
    step_losses: list = field(default_factory=list)  # loss of every step
    steps: int = 0             # budget ticks (groups of steps_per_call)
    compile_seconds: float = 0.0

    @property
    def model(self) -> GraphSAGE:
        """A bf16 GraphSAGE on the CPU holding the trained weights."""
        model = GraphSAGE(hidden=self.config.hidden, embed=self.config.embed,
                          in_features=self.node_features.shape[1])
        model.load_state_dict(self.state_dict)
        return model


class GNNTrainer:
    """One training run: tables, model and optimizer on ``device``,
    data-parallel over ``group``. :meth:`fit` is the whole run;
    :meth:`step` is one optimizer step."""

    def __init__(self, graph: Graph, config: GNNTrainConfig = GNNTrainConfig(),
                 device=None, init_state: dict | None = None, group=None):
        self.device = default_device(device)
        self.config = config
        self.dp = DataParallel(group)
        labels = graph.edge_labels(config.rtt_threshold_ns)
        self.train_ids, self.eval_ids = edge_split(
            graph, config.eval_fraction, config.seed)
        self.batch = global_batch(config.batch_size, len(self.train_ids),
                                  self.dp.world)
        if self.batch == 0:
            raise ValueError(f"train split of {len(self.train_ids)} edges "
                             f"can't fill a batch of {self.dp.world} ranks")
        train_graph = Graph(
            node_ids=graph.node_ids, node_features=graph.node_features,
            edge_src=graph.edge_src[self.train_ids],
            edge_dst=graph.edge_dst[self.train_ids],
            edge_rtt_ns=graph.edge_rtt_ns[self.train_ids])
        self.csr = CSRGraph.from_graph(train_graph)
        self.train_sampler = EdgeBatchSampler(
            self.csr, graph.edge_src[self.train_ids],
            graph.edge_dst[self.train_ids], labels[self.train_ids],
            config.fanouts)
        self.eval_sampler = EdgeBatchSampler(
            self.csr, graph.edge_src[self.eval_ids],
            graph.edge_dst[self.eval_ids], labels[self.eval_ids],
            config.fanouts)

        gen = (None if init_state is not None
               else torch.Generator().manual_seed(config.seed))
        self.model = GraphSAGE(hidden=config.hidden, embed=config.embed,
                               in_features=self.csr.node_features.shape[1],
                               generator=gen)
        if init_state is not None:
            self.model.load_state_dict(init_state)
        self.model.to(self.device)
        self.dp.broadcast_(self.model)
        self.optimizer = torch.optim.AdamW(
            self.model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=config.weight_decay)
        self.steps_per_epoch = max(self.train_sampler.n_edges // self.batch, 1)
        self.total_steps = max(config.epochs * self.steps_per_epoch, 2)
        self.warmup_steps = min(100, self.total_steps // 10 + 1)
        self.step_count = 0

        # The device path keeps the CSR tables and both edge splits on the
        # device; the host path only the node features.
        if config.device_sample:
            self.tables = put_graph_tables(self.csr, self.device)
            self.node_features = self.tables.node_features
            self.train_edges, self.eval_edges = (
                put_edge_tables(s.edge_src, s.edge_dst, s.labels, self.device)
                for s in (self.train_sampler, self.eval_sampler))
        else:
            self.tables = self.train_edges = self.eval_edges = None
            self.node_features = torch.from_numpy(np.ascontiguousarray(
                self.csr.node_features)).to(self.device)
        self._salts = torch.Generator().manual_seed(config.seed + 1)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @staticmethod
    def _draw_salts(gen: torch.Generator) -> tuple[int, int]:
        s1, s2 = torch.randint(0, 2**32, (2,), generator=gen,
                               dtype=torch.int64).tolist()
        return s1, s2

    def _place(self, ids: np.ndarray, sampler: EdgeBatchSampler,
               rng_key: tuple):
        """Host half of this rank's share of a global batch: its edge ids
        and their first global row on the device path; on the other,
        its rows of the index batch sampled for the whole global
        batch."""
        rows = self.dp.rows(len(ids))
        if self.config.device_sample:
            return self._put(np.asarray(ids[rows], np.int64)), rows.start
        batch = sampler.sample_indices(ids, np.random.default_rng(rng_key))
        return tuple(self._put(a[rows]) for a in batch.astuple())

    def _logits(self, placed, edges, salt_gen):
        """(logits, labels) for a placed batch on the device."""
        if self.config.device_sample:
            ids, row_offset = placed
            src, dst, y = (t[ids] for t in edges)
            salts = self._draw_salts(salt_gen)
            return sample_and_apply(self.model, self.tables, src, dst, salts,
                                    self.config.fanouts, row_offset), y
        *inputs, y = placed
        return apply_indexed(self.model, self.node_features, *inputs), y

    def _stream(self, tasks, build):
        """``build(task)`` for each task, in order: in prefetch threads
        on the host path, whose sampling overlaps the device's steps; on
        this thread on the device path, which only ships ids."""
        if self.config.device_sample:
            return (build(task) for task in tasks)
        return prefetch(tasks, build)

    def _step_placed(self, placed) -> torch.Tensor:
        lr = warmup_cosine_lr(self.step_count, self.config.learning_rate,
                              self.warmup_steps, self.total_steps)
        loss = train_step(self.optimizer, lambda: self._logits(
            placed, self.train_edges, self._salts), lr, self.dp)
        self.step_count += 1
        return loss

    def _place_train(self, task):
        """(epoch, step, ids) → (epoch, step, placed batch); the host path
        samples with the JAX trainer's generator key for that step."""
        epoch, step, ids = task
        return epoch, step, self._place(ids, self.train_sampler,
                                        (self.config.seed, epoch, step, 3))

    def step(self, ids: np.ndarray, epoch: int = 0,
             step: int = 0) -> torch.Tensor:
        """One AdamW step on the global batch of train-split positions
        ``ids``, of which this rank takes its share; returns the loss
        over the global batch (a 0-d tensor on the device, not waited
        for). ``epoch`` and ``step`` key the host path's sampling
        generator."""
        return self._step_placed(self._place_train((epoch, step, ids))[2])

    @torch.no_grad()
    def evaluate(self) -> dict:
        """Exact eval over the eval split in fixed-size chunks with a
        zero-weighted tail, each rank scoring its share of a chunk and
        the counts summed over the group →
        precision/recall/f1/accuracy."""
        config = self.config
        cm = torch.zeros(4, dtype=torch.float32, device=self.device)
        salt_gen = torch.Generator().manual_seed(config.seed + 2)

        def build(chunk):
            ids, weights = chunk
            key = (config.seed, 2, ids[0] if len(ids) else 0)
            return (self._place(ids, self.eval_sampler, key),
                    self._put(weights[self.dp.rows(len(weights))]))

        for placed, weights in self._stream(
                padded_chunks(np.arange(self.eval_sampler.n_edges),
                              self.batch), build):
            logits, y = self._logits(placed, self.eval_edges, salt_gen)
            cm += confusion(logits, y, weights)
        cm = self.dp.sum_(cm)
        return metrics_from_confusion(cm.cpu().numpy().astype(np.float64))

    def _tasks(self):
        n, batch = self.train_sampler.n_edges, self.batch
        for epoch in range(self.config.epochs):
            order = np.random.default_rng((self.config.seed, epoch)
                                          ).permutation(n)
            for step, start in enumerate(range(0, n - batch + 1, batch)):
                yield epoch, step, order[start:start + batch]

    def fit(self) -> GNNTrainResult:
        config, batch = self.config, self.batch
        budget = StepBudget(config.max_seconds,
                            on_compile=config.compile_callback,
                            on_progress=config.progress_callback)
        k = max(min(int(config.steps_per_call), self.steps_per_epoch), 1)
        history, step_losses, losses = [], [], []

        def close_epoch():
            if losses:
                epoch_losses = torch.stack(losses)
                history.append(float(epoch_losses.mean()))
                step_losses.extend(epoch_losses.tolist())
                losses.clear()

        stream = self._stream(self._tasks(), self._place_train)
        current_epoch, in_group = 0, 0
        for epoch, step, placed in stream:
            if epoch != current_epoch:
                close_epoch()
                current_epoch = epoch
            losses.append(self._step_placed(placed))
            in_group += 1
            # A budget tick closes each group of k steps and an epoch's
            # last (possibly shorter) group.
            if in_group == k or step == self.steps_per_epoch - 1:
                done = self.dp.any(budget.tick(in_group * batch, losses[-1]),
                                   self.device)
                in_group = 0
                if done:
                    stream.close()
                    break
        close_epoch()
        block_until_ready(next(self.model.parameters()))
        budget.finish()
        metrics = self.evaluate()
        return GNNTrainResult(
            state_dict={name: t.detach().cpu().clone()
                        for name, t in self.model.state_dict().items()},
            config=config,
            node_features=self.csr.node_features,
            precision=metrics["precision"],
            recall=metrics["recall"],
            f1=metrics["f1"],
            accuracy=metrics["accuracy"],
            samples_per_sec=budget.samples_per_sec(batch * k),
            history=history,
            step_losses=step_losses,
            steps=budget.steps,
            compile_seconds=budget.compile_seconds,
        )


def train_gnn(graph: Graph, config: GNNTrainConfig = GNNTrainConfig(),
              device=None, init_state: dict | None = None,
              group=None) -> GNNTrainResult:
    """Train a GraphSAGE on ``graph``. ``device=None`` means the card;
    ``init_state`` is a GraphSAGE state dict to start from (else a seeded
    init); ``group`` is the data-parallel process group
    (``parallel/mesh.py``), every rank passing the same graph."""
    return GNNTrainer(graph, config, device, init_state, group).fit()
