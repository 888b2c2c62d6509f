"""Full-graph GraphTransformer training (BASELINE config #3), data- and
tensor-parallel — port of ``dragonfly2_tpu/train/gat_trainer.py``.

Every mode trains on the card. The inverse index of the neighbor lists
(``build_inverse_index``) is built once per graph and placed on the
device once: in gather mode the neighbor gather's backward (the
``table_scatter_add`` kernel) walks it, in blocks and flash mode, and in
ring mode on a data axis of one, the backward of
``graph_flash_attention`` (K1) does.

Placement over a ``(data, model)`` grid of ranks (``grid=``, from
``parallel/mesh.grid_groups``; ``group=`` alone is a grid whose every
rank is on the data axis), as the JAX trainer places its state on its
mesh:

- the node rows shard over ``data`` in every mode, as JAX's
  ``shard_spec("data")``: they pad to a multiple of ``n_data`` (gather
  and flash mode), of ``lcm(n_data, chunk)`` once the graph exceeds one
  key block (blocks mode) or of ``n_data · chunk`` once a rank's rows
  exceed one chunk (ring mode), and each rank places only its rows of
  the features and neighbor lists, with the inverse index of its rows
  over every key row. The model all-gathers K/V (or, in ring mode,
  passes K/V blocks around the ring) and the embedding table
  (``models/graph_transformer.py``). The global edge batch is rounded to
  a multiple of ``n_data`` and each data rank scores its contiguous
  share of it (the same epoch order on every rank, from ``config.seed``);
  the all-gathers' backwards sum every rank's gradient of a rank's rows,
  and one all-reduce a step over ``data`` then averages the gradients
  and the loss.
- the attention blocks' Dense layers split over ``model`` as
  ``tp_state_shardings`` splits them (:func:`tp_shard_state`), with the
  JAX trainer's refusals; AdamW is elementwise, so its moments over a
  shard are JAX's sharded moments. The result carries the whole state
  (:func:`tp_gather_state`), so its artifact serves in a world of one.

The loop is the JAX trainer's: the attention structure is built from
TRAIN edges only (an eval edge's RTT, a function of its label, never
reaches the message structure), the same seeded batch order, AdamW under
optax's warmup-cosine schedule, mean sigmoid BCE, and an exact eval in
fixed-size chunks. ``steps_per_call`` groups steps for the budget's
accounting only; PyTorch runs each step eagerly, so the trajectory does
not depend on it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from dragonfly2_tpu_torch.data.features import Graph
from dragonfly2_tpu_torch.device import default_device
from dragonfly2_tpu_torch.models.graph_transformer import (
    COLUMN,
    ROW,
    GraphTransformer,
    build_inverse_index,
    build_neighbor_lists,
    check_tensor_parallel,
    pad_graph_sparse,
    pad_multiple,
    shard,
)
from dragonfly2_tpu_torch.ops.flash_attention import check_graph_flash_heads
from dragonfly2_tpu_torch.parallel.mesh import (
    LOCAL,
    DataParallel,
    Grid,
    all_gather_rows,
    global_batch,
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
    # "gather" | "blocks" | "flash" | "ring" (rows sharded over the
    # ranks; K/V blocks travel around the ring).
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
        """A bf16 GraphTransformer on the CPU holding the trained weights,
        over the whole graph in this process alone."""
        cfg = self.config
        model = GraphTransformer(
            in_features=self.node_features.shape[1], hidden=cfg.hidden,
            embed=cfg.embed, layers=cfg.layers, heads=cfg.heads,
            chunk=cfg.chunk, attention=cfg.attention, group=LOCAL)
        model.load_state_dict(self.state_dict)
        return model


_TP_KEY = re.compile(r"blocks\.\d+\.Dense_(\d)\.(weight|bias)")


def _tp_dim(key: str) -> int | None:
    """The dim along which ``tp_state_shardings`` shards a state-dict key
    over ``model`` — 0 for column kernels and biases (their output
    features; torch's kernels are ``[out, in]``), 1 for row kernels
    (their input features) — or None for what replicates."""
    match = _TP_KEY.fullmatch(key)
    if match is None:
        return None
    index, leaf = int(match.group(1)), match.group(2)
    if index in COLUMN:
        return 0
    if index in ROW and leaf == "weight":
        return 1
    return None


def tp_shard_state(state_dict: dict, grid: Grid) -> dict:
    """This rank's slices of a whole GraphTransformer state dict under
    the Megatron placement (the JAX trainer's ``tp_state_shardings``):
    what a rank of ``grid`` loads. Shards are contiguous copies; what
    replicates is passed through."""
    if grid.n_model == 1:
        return dict(state_dict)
    out = {}
    for key, value in state_dict.items():
        dim = _tp_dim(key)
        if dim is not None:
            part = shard(value.shape[dim], grid.n_model, grid.model_rank)
            value = value.narrow(dim, part.start,
                                 part.stop - part.start).contiguous()
        out[key] = value
    return out


@torch.no_grad()
def tp_gather_state(module: torch.nn.Module, grid: Grid) -> dict:
    """The whole state dict of a model placed on ``grid``, on the CPU:
    the shards all-gathered over ``model`` in one exchange of one flat
    f32 buffer (the inverse of :func:`tp_shard_state`). Every rank of
    the model axis calls it alike."""
    state = module.state_dict()
    sharded = ([k for k in state if _tp_dim(k) is not None]
               if grid.n_model > 1 else [])
    whole = {k: v.detach().cpu().clone() for k, v in state.items()}
    if not sharded:
        return whole
    flat = torch.cat([state[k].reshape(-1).float() for k in sharded])
    parts = all_gather_rows(flat[None], grid.model).cpu()
    offset = 0
    for key in sharded:
        size = state[key].numel()
        pieces = [p[offset:offset + size].view(state[key].shape)
                  for p in parts]
        whole[key] = torch.cat(pieces, dim=_tp_dim(key)).to(
            state[key].dtype)
        offset += size
    return whole


class GATTrainer:
    """One training run: the graph, model and optimizer on ``device``,
    placed on ``grid`` (or data-parallel over ``group``). :meth:`fit` is
    the whole run; :meth:`step` is one optimizer step."""

    def __init__(self, graph: Graph, config: GATTrainConfig = GATTrainConfig(),
                 device=None, init_state: dict | None = None, group=None,
                 grid: Grid | None = None):
        self.device = default_device(device)
        self.config = config
        self.grid = Grid.of(group) if grid is None else grid
        n_model = self.grid.n_model
        check_tensor_parallel(config.attention, config.hidden, config.heads,
                              n_model)
        if n_model > 1 and config.attention in ("blocks", "flash") and (
                self.device.type == "cuda"):
            # K1 runs a rank's head share; refuse one it does not take
            # before anything is placed.
            check_graph_flash_heads(config.heads // n_model,
                                    config.hidden // config.heads)
        self.dp = DataParallel(self.grid.data)
        # The model axis agrees on when a budget stops (its ranks' steps
        # pair up in every exchange of a layer).
        self.mp = DataParallel(self.grid.model)
        n_data = self.dp.world
        # Pair-level split: every sighting of an eval (src, dst) pair
        # stays out of training AND out of the attention bias.
        self.train_ids, self.eval_ids = edge_split(
            graph, config.eval_fraction, config.seed)
        nbr, val = build_neighbor_lists(
            graph.n_nodes, graph.edge_src[self.train_ids],
            graph.edge_dst[self.train_ids], graph.edge_rtt_ns[self.train_ids],
            cap=config.neighbor_cap)
        # Rows pad as the JAX trainer's: to whole key blocks in blocks
        # mode, to whole chunks a rank in ring mode once a rank's rows
        # exceed one, else to the data axis.
        if config.attention == "blocks":
            multiple = pad_multiple(n_data, config.chunk, graph.n_nodes)
        elif config.attention == "ring":
            per_rank = -(-graph.n_nodes // n_data)
            multiple = (n_data * config.chunk if per_rank > config.chunk
                        else n_data)
        else:
            multiple = n_data
        self.node_features, self.nbr, self.val, self.n_real = pad_graph_sparse(
            graph.node_features, nbr, val, multiple)
        self.sharded = n_data > 1

        gen = (None if init_state is not None
               else torch.Generator().manual_seed(config.seed))
        self.model = GraphTransformer(
            in_features=self.node_features.shape[1], hidden=config.hidden,
            embed=config.embed, layers=config.layers, heads=config.heads,
            chunk=config.chunk, attention=config.attention, generator=gen,
            grid=self.grid)
        if init_state is not None:
            self.model.load_state_dict(tp_shard_state(init_state, self.grid))
        self.model.to(self.device)
        self.dp.broadcast_(self.model)
        self.optimizer = torch.optim.AdamW(
            self.model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=config.weight_decay)

        self.batch = global_batch(config.edge_batch_size,
                                  len(self.train_ids), self.dp.world)
        if self.batch == 0:
            raise ValueError(f"train split of {len(self.train_ids)} edges "
                             f"can't fill a batch of {self.dp.world} ranks")
        self.steps_per_epoch = max(len(self.train_ids) // self.batch, 1)
        self.total_steps = max(config.epochs * self.steps_per_epoch, 2)
        self.warmup_steps = min(100, self.total_steps // 10 + 1)
        self.step_count = 0

        # This rank's rows of the graph tensors, the inverse index of its
        # rows over every key row (which the sharded ring does not walk)
        # and the edge arrays go to the device once; a step sends only
        # its edge ids.
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(  # noqa: E731
            self.device)
        rows = self.dp.rows(len(self.nbr))
        self.g_feat, self.g_nbr, self.g_val = (
            put(a[rows]) for a in (self.node_features, self.nbr, self.val))
        self.g_inv = (None if self.sharded and config.attention == "ring"
                      else put(build_inverse_index(self.nbr[rows],
                                                   len(self.nbr))))
        self.g_src = put(graph.edge_src.astype(np.int32))
        self.g_dst = put(graph.edge_dst.astype(np.int32))
        self.g_y = put(graph.edge_labels(config.rtt_threshold_ns).astype(
            np.float32))

    def _edges(self, ids: np.ndarray):
        """(src, dst, labels) of this rank's share of the global edge
        batch ``ids``, on the device."""
        ids = np.asarray(ids, np.int64)[self.dp.rows(len(ids))]
        ids = torch.from_numpy(ids).to(self.device)
        return self.g_src[ids], self.g_dst[ids], self.g_y[ids]

    def step(self, ids: np.ndarray) -> torch.Tensor:
        """One AdamW step on the global edge batch ``ids``, of which this
        rank takes its share; returns the loss over the global batch (a
        0-d tensor on the device, not waited for). The learning rate is
        the schedule at the step count before the update, as optax's."""
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
        loss = self.dp.allreduce_grads_(self.model.parameters(), loss)
        self.optimizer.step()
        self.step_count += 1
        return loss.detach()

    @torch.no_grad()
    def evaluate(self) -> dict:
        """Exact eval over the eval edges in fixed-size chunks with a
        zero-weighted tail, each rank scoring its share of a chunk and
        the counts summed over the group →
        precision/recall/f1/accuracy."""
        cm = torch.zeros(4, dtype=torch.float32, device=self.device)
        for ids, weights in padded_chunks(self.eval_ids, self.batch):
            src, dst, y = self._edges(ids)
            w = torch.from_numpy(weights[self.dp.rows(len(weights))]).to(
                self.device)
            logits = self.model(self.g_feat, self.g_nbr, self.g_val, src, dst)
            cm += confusion(logits, y, w)
        cm = self.dp.sum_(cm)
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
                if self.mp.any(self.dp.any(
                        budget.tick(gk * batch, losses[-1]), self.device),
                        self.device):
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
            state_dict=tp_gather_state(self.model, self.grid),
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
              device=None, init_state: dict | None = None,
              group=None, grid: Grid | None = None) -> GATTrainResult:
    """Train a GraphTransformer on ``graph``. ``device=None`` means the
    card; ``init_state`` is a whole GraphTransformer state dict to start
    from (else a seeded init); ``grid`` is the ``(data, model)`` grid of
    ranks (``parallel/mesh.grid_groups``), or ``group`` the data-parallel
    process group, every rank passing the same graph."""
    return GATTrainer(graph, config, device, init_state, group, grid).fit()
