"""Data-parallel MLP bandwidth-predictor training (BASELINE config #1) —
port of ``dragonfly2_tpu/train/mlp_trainer.py``.

The loop is the JAX trainer's: a seeded train/eval split
(``ArrayDataset.split``), feature and target normalizers fitted on the
train split, the target ``log1p(MB/s)`` standardized, each epoch's rows in
``ArrayDataset`` order with the remainder dropped, AdamW under optax's
warmup-cosine schedule, the f32 mean square of the bf16 model's f32
output against the f32 target, and eval MSE/MAE on the raw MB/s scale
through ``expm1``.

The normalized train and eval splits live on the device; a step gathers
its batch there by the epoch's numpy permutation, uploaded once an
epoch, so it ships no features.

Data parallelism over ``group`` (``parallel/mesh.py``), the JAX mesh's
``data`` axis: every rank holds both splits and draws the same epoch
order from ``config.seed`` (never from its rank); the global batch is
rounded to a multiple of the world as the JAX trainer rounds it, each
rank steps on its contiguous share, and one all-reduce a step averages
the gradients and the loss. The initial parameters are rank 0's. Eval
sums are taken over each rank's share of every chunk and summed over
the group. Tensor parallelism (the ``(data, model)`` grid,
``parallel/mesh.grid_groups``), pipeline and expert parallelism are
layouts of their own, which this trainer, like the JAX package's, does
not use: the GraphTransformer's trainer takes the grid.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from dragonfly2_tpu_torch.data.pipeline import ArrayDataset
from dragonfly2_tpu_torch.device import default_device
from dragonfly2_tpu_torch.models.mlp import MLPBandwidthPredictor, Normalizer
from dragonfly2_tpu_torch.parallel.mesh import DataParallel, global_batch
from dragonfly2_tpu_torch.train.checkpoint import (
    flax_from_mlp_state_dict,
    mlp_state_dict_from_flax,
)
from dragonfly2_tpu_torch.train.schedule import warmup_cosine_lr
from dragonfly2_tpu_torch.train.step_budget import (
    StepBudget,
    block_until_ready,
)


@dataclass(frozen=True)
class MLPTrainConfig:
    hidden: Sequence[int] = (128, 128, 64)
    learning_rate: float = 3e-3
    weight_decay: float = 1e-4
    batch_size: int = 8192
    epochs: int = 5
    seed: int = 0
    eval_fraction: float = 0.1
    warmup_steps: int = 100
    # Wall-clock budget for the step loop (the first step excluded);
    # None = run all epochs.
    max_seconds: float | None = None
    # Publishing hooks: (steps, samples/s) every 25 steps, and the first
    # step's seconds once.
    progress_callback: object = None
    compile_callback: object = None


@dataclass
class MLPTrainResult:
    params: dict               # flax layout {"params": {...}}, numpy f32
    normalizer: Normalizer
    target_norm: Normalizer    # over log1p(y)
    config: MLPTrainConfig
    # Registry metrics on the raw MB/s scale (NaN without an eval split).
    mse: float
    mae: float
    samples_per_sec: float     # steady state, the first step excluded
    history: list = field(default_factory=list)      # mean loss per epoch
    step_losses: list = field(default_factory=list)  # loss of every step

    @property
    def model(self) -> MLPBandwidthPredictor:
        """A bf16 MLPBandwidthPredictor on the CPU holding the trained
        weights."""
        model = MLPBandwidthPredictor(
            hidden=tuple(self.config.hidden),
            in_features=len(self.normalizer.mean))
        model.load_state_dict(mlp_state_dict_from_flax(self.params))
        return model


def mlp_loss(model: MLPBandwidthPredictor, x: torch.Tensor,
             target: torch.Tensor) -> torch.Tensor:
    """Mean square of the model's (f32) prediction against the f32
    standardized target, in f32 — flax's promotion of the bf16 output."""
    return ((model(x) - target) ** 2).mean()


def adamw(model: MLPBandwidthPredictor,
          weight_decay: float) -> torch.optim.AdamW:
    """optax ``adamw``'s defaults (b1 0.9, b2 0.999, eps 1e-8, decay on
    every parameter); the learning rate is set each step."""
    return torch.optim.AdamW(model.parameters(), lr=0.0, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def train_step(model: MLPBandwidthPredictor, optimizer, x: torch.Tensor,
               target: torch.Tensor, lr: float,
               dp: DataParallel | None = None) -> torch.Tensor:
    """One optimizer step on :func:`mlp_loss` at learning rate ``lr``,
    the gradients averaged over ``dp``'s group; returns the loss (its
    mean over the group; a 0-d tensor on the device, not waited for)."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.zero_grad(set_to_none=True)
    loss = mlp_loss(model, x, target)
    loss.backward()
    if dp is not None:
        loss = dp.allreduce_grads_(model.parameters(), loss)
    optimizer.step()
    return loss.detach()


def _state_dict(init_params) -> dict:
    """A flax tree (bare or ``{"params": …}``) or a port state dict → a
    port state dict."""
    if any("." in key for key in init_params):
        return init_params
    return mlp_state_dict_from_flax(init_params)


class MLPTrainer:
    """One training run: normalized splits, model and optimizer on
    ``device``, data-parallel over ``group``. :meth:`fit` is the whole
    run; :meth:`step` one optimizer step."""

    def __init__(self, X: np.ndarray, y: np.ndarray,
                 config: MLPTrainConfig = MLPTrainConfig(), device=None, *,
                 init_params=None, normalizer: Normalizer | None = None,
                 target_norm: Normalizer | None = None, group=None):
        self.device = default_device(device)
        self.config = config
        self.dp = DataParallel(group)
        train_ds, eval_ds = ArrayDataset(X, y).split(config.eval_fraction,
                                                     config.seed)
        self.train_ds = train_ds
        # The global batch may not exceed the train split, or no batch
        # would ever be yielded, and splits evenly over the group.
        self.batch = global_batch(config.batch_size, len(train_ds),
                                  self.dp.world)
        if self.batch == 0:
            raise ValueError(f"train split of {len(train_ds)} rows can't "
                             f"fill a batch of {self.dp.world} ranks")
        if normalizer is None:
            normalizer = Normalizer.fit(train_ds.arrays[0])
        if target_norm is None:
            target_norm = Normalizer.fit(np.log1p(train_ds.arrays[1])[:, None])
        self.normalizer, self.target_norm = normalizer, target_norm
        self.t_mean = float(target_norm.mean[0])
        self.t_std = float(target_norm.std[0])

        put = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a, np.float32)).to(self.device)
        self.train_x = put(normalizer(train_ds.arrays[0]))
        self.train_t = (torch.log1p(put(train_ds.arrays[1])) - self.t_mean
                        ) / self.t_std
        self.eval_x = put(normalizer(eval_ds.arrays[0]))
        self.eval_y = put(eval_ds.arrays[1])

        gen = (None if init_params is not None
               else torch.Generator().manual_seed(config.seed))
        self.model = MLPBandwidthPredictor(hidden=tuple(config.hidden),
                                           in_features=X.shape[1],
                                           generator=gen)
        if init_params is not None:
            self.model.load_state_dict(_state_dict(init_params))
        self.model.to(self.device)
        self.dp.broadcast_(self.model)
        self.optimizer = adamw(self.model, config.weight_decay)
        self.steps_per_epoch = max(len(train_ds) // self.batch, 1)
        self.total_steps = max(config.epochs * self.steps_per_epoch, 2)
        self.warmup_steps = min(config.warmup_steps,
                                self.total_steps // 10 + 1)
        self.step_count = 0

    def epoch_order(self, epoch: int) -> torch.Tensor:
        """Epoch ``epoch``'s row order on the device: the permutation
        ``ArrayDataset.batches`` takes its batches from."""
        order = self.train_ds.epoch_order(seed=self.config.seed, epoch=epoch)
        return torch.from_numpy(order).to(self.device)

    def step(self, idx: torch.Tensor) -> torch.Tensor:
        """One AdamW step on the global batch of train rows ``idx`` (on
        the device), of which this rank takes its share; returns the
        loss over the global batch (a 0-d tensor on the device, not
        waited for)."""
        lr = warmup_cosine_lr(self.step_count, self.config.learning_rate,
                              self.warmup_steps, self.total_steps)
        idx = idx[self.dp.rows(len(idx))]
        loss = train_step(self.model, self.optimizer,
                          self.train_x.index_select(0, idx),
                          self.train_t.index_select(0, idx), lr, self.dp)
        self.step_count += 1
        return loss

    @torch.no_grad()
    def evaluate(self) -> tuple[float, float]:
        """(MSE, MAE) of the eval split on the raw MB/s scale, in chunks
        of the global batch, each rank scoring its share of a chunk and
        the sums added over the group; NaN when the split is empty."""
        n = len(self.eval_y)
        if n == 0:
            return float("nan"), float("nan")
        sums = torch.zeros(2, dtype=torch.float64, device=self.device)
        for start in range(0, n, self.batch):
            rows = self.dp.rows(min(self.batch, n - start))
            rows = slice(start + rows.start, start + rows.stop)
            pred = torch.expm1(self.model(self.eval_x[rows]) * self.t_std
                               + self.t_mean)
            err = pred - self.eval_y[rows]
            sums[0] += (err ** 2).sum().double()
            sums[1] += err.abs().sum().double()
        se, ae = self.dp.sum_(sums).tolist()
        return se / n, ae / n

    def fit(self) -> MLPTrainResult:
        config, batch = self.config, self.batch
        budget = StepBudget(config.max_seconds,
                            on_compile=config.compile_callback,
                            on_progress=config.progress_callback)
        history, step_losses = [], []
        stop = False
        for epoch in range(config.epochs):
            order = self.epoch_order(epoch)
            losses = []
            for start in range(0, len(order) - batch + 1, batch):
                losses.append(self.step(order[start:start + batch]))
                if self.dp.any(budget.tick(batch, losses[-1]),
                               self.device):
                    stop = True
                    break
            if losses:
                epoch_losses = torch.stack(losses)
                history.append(float(epoch_losses.mean()))
                step_losses.extend(epoch_losses.tolist())
            if stop:
                break
        block_until_ready(next(self.model.parameters()))
        budget.finish()
        mse, mae = self.evaluate()
        state = {name: t.detach().cpu().clone()
                 for name, t in self.model.state_dict().items()}
        return MLPTrainResult(
            params={"params": flax_from_mlp_state_dict(state)},
            normalizer=self.normalizer,
            target_norm=self.target_norm,
            config=config,
            mse=mse,
            mae=mae,
            samples_per_sec=budget.samples_per_sec(batch),
            history=history,
            step_losses=step_losses,
        )


def train_mlp(X: np.ndarray, y: np.ndarray,
              config: MLPTrainConfig = MLPTrainConfig(), device=None, *,
              init_params=None, normalizer: Normalizer | None = None,
              target_norm: Normalizer | None = None,
              group=None) -> MLPTrainResult:
    """Train the bandwidth predictor on pair examples.

    ``X``: [n, FEATURE_DIM] float32 (raw, unnormalized); ``y``: [n] MB/s.
    ``device=None`` means the card. ``init_params`` (a flax tree, bare or
    ``{"params": …}``, or a port state dict), ``normalizer`` and
    ``target_norm`` warm-start from an existing model. ``group`` is the
    data-parallel process group (``parallel/mesh.py``: ``None`` the
    default group if one is initialized, ``LOCAL`` this process alone);
    every rank passes the same ``X`` and ``y``.
    """
    return MLPTrainer(X, y, config, device, init_params=init_params,
                      normalizer=normalizer, target_norm=target_norm,
                      group=group).fit()


def bandwidth_examples_from_corpus(
    corpus, piece_mb: float = 4.0,
) -> tuple[np.ndarray, np.ndarray]:
    """(X [n, FEATURE_DIM] float32, y [n] MB/s) from a replay corpus:
    each candidate's realized per-piece cost (seconds for a
    ``piece_mb``-sized piece) inverted into achieved bandwidth. Takes
    whatever ``cost_examples_from_corpus`` takes; costs are floored at
    0.1 ms so a clock-resolution cost cannot mint an absurd label."""
    from dragonfly2_tpu_torch.train.cost_trainer import (
        cost_examples_from_corpus,
    )

    X, cost_s = cost_examples_from_corpus(corpus)
    y = (piece_mb / np.maximum(cost_s, 1e-4)).astype(np.float32)
    return X, y
