"""MLP bandwidth predictor — port of ``dragonfly2_tpu/models/mlp.py``
(BASELINE config #1): Dense+GELU layers over a (parent, child) feature
vector in the evaluator layout, predicting standardized log-bandwidth.
bf16 compute, f32 params, f32 output, as in the JAX model."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dragonfly2_tpu_torch.models.graph_transformer import Dense
from dragonfly2_tpu_torch.scheduler.evaluator.scoring import FEATURE_DIM


@dataclass(frozen=True)
class Normalizer:
    """Per-feature affine normalization with training-time statistics."""

    mean: np.ndarray
    std: np.ndarray

    @staticmethod
    def fit(x: np.ndarray) -> "Normalizer":
        return Normalizer(
            mean=x.mean(axis=0).astype(np.float32),
            std=(x.std(axis=0) + 1e-6).astype(np.float32),
        )

    @staticmethod
    def identity(dim: int) -> "Normalizer":
        return Normalizer(np.zeros(dim, np.float32), np.ones(dim, np.float32))

    def __call__(self, x):
        return (x - self.mean) / self.std


class MLPBandwidthPredictor(nn.Module):
    """Predicts standardized log1p(bandwidth MB/s) for normalized pair
    features. Layers keep flax's names ``Dense_0`` … ``Dense_<len(hidden)>``."""

    def __init__(self, hidden: Sequence[int] = (128, 128, 64),
                 in_features: int = FEATURE_DIM,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        widths = [in_features, *hidden, 1]
        self.n_layers = len(widths) - 1
        for i in range(self.n_layers):
            self.add_module(f"Dense_{i}", Dense(widths[i], widths[i + 1],
                                                dtype, generator))

    def forward(self, x):
        for i in range(self.n_layers - 1):
            x = F.gelu(getattr(self, f"Dense_{i}")(x), approximate="tanh")
        x = getattr(self, f"Dense_{self.n_layers - 1}")(x)
        return x[..., 0].float()


class MLPApply:
    """The port's counterpart of a flax MLP module's ``model.apply``:
    ``apply(params, x)`` runs the bf16 :class:`MLPBandwidthPredictor`
    with flax-layout ``params`` (bare or ``{"params": …}``, numpy f32)
    over normalized features ``x`` on ``device`` (``None``: the card) and
    returns the f32 output as numpy — the duck type the federated
    screens and :func:`predict_bandwidth` call."""

    def __init__(self, hidden: Sequence[int] = (128, 128, 64),
                 in_features: int = FEATURE_DIM, device=None):
        from dragonfly2_tpu_torch.device import default_device

        self.hidden = tuple(hidden)
        self.in_features = in_features
        self.device = default_device(device)

    def module(self, params) -> MLPBandwidthPredictor:
        """A bf16 model on ``device`` holding ``params``."""
        from dragonfly2_tpu_torch.train.checkpoint import (
            mlp_state_dict_from_flax,
        )

        # A throwaway generator: the weights are overwritten, and the
        # global RNG stays untouched.
        model = MLPBandwidthPredictor(hidden=self.hidden,
                                      in_features=self.in_features,
                                      generator=torch.Generator())
        model.load_state_dict(mlp_state_dict_from_flax(params))
        return model.to(self.device).eval()

    @torch.no_grad()
    def apply(self, params, x) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        return self.module(params)(x.to(self.device)).cpu().numpy()


def predict_bandwidth(model, params, normalizer: Normalizer,
                      target_norm: Normalizer, x) -> np.ndarray:
    """Raw-scale bandwidth prediction (MB/s) for raw features ``x``:
    ``model.apply`` (an :class:`MLPApply`) emits standardized
    log-bandwidth, denormalized here with the training-time target
    statistics, in f32 as in the JAX package."""
    out = model.apply(params, normalizer(x))
    return np.expm1(out * target_norm.std[0] + target_norm.mean[0])
