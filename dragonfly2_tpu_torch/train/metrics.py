"""Eval helpers — port of ``dragonfly2_tpu/train/metrics.py``: exact
chunked confusion matrices under fixed batch shapes, and the registry's
precision/recall/f1 schema."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch


def padded_chunks(ids: np.ndarray, batch: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield fixed-size (ids, weights) chunks; the tail pads with id 0 at
    weight 0 so every eval example counts exactly once."""
    for start in range(0, len(ids), batch):
        chunk = ids[start:start + batch]
        weights = np.ones(batch, np.float32)
        if len(chunk) < batch:
            weights[len(chunk):] = 0.0
            chunk = np.concatenate(
                [chunk, np.zeros(batch - len(chunk), np.int64)])
        yield chunk, weights


def confusion(logits: torch.Tensor, labels: torch.Tensor,
              weights: torch.Tensor) -> torch.Tensor:
    """[tp, fp, fn, tn] of ``logits > 0`` against ``labels``, each row
    weighted (a zero-weighted tail counts nothing); on the tensors'
    device."""
    pred = (logits > 0).float()
    return torch.stack([(weights * pred * labels).sum(),
                        (weights * pred * (1 - labels)).sum(),
                        (weights * (1 - pred) * labels).sum(),
                        (weights * (1 - pred) * (1 - labels)).sum()])


def metrics_from_confusion(cm: np.ndarray) -> dict:
    """[tp, fp, fn, tn] → registry metrics."""
    tp, fp, fn, tn = cm
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    accuracy = (tp + tn) / cm.sum() if cm.sum() else float("nan")
    return {
        "precision": float(precision),
        "recall": float(recall),
        "f1": float(f1),
        "accuracy": float(accuracy),
    }
