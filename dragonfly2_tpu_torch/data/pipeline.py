"""Batched input pipeline with a deterministic global shuffle — port of
``ArrayDataset`` from ``dragonfly2_tpu/data/pipeline.py``.

Each epoch's order is a pure function of (seed, epoch), so training is
restartable without replaying data-order state, and batches have a fixed
size (the remainder is dropped). The orders come from the same numpy
generators as the JAX package's, so both packages yield the same rows.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class ArrayDataset:
    """In-memory array dataset: (features, labels) with epoch batching."""

    def __init__(self, *arrays: np.ndarray):
        if not arrays or any(len(a) != len(arrays[0]) for a in arrays):
            raise ValueError("ArrayDataset needs arrays of one length")
        self.arrays = arrays

    def __len__(self) -> int:
        return len(self.arrays[0])

    def epoch_order(self, *, seed: int = 0, epoch: int = 0,
                    shuffle: bool = True) -> np.ndarray:
        """The row order of epoch ``epoch``: a permutation drawn from
        ``default_rng((seed, epoch))``, or the identity."""
        n = len(self)
        if shuffle:
            return np.random.default_rng((seed, epoch)).permutation(n)
        return np.arange(n)

    def batches(
        self, batch_size: int, *, seed: int = 0, epoch: int = 0,
        shuffle: bool = True,
    ) -> Iterator[tuple[np.ndarray, ...]]:
        """Fixed-size batches in :meth:`epoch_order`; remainder dropped."""
        order = self.epoch_order(seed=seed, epoch=epoch, shuffle=shuffle)
        for start in range(0, len(self) - batch_size + 1, batch_size):
            idx = order[start:start + batch_size]
            yield tuple(a[idx] for a in self.arrays)

    def split(self, eval_fraction: float = 0.1, seed: int = 0):
        """Deterministic train/eval split."""
        n = len(self)
        order = np.random.default_rng((seed, 1)).permutation(n)
        n_eval = int(n * eval_fraction)
        eval_idx, train_idx = order[:n_eval], order[n_eval:]
        return (
            ArrayDataset(*(a[train_idx] for a in self.arrays)),
            ArrayDataset(*(a[eval_idx] for a in self.arrays)),
        )
