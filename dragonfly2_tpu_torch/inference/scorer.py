"""Batched parent scorers — port of ``ParentScorer`` and ``GATParentScorer``
from ``dragonfly2_tpu/inference/scorer.py``.

A request pads to the smallest power-of-two bucket (up to ``max_batch``)
of a preallocated host staging buffer, is copied to the device once and
scored in one forward; every bucket is run once at construction so the
first request pays no warm-up. ``score_corpus`` is not ported yet.
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from dragonfly2_tpu_torch.device import default_device
from dragonfly2_tpu_torch.models.mlp import FEATURE_DIM, Normalizer


def _buckets(max_batch: int) -> list[int]:
    out, b = [], 8
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def _bucket(buckets: Sequence[int], n: int) -> int:
    """The smallest bucket holding ``n`` rows (the last is max_batch)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch {n} exceeds max_batch {buckets[-1]}")


class ScoreHandle:
    """An in-flight dispatch: the device result plus the valid row count.
    ``materialize`` waits for the device and slices the padding off."""

    __slots__ = ("_out", "_n", "bucket")

    def __init__(self, out, n: int, bucket: int):
        self._out = out
        self._n = n
        self.bucket = bucket

    def materialize(self) -> np.ndarray:
        # .cpu() is the synchronization point: CUDA work is asynchronous.
        out = self._out
        if isinstance(out, torch.Tensor):
            out = out.float().cpu().numpy()
        return out[: self._n]


class _StagingBuffers:
    """Preallocated zeroed host buffers per bucket, ``depth`` deep.

    A request writes its rows into a buffer and re-zeros only the rows
    the previous occupant dirtied. On a CUDA device the buffers are
    pinned and the host→device copy is asynchronous, so a slot must not
    be refilled while the copy that read it may still be running: each
    claim waits on the ``torch.cuda.Event`` recorded after the slot's
    previous dispatch (``commit``). With two slots a request refills the
    one its predecessor's predecessor used, whose copy has normally
    finished, so the wait rarely blocks. A per-bucket lock covers
    claim + fill + dispatch + commit.
    """

    depth = 2

    def __init__(self, buckets: Sequence[int], make):
        self._locks = {b: threading.Lock() for b in buckets}
        self._bufs = {b: [make(b) for _ in range(self.depth)]
                      for b in buckets}
        self._flip = {b: 0 for b in buckets}
        self._dirty = {b: [0] * self.depth for b in buckets}
        self._pending = {b: [None] * self.depth for b in buckets}

    def lock_for(self, bucket: int) -> threading.Lock:
        return self._locks[bucket]

    def claim(self, bucket: int, n: int) -> tuple:
        """Under ``lock_for(bucket)``: (slot, buffer) for ``bucket`` with
        rows ``n:`` zero and no dispatch still reading it."""
        i = self._flip[bucket]
        self._flip[bucket] = (i + 1) % len(self._bufs[bucket])
        pending = self._pending[bucket][i]
        if pending is not None:
            self._pending[bucket][i] = None
            pending.synchronize()
        buf = self._bufs[bucket][i]
        if self._dirty[bucket][i] > n:
            buf[n:self._dirty[bucket][i]] = 0
        self._dirty[bucket][i] = n
        return i, buf

    def commit(self, bucket: int, slot: int, event) -> None:
        """Under the bucket lock: record the event after the dispatch that
        read the slot's buffer (None on the CPU, where it already ran)."""
        self._pending[bucket][slot] = event


def _host_buffer(shape, dtype, device: torch.device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, pin_memory=device.type == "cuda")


def _dispatched(device: torch.device):
    """An event after the work queued so far on ``device`` (None on CPU)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


class ParentScorer:
    """Bucketed scorer over a trained bandwidth predictor: normalize →
    model → denormalize, one device dispatch per request."""

    def __init__(self, model, normalizer: Normalizer, target_norm: Normalizer,
                 max_batch: int = 64, device=None):
        self._device = default_device(device)
        self._model = model.to(self._device).eval()
        self._mean = torch.as_tensor(normalizer.mean, dtype=torch.float32,
                                     device=self._device)
        self._std = torch.as_tensor(normalizer.std, dtype=torch.float32,
                                    device=self._device)
        self._t_mean = float(target_norm.mean[0])
        self._t_std = float(target_norm.std[0])
        self.buckets = _buckets(max_batch)
        self.max_batch = max_batch
        self._staging = _StagingBuffers(
            self.buckets,
            lambda b: _host_buffer((b, FEATURE_DIM), torch.float32,
                                   self._device))
        for b in self.buckets:
            self._forward(torch.zeros(b, FEATURE_DIM))
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    @torch.no_grad()
    def _forward(self, buf: torch.Tensor) -> torch.Tensor:
        # Score = predicted log-bandwidth, denormalized so scores are
        # comparable across model versions.
        x = buf.to(self._device, non_blocking=True)
        out = self._model((x - self._mean) / self._std)
        return out * self._t_std + self._t_mean

    def score_async(self, features: np.ndarray) -> ScoreHandle:
        """Stage ``[n, FEATURE_DIM]`` features and dispatch without waiting
        for the device; ``materialize()`` yields the ``[n]`` scores."""
        n = len(features)
        if n == 0:
            return ScoreHandle(np.zeros(0, np.float32), 0, self.buckets[0])
        b = _bucket(self.buckets, n)
        with self._staging.lock_for(b):
            slot, buf = self._staging.claim(b, n)
            buf[:n] = torch.from_numpy(np.asarray(features, np.float32))
            out = self._forward(buf)
            self._staging.commit(b, slot, _dispatched(self._device))
        return ScoreHandle(out, n, b)

    def score(self, features: np.ndarray) -> np.ndarray:
        """Scores for [n, FEATURE_DIM] features; higher is better."""
        if len(features) == 0:
            return np.zeros(0, np.float32)
        return self.score_async(features).materialize()


class GATParentScorer:
    """Pair scorer over a trained GraphTransformer (config #3).

    The full-graph attention runs once at construction —
    ``node_embeddings`` over the checkpointed padded features and neighbor
    lists, through the hand-written kernels on the card — leaving an
    [N, E] table on the device. Every request is then an index gather
    plus the small edge head, bucketed like :class:`ParentScorer`.
    """

    def __init__(self, model, node_features, neighbors, neighbor_vals,
                 max_batch: int = 64, device=None, node_ids=None):
        self._device = default_device(device)
        self._model = model.to(self._device).eval()
        self.n_nodes = int(np.asarray(node_features).shape[0])
        # Index validation uses the REAL row count when ids ship: a padded
        # phantom row would pass a padded-count check and return a
        # plausible-looking logit from a phantom embedding.
        self.node_ids = list(node_ids) if node_ids is not None else None
        self.n_real = (len(self.node_ids) if self.node_ids is not None
                       else self.n_nodes)
        self._id_index = ({h: i for i, h in enumerate(self.node_ids)}
                          if self.node_ids is not None else None)
        with torch.no_grad():
            self._emb = self._model.node_embeddings(
                torch.as_tensor(np.asarray(node_features, np.float32),
                                device=self._device),
                torch.as_tensor(np.asarray(neighbors, np.int32),
                                device=self._device),
                torch.as_tensor(np.asarray(neighbor_vals, np.float32),
                                device=self._device))
        self.buckets = _buckets(max_batch)
        self.max_batch = max_batch
        # Separate src/dst staging: the head takes two flat [b] vectors.
        make = lambda b: _host_buffer(b, torch.int32, self._device)  # noqa: E731
        self._staging_src = _StagingBuffers(self.buckets, make)
        self._staging_dst = _StagingBuffers(self.buckets, make)
        for b in self.buckets:
            zero = torch.zeros(b, dtype=torch.int32)
            self._forward(zero, zero)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    @property
    def embeddings(self) -> torch.Tensor:
        """The [N, E] embedding table (padded rows included)."""
        return self._emb

    @torch.no_grad()
    def _forward(self, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        return self._model.score_pairs(
            self._emb, src.to(self._device, non_blocking=True),
            dst.to(self._device, non_blocking=True))

    def score_async(self, pairs: np.ndarray) -> ScoreHandle:
        """Stage validated [n, 2] (src, dst) host-index pairs and dispatch
        without waiting for the device."""
        pairs = np.asarray(pairs)
        n = len(pairs)
        if n == 0:
            return ScoreHandle(np.zeros(0, np.float32), 0, self.buckets[0])
        if pairs.ndim != 2 or pairs.shape[1] != 2:
            raise ValueError(f"expected [n, 2] host-index pairs, "
                             f"got {pairs.shape}")
        if (pairs < 0).any() or (pairs >= self.n_real).any():
            raise ValueError("host index out of range for the "
                             f"{self.n_real}-host embedding table")
        b = _bucket(self.buckets, n)
        # src-then-dst lock order (always) keeps the two vectors paired
        # under concurrent callers.
        with self._staging_src.lock_for(b), self._staging_dst.lock_for(b):
            si, src = self._staging_src.claim(b, n)
            di, dst = self._staging_dst.claim(b, n)
            src[:n] = torch.from_numpy(pairs[:, 0].astype(np.int32))
            dst[:n] = torch.from_numpy(pairs[:, 1].astype(np.int32))
            out = self._forward(src, dst)
            event = _dispatched(self._device)
            self._staging_src.commit(b, si, event)
            self._staging_dst.commit(b, di, event)
        return ScoreHandle(out, n, b)

    def score(self, pairs: np.ndarray) -> np.ndarray:
        """Edge logits for [n, 2] (src, dst) host indices; higher is a
        better parent edge."""
        if len(pairs) == 0:
            return np.zeros(0, np.float32)
        return self.score_async(pairs).materialize()

    def index_of(self, host_id: str):
        """Embedding-row index for a host ID, or None when the host was
        not in the training graph."""
        if self._id_index is None:
            return None
        return self._id_index.get(host_id)

    def score_host_pairs(self, id_pairs) -> np.ndarray:
        """Edge logits for [(src_host_id, dst_host_id), ...]; raises
        KeyError on hosts outside the training graph."""
        if self._id_index is None:
            raise ValueError("checkpoint carries no node_ids")
        pairs = np.array([[self._id_index[a], self._id_index[b]]
                          for a, b in id_pairs], np.int32).reshape(-1, 2)
        return self.score(pairs)
