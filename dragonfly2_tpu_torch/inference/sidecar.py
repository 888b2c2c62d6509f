"""Inference service — port of the serving core of
``dragonfly2_tpu/inference/sidecar.py``.

:class:`InferenceService` serves installed scorers over the KServe-style
four-method surface (ModelInfer / ModelReady / ServerLive / ServerReady),
and the ``*_from_artifact`` loaders turn a port model.tar
(``train/checkpoint.py``) into a scorer: ``mlp`` and ``cost`` artifacts
share one checkpoint layout and one loader
(:func:`_mlp_checkpoint_from_artifact`). The port has no gRPC: a method's
``context`` only needs ``abort(code, details)`` taking a
:class:`StatusCode` and raising, as gRPC's does; :class:`CallContext` is
the in-process one. The gRPC transport, the micro-batcher, the manager
watcher, shadow/canary rollout and fault plans are not ported yet.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from dragonfly2_tpu_torch.inference.scorer import (
    CostScorer,
    GATParentScorer,
    ParentScorer,
)
from dragonfly2_tpu_torch.models.graph_transformer import GraphTransformer
from dragonfly2_tpu_torch.models.mlp import FEATURE_DIM, MLPBandwidthPredictor
from dragonfly2_tpu_torch.train.checkpoint import (
    gat_from_tree,
    gat_state_dict_from_flax,
    load_artifact,
    mlp_from_tree,
    mlp_state_dict_from_flax,
)

MODEL_NAME_MLP = "mlp"
MODEL_NAME_GAT = "gat"
MODEL_NAME_COST = "cost"


class StatusCode(enum.Enum):
    """RPC status codes, named and numbered as gRPC's."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class RpcAbort(Exception):
    """Raised by :meth:`CallContext.abort`."""

    def __init__(self, code: StatusCode, details: str):
        super().__init__(f"{code.name}: {details}")
        self.code = code
        self.details = details


class CallContext:
    """In-process call context: ``abort`` raises :class:`RpcAbort`."""

    def abort(self, code: StatusCode, details: str):
        raise RpcAbort(code, details)


@dataclass
class ModelInferRequest:
    model_name: str = ""
    # [batch, FEATURE_DIM] features (mlp) or [batch, 2] host indexes (gat).
    inputs: Optional[np.ndarray] = None


@dataclass
class ModelInferResponse:
    model_name: str = ""
    model_version: str = ""
    outputs: Optional[np.ndarray] = None


@dataclass
class ModelReadyRequest:
    name: str = ""


@dataclass
class ModelReadyResponse:
    ready: bool = False
    version: str = ""


@dataclass
class ServerLiveRequest:
    pass


@dataclass
class ServerLiveResponse:
    live: bool = True


@dataclass
class ServerReadyRequest:
    pass


@dataclass
class ServerReadyResponse:
    ready: bool = False


@dataclass
class _LoadedModel:
    version: str
    scorer: object  # ParentScorer | GATParentScorer

    @property
    def max_rows(self) -> int:
        return self.scorer.max_batch

    def score(self, inputs):
        return self.scorer.score(inputs)


class InferenceService:
    """Serves installed scorers; one device dispatch per request."""

    def __init__(self):
        self._models: Dict[str, _LoadedModel] = {}
        self._lock = threading.Lock()

    def install_scorer(self, name: str, scorer, version: str = "local") -> None:
        """Install (or replace) the scorer served under ``name``."""
        with self._lock:
            self._models[name] = _LoadedModel(version, scorer)

    def ModelInfer(self, request: ModelInferRequest, context):  # noqa: N802
        with self._lock:
            model = self._models.get(request.model_name)
        if model is None:
            context.abort(StatusCode.NOT_FOUND,
                          f"model {request.model_name!r} not loaded")
        inputs = request.inputs
        if inputs is None or np.asarray(inputs).size == 0:
            context.abort(StatusCode.INVALID_ARGUMENT, "empty inputs")
        if request.model_name == MODEL_NAME_GAT:
            # Pair scorer: [batch, 2] int host indexes, not feature rows.
            inputs = np.asarray(inputs)
            if inputs.ndim != 2 or inputs.shape[1] != 2:
                context.abort(
                    StatusCode.INVALID_ARGUMENT,
                    f"gat inputs must be [batch, 2] host-index pairs, "
                    f"got {inputs.shape}")
            # Range-check BEFORE the int32 cast: an int64 index past 2^31
            # would wrap back into range.
            n_real = getattr(model.scorer, "n_real", None)
            if n_real is not None and (
                    (inputs < 0).any() or (inputs >= n_real).any()):
                context.abort(
                    StatusCode.INVALID_ARGUMENT,
                    f"host index out of range for the {n_real}-host "
                    "embedding table")
            inputs = inputs.astype(np.int32)
        else:
            inputs = np.asarray(inputs, dtype=np.float32)
            if inputs.ndim != 2 or inputs.shape[1] != FEATURE_DIM:
                context.abort(
                    StatusCode.INVALID_ARGUMENT,
                    f"inputs must be [batch, {FEATURE_DIM}], "
                    f"got {inputs.shape}")
        if inputs.shape[0] > model.max_rows:
            context.abort(
                StatusCode.INVALID_ARGUMENT,
                f"batch {inputs.shape[0]} exceeds max {model.max_rows}")
        scores = model.score(inputs)
        return ModelInferResponse(model_name=request.model_name,
                                  model_version=model.version,
                                  outputs=np.asarray(scores))

    def ModelReady(self, request: ModelReadyRequest, context):  # noqa: N802
        with self._lock:
            model = self._models.get(request.name)
        return ModelReadyResponse(ready=model is not None,
                                  version=model.version if model else "")

    def ServerLive(self, request, context):  # noqa: N802
        return ServerLiveResponse(live=True)

    def ServerReady(self, request, context):  # noqa: N802
        with self._lock:
            ready = bool(self._models)
        return ServerReadyResponse(ready=ready)


def _mlp_checkpoint_from_artifact(artifact: bytes, device=None):
    """The one load path of every MLP-layout checkpoint (the bandwidth
    scorer and the cost predictor share it) → ``(ParentScorer,
    target_norm)``, loaded and warmed up on ``device``."""
    tree, metadata = load_artifact(artifact)
    params, normalizer, target_norm = mlp_from_tree(tree)
    hidden = tuple(metadata.config.get("hidden", (128, 128, 64)))
    model = MLPBandwidthPredictor(hidden=hidden,
                                  in_features=len(normalizer.mean))
    model.load_state_dict(mlp_state_dict_from_flax(params))
    return ParentScorer(model, normalizer, target_norm,
                        device=device), target_norm


def _scorer_from_artifact(artifact: bytes, device=None) -> ParentScorer:
    """model.tar (MLP layout) → ParentScorer (load + bucket warm-up)."""
    return _mlp_checkpoint_from_artifact(artifact, device)[0]


def _cost_scorer_from_artifact(artifact: bytes, version: str = "",
                               device=None) -> CostScorer:
    """model.tar (type ``cost``) → CostScorer: the bandwidth MLP's
    checkpoint layout, wrapped so ``score`` ranks by NEGATED predicted
    cost and ``predict_cost_s`` feeds the learned bad-node threshold.
    The target normalizer's mean is the training corpus's typical
    log1p(cost): ``expm1`` of it is the absolute bad-node baseline."""
    scorer, target_norm = _mlp_checkpoint_from_artifact(artifact, device)
    typical = float(np.expm1(float(target_norm.mean[0])))
    return CostScorer(scorer, version=version,
                      typical_cost_s=max(typical, 0.0))


def _gat_scorer_from_artifact(artifact: bytes,
                              device=None) -> GATParentScorer:
    """model.tar (GraphTransformer layout) → GATParentScorer: one
    full-graph embedding pass at load, pair-gather scoring per request."""
    tree, metadata = load_artifact(artifact)
    (params, node_features, neighbors, neighbor_vals,
     node_ids) = gat_from_tree(tree)
    cfg = metadata.config
    model = GraphTransformer(
        in_features=int(node_features.shape[1]),
        hidden=int(cfg.get("hidden", 128)),
        embed=int(cfg.get("embed", 64)),
        layers=int(cfg.get("layers", 2)),
        heads=int(cfg.get("heads", 4)),
        attention=str(cfg.get("attention", "gather")),
        chunk=int(cfg.get("chunk", 1024)),
        dtype=torch.bfloat16,
    )
    model.load_state_dict(gat_state_dict_from_flax(params))
    return GATParentScorer(model, node_features, neighbors, neighbor_vals,
                           node_ids=node_ids, device=device)
