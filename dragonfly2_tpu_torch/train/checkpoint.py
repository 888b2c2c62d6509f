"""Model artifacts — port of ``dragonfly2_tpu/train/checkpoint.py``.

The JAX package saves an orbax tree, which needs orbax and tensorstore to
read. The port's artifact is framework-neutral instead: a tar holding

- ``tree.npz`` — the checkpoint tree flattened with ``/``, keeping the
  flax layout and key names (``params/blocks_0/Dense_3/kernel`` with
  ``[in, out]`` kernels, ``params/blocks_0/LayerNorm_0/scale`` …, plus
  top-level ``node_features``, ``neighbors``, ``neighbor_vals``,
  ``node_ids_utf8`` for the GraphTransformer, or ``norm_mean`` …
  ``target_std`` for the MLP), so numpy alone writes one from a JAX param
  tree;
- ``metadata.json`` — the registry-facing :class:`ModelMetadata`.

``*_state_dict_from_flax`` map a flax param tree onto the port modules'
state dicts (kernel ``[in, out]`` → ``weight [out, in]``, LayerNorm
``scale`` → ``weight``, ``blocks_i`` → ``blocks.i``); ``flax_from_*``
invert them. :func:`gat_artifact_from_result` packs a trained
GraphTransformer (``train/gat_trainer.py``) for the sidecar.
"""

from __future__ import annotations

import io
import json
import os
import re
import tarfile
import tempfile
from dataclasses import asdict, dataclass, field
from typing import Any

import numpy as np
import torch

from dragonfly2_tpu_torch.models.mlp import Normalizer

METADATA_FILE = "metadata.json"
TREE_FILE = "tree.npz"


class ArtifactError(ValueError):
    """A model artifact that is malformed or unsafe to unpack."""


@dataclass
class ModelMetadata:
    """Registry-facing model description."""

    model_id: str
    model_type: str  # "mlp" | "gnn" | "gat" | "cost"
    version: int = 1
    evaluation: dict = field(default_factory=dict)
    config: dict = field(default_factory=dict)
    feature_schema: list = field(default_factory=list)


def flatten_tree(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict of arrays → ``{"a/b/c": array}``."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(flatten_tree(value, path + "/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def unflatten_tree(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def save_model(path: str, tree: dict, metadata: ModelMetadata) -> None:
    """Write ``tree.npz`` + ``metadata.json`` under directory ``path``."""
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, TREE_FILE), **flatten_tree(tree))
    with open(os.path.join(path, METADATA_FILE), "w") as f:
        json.dump(asdict(metadata), f, indent=2)


def load_model(path: str) -> tuple[dict, ModelMetadata]:
    with np.load(os.path.join(path, TREE_FILE), allow_pickle=False) as npz:
        tree = unflatten_tree({k: npz[k] for k in npz.files})
    with open(os.path.join(path, METADATA_FILE)) as f:
        metadata = ModelMetadata(**json.load(f))
    return tree, metadata


def write_artifact(tree: dict, metadata: ModelMetadata) -> bytes:
    """The model.tar payload for ``tree`` and ``metadata``."""
    with tempfile.TemporaryDirectory(prefix="df2-artifact-") as tmp:
        save_model(tmp, tree, metadata)
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as tar:
            for name in (TREE_FILE, METADATA_FILE):
                tar.add(os.path.join(tmp, name), arcname=name)
    return buf.getvalue()


def untar_to_directory(artifact: bytes, directory: str) -> None:
    """Unpack a model.tar payload, refusing members that would land
    outside ``directory`` and links of any kind."""
    os.makedirs(directory, exist_ok=True)
    base = os.path.abspath(directory)
    with tarfile.open(fileobj=io.BytesIO(artifact), mode="r") as tar:
        for member in tar.getmembers():
            target = os.path.abspath(os.path.join(base, member.name))
            if target != base and not target.startswith(base + os.sep):
                raise ArtifactError(f"unsafe tar member {member.name!r}")
            # Links can alias paths outside base even when the member name
            # itself is inside it; a model.tar is plain files only.
            if member.issym() or member.islnk():
                raise ArtifactError(f"link tar member {member.name!r}")
        tar.extractall(base, filter="data")


def load_artifact(artifact: bytes) -> tuple[dict, ModelMetadata]:
    """model.tar payload → (tree, metadata), unpacked in a temporary
    directory that is removed before returning."""
    with tempfile.TemporaryDirectory(prefix="df2-sidecar-") as tmp:
        untar_to_directory(artifact, tmp)
        return load_model(tmp)


def gat_tree(params: dict, node_features: np.ndarray,
             neighbors: np.ndarray, neighbor_vals: np.ndarray,
             node_ids=None) -> dict:
    """GraphTransformer checkpoint: flax-layout params + the padded node
    features and neighbor lists serving recomputes embeddings over.
    ``node_ids`` (the real rows' host IDs) ship newline-joined as UTF-8
    bytes."""
    tree = {"params": params,
            "node_features": np.asarray(node_features),
            "neighbors": np.asarray(neighbors),
            "neighbor_vals": np.asarray(neighbor_vals)}
    if node_ids is not None:
        blob = "\n".join(str(i) for i in node_ids).encode()
        tree["node_ids_utf8"] = np.frombuffer(blob, dtype=np.uint8).copy()
    return tree


def gat_artifact_from_result(result, graph, model_id: str) -> bytes:
    """A trained GraphTransformer (``train.gat_trainer.GATTrainResult``)
    as the model.tar payload the sidecar loads: its flax-layout weights,
    padded graph and ``graph``'s host ids, with the registry metadata
    the JAX package's training service writes."""
    cfg = result.config
    tree = gat_tree(flax_from_gat_state_dict(result.state_dict),
                    result.node_features, result.neighbors,
                    result.neighbor_vals, node_ids=graph.node_ids)
    metadata = ModelMetadata(
        model_id=model_id, model_type="gat",
        evaluation={"precision": result.precision, "recall": result.recall,
                    "f1": result.f1, "n_samples": int(graph.n_edges)},
        # chunk is structural for blocks mode: serving rebuilds with the
        # block size the padded row count was sized for.
        config={"hidden": cfg.hidden, "embed": cfg.embed,
                "layers": cfg.layers, "heads": cfg.heads,
                "attention": cfg.attention, "chunk": cfg.chunk})
    return write_artifact(tree, metadata)


def gat_from_tree(tree: dict) -> tuple:
    """→ (params, node_features, neighbors, neighbor_vals, node_ids)."""
    node_ids = None
    if "node_ids_utf8" in tree:
        blob = bytes(np.asarray(tree["node_ids_utf8"], dtype=np.uint8))
        node_ids = blob.decode().split("\n") if blob else []
    return (tree["params"], np.asarray(tree["node_features"]),
            np.asarray(tree["neighbors"]), np.asarray(tree["neighbor_vals"]),
            node_ids)


def mlp_tree(params: dict, normalizer: Normalizer,
             target_norm: Normalizer) -> dict:
    return {
        "params": params,
        "norm_mean": np.asarray(normalizer.mean),
        "norm_std": np.asarray(normalizer.std),
        "target_mean": np.asarray(target_norm.mean),
        "target_std": np.asarray(target_norm.std),
    }


def mlp_from_tree(tree: dict) -> tuple[Any, Normalizer, Normalizer]:
    return (
        tree["params"],
        Normalizer(mean=np.asarray(tree["norm_mean"]),
                   std=np.asarray(tree["norm_std"])),
        Normalizer(mean=np.asarray(tree["target_mean"]),
                   std=np.asarray(tree["target_std"])),
    )


def _module_params(params: dict) -> dict:
    # A flax ``model.init`` result wraps the tree as {"params": {...}};
    # the JAX trainers checkpoint it that way.
    if set(params) == {"params"}:
        return params["params"]
    return params


def _state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    state = {}
    for path, value in flatten_tree(_module_params(params)).items():
        *modules, leaf = path.split("/")
        name = ".".join(re.sub(r"^blocks_(\d+)$", r"blocks.\1", m)
                        for m in modules)
        value = torch.from_numpy(np.array(value, dtype=np.float32))
        if leaf == "kernel":
            state[f"{name}.weight"] = value.T.contiguous()
        elif leaf == "scale":
            state[f"{name}.weight"] = value
        elif leaf == "bias":
            state[f"{name}.bias"] = value
        else:
            raise KeyError(f"unexpected flax leaf {path!r}")
    return state


def _flax_from_state_dict(state: dict[str, torch.Tensor]) -> dict:
    flat = {}
    for key, value in state.items():
        *modules, leaf = key.split(".")
        name = "/".join(modules).replace("blocks/", "blocks_")
        value = value.detach().cpu().float().numpy()
        if leaf == "weight":
            leaf, value = (("kernel", value.T.copy()) if value.ndim == 2
                           else ("scale", value))
        flat[f"{name}/{leaf}"] = value
    return unflatten_tree(flat)


def gat_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax GraphTransformer params (bare, or wrapped as ``{"params": …}``)
    → a ``GraphTransformer`` state dict."""
    return _state_dict_from_flax(params)


def flax_from_gat_state_dict(state: dict[str, torch.Tensor]) -> dict:
    """``GraphTransformer`` state dict → bare flax param tree (numpy)."""
    return _flax_from_state_dict(state)


def mlp_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """flax MLPBandwidthPredictor params → an ``MLPBandwidthPredictor``
    state dict."""
    return _state_dict_from_flax(params)


def flax_from_mlp_state_dict(state: dict[str, torch.Tensor]) -> dict:
    """``MLPBandwidthPredictor`` state dict → bare flax param tree."""
    return _flax_from_state_dict(state)
