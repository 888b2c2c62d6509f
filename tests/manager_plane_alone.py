"""The manager-plane phase of ``chip_smoke.py`` (manager_plane) on the
card without the rest of the script: the kernels built from
``dragonfly2_tpu_torch/ops/csrc/`` in parallel, config #3's seeded
gather- and blocks-mode artifacts and the seeded MLP artifact made as
the script's main path makes them, then ``run_manager_plane`` through
the script's own function.

    python3 tests/manager_plane_alone.py

Needs one CUDA card. Prints the build's seconds, the phase's JSON line,
its launch counts and seconds, and the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_smoke():
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def smoke_artifacts(torch, smoke):
    """The main path's artifacts: config #3 with seeded weights in
    gather and blocks mode, and the seeded MLP, as ``chip_smoke.main``
    writes them (at ``smoke.N_HOSTS`` hosts)."""
    from dragonfly2_tpu_torch.data import SyntheticCluster
    from dragonfly2_tpu_torch.models.graph_transformer import (
        GraphTransformer,
        build_neighbor_lists,
        pad_graph_sparse,
        pad_multiple,
    )
    from dragonfly2_tpu_torch.models.mlp import (
        FEATURE_DIM,
        MLPBandwidthPredictor,
        Normalizer,
    )
    from dragonfly2_tpu_torch.train.checkpoint import (
        ModelMetadata,
        flax_from_gat_state_dict,
        flax_from_mlp_state_dict,
        gat_tree,
        mlp_tree,
        write_artifact,
    )

    graph = SyntheticCluster(n_hosts=smoke.N_HOSTS, seed=smoke.SEED
                             ).probe_graph(smoke.N_EDGES)
    nbr, val = build_neighbor_lists(graph.n_nodes, graph.edge_src,
                                    graph.edge_dst, graph.edge_rtt_ns,
                                    cap=smoke.NEIGHBOR_CAP)
    graphs = {"gather": pad_graph_sparse(graph.node_features, nbr, val, 1),
              "blocks": pad_graph_sparse(
                  graph.node_features, nbr, val,
                  pad_multiple(1, smoke.GAT_CFG["chunk"], graph.n_nodes))}
    model = GraphTransformer(**smoke.GAT_CFG, generator=torch.Generator()
                             .manual_seed(smoke.SEED))
    params = flax_from_gat_state_dict(model.state_dict())
    artifacts = {}
    for mode, (feats, m_nbr, m_val, _) in graphs.items():
        artifacts[mode] = write_artifact(
            gat_tree(params, feats, m_nbr, m_val, node_ids=graph.node_ids),
            ModelMetadata(model_id=f"smoke-gat-{mode}", model_type="gat",
                          config=dict(smoke.GAT_CFG, attention=mode)))
    rng = np.random.default_rng(smoke.SEED)
    features = rng.uniform(0, 100, (4096, FEATURE_DIM)).astype(np.float32)
    mlp = MLPBandwidthPredictor(
        generator=torch.Generator().manual_seed(smoke.SEED))
    mlp_artifact = write_artifact(
        mlp_tree(flax_from_mlp_state_dict(mlp.state_dict()),
                 Normalizer.fit(features),
                 Normalizer(np.array([2.5], np.float32),
                            np.array([0.7], np.float32))),
        ModelMetadata(model_id="smoke-mlp", model_type="mlp",
                      config={"hidden": [128, 128, 64]}))
    return artifacts, mlp_artifact


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("manager_plane_alone: no CUDA device", file=sys.stderr)
        return 2
    smoke = load_smoke()
    from dragonfly2_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"python": sys.version, "torch": torch.__version__,
                      "cuda": torch.version.cuda, "cpus": os.cpu_count()}),
          flush=True)
    print(smoke.nvidia_smi(), flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    artifacts, mlp_artifact = smoke_artifacts(torch, smoke)
    t0 = time.perf_counter()
    launches = smoke.run_manager_plane(torch, artifacts, mlp_artifact,
                                       smoke.Counts())
    print(json.dumps({"build_seconds": build_s, "manager_plane_launches":
                      launches, "seconds": time.perf_counter() - t0}),
          flush=True)
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
