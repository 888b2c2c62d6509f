"""What a rank runs in the port's sequence, pipeline and expert
parallelism tests (``tests/test_torch_ring_attention.py``,
``test_torch_pipeline.py``, ``test_torch_moe.py``), in the ring-mode
GraphTransformer's (``test_torch_model.py``) and in the tensor-parallel
GraphTransformer's (``test_torch_tensor_parallel.py``), spawned through
``tests/torch_dist_worker.py``.

Each case carries global numpy inputs; a rank takes its shard, runs the
port's function over the world's default group on the CPU, and returns
``{key: numpy array}`` (an ``error`` string where the case expects a
ValueError). A spawned child imports this module afresh, so it imports no
JAX: only torch, numpy and the port.
"""

from __future__ import annotations

import numpy as np


def _rows(n: int, rank: int, world: int) -> slice:
    return slice(rank * n // world, (rank + 1) * n // world)


def _tensor(a, dtype=None, grad=False):
    import torch

    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    return t.requires_grad_(grad)


def _numpy(t) -> np.ndarray:
    import torch

    return t.detach().to(torch.float32).numpy()


def _error(fn) -> dict:
    try:
        fn()
    except ValueError as exc:
        return {"error": np.array(str(exc))}
    return {"error": np.array("")}


def run_ring_attention(case: dict, rank: int, world: int) -> dict:
    """``ring_attention`` on this rank's rows of the global q/k/v
    (``[T, h, d]`` or ``[B, T, h, d]``) and of ``valid``; with
    ``case["grad"]`` also the gradients of (out²).sum() summed over the
    ranks, i.e. of the global loss. ``case["bf16"]`` runs in bf16."""
    import torch

    from dragonfly2_tpu_torch.parallel import ring_attention

    if case.get("expect_error"):
        q = _tensor(case["q"])
        return _error(lambda: ring_attention(q, q, q))
    t_axis = case["q"].ndim - 3
    rows = _rows(case["q"].shape[t_axis], rank, world)
    index = (slice(None),) * t_axis + (rows,)
    dtype = torch.bfloat16 if case.get("bf16") else None
    grad = bool(case.get("grad"))
    q, k, v = (_tensor(case[n][index], dtype, grad) for n in ("q", "k", "v"))
    valid = (_tensor(case["valid"][index]) if "valid" in case else None)
    out = ring_attention(q, k, v, causal=bool(case["causal"]),
                         kv_valid=valid)
    result = {"out": _numpy(out), "dtype": np.array(str(out.dtype))}
    if grad:
        (out ** 2).sum().backward()
        result.update(dq=_numpy(q.grad), dk=_numpy(k.grad),
                      dv=_numpy(v.grad))
    return result


def _stage(params, x):
    import torch

    return torch.tanh(x @ params["w"] + params["b"])


def run_pipeline(case: dict, rank: int, world: int) -> dict:
    """``pipeline_apply`` of tanh(x @ w + b) stages stacked in
    ``case["w"]`` / ``case["b"]`` on the global ``x``; with
    ``case["y"]`` also the gradients of mean((out − y)²): this rank's
    stage slice of each parameter and x's."""
    from dragonfly2_tpu_torch.parallel import pipeline_apply

    grad = "y" in case
    params = {"w": _tensor(case["w"], grad=grad),
              "b": _tensor(case["b"], grad=grad)}
    x = _tensor(case["x"], grad=grad)
    micro = case.get("microbatches")
    micro = None if micro is None else int(micro)
    if case.get("expect_error"):
        return _error(lambda: pipeline_apply(_stage, params, x,
                                             microbatches=micro))
    out = pipeline_apply(_stage, params, x, microbatches=micro)
    result = {"out": _numpy(out)}
    if grad:
        ((out - _tensor(case["y"])) ** 2).mean().backward()
        result.update(dw=_numpy(params["w"].grad[rank]),
                      db=_numpy(params["b"].grad[rank]),
                      dx=_numpy(x.grad))
    return result


def _expert(params, x):
    import torch

    return torch.tanh(x @ params["w"]) + params["b"]


def run_moe(case: dict, rank: int, world: int) -> dict:
    """``moe_apply`` of tanh(x @ w) + b experts stacked in ``case["w"]`` /
    ``case["b"]`` on this rank's tokens of the global ``x`` and
    ``gates``; with ``case["grad"]`` also the gradients of (out²).sum()
    summed over the ranks: this rank's expert slice and its gates'."""
    from dragonfly2_tpu_torch.parallel import moe_apply

    grad = bool(case.get("grad"))
    params = {"w": _tensor(case["w"], grad=grad),
              "b": _tensor(case["b"], grad=grad)}
    rows = _rows(case["x"].shape[0], rank, world)
    x = _tensor(case["x"][rows])
    gates = _tensor(case["gates"][rows], grad=grad)
    kwargs = dict(capacity_factor=float(case["capacity_factor"]))
    if case.get("expect_error"):
        x = _tensor(case["x"])
        return _error(lambda: moe_apply(_expert, params, x,
                                        _tensor(case["gates"]), **kwargs))
    out = moe_apply(_expert, params, x, gates, **kwargs)
    result = {"out": _numpy(out)}
    if grad:
        (out ** 2).sum().backward()
        result.update(dw=_numpy(params["w"].grad[rank]),
                      db=_numpy(params["b"].grad[rank]),
                      dgates=_numpy(gates.grad))
    return result


def run_ring_graph(case: dict, rank: int, world: int) -> dict:
    """Ring-mode graph attention with the rows sharded over the world:
    ``ring_graph_attention`` on this rank's rows of q/k/v/nbr/val and the
    gradients of the global (out²).sum(); then a ring-mode
    ``GraphTransformer`` (f32, the state dict ``case["state"]``) whose
    embeddings of this rank's rows it returns."""
    import torch

    from dragonfly2_tpu_torch.models.graph_transformer import (
        GraphTransformer,
        ring_graph_attention,
    )

    n = case["q"].shape[0]
    rows = _rows(n, rank, world)
    q, k, v = (_tensor(case[name][rows], grad=True)
               for name in ("q", "k", "v"))
    nbr, val = _tensor(case["nbr"][rows]), _tensor(case["val"][rows])
    out = ring_graph_attention(q, k, v, nbr, val, int(case["chunk"]))
    (out ** 2).sum().backward()
    result = {"out": _numpy(out), "dq": _numpy(q.grad),
              "dk": _numpy(k.grad), "dv": _numpy(v.grad)}
    state = {key: torch.from_numpy(np.array(value))
             for key, value in case["state"].items()}
    model = GraphTransformer(
        in_features=case["feats"].shape[1], hidden=int(case["hidden"]),
        embed=int(case["embed"]), layers=int(case["layers"]),
        heads=int(case["heads"]), chunk=int(case["chunk"]),
        attention="ring", dtype=torch.float32)
    model.load_state_dict(state)
    with torch.no_grad():
        emb = model.node_embeddings(_tensor(case["feats"][rows]), nbr, val)
    result["emb"] = _numpy(emb)
    return result


def run_tensor_parallel(case: dict, rank: int, world: int) -> dict:
    """The GraphTransformer on a ``(world / mp × mp)`` grid
    (``grid_groups(case["model_parallel"])``) over the world's default
    group: this rank's grid coordinates and its ``tp_shard_state`` slices
    of ``case["init"]``; then, in gather and in blocks mode, ``train_gat``
    with ``case["config"]`` from ``case["init"]`` (the history, step
    losses, F1 and the gathered whole state; this rank's parameter bytes
    and the replicated model's; rank 0's artifact), and the embeddings of every row under
    ``case["emb_state"]`` placed on the grid (gathered over the data
    axis)."""
    import torch

    from dragonfly2_tpu_torch.data import SyntheticCluster
    from dragonfly2_tpu_torch.models.graph_transformer import (
        GraphTransformer,
        build_neighbor_lists,
        pad_graph_sparse,
    )
    from dragonfly2_tpu_torch.parallel.mesh import (
        all_gather_rows,
        grid_groups,
    )
    from dragonfly2_tpu_torch.train.checkpoint import gat_artifact_from_result
    from dragonfly2_tpu_torch.train.gat_trainer import (
        GATTrainConfig,
        GATTrainer,
        tp_shard_state,
    )

    grid = grid_groups(int(case["model_parallel"]))
    graph = SyntheticCluster(n_hosts=int(case["n_hosts"]),
                             seed=int(case["graph_seed"])).probe_graph(
        int(case["n_probes"]))
    init = {k: _tensor(v) for k, v in case["init"].items()}
    out = {"grid": np.array([grid.data_rank, grid.model_rank, grid.n_data,
                             grid.n_model])}
    for key, value in tp_shard_state(init, grid).items():
        out[f"shard/{key}"] = _numpy(value)
    cfg = dict(case["config"])
    for mode in ("gather", "blocks"):
        trainer = GATTrainer(graph, GATTrainConfig(**cfg, attention=mode),
                             "cpu", init_state=init, grid=grid)
        result = trainer.fit()
        out[f"{mode}.history"] = np.array(result.history)
        out[f"{mode}.step_losses"] = np.array(result.step_losses)
        out[f"{mode}.f1"] = np.array(result.f1)
        out[f"{mode}.param_bytes"] = np.array(sum(
            p.numel() * p.element_size()
            for p in trainer.model.parameters()))
        out[f"{mode}.whole_bytes"] = np.array(sum(
            t.numel() * t.element_size()
            for t in result.state_dict.values()))
        for key, value in result.state_dict.items():
            out[f"{mode}.param/{key}"] = _numpy(value)
        artifact = (gat_artifact_from_result(result, graph, f"tp-{mode}")
                    if rank == 0 else b"")
        out[f"{mode}.artifact"] = np.frombuffer(artifact, np.uint8)

        # The embeddings of the given weights placed on the grid: this
        # rank's rows, gathered over the data axis.
        nbr, val = build_neighbor_lists(
            graph.n_nodes, graph.edge_src, graph.edge_dst,
            graph.edge_rtt_ns)
        feats, nbr, val, _ = pad_graph_sparse(graph.node_features, nbr, val,
                                              int(case["emb_pad"]))
        rows = _rows(len(nbr), grid.data_rank, grid.n_data)
        model = GraphTransformer(
            in_features=feats.shape[1], hidden=cfg["hidden"],
            embed=cfg["embed"], layers=cfg["layers"], heads=cfg["heads"],
            attention=mode, grid=grid)
        model.load_state_dict(tp_shard_state(
            {k: _tensor(v) for k, v in case["emb_state"].items()}, grid))
        with torch.no_grad():
            emb = model.node_embeddings(*(_tensor(a[rows])
                                          for a in (feats, nbr, val)))
            out[f"{mode}.emb"] = _numpy(all_gather_rows(emb, grid.data))
    return out
