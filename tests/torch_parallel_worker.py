"""What a rank runs in the port's sequence, pipeline and expert
parallelism tests (``tests/test_torch_ring_attention.py``,
``test_torch_pipeline.py``, ``test_torch_moe.py``) and in the ring-mode
GraphTransformer's (``test_torch_model.py``), spawned through
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
