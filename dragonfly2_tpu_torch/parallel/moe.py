"""Expert parallelism — Switch-style top-1 mixture-of-experts routing over
a process group, port of ``dragonfly2_tpu/parallel/moe.py``.

Each rank holds a shard of the tokens and owns one expert (parameters
stacked ``[E, ...]``, rank e reading slice e). A token's top-1 gate
picks its expert; each rank packs its tokens into a capacity-bounded
dispatch buffer ``[E, C, d]``, one all-to-all (:func:`~.mesh.all_to_all`)
routes row e of every rank's buffer to rank e, the expert runs over
everything it received, and the inverse all-to-all plus a gather return
the outputs to their tokens, scaled by the gate probability. Tokens
past an expert's capacity are dropped (output 0), the documented Switch
trade.

The bits are JAX's: ``argmax`` takes the first index on ties (as
``jnp.argmax``), a token's slot is the running count of its expert's
tokens before it, the capacity is ``max(ceil(t / E · factor), 1)`` in
float64, and the dispatch is an accumulating scatter in which dropped
tokens add exact zeros, so the order of the sums cannot change the
result. Gradients reach the experts through both exchanges (an
all-to-all is its own inverse) and the gate through the combine scale.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from dragonfly2_tpu_torch.parallel.mesh import all_to_all, group_size_rank
from dragonfly2_tpu_torch.parallel.pipeline import (
    _leaves,
    _rebuild,
    check_stacked,
)


def moe_apply(expert_fn: Callable, expert_params, x, gate_logits, *,
              group=None, capacity_factor: float = 1.25):
    """Route this rank's tokens through the group's experts by top-1
    gating.

    ``expert_fn(params_slice, tokens) -> tokens`` is one expert's compute
    (shape-preserving); ``expert_params`` leaves are stacked ``[E, ...]``
    with E the size of ``group`` (``None``: the default process group,
    or a world of one). ``x``: this rank's ``[t, d]`` tokens and
    ``gate_logits``: their ``[t, E]`` logits; every rank passes the same
    number of tokens. Returns this rank's ``[t, d]`` outputs."""
    if x.ndim != 2 or gate_logits.ndim != 2:
        raise ValueError(
            f"expected x as [tokens, d] and gate_logits as "
            f"[tokens, experts], got {tuple(x.shape)} / "
            f"{tuple(gate_logits.shape)}; flatten batch dims before routing")
    n_exp, rank = group_size_rank(group)
    if gate_logits.shape[-1] != n_exp:
        raise ValueError(
            f"gate_logits last dim ({gate_logits.shape[-1]}) must equal "
            f"the process group's size ({n_exp}) — one expert per rank")
    if gate_logits.shape[0] != x.shape[0]:
        raise ValueError(
            f"gate_logits covers {gate_logits.shape[0]} tokens but x "
            f"has {x.shape[0]}")
    check_stacked(expert_params, n_exp, "expert_params", "experts")
    t_loc, width = x.shape
    capacity = max(int(math.ceil(t_loc / n_exp * capacity_factor)), 1)
    params_e = _rebuild(expert_params, {
        path: leaf[rank] for path, leaf in _leaves(expert_params)})

    # Top-1 gate: the winner's softmax probability scales the output and
    # carries the gradient back into the gate.
    probs = torch.softmax(gate_logits.float(), dim=-1)
    expert_idx = torch.argmax(gate_logits, dim=-1)            # [t]
    gate = probs.gather(-1, expert_idx[:, None])[:, 0]       # [t]

    # A token's place in its expert's capacity window: how many tokens
    # before it chose the same expert.
    onehot = F.one_hot(expert_idx, n_exp)
    rows = torch.arange(t_loc, device=x.device)
    pos = (torch.cumsum(onehot, dim=0) - 1)[rows, expert_idx]
    keep = pos < capacity
    slot = pos.clamp(0, capacity - 1)

    # Dispatch: [E, C, d]; dropped tokens add zeros to a clamped slot.
    dispatch = x.new_zeros(n_exp, capacity, width).index_put(
        (expert_idx, slot), x * keep[:, None].to(x.dtype), accumulate=True)
    # Row e of every rank's buffer lands on rank e, which then holds
    # [E_src, C, d] for its expert.
    routed = all_to_all(dispatch, group).reshape(n_exp * capacity, width)
    out = expert_fn(params_e, routed).reshape(n_exp, capacity, -1)
    # The inverse exchange returns the expert outputs to their tokens.
    back = all_to_all(out, group)
    gathered = back[expert_idx, slot]                        # [t, d]
    scale = (gate * keep.float()).to(x.dtype)
    return gathered * scale[:, None]
