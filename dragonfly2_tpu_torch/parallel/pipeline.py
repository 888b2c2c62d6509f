"""Pipeline parallelism — the GPipe microbatch schedule over a process
group, port of ``dragonfly2_tpu/parallel/pipeline.py``.

The model is S stages, one a rank of the group. Stage parameters are
stacked ``[S, ...]`` leaves (as the JAX package's, which shards them
over its ``stage`` axis); rank s reads only its slice s. A batch splits
into M microbatches. At schedule step t (M + S − 1 steps) rank s runs
``stage_fn`` on microbatch t − s when 0 ≤ t − s < M, and the activation
hops to rank s + 1 (:func:`~.mesh.ring_shift`). The last stage banks its
finished microbatches, and one all-reduce at the end returns the output
replicated.

Where JAX runs every step on every device and masks the bubble (SPMD
uniformity), a rank here knows its own index, so outside its window it
hands zeros around without running the stage: the same output and the
same gradients. The activation hops on every step but the last, whose
hop feeds nothing.

The schedule is one ``torch.autograd.Function``: its backward runs the
schedule in reverse, each step's gradient hopping back one rank, so every
rank makes the same hops in the same order whichever steps it was active
in (autograd alone would run a hop's backward only on ranks whose graph
uses it, and the hops would no longer pair up). A stage's backward
recomputes its forward from the stage input saved at that step — JAX's
``jax.checkpoint`` of the step body, one activation a step resident.
Every rank computes the same loss from the replicated output, so the
final all-reduce's backward is the identity; each rank's stage
parameters get their gradient on that rank only (the other slices' stay
zero), and ``x``'s gradient, which only stage 0 consumes, is summed over
the ranks (:func:`~.mesh.replicated_input`), as JAX transposes a
replicated input.
"""

from __future__ import annotations

from typing import Callable

import torch

from dragonfly2_tpu_torch.parallel.mesh import (
    EXCHANGES,
    _hop,
    _sum_f32,
    group_size_rank,
    replicated_input,
)


def _leaves(tree, path=""):
    """(JAX-style key path, leaf) of a nested dict of tensors, in sorted
    key order as ``jax.tree_util`` walks a dict."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{path}[{key!r}]")
    else:
        yield path, tree


def check_stacked(params, n: int, name: str, unit: str) -> None:
    """Every leaf's leading dim must equal the group's size: with a
    mismatch a rank would take one slice of several, and the result
    would be finite, plausible and wrong. Shared by the pipeline and MoE
    layouts."""
    for path, leaf in _leaves(params):
        if leaf.ndim == 0 or leaf.shape[0] != n:
            have = "a scalar" if leaf.ndim == 0 else str(leaf.shape[0])
            raise ValueError(
                f"{name} leaf {path} has {have} {unit} but the process "
                f"group has {n} ranks; stack exactly one per rank")


class _Schedule(torch.autograd.Function):
    """The GPipe schedule on one rank; ``leaves`` are the rank's stage
    parameters, flattened (``unflatten`` rebuilds the tree)."""

    @staticmethod
    def forward(ctx, run, x_mbs, *leaves):
        stage_fn, unflatten, group, n_stages, rank = run
        m = x_mbs.shape[0]
        params = unflatten(leaves)
        inputs = {}                    # step → the stage's input
        act = torch.zeros_like(x_mbs[0])
        banked = torch.zeros_like(x_mbs)
        n_steps = m + n_stages - 1
        for t in range(n_steps):
            mb = t - rank
            if 0 <= mb < m:
                # Stage 0 ingests microbatch t; later stages take the
                # inbound activation.
                inputs[t] = x_mbs[t] if rank == 0 else act
                y = stage_fn(params, inputs[t])
                if rank == n_stages - 1:
                    banked[mb] = y
            else:
                y = torch.zeros_like(act)
            if t < n_steps - 1:
                act = _hop([y], group, 1)[0] if n_stages > 1 else y
        ctx.run, ctx.inputs, ctx.m = run, inputs, m
        ctx.save_for_backward(*leaves)
        if n_stages == 1:
            return banked
        # Only the last stage banked real outputs; the sum is the
        # broadcast that returns them replicated.
        EXCHANGES.counts["all_reduce"] += 1
        return _sum_f32(banked, group).to(banked.dtype)

    @staticmethod
    def backward(ctx, g_out):
        stage_fn, unflatten, group, n_stages, rank = ctx.run
        leaves = ctx.saved_tensors
        m = ctx.m
        g_leaves = [torch.zeros_like(p) for p in leaves]
        g_x = torch.zeros_like(g_out)
        g_y = torch.zeros_like(g_out[0])      # from the next stage
        for t in reversed(range(m + n_stages - 1)):
            mb = t - rank
            g_in = torch.zeros_like(g_y)
            if 0 <= mb < m:
                if rank == n_stages - 1:
                    g_y = g_y + g_out[mb]
                with torch.enable_grad():
                    params = [p.detach().requires_grad_(p.requires_grad)
                              for p in leaves]
                    x_in = ctx.inputs[t].detach().requires_grad_()
                    y = stage_fn(unflatten(params), x_in)
                    wrt = [x_in] + [p for p in params if p.requires_grad]
                    grads = iter(torch.autograd.grad(
                        y, wrt, g_y, allow_unused=True))
                g_in = next(grads)
                g_in = torch.zeros_like(x_in) if g_in is None else g_in
                for i, p in enumerate(params):
                    g = next(grads) if p.requires_grad else None
                    if g is not None:
                        g_leaves[i] += g
                if rank == 0:
                    g_x[t] = g_in
                    g_in = torch.zeros_like(g_in)
            if t > 0:
                # The inverse of step t − 1's hop: the gradient of the
                # inbound activation goes back to the rank that sent it.
                g_y = _hop([g_in], group, -1)[0] if n_stages > 1 else g_in
        return (None, g_x, *g_leaves)


def pipeline_apply(stage_fn: Callable, stage_params, x, *, group=None,
                   microbatches: int | None = None):
    """Run ``x`` through S pipelined stages of ``stage_fn`` over ``group``
    (S = its size; ``None`` is the default process group, or a world of
    one when none is initialized).

    ``stage_fn(params_slice, x_mb) -> y_mb`` is one stage's compute,
    shape-preserving, with no collective. ``stage_params`` is a nested
    dict of stacked ``[S, ...]`` tensors; ``x`` is ``[B, ...]``, the same on
    every rank, split into ``microbatches`` equal slices (default S).
    Returns ``[B, ...]`` on every rank."""
    n_stages, rank = group_size_rank(group)
    if microbatches is not None and microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    m = microbatches if microbatches is not None else n_stages
    batch = x.shape[0]
    if batch % m:
        raise ValueError(f"batch ({batch}) must split into {m} equal "
                         "microbatches")
    check_stacked(stage_params, n_stages, "stage_params", "stages")
    paths = [path for path, _ in _leaves(stage_params)]
    mine = [leaf[rank] for _, leaf in _leaves(stage_params)]

    def unflatten(leaves):
        return _rebuild(stage_params, dict(zip(paths, leaves)))

    x_mbs = replicated_input(x, group).reshape(m, batch // m, *x.shape[1:])
    out = _Schedule.apply((stage_fn, unflatten, group, n_stages, rank),
                          x_mbs, *mine)
    return out.reshape(batch, *x.shape[1:])


def _rebuild(tree, by_path, path=""):
    """``tree``'s structure with each leaf replaced by ``by_path[path]``."""
    if isinstance(tree, dict):
        return {key: _rebuild(value, by_path, f"{path}[{key!r}]")
                for key, value in tree.items()}
    return by_path[path]


def stack_stage_params(param_list):
    """[per-stage param trees] → stacked ``[S, ...]`` leaves (host-side
    convenience for building the layout): nested dicts whose leaves are
    numpy arrays (``np.stack``) or tensors (``torch.stack``)."""
    import numpy as np

    first = param_list[0]
    if isinstance(first, dict):
        return {key: stack_stage_params([p[key] for p in param_list])
                for key in first}
    if isinstance(first, torch.Tensor):
        return torch.stack(param_list)
    return np.stack(param_list)
