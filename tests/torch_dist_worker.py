"""Multi-process runs of the port on the CPU (gloo): Ulysses attention,
and any function of ``tests/torch_dp_worker.py`` (the data-parallel
trainers, ``sync`` and ``agree``, the dryrun twin) or of
``tests/torch_parallel_worker.py`` (ring attention, the pipeline, the
experts, ring-mode graph attention).

:func:`spawn_worlds` starts one process per rank for each world size, all
at once, each joining its world's process group through a ``file://``
store, and gathers what every rank computed. The ranks run
:func:`run_rank` from this module, which a spawned child imports afresh:
so this module imports no JAX (and nothing that does), only torch, numpy
and the port.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
import traceback

import numpy as np

# Process-group timeout: a rank that waits longer for its peers fails.
PG_TIMEOUT_S = 60


def _run_case(case: dict, rank: int, world: int) -> dict:
    import torch

    from dragonfly2_tpu_torch.parallel import ulysses_attention

    if "call" in case:
        import importlib

        module = importlib.import_module(
            str(case.get("module", "torch_dp_worker")))
        return getattr(module, case["call"])(case, rank, world)

    t = case["q"].shape[0]
    rows = slice(rank * t // world, (rank + 1) * t // world)
    q, k, v = (torch.from_numpy(case[n][rows].copy()).requires_grad_(
        case.get("grad", False)) for n in ("q", "k", "v"))
    kwargs = dict(causal=case["causal"], chunk=case.get("chunk", 1024))
    if case.get("expect_error"):
        try:
            ulysses_attention(q, k, v, **kwargs)
        except ValueError as exc:
            return {"error": np.array(str(exc))}
        return {"error": np.array("")}
    out = ulysses_attention(q, k, v, **kwargs)
    result = {"out": out.detach().numpy()}
    if case.get("grad"):
        (out ** 2).sum().backward()
        result.update(dq=q.grad.numpy(), dk=k.grad.numpy(),
                      dv=v.grad.numpy())
    return result


def run_rank(rank: int, world: int, store: str, cases: dict,
             out_dir: str) -> None:
    """One rank: join the gloo group, run every case, save the results to
    ``out_dir/rank<rank>.npz`` (a traceback to ``rank<rank>.err``)."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", world_size=world,
            rank=rank, timeout=timedelta(seconds=PG_TIMEOUT_S))
        try:
            flat = {}
            for name, case in cases.items():
                for key, val in _run_case(case, rank, world).items():
                    flat[f"{name}/{key}"] = val
            np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **flat)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def spawn_worlds(worlds: dict, tmp_dir: str, timeout_s: float = 90.0):
    """Run ``{world size: {case name: case}}`` with one process per rank,
    every world at once. A case holds global q/k/v [T, H, D] f32 arrays,
    ``causal``, and optionally ``chunk``, ``grad`` and ``expect_error``;
    or ``call``, the name of a function of ``module`` (default
    ``torch_dp_worker``) that takes (case, rank, world) and returns
    ``{key: array}``.
    Returns ``{world: {case name: {key: per-rank arrays, rank order}}}``.
    Raises when a rank fails or the whole run outlasts ``timeout_s``
    (the ranks are then terminated)."""
    ctx = mp.get_context("spawn")
    procs = []
    for world, cases in worlds.items():
        out_dir = os.path.join(tmp_dir, f"world{world}")
        os.makedirs(out_dir)
        # A FileStore's file must not exist yet and serves one group.
        store = os.path.join(out_dir, "store")
        for rank in range(world):
            proc = ctx.Process(target=run_rank,
                               args=(rank, world, store, cases, out_dir))
            proc.start()
            procs.append((world, rank, proc, out_dir))
    deadline = time.monotonic() + timeout_s
    for *_, proc, _ in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    hung = [(w, r) for w, r, proc, _ in procs if proc.is_alive()]
    for *_, proc, _ in procs:
        if proc.is_alive():
            proc.terminate()
            proc.join(5)
    if hung:
        raise TimeoutError(f"ranks (world, rank) {hung} still running after "
                           f"{timeout_s} s")
    failed = {}
    for world, rank, proc, out_dir in procs:
        if proc.exitcode != 0:
            err = os.path.join(out_dir, f"rank{rank}.err")
            failed[(world, rank)] = (open(err).read() if os.path.exists(err)
                                     else f"exit code {proc.exitcode}")
    if failed:
        raise RuntimeError(f"ranks failed: {failed}")
    return load_worlds(worlds, tmp_dir)


def load_worlds(worlds: dict, tmp_dir: str):
    """What :func:`spawn_worlds` returns, read back from the ranks' files
    under ``tmp_dir``."""
    results = {}
    for world, cases in worlds.items():
        out_dir = os.path.join(tmp_dir, f"world{world}")
        per_rank = [np.load(os.path.join(out_dir, f"rank{r}.npz"))
                    for r in range(world)]
        results[world] = {
            name: {key.split("/", 1)[1]: [d[key] for d in per_rank]
                   for key in per_rank[0].files if key.startswith(name + "/")}
            for name in cases}
    return results


def run_once(root: str, run) -> None:
    """``run()`` once for every process that asks with the same ``root``
    (pytest-xdist workers of one run): the first runs it under a file
    lock, the others wait for it and see its result, or its failure."""
    from filelock import FileLock

    os.makedirs(root, exist_ok=True)
    done, error = (os.path.join(root, name) for name in ("done", "error"))
    with FileLock(os.path.join(root, "lock")):
        if os.path.exists(error):
            raise RuntimeError(open(error).read())
        if not os.path.exists(done):
            try:
                run()
            except Exception as exc:
                with open(error, "w") as fh:
                    fh.write(f"{type(exc).__name__}: {exc}")
                raise
            open(done, "w").close()


def spawn_once(names: dict, build, root: str, timeout_s: float = 90.0):
    """:func:`spawn_worlds` of ``build()`` into ``root`` once a test run
    (:func:`run_once`: only the first caller builds the cases), its
    results read back by every caller. ``names`` is ``{world: case
    names}`` of what ``build()`` returns."""
    run_once(root, lambda: spawn_worlds(build(), root, timeout_s))
    return load_worlds(names, root)
