"""Joining a training fleet: one process per rank over
``torch.distributed`` — port of ``dragonfly2_tpu/parallel/multihost.py``
and of ``cmd/common.py``'s ``maybe_init_multihost`` (the port has no
``cmd``).

The JAX package starts ``jax.distributed`` from a coordinator address,
a process count and a process id, and builds one global device mesh
over every process; XLA routes the collectives. Here the same three
values start a process group over ``tcp://`` (one process per rank),
and the trainers take that group where the JAX trainers take the mesh
(``group=``, :class:`~dragonfly2_tpu_torch.parallel.mesh.DataParallel`).

The backend is NCCL when the rank's device is a card and gloo on the CPU.
A caller may name another: gloo also all-reduces and broadcasts CUDA
tensors (through the host), which lets several ranks share one card,
where NCCL refuses two ranks on one GPU. Each rank's device is
``cuda:(rank % device_count)``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from dragonfly2_tpu_torch.parallel.mesh import LOCAL, Grid, grid_groups


@dataclass(frozen=True)
class MultihostInfo:
    process_id: int
    num_processes: int
    backend: str
    device: torch.device


def _env(name: str, cast, given):
    if given is not None:
        return given
    for key in (f"DF2_{name}", f"JAX_{name}"):
        if os.environ.get(key):
            return cast(os.environ[key])
    return None


def rank_device(rank: int) -> torch.device:
    """``cuda:(rank % device_count)`` on a machine with cards, else the
    CPU."""
    if torch.cuda.is_available():
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None, *,
                   backend: str | None = None) -> MultihostInfo:
    """Join (or start, as process 0) the default process group. Call once
    a process.

    Arguments fall back to the JAX package's environment names,
    ``DF2_COORDINATOR_ADDRESS`` / ``DF2_NUM_PROCESSES`` /
    ``DF2_PROCESS_ID`` and then ``JAX_*``. The address is ``host:port``
    (``tcp://`` may be written); process 0 listens there. ``backend``
    defaults to NCCL on a card and gloo on the CPU. On a card the rank's
    device becomes the current CUDA device."""
    if dist.is_initialized():
        raise RuntimeError("init_multihost called twice in one process")
    address = _env("COORDINATOR_ADDRESS", str, coordinator_address)
    world = _env("NUM_PROCESSES", int, num_processes)
    rank = _env("PROCESS_ID", int, process_id)
    if address is None or world is None or rank is None:
        raise ValueError(
            "init_multihost needs a coordinator address, a process count "
            "and a process id (arguments or DF2_COORDINATOR_ADDRESS, "
            "DF2_NUM_PROCESSES, DF2_PROCESS_ID)")
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside [0, {world})")
    device = rank_device(rank)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not address.startswith("tcp://"):
        address = f"tcp://{address}"
    dist.init_process_group(backend, init_method=address, world_size=world,
                            rank=rank)
    return MultihostInfo(process_id=dist.get_rank(),
                         num_processes=dist.get_world_size(),
                         backend=dist.get_backend(), device=device)


def maybe_init_multihost(coordinator: str = "", num_processes: int = 0,
                         process_id: int = -1, *,
                         backend: str | None = None):
    """Join the fleet when a coordinator is given (as an argument or in
    ``DF2_COORDINATOR_ADDRESS`` / ``JAX_COORDINATOR_ADDRESS``) and return
    the default group; ``None`` for the single-process path. The
    defaults are the trainer CLI's ``--coordinator``,
    ``--num-processes`` and ``--process-id`` flags left unset."""
    if not (coordinator or os.environ.get("DF2_COORDINATOR_ADDRESS")
            or os.environ.get("JAX_COORDINATOR_ADDRESS")):
        return None
    init_multihost(coordinator or None, num_processes or None,
                   process_id if process_id >= 0 else None, backend=backend)
    return dist.group.WORLD


def multihost_grid(model_parallel: int = 1) -> Grid:
    """The ``(data, model)`` grid over every process of the default group
    that :func:`init_multihost` joined — the counterpart of the JAX
    package's ``multihost_mesh(model_parallel)``, with its axis layout
    (``parallel/mesh.grid_groups``). Every process calls it alike."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("multihost_grid needs init_multihost first")
    return grid_groups(model_parallel)


def _collective_device(group=None) -> torch.device:
    """Where a collective's tensors live: the current card under NCCL,
    the host under gloo (whose all-gather takes CPU tensors only)."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _alone(group) -> bool:
    return group is LOCAL or not (dist.is_available()
                                  and dist.is_initialized())


def sync(name: str = "df2", group=None) -> None:
    """Barrier across every process of ``group`` (the default group; none
    in a world of one). ``name`` is the JAX package's barrier name;
    torch's barrier needs none."""
    del name
    if _alone(group):
        return
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


def agree(value, group=None) -> np.ndarray:
    """All-gather a small host value across processes → [P, ...]: lets
    callers assert that every rank holds the same metric, digest or
    decision. In a world of one: ``[value]``."""
    arr = np.asarray(value)
    if _alone(group):
        return arr[None]
    t = torch.from_numpy(arr.copy()).to(_collective_device(group))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return np.stack([o.cpu().numpy() for o in out])
