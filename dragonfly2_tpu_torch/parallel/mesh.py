"""The process group that stands in for a JAX mesh axis — port of the
data-parallel half of ``dragonfly2_tpu/parallel/mesh.py``.

PyTorch runs one process per device, so where the JAX package names a
mesh axis the port takes a ``torch.distributed`` process group; no mesh
object is needed. The JAX trainers jit a step with the batch sharded over
the mesh's ``data`` axis and let XLA insert the gradient ``psum``
(``MeshContext.batch_sharding``, ``data_parallel_mesh``).
:class:`DataParallel` is that axis spelled out: the global batch
rounded to a multiple of the world, this rank's rows of it, the initial
parameters broadcast from rank 0, and one all-reduce a step of every
gradient packed into one flat buffer.

``group=None`` means the default process group when one is initialized,
and a world of one otherwise. :data:`LOCAL` means this process alone
whatever groups exist: a fit that must stay local (a federated
cluster's) passes it, so that a process that happens to have a default
group does not turn it into a collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _Local:
    def __repr__(self) -> str:
        return "LOCAL"


#: A world of one, even inside an initialized default group.
LOCAL = _Local()


def group_size_rank(group=None) -> tuple[int, int]:
    """(size, rank) of ``group``. ``None`` means the default process group
    when one is initialized, and a world of one (1, 0) otherwise;
    :data:`LOCAL` is always (1, 0)."""
    if group is LOCAL or (group is None and not (
            dist.is_available() and dist.is_initialized())):
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def global_batch(batch: int, n: int, world: int) -> int:
    """The JAX trainers' global batch: at most ``n`` rows, rounded down to
    a multiple of the data-parallel degree (``(min(batch, n) // n_data) *
    n_data``), so that every rank holds as many rows and the mean of the
    ranks' means is the mean over the global batch."""
    return (min(batch, n) // world) * world


class DataParallel:
    """The data axis of one trainer over ``group`` (see the module
    docstring for ``None`` and :data:`LOCAL`). In a world of one without a
    process group every method is the identity and issues no
    collective."""

    def __init__(self, group=None):
        self.world, self.rank = group_size_rank(group)
        # Collectives run whenever a group is in play, a group of one
        # included (it all-reduces over one rank and divides by 1).
        self.active = group is not LOCAL and (
            group is not None or (dist.is_available()
                                  and dist.is_initialized()))
        self.group = None if group is LOCAL else group

    def rows(self, n: int) -> slice:
        """This rank's contiguous share of ``n`` global rows (the shares
        are equal when the world divides ``n``)."""
        return slice(self.rank * n // self.world,
                     (self.rank + 1) * n // self.world)

    def _src(self) -> int:
        """The global rank of the group's rank 0."""
        if self.group is None:
            return 0
        return dist.get_global_rank(self.group, 0)

    @torch.no_grad()
    def broadcast_(self, module: torch.nn.Module) -> None:
        """Overwrite ``module``'s parameters and buffers with rank 0's, in
        one broadcast of one flat buffer per dtype."""
        if not self.active:
            return
        by_dtype: dict = {}
        for t in list(module.parameters()) + list(module.buffers()):
            by_dtype.setdefault(t.dtype, []).append(t)
        for tensors in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in tensors])
            dist.broadcast(flat, src=self._src(), group=self.group)
            _unpack(flat, tensors)

    @torch.no_grad()
    def allreduce_grads_(self, params, loss: torch.Tensor) -> torch.Tensor:
        """Replace each gradient of ``params`` with its mean over the
        group, and return ``loss``'s mean over the group — one
        all-reduce of one f32 buffer holding every gradient and the
        loss, divided by the world size: the ``psum`` that XLA inserts
        for a batch-sharded step. Every rank then applies the same
        update to the same bits."""
        if not self.active:
            return loss
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([g.reshape(-1).float() for g in grads]
                         + [loss.detach().reshape(1).float()])
        dist.all_reduce(flat, group=self.group)
        flat.div_(self.world)
        _unpack(flat[:-1], grads)
        return flat[-1]

    def sum_(self, tensor: torch.Tensor) -> torch.Tensor:
        """``tensor`` summed over the group, in place (eval sums)."""
        if self.active:
            dist.all_reduce(tensor, group=self.group)
        return tensor

    def any(self, flag: bool, device) -> bool:
        """True when ``flag`` is true on any rank: ranks that stop on a
        wall-clock budget stop at the same step."""
        if not self.active:
            return flag
        t = torch.tensor([1.0 if flag else 0.0], device=device)
        dist.all_reduce(t, group=self.group)
        return bool(t.item() > 0)


def _unpack(flat: torch.Tensor, tensors) -> None:
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
