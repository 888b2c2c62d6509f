"""The process groups that stand in for a JAX mesh — port of
``dragonfly2_tpu/parallel/mesh.py``: the data axis, the ``(data, model)``
grid, and the exchanges that ``shard_map`` bodies and tensor-parallel
layers make over an axis.

PyTorch runs one process per device, so where the JAX package names a
mesh axis the port takes a ``torch.distributed`` process group, and
where it builds a ``(data, model)`` mesh the port builds a :class:`Grid`:
a group for each axis that a rank belongs to (:func:`grid_groups`). The
JAX trainers jit a step with the batch sharded over
the mesh's ``data`` axis and let XLA insert the gradient ``psum``
(``MeshContext.batch_sharding``, ``data_parallel_mesh``).
:class:`DataParallel` is that axis spelled out: the global batch
rounded to a multiple of the world, this rank's rows of it, the initial
parameters broadcast from rank 0, and one all-reduce a step of every
gradient packed into one flat buffer.

The exchanges (:func:`ring_shift`, :func:`all_gather_rows`,
:func:`all_to_all`, :func:`replicated_input`) are the collectives of the
JAX package's ``shard_map`` bodies — ``lax.ppermute`` around the ring,
the row all-gather of a sharded table, ``lax.all_to_all`` tiled over dim
0, the transpose of a replicated input — and Megatron's two exchanges over
the model axis (:func:`copy_to_model`, :func:`reduce_from_model`), each a
``torch.autograd.Function`` whose backward is the collective's transpose.
NCCL carries device tensors directly. gloo takes CPU tensors only in its
point-to-point and all-to-all, so under gloo every exchange of device
tensors goes through pinned host memory (its all-reduce too, on one
path): chosen by the group's backend, counted in :data:`EXCHANGES`. Every exchange moves bytes (a ``uint8``
view), so no backend's dtype support matters, and sums run in f32. The
compute never leaves the device.

``group=None`` means the default process group when one is initialized,
and a world of one otherwise. :data:`LOCAL` means this process alone
whatever groups exist: a fit that must stay local (a federated
cluster's) passes it, so that a process that happens to have a default
group does not turn it into a collective.
"""

from __future__ import annotations

from dataclasses import dataclass

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


# -- the exchanges of one mesh axis ------------------------------------------


class Exchanges:
    """How many exchanges of each kind this process issued, and the bytes
    that gloo's took through pinned host memory (both ways). The
    exchanges of a world of one issue no collective and count nothing."""

    KINDS = ("ring_shift", "all_gather", "reduce_scatter", "all_to_all",
             "all_reduce")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.counts = dict.fromkeys(self.KINDS, 0)
        self.staged_bytes = 0

    def read(self) -> dict:
        return dict(self.counts, staged_bytes=self.staged_bytes)


#: The process's exchange counts (``chip_smoke.py`` reads them).
EXCHANGES = Exchanges()


def _peer(group, rank: int) -> int:
    """The global rank of ``group``'s rank ``rank``."""
    return rank if group is None else dist.get_global_rank(group, rank)


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(-1).view(torch.uint8)


def _from_bytes(flat: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return flat.view(like.dtype).view(like.shape)


class _Transport:
    """Where one exchange's buffers live: the device under NCCL or when
    the tensors are on the CPU; pinned host memory for device tensors
    under gloo (its point-to-point and all-to-all take CPU tensors only).
    """

    def __init__(self, group, device: torch.device):
        self.device = device
        self.staged = (device.type != "cpu"
                       and dist.get_backend(group) == "gloo")

    def out(self, flat: torch.Tensor) -> torch.Tensor:
        if not self.staged:
            return flat
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat)
        EXCHANGES.staged_bytes += host.numel() * host.element_size()
        return host

    def empty(self, numel: int, dtype) -> torch.Tensor:
        if self.staged:
            return torch.empty(numel, dtype=dtype, pin_memory=True)
        return torch.empty(numel, dtype=dtype, device=self.device)

    def back(self, flat: torch.Tensor) -> torch.Tensor:
        if not self.staged:
            return flat
        EXCHANGES.staged_bytes += flat.numel() * flat.element_size()
        return flat.to(self.device)


def _hop(tensors, group, offset: int) -> list:
    """Send ``tensors`` (packed into one byte buffer) to the rank
    ``offset`` ahead and receive the same shapes from the rank
    ``offset`` behind: one send and one receive a hop."""
    world, rank = group_size_rank(group)
    flat = torch.cat([_as_bytes(t) for t in tensors])
    transport = _Transport(group, flat.device)
    send = transport.out(flat)
    recv = transport.empty(send.numel(), send.dtype)
    ops = [dist.P2POp(dist.isend, send, _peer(group, (rank + offset) % world),
                      group),
           dist.P2POp(dist.irecv, recv, _peer(group, (rank - offset) % world),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    recv = transport.back(recv)
    EXCHANGES.counts["ring_shift"] += 1
    out, start = [], 0
    for t in tensors:
        size = t.numel() * t.element_size()
        out.append(_from_bytes(recv[start:start + size], t))
        start += size
    return out


class _RingShift(torch.autograd.Function):
    """``lax.ppermute`` with ``perm = [(i, (i + 1) % d)]`` over several
    tensors in one hop; the backward sends the floating gradients back
    one rank (the inverse permutation)."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        ctx.floating = [t.is_floating_point() for t in tensors]
        ctx.dtypes = [t.dtype for t in tensors]
        ctx.shapes = [t.shape for t in tensors]
        ctx.device = tensors[0].device
        out = _hop(tensors, group, 1)
        ctx.mark_non_differentiable(
            *[o for o, f in zip(out, ctx.floating) if not f])
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        sent = [torch.zeros(shape, dtype=dtype, device=ctx.device)
                if g is None else g
                for g, f, dtype, shape in zip(grads, ctx.floating,
                                              ctx.dtypes, ctx.shapes) if f]
        back = iter(_hop(sent, ctx.group, -1))
        return (None, *[next(back) if f else None for f in ctx.floating])


def ring_shift(x, group=None):
    """This rank's tensor(s) to the next rank of ``group``, the previous
    rank's to this one (JAX's ``ppermute`` one step around the ring).
    ``x`` is a tensor or a sequence of tensors, which share one hop;
    returns the same structure. In a world of one: ``x``, and no
    collective."""
    single = isinstance(x, torch.Tensor)
    tensors = (x,) if single else tuple(x)
    if group_size_rank(group)[0] == 1:
        return x
    out = _RingShift.apply(group, *tensors)
    return out[0] if single else out


def _all_gather_bytes(x, group, world: int) -> torch.Tensor:
    flat = _as_bytes(x)
    transport = _Transport(group, flat.device)
    send = transport.out(flat)
    recv = transport.empty(world * send.numel(), send.dtype)
    dist.all_gather(list(recv.chunk(world)), send, group=group)
    return _from_bytes(transport.back(recv),
                       x.new_empty((world * x.shape[0], *x.shape[1:])))


def _sum_f32(x, group) -> torch.Tensor:
    """``x`` summed over ``group`` in f32 (a new tensor, on x's device)."""
    total = x.float().contiguous().clone()
    transport = _Transport(group, total.device)
    buf = transport.out(total.view(-1))
    dist.all_reduce(buf, group=group)
    return transport.back(buf).view(total.shape)


class _AllGatherRows(torch.autograd.Function):
    """Row shards → the whole table on every rank; the backward is the
    SUMMING reduce-scatter: each rank's rows get every rank's gradient."""

    @staticmethod
    def forward(ctx, x, group, world, rank):
        ctx.group, ctx.world, ctx.rank = group, world, rank
        EXCHANGES.counts["all_gather"] += 1
        return _all_gather_bytes(x, group, world)

    @staticmethod
    def backward(ctx, grad):
        rows = grad.shape[0] // ctx.world
        EXCHANGES.counts["reduce_scatter"] += 1
        total = _sum_f32(grad, ctx.group)
        mine = total[ctx.rank * rows:(ctx.rank + 1) * rows]
        return mine.to(grad.dtype), None, None, None


def all_gather_rows(x, group=None):
    """Every rank's row shard ``[n, ...]`` stacked in rank order →
    ``[world · n, ...]`` on every rank (JAX's reshard of a row-sharded
    array to replicated). The gradient of a rank's shard is the sum of
    every rank's gradient of its rows. In a world of one: ``x``."""
    world, rank = group_size_rank(group)
    if world == 1:
        return x
    return _AllGatherRows.apply(x, group, world, rank)


def _all_to_all(x, group) -> torch.Tensor:
    flat = _as_bytes(x)
    transport = _Transport(group, flat.device)
    send = transport.out(flat)
    recv = transport.empty(send.numel(), send.dtype)
    dist.all_to_all_single(recv, send, group=group)
    EXCHANGES.counts["all_to_all"] += 1
    return _from_bytes(transport.back(recv), x)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, ctx.group), None


def all_to_all(x, group=None):
    """JAX's ``lax.all_to_all(x, split_axis=0, concat_axis=0,
    tiled=True)``: dim 0 (a multiple of the world) splits into one block
    a rank, block ``i`` goes to rank ``i``, and the blocks received stack
    in rank order. Its own inverse, so its backward is itself. In a world
    of one: ``x``."""
    world, _ = group_size_rank(group)
    if world == 1:
        return x
    if x.shape[0] % world:
        raise ValueError(f"dim 0 ({x.shape[0]}) must split over the "
                         f"{world} ranks")
    return _AllToAll.apply(x, group)


class _ReplicatedInput(torch.autograd.Function):
    """An input that every rank holds alike but only some ranks consume:
    its gradient is the sum of the ranks' cotangents (JAX's transpose of
    a replicated ``shard_map`` input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        EXCHANGES.counts["all_reduce"] += 1
        return _sum_f32(grad, ctx.group).to(grad.dtype), None


def replicated_input(x, group=None):
    """``x`` unchanged; its gradient summed over ``group``. In a world of
    one, or when ``x`` takes no gradient: ``x``."""
    if group_size_rank(group)[0] == 1 or not x.requires_grad:
        return x
    return _ReplicatedInput.apply(x, group)


def copy_to_model(x, group=None):
    """Megatron's f, before the column splits of a tensor-parallel layer:
    ``x`` unchanged forward; its gradient, each rank's partial from its
    own columns, summed over the model axis ``group`` backward (the
    transpose of a replicated input, :func:`replicated_input`)."""
    return replicated_input(x, group)


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the ranks' partial sums added (an f32 all-reduce)
    forward; the gradient, which every rank holds alike, unchanged
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        EXCHANGES.counts["all_reduce"] += 1
        return _sum_f32(x, group).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def reduce_from_model(x, group=None):
    """Megatron's g, after the row split of a tensor-parallel layer:
    ``x`` summed over the model axis ``group`` in f32 and cast back; its
    gradient passes unchanged. In a world of one: ``x``."""
    if group_size_rank(group)[0] == 1:
        return x
    return _ReduceFromModel.apply(x, group)


# -- the (data, model) grid --------------------------------------------------


@dataclass(frozen=True)
class Grid:
    """This rank's place on a ``(data, model)`` grid of ranks and the two
    groups it belongs to: ``data``, the ranks that share its model index
    (they hold the same weight shards and different node rows), and
    ``model``, the ranks that share its data index (they hold the same
    rows and split the weights). Either is :data:`LOCAL` where its axis
    has one rank; ``data`` may also be ``None`` (the default group, or a
    world of one), as ``group=`` is elsewhere."""

    data: object
    model: object
    n_data: int
    n_model: int
    data_rank: int
    model_rank: int

    @classmethod
    def of(cls, group=None) -> "Grid":
        """The grid of a plain data-parallel ``group``: every rank on the
        data axis, a model axis of one."""
        world, rank = group_size_rank(group)
        return cls(group, LOCAL, world, 1, rank, 0)


def grid_groups(model_parallel: int, group=None) -> Grid:
    """The ``(data, model)`` grid over ``group``'s ranks (the default
    group when ``None``), laid out as ``jax.make_mesh((n // mp, mp),
    ("data", "model"))``: rank ``r`` sits at data index ``r // mp`` and
    model index ``r % mp``, so that rank ``i`` holds what JAX device
    ``i`` holds. Every rank of the default group must call it alike: it
    creates a group for each row and each column of the grid
    (``dist.new_group``, which is collective over the default group).
    With ``model_parallel == 1``, and in a world of one, it creates none:
    the grid is :meth:`Grid.of` ``group``."""
    world, rank = group_size_rank(group)
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model_parallel ({model_parallel}) must divide "
                         f"the world ({world})")
    if model_parallel == 1:
        return Grid.of(group)
    n_data = world // model_parallel
    ranks = (list(range(world)) if group is None
             else dist.get_process_group_ranks(group))
    data = model = LOCAL
    # new_group is collective over the whole world: every rank creates
    # every group, in one order, and keeps those it belongs to.
    if n_data > 1:
        for m in range(model_parallel):
            g = dist.new_group(ranks[m::model_parallel])
            if m == rank % model_parallel:
                data = g
    for d in range(n_data):
        g = dist.new_group(ranks[d * model_parallel:(d + 1) * model_parallel])
        if d == rank // model_parallel:
            model = g
    return Grid(data, model, n_data, model_parallel,
                rank // model_parallel, rank % model_parallel)
