"""Parallelism across processes (``torch.distributed``): the data axis of
the trainers, the ``(data, model)`` grid of tensor parallelism and its
Megatron exchanges, joining a fleet, and the layouts over one
process-group axis — Ulysses and ring sequence parallelism, the GPipe
pipeline and Switch experts."""

from dragonfly2_tpu_torch.parallel.mesh import (
    EXCHANGES,
    LOCAL,
    DataParallel,
    Grid,
    all_gather_rows,
    all_to_all,
    copy_to_model,
    global_batch,
    grid_groups,
    group_size_rank,
    reduce_from_model,
    ring_shift,
)
from dragonfly2_tpu_torch.parallel.moe import moe_apply
from dragonfly2_tpu_torch.parallel.multihost import (
    agree,
    init_multihost,
    maybe_init_multihost,
    multihost_grid,
    sync,
)
from dragonfly2_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    stack_stage_params,
)
from dragonfly2_tpu_torch.parallel.ring_attention import ring_attention
from dragonfly2_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = ["DataParallel", "EXCHANGES", "Grid", "LOCAL", "agree",
           "all_gather_rows", "all_to_all", "copy_to_model", "global_batch",
           "grid_groups", "group_size_rank", "init_multihost",
           "maybe_init_multihost", "moe_apply", "multihost_grid",
           "pipeline_apply", "reduce_from_model", "ring_attention",
           "ring_shift", "stack_stage_params", "sync", "ulysses_attention"]
