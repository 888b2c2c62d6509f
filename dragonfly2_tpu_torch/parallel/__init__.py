"""Parallelism across processes (``torch.distributed``): the data axis of
the trainers, joining a fleet, and the layouts over one process-group
axis — Ulysses and ring sequence parallelism, the GPipe pipeline and
Switch experts. Tensor parallelism is not ported (ROADMAP.md Queue 1
item 8b)."""

from dragonfly2_tpu_torch.parallel.mesh import (
    EXCHANGES,
    LOCAL,
    DataParallel,
    all_gather_rows,
    all_to_all,
    global_batch,
    group_size_rank,
    ring_shift,
)
from dragonfly2_tpu_torch.parallel.moe import moe_apply
from dragonfly2_tpu_torch.parallel.multihost import (
    agree,
    init_multihost,
    maybe_init_multihost,
    sync,
)
from dragonfly2_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    stack_stage_params,
)
from dragonfly2_tpu_torch.parallel.ring_attention import ring_attention
from dragonfly2_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = ["DataParallel", "EXCHANGES", "LOCAL", "agree", "all_gather_rows",
           "all_to_all", "global_batch", "group_size_rank", "init_multihost",
           "maybe_init_multihost", "moe_apply", "pipeline_apply",
           "ring_attention", "ring_shift", "stack_stage_params", "sync",
           "ulysses_attention"]
