"""Parallelism across processes (``torch.distributed``): the data axis of
the trainers, joining a fleet, and Ulysses sequence parallelism."""

from dragonfly2_tpu_torch.parallel.mesh import (
    LOCAL,
    DataParallel,
    global_batch,
    group_size_rank,
)
from dragonfly2_tpu_torch.parallel.multihost import (
    agree,
    init_multihost,
    maybe_init_multihost,
    sync,
)
from dragonfly2_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = ["DataParallel", "LOCAL", "agree", "global_batch",
           "group_size_rank", "init_multihost", "maybe_init_multihost",
           "sync", "ulysses_attention"]
