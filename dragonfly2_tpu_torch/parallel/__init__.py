"""Sequence parallelism across processes (``torch.distributed``)."""

from dragonfly2_tpu_torch.parallel.mesh import group_size_rank
from dragonfly2_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = ["group_size_rank", "ulysses_attention"]
