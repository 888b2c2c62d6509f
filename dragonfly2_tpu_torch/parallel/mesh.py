"""The process group that stands in for a JAX mesh axis.

PyTorch runs one process per device, so where the JAX package names a
mesh axis (``parallel/mesh.py``) the port takes a ``torch.distributed``
process group; no mesh object is needed.
"""

from __future__ import annotations

import torch.distributed as dist


def group_size_rank(group=None) -> tuple[int, int]:
    """(size, rank) of ``group``. ``None`` means the default process group
    when one is initialized, and a world of one (1, 0) otherwise."""
    if group is None and not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)
