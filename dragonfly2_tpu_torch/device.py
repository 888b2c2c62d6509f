"""Device selection: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    Raises when a CUDA device is asked for (explicitly or by default) and
    none is available — a measurement or serving path that finds no card
    must fail, not fall back to the CPU silently.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch path")
    return dev
