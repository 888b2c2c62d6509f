"""Device selection: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


class DeviceFault(RuntimeError):
    """A fault of the card or of the port's kernels, not of the data
    handed to them: no card, or a kernel that did not build, load or
    launch."""


def is_device_fault(exc: BaseException) -> bool:
    """True when ``exc`` is the card's fault rather than its input's: a
    :class:`DeviceFault`, device memory exhausted, or an error of the
    CUDA runtime or its libraries. A validation gate or a model reload
    lets such an error propagate instead of blaming the artifact."""
    if isinstance(exc, (DeviceFault, torch.cuda.OutOfMemoryError)):
        return True
    accelerator_error = getattr(torch, "AcceleratorError", None)
    if accelerator_error is not None and isinstance(exc, accelerator_error):
        return True
    return isinstance(exc, RuntimeError) and str(exc).startswith(
        ("CUDA error", "CUDA out of memory", "CUDA driver error",
         "CUBLAS_STATUS", "cuDNN error"))


def default_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    Raises when a CUDA device is asked for (explicitly or by default) and
    none is available — a measurement or serving path that finds no card
    must fail, not fall back to the CPU silently.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceFault(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch path")
    return dev
