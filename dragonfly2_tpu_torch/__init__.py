"""PyTorch + CUDA port of ``dragonfly2_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package keeps its module names
so each port module sits at the same path as its counterpart. It imports
``torch`` and ``numpy`` only — never JAX, flax, optax, orbax, grpc,
pyarrow, or anything of ``dragonfly2_tpu`` — and keeps its own copy of
whatever framework-neutral code it needs.

Every entry point takes ``device=None``, meaning ``torch.device("cuda")``,
and fails when no card is present; pass ``device="cpu"`` to run the plain
PyTorch versions of the kernels (the CPU tests do).
"""
