"""Hand-written CUDA kernels and their plain PyTorch twins."""

from dragonfly2_tpu_torch.ops.flash_attention import flash_attention

__all__ = ["flash_attention"]
