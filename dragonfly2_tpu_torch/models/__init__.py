"""Model modules (``nn.Module``s with flax-compatible parameter names)."""
