"""Learning-rate schedule shared by the port's trainers."""

from __future__ import annotations

import math


def warmup_cosine_lr(step: int, peak: float, warmup_steps: int,
                     decay_steps: int) -> float:
    """optax ``warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps)`` at ``step``: linear from 0 over the warmup, then a
    cosine down to 0 over the remaining steps."""
    if step < warmup_steps:
        frac = 1.0 - min(max(step, 0), warmup_steps) / warmup_steps
        return -peak * frac + peak
    span = decay_steps - warmup_steps
    count = min(step - warmup_steps, span)
    return peak * 0.5 * (1.0 + math.cos(math.pi * count / span))
