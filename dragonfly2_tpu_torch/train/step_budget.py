"""Step-loop accounting — port of ``dragonfly2_tpu/train/step_budget.py``:
first-step exclusion plus a wall-clock budget.

The trainer waits for its first step to finish, restarts the clock, then
counts samples until the optional deadline, so the samples/s it reports
is the steady state. Where the JAX package blocks on an array
(``jax.block_until_ready``), this waits for the device the output tensor
lives on (``torch.cuda.synchronize``); CPU work has finished when the
call returns. ``on_compile`` fires with the first step's seconds,
``on_progress`` every ``progress_every`` steps with the current
steady-state rate. The JAX package's mid-run exclusion of a newly
compiled program (``sync_point``, ``new_program``) has no counterpart:
PyTorch runs eagerly and compiles nothing mid-run.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch


def block_until_ready(output) -> None:
    """Wait until the device work producing ``output`` has finished."""
    if isinstance(output, torch.Tensor) and output.device.type == "cuda":
        torch.cuda.synchronize(output.device)


class StepBudget:
    def __init__(
        self,
        max_seconds: Optional[float] = None,
        on_compile: Optional[Callable[[float], None]] = None,
        on_progress: Optional[Callable[[int, float], None]] = None,
        progress_every: int = 25,
    ):
        self.max_seconds = max_seconds
        self.steps = 0
        self.samples = 0
        self.compile_seconds = 0.0
        self._on_compile = on_compile
        self._on_progress = on_progress
        self._progress_every = max(progress_every, 1)
        self._start = time.perf_counter()
        self._deadline: Optional[float] = None
        self._elapsed: Optional[float] = None

    def tick(self, n_samples: int, first_step_output) -> bool:
        """Account one completed step dispatch; returns True when the
        budget is exhausted and the loop should stop. The first step is
        waited for and excluded from the throughput window (start and
        deadline begin after it)."""
        if self.steps == 0:
            block_until_ready(first_step_output)
            now = time.perf_counter()
            self.compile_seconds = now - self._start
            self._start = now
            if self.max_seconds is not None:
                self._deadline = now + self.max_seconds
            if self._on_compile is not None:
                self._on_compile(self.compile_seconds)
        else:
            self.samples += n_samples
        self.steps += 1
        if (self._on_progress is not None and self.samples
                and self.steps % self._progress_every == 0):
            # Wait for the CURRENT step so the published rate counts
            # finished device work, not the host's enqueue rate.
            block_until_ready(first_step_output)
            elapsed = max(time.perf_counter() - self._start, 1e-9)
            self._on_progress(self.steps, self.samples / elapsed)
        return (self._deadline is not None
                and time.perf_counter() >= self._deadline)

    def finish(self) -> None:
        """Freeze the throughput window (call after the final wait)."""
        self._elapsed = max(time.perf_counter() - self._start, 1e-9)

    def samples_per_sec(self, batch_size: int) -> float:
        """Steady-state throughput; a single-step run has no window after
        the first step, so the whole run is the best estimate."""
        elapsed = self._elapsed or max(time.perf_counter() - self._start, 1e-9)
        if self.samples:
            return self.samples / elapsed
        return batch_size * self.steps / max(self.compile_seconds, 1e-9)
