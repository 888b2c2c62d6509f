"""Background batch prefetching — port of ``dragonfly2_tpu/data/prefetch.py``.

Worker threads build (and place on the device) up to ``depth`` batches
ahead of the consumer, so the next batch's host work and host-to-device
copy run while the current step executes. Results come in task order;
determinism is the caller's job (pass per-task seeds into ``fn`` instead
of sharing one generator across workers).
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
U = TypeVar("U")


def prefetch(
    tasks: Iterable[T],
    fn: Callable[[T], U],
    depth: int = 2,
    workers: int = 2,
) -> Iterator[U]:
    """Yield ``fn(task)`` in task order with up to ``depth`` results built
    ahead by ``workers`` threads. A worker's exception is raised where its
    result is yielded. Closing the generator (the consumer breaks or
    raises) cancels the work not yet started."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    executor = ThreadPoolExecutor(max_workers=workers,
                                  thread_name_prefix="prefetch")
    pending: deque = deque()
    try:
        for task in tasks:
            pending.append(executor.submit(fn, task))
            if len(pending) > depth:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
    finally:
        executor.shutdown(wait=False, cancel_futures=True)
