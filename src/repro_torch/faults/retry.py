"""Bounded exponential-backoff retry for checkpoint I/O.

``launch.train`` wraps every checkpoint save/restore in
:func:`retry_with_backoff` so a transiently failing filesystem (the
fault model's I/O analogue of a dropped link) degrades to a delayed
checkpoint instead of a dead run. Deliberately tiny and dependency-free:
deterministic delays (base * 2^attempt, capped), no jitter — retry
timing must not perturb the seeded fault realization.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple, Type

__all__ = ["retry_with_backoff"]


def retry_with_backoff(
    fn: Callable,
    *,
    attempts: int = 4,
    base_delay: float = 0.05,
    max_delay: float = 2.0,
    retry_on: Tuple[Type[BaseException], ...] = (OSError,),
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
):
    """Call ``fn()`` up to ``attempts`` times, sleeping
    ``min(base_delay * 2**i, max_delay)`` between tries.

    Only exceptions in ``retry_on`` are retried; anything else (and the
    final failure) propagates unchanged so the caller sees the real
    error. ``on_retry(attempt_index, exc, delay)`` is invoked before
    each sleep — a caller uses it to log and to emit fault-trace
    events. ``sleep`` is injectable for tests.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    for i in range(attempts):
        try:
            return fn()
        except retry_on as exc:
            if i == attempts - 1:
                raise
            delay = min(base_delay * (2.0 ** i), max_delay)
            if on_retry is not None:
                on_retry(i, exc, delay)
            sleep(delay)
