"""What a kernel wrapper does with meta tensors, and who hears of it.

A wrapper given meta tensors (the dry run, ``repro_torch.launch.dryrun``)
runs its own shape, dtype and width checks, allocates the outputs its
CUDA kernel would allocate and calls :func:`report` with the kernel's
name and its ``cost(...)``: the FLOPs and bytes behind ``PERF.md``'s
bound column. ``repro_torch.analysis.cost.CostMode`` is the listener and
counts the launch; with none listening a report goes nowhere. The
wrapper's own ``launches`` counter is left alone: it counts launches of
the kernel on the card only.
"""
from __future__ import annotations

from typing import Callable, List

import torch

_LISTENERS: List[Callable] = []


def is_meta(t: torch.Tensor) -> bool:
    return t.device.type == "meta"


def listen(fn: Callable) -> None:
    """Call ``fn(kernel, flops, nbytes, dtype)`` on every meta launch."""
    _LISTENERS.append(fn)


def unlisten(fn: Callable) -> None:
    _LISTENERS.remove(fn)


def report(kernel: str, flops: int, nbytes: int, dtype: torch.dtype) -> None:
    for fn in list(_LISTENERS):
        fn(kernel, flops, nbytes, dtype)
