"""Spans inside the model, on the spans of the step that runs it.

A train step makes its :class:`~repro_torch.telemetry.timers.StepSpans`
current while it runs the model (``block_spans``), and a block opens its
own spans on them: ``mla`` and ``moe`` around each latent-attention and
MoE block's forward (remat's recompute in the backward included), and
``mla/backward`` / ``moe/backward`` around its backward, opened by the
gradient of the block's output and closed by that of its input
(:class:`BackwardSpan`, identity autograd Functions). Autograd runs the
backward of CUDA tensors, and a checkpoint's recompute with it, on a
thread of its own: ``bind_block_spans`` carries the spans there, as
``dist.sharding.bound`` carries the rules. Nothing is fenced; outside a
step (serving, the FSDP steps, the tests' direct calls) the blocks open
nothing.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Tuple

import torch

from repro_torch.telemetry.timers import NO_SPANS

_BLOCKS = threading.local()


@contextlib.contextmanager
def block_spans(spans, *, counters: bool = False):
    """Make ``spans`` (a step's :class:`StepSpans`, or :data:`NO_SPANS`)
    the ones the model's blocks open theirs on, on this thread; with
    ``counters`` the blocks attach their counters too."""
    prev = getattr(_BLOCKS, "current", None)
    _BLOCKS.current = (spans, counters)
    try:
        yield
    finally:
        _BLOCKS.current = prev


def current_block_spans() -> Tuple[Any, bool]:
    """``(spans, counters)`` current on this thread; ``(NO_SPANS, False)``
    outside any ``block_spans``."""
    return getattr(_BLOCKS, "current", None) or (NO_SPANS, False)


def bind_block_spans(fn: Callable) -> Callable:
    """``fn`` run with the block spans current now, wherever it is called
    (autograd's backward thread recomputes a checkpointed layer there)."""
    current = getattr(_BLOCKS, "current", None)
    if current is None:
        return fn

    def run(*args, **kwargs):
        with block_spans(current[0], counters=current[1]):
            return fn(*args, **kwargs)

    return run


class _Mark(torch.autograd.Function):
    """The identity; its backward opens (at a block's output) or closes
    (at its input) the block's backward span. It saves its input so that
    a checkpointed layer is recomputed before the span opens, not inside
    it (the recompute keeps its own forward spans)."""

    @staticmethod
    def forward(ctx, x, box, opens: bool):
        ctx.box, ctx.opens = box, opens
        ctx.save_for_backward(x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.saved_tensors  # noqa: B018 - unpacking runs a pending recompute first
        if ctx.opens:
            ctx.box.open()
        else:
            ctx.box.close()
        return grad, None, None


class BackwardSpan:
    """A block's backward span ``name``: ``input(x)`` marks the block's
    input and ``output(y)`` its output; the gradient reaching the output
    opens the span, the input's (complete once every use inside the block
    has given its part) closes it. Nothing is marked without spans or
    without a gradient to follow into the input: a span that opens always
    closes."""

    def __init__(self, spans, name: str):
        self.spans, self.name = spans, name
        self._span = None
        self.marked = False
        self.live = spans is not NO_SPANS and torch.is_grad_enabled()

    def input(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.live and x.requires_grad):
            return x
        self.marked = True
        return _Mark.apply(x, self, False)

    def output(self, y: torch.Tensor) -> torch.Tensor:
        return _Mark.apply(y, self, True) if self.marked and y.requires_grad else y

    def open(self) -> None:
        self._span = self.spans(self.name)
        self._span.__enter__()

    def close(self) -> None:
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None
