"""Tensor parallel over the mesh's ``model`` axis: the context the layers
read, and the collectives at the edges of their sharded regions.

The JAX package declares logical axes and lets GSPMD insert the
collectives. The port runs the same layouts (``repro_torch.dist.sharding``'s
rules) as explicit sharded layers in the Megatron style: column-parallel
projections take a replicated input through ``to_model``, row-parallel
ones give a partial sum that ``reduce_from_model`` adds over the model
group. Activations between sharded regions are replicated, bit-equal on
every rank, and so is every replicated parameter's gradient: each rank
differentiates the same replicated loss, and every place where a
replicated tensor feeds a sharded computation passes it through
``to_model``, whose backward adds the ranks' partial gradients.

``context()`` is ``None`` with no rules active or a ``model`` axis of 1:
the layers then run their one-device code, bit for bit. The reductions
run in fp32, cast back afterwards, through ``repro_torch.dist.comm``.

Sequence parallel (the rules map ``seq_res``, JAX's residual-stream
constraint ``("batch", "seq_res", "embed")``): the residual stream of
the decoder layers is this rank's contiguous ``1 / T`` of the sequence,
and the norms and residual adds run on it (a norm's scale is used on
every rank's slice, so its gradient is added over the ranks,
``sum_grad``). Each sublayer gathers its normed input over the sequence
(``SeqIn``: the all-gather, whose transpose is the reduce-scatter of the
ranks' partial gradients) and runs its block on the whole sequence:
attention and the Mamba scan need it. The sublayer hands the block the
gathered sequence twice, as its replicated input and as its input to
sharded work (``xm``, in place of ``to_model``), and the reduction of a
row-parallel output (``reduce``: the reduce-scatter over the sequence,
whose transpose is the all-gather, where GSPMD would all-reduce). A
block that does not use ``reduce`` gives a whole output, which the
sublayer slices (``seq_slice``, transpose: the all-gather). Where
``seq_res`` is unmapped, or the sequence does not split over the ranks,
nothing changes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.dist import comm
from repro_torch.dist.sharding import ShardingRules, current_rules

# Checker declaration (``repro_torch.analysis.checks``): tensor and
# sequence parallel run over the model axis only.
COLLECTIVE_CONTRACT = {
    "psum": {"axes": ("model",)},
    "all_gather": {"axes": ("model",)},
    "psum_scatter": {"axes": ("model",)},
}


@dataclasses.dataclass(frozen=True)
class TP:
    """This rank's place on the ``model`` axis under ``rules``."""

    size: int
    rank: int
    group: Any
    rules: ShardingRules

    def sharded(self, name: str) -> bool:
        """Whether the logical axis ``name`` maps to the model axis."""
        return self.rules.axis(name) == "model"

    def part(self, n: int) -> Tuple[int, int]:
        """``(lo, hi)``: this rank's contiguous 1/size of a dim of ``n``."""
        k = n // self.size
        return self.rank * k, (self.rank + 1) * k


def context() -> Optional[TP]:
    """The tensor-parallel context of the current rules, or None."""
    rules = current_rules()
    if rules is None or rules.tp == 1:
        return None
    mesh = rules.mesh
    return TP(rules.tp, mesh.model_rank, mesh.model_group, rules)


def _sum(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` all-reduced over ``group`` in fp32, in a buffer of its own,
    cast back to ``t``'s dtype."""
    buf = t.detach().to(torch.float32, copy=True).contiguous()
    comm.all_reduce(buf, group, op)
    return buf.to(t.dtype)


class _ToModel(torch.autograd.Function):
    """Identity forward; the backward adds the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the ranks forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def to_model(x: torch.Tensor) -> torch.Tensor:
    """A replicated tensor entering a sharded computation."""
    tp = context()
    return x if tp is None else _ToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The ranks' partial sums added: a replicated tensor."""
    tp = context()
    return x if tp is None else _ReduceFromModel.apply(x, tp.group)


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """``reduce_from_model`` whose result feeds sharded work again (a
    norm's statistic): the sum forward, and the sum of the gradients
    backward."""
    return to_model(reduce_from_model(x))


def model_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the ranks, outside autograd."""
    tp = context()
    if tp is None:
        return x.detach()
    return _sum(x, tp.group, op="max")


def gather_vocab(x: torch.Tensor, full: int) -> torch.Tensor:
    """A vocab-sharded ``(..., full / size)`` tensor made whole: each rank
    writes its columns into a zero-filled ``(..., full)`` fp32 buffer and
    the buffers are all-reduced (the one gather that needs only
    ``all_reduce``). The serving step's last-position logits."""
    tp = context()
    if tp is None or x.shape[-1] == full:
        return x
    lo, hi = tp.part(full)
    buf = x.new_zeros(x.shape[:-1] + (full,), dtype=torch.float32)
    buf[..., lo:hi] = x.float()
    return _sum(buf, tp.group).to(x.dtype)


def local(t: torch.Tensor, dim: int, tp: Optional[TP]) -> torch.Tensor:
    """This rank's slice of a replicated tensor along ``dim`` (``t``
    itself without tensor parallel)."""
    if tp is None:
        return t
    lo, hi = tp.part(t.shape[dim])
    return t.narrow(dim, lo, hi - lo)


# ---------------------------------------------------------------------------
# Sequence parallel
# ---------------------------------------------------------------------------
def seq_parallel(length: Optional[int] = None) -> Optional[TP]:
    """The tensor-parallel context when the rules map ``seq_res`` (and a
    sequence of ``length`` splits over the ranks), else None."""
    tp = context()
    if tp is None or not tp.sharded("seq_res"):
        return None
    if length is not None and length % tp.size:
        return None
    return tp


def _gather_seq(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The ranks' ``(B, s, ...)`` slices joined along dim 1, in rank order."""
    buf = x.new_empty((tp.size * x.shape[0],) + tuple(x.shape[1:]))
    comm.all_gather(buf, x.contiguous(), tp.group)
    full = buf.view((tp.size,) + tuple(x.shape)).transpose(0, 1)
    return full.reshape((x.shape[0], tp.size * x.shape[1]) + tuple(x.shape[2:]))


def _slice_seq(x: torch.Tensor, tp: TP) -> torch.Tensor:
    lo, hi = tp.part(x.shape[1])
    return x[:, lo:hi].contiguous()


class _SeqGather(torch.autograd.Function):
    """The all-gather over the sequence; the backward, its transpose, the
    reduce-scatter of the ranks' partial gradients (fp32, cast back)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _gather_seq(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter_seq(grad, ctx.tp), None


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


class _SeqSlice(torch.autograd.Function):
    """This rank's slice of a whole sequence; the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _slice_seq(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _gather_seq(grad.contiguous(), ctx.tp), None


def _reduce_scatter_seq(x: torch.Tensor, tp: TP) -> torch.Tensor:
    """The ranks' ``(B, S, ...)`` partial sums added, this rank's slice of
    the sequence kept: a reduce-scatter in fp32, cast back."""
    B, S = x.shape[0], x.shape[1]
    s = S // tp.size
    parts = x.detach().to(torch.float32).reshape((B, tp.size, s) + tuple(x.shape[2:]))
    full = parts.transpose(0, 1).contiguous().view((tp.size * B, s) + tuple(x.shape[2:]))
    out = full.new_empty((B, s) + tuple(x.shape[2:]))
    comm.reduce_scatter(out, full, tp.group)
    return out.to(x.dtype)


class _SeqReduceScatter(torch.autograd.Function):
    """The ranks' partial sums added and split over the sequence; the
    backward all-gathers."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return _reduce_scatter_seq(x, tp)

    @staticmethod
    def backward(ctx, grad):
        return _gather_seq(grad.contiguous(), ctx.tp), None


class SeqIn:
    """A sublayer's normed slice gathered over the sequence for its block.
    ``x`` is the whole sequence for the block's replicated work (a
    router, a replicated projection, a norm), which every rank computes
    alike, so it enters at ``1 / T`` of its gradient and the T ranks'
    shares add up to it; ``xm`` is the same sequence as it enters sharded
    work, where each rank's gradient is partial: the gather's transpose,
    the reduce-scatter, adds both kinds. ``reduce`` is the reduction of
    the block's row-parallel output, the reduce-scatter over the
    sequence; ``done`` says whether the block used it."""

    def __init__(self, h: torch.Tensor, tp: TP):
        self.tp = tp
        self.xm = _SeqGather.apply(h, tp)
        self.x = _ScaleGrad.apply(self.xm, 1.0 / tp.size)
        self.done = False

    def reduce(self, y: torch.Tensor) -> torch.Tensor:
        self.done = True
        return _SeqReduceScatter.apply(y, self.tp)


def seq_gather(x: torch.Tensor) -> torch.Tensor:
    """A sequence slice made whole for replicated work (identity without
    sequence parallel): ``SeqIn.x``."""
    tp = seq_parallel()
    return x if tp is None else SeqIn(x, tp).x


def seq_slice(x: torch.Tensor) -> torch.Tensor:
    """This rank's slice of a whole sequence (identity without sequence
    parallel)."""
    tp = seq_parallel()
    return x if tp is None else _SeqSlice.apply(x, tp)


def sum_grad(tree):
    """Parameters used on this rank's sequence slice: identity forward,
    their gradients added over the ranks (identity without sequence
    parallel)."""
    tp = seq_parallel()
    if tp is None:
        return tree
    if isinstance(tree, dict):
        return {k: sum_grad(v) for k, v in tree.items()}
    return _ToModel.apply(tree, tp.group)
