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
the layers then run their one-device code, bit for bit. The collectives
use only ``all_reduce`` (gloo takes it for CUDA tensors too, so a world
of ranks can share one card), in fp32, cast back afterwards.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.dist.sharding import ShardingRules, current_rules


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


def _sum(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """``t`` all-reduced over ``group`` in fp32, in a buffer of its own,
    cast back to ``t``'s dtype."""
    import torch.distributed as dist

    buf = t.detach().to(torch.float32, copy=True).contiguous()
    dist.all_reduce(buf, op=op or dist.ReduceOp.SUM, group=group)
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
    import torch.distributed as dist

    tp = context()
    if tp is None:
        return x.detach()
    return _sum(x, tp.group, op=dist.ReduceOp.MAX)


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
