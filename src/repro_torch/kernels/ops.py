"""Public wrappers that dispatch between the kernels and their plain
versions.

The port of ``repro.kernels.ops`` (its gossip part). ``resolve_mode`` is
the one place the decision is made, per tensor device:

  * ``"auto"``  -> ``"cuda"`` for a CUDA tensor, ``"torch"`` for a CPU one;
  * ``"cuda"``  -> the hand-written kernel (it raises on a CPU tensor, and
    on a card other than sm_90);
  * ``"torch"`` -> the plain PyTorch version, on any device (the tests
    and the chip smoke compare the kernel with it).

A CUDA tensor under ``"auto"`` always takes the kernel: there is no
silent fall-back to the plain path. Unknown impl strings raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import gossip_axpy as _ga
from repro_torch.kernels.ref import gossip_axpy_ref
from repro_torch.tree import tree_map

MODES = ("torch", "cuda")


def resolve_mode(impl: str, device) -> str:
    """Resolve an ``impl`` string to an execution mode for ``device``."""
    if impl == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    if impl not in MODES:
        raise ValueError(
            f"unknown impl/mode {impl!r}: expected 'auto' or one of {MODES}"
        )
    return impl


def _gossip_tree_map(x_tree, y_tree, alpha: float, impl: str, inplace: bool):
    """Leaf dispatcher for x + alpha * (y - x); non-float leaves pass
    through untouched."""

    def leaf(x, y):
        if not x.is_floating_point():
            return x
        if resolve_mode(impl, x.device) == "torch":
            out = gossip_axpy_ref(x, y, alpha)
            return x.copy_(out) if inplace else out
        return _ga.gossip_axpy(x, y, alpha, inplace=inplace)

    return tree_map(leaf, x_tree, y_tree)


def gossip_update(x_tree, partner_tree, alpha: float, *, impl: str = "auto"):
    """Tree-wide consensus update x + alpha (partner - x), new tensors."""
    return _gossip_tree_map(x_tree, partner_tree, alpha, impl, inplace=False)


def gossip_apply(
    x_tree, target_tree, alpha: float, *, impl: str = "auto", inplace: bool = False
):
    """Gossip hot-path entry used by ``repro_torch.dist.gossip`` once each
    leaf's fp32 target is built. ``inplace=True`` writes the result over
    x (each target is complete before its update runs, so nothing reads
    the old x afterwards) and returns the same tree."""
    return _gossip_tree_map(x_tree, target_tree, alpha, impl, inplace=inplace)
