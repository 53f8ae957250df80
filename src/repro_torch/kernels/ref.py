"""Plain PyTorch versions of the port's hand-written kernels.

The correctness contract: the CPU tests run these, and on the card the
kernels are held against them on the same inputs.
"""
from __future__ import annotations

import torch


def gossip_axpy_ref(x: torch.Tensor, y: torch.Tensor, alpha: float) -> torch.Tensor:
    """Consensus update on matched nodes: x + alpha * (y - x) in fp32,
    cast to x's dtype."""
    xf = x.float()
    yf = y.float()
    return (xf + alpha * (yf - xf)).to(x.dtype)
