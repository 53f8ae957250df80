"""What the family references share: the matmul of a chosen precision,
RMSNorm, the mean token cross-entropy and the parameter laws.

``matmul("fp32")`` is a plain float32 product. ``matmul("fp8")`` is the
control of a bfloat16 configuration: both operands rounded to float8
e4m3 with a per-tensor scale (amax over 448) before a float32 product,
the gradient passed straight through the rounding.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t).detach()


def matmul(precision: str):
    if precision == "fp32":
        return torch.matmul
    if precision == "fp8":
        return lambda a, b: torch.matmul(_fp8(a), _fp8(b))
    raise ValueError(f"unknown reference precision {precision!r}")


def rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())


def lecun(fan_in: int) -> str:
    return f"normal:{1.0 / math.sqrt(fan_in)!r}"
