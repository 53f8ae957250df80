"""Shared building blocks (pure functions over nested param dicts).

The port of ``repro.models.layers``: the same arithmetic in the same
dtypes, op for op, so the tests can hold each function to the JAX one.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.module import (
    ParamBuilder,
    embedding_init,
    lecun_normal,
    ones_init,
    zeros_init,
)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def declare_norm(b: ParamBuilder, path: str, dim: int, kind: str) -> None:
    b.declare(f"{path}.scale", (dim,), (None,), init=ones_init)
    if kind == "layernorm":
        b.declare(f"{path}.bias", (dim,), (None,), init=zeros_init)


def apply_norm(p, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    """Normalization with fp32 statistics; the multiply stays in the
    input (compute) dtype, as in the JAX package."""
    dtype = x.dtype
    xf = x.float()
    if kind == "rmsnorm":
        stat = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        out = x * stat.to(dtype) * p["scale"].to(dtype)
    elif kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        stat = torch.rsqrt(var + eps)
        out = (x - mu.to(dtype)) * stat.to(dtype)
        out = out * p["scale"].to(dtype) + p["bias"].to(dtype)
    else:
        raise ValueError(f"unknown norm {kind!r}")
    return out.to(dtype)


# ---------------------------------------------------------------------------
# Dense projections
# ---------------------------------------------------------------------------
def declare_dense(
    b: ParamBuilder,
    path: str,
    in_dim: int,
    out_dim: int,
    axes=(None, None),
    bias: bool = False,
) -> None:
    b.declare(f"{path}.w", (in_dim, out_dim), axes, init=lecun_normal)
    if bias:
        b.declare(f"{path}.b", (out_dim,), (axes[1],), init=zeros_init)


def apply_dense(p, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    w = p["w"].to(compute_dtype)
    y = torch.matmul(x.to(compute_dtype), w)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------
def declare_embedding(b: ParamBuilder, path: str, vocab: int, dim: int) -> None:
    b.declare(f"{path}.table", (vocab, dim), ("vocab", None), init=embedding_init)


def unembed(p, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Tied unembedding: logits = x @ table^T (in the wider of the two
    dtypes, as jnp promotes a mixed matmul)."""
    table = p["table"].to(compute_dtype)
    dtype = torch.promote_types(x.dtype, table.dtype)
    return torch.matmul(x.to(dtype), table.to(dtype).T)


# ---------------------------------------------------------------------------
# Positional encodings
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). Split
    halves (not interleaved pairs), fp32 angles."""
    head_dim = x.shape[-1]
    freqs = torch.tensor(
        rope_frequencies(head_dim, theta), dtype=torch.float32, device=x.device
    )
    angles = positions[..., None].float() * freqs       # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_table(max_pos: int, dim: int) -> np.ndarray:
    pos = np.arange(max_pos)[:, None]
    div = np.exp(np.arange(0, dim, 2) * (-np.log(10000.0) / dim))
    table = np.zeros((max_pos, dim), dtype=np.float32)
    table[:, 0::2] = np.sin(pos * div)
    table[:, 1::2] = np.cos(pos * div)
    return table


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------
def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return _gelu_tanh
    if name == "relu2":  # squared ReLU (nemotron-4)
        return _relu2
    raise ValueError(f"unknown activation {name!r}")


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def softmax_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean token cross-entropy, fp32 logsumexp."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
