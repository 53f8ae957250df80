"""Attention: GQA/MQA, causal and sliding-window, over position arrays.

The port of ``repro.models.attention`` for training (no KV cache: the
cache belongs to serving). Attention is plain PyTorch, as the JAX model
computes it with jnp: the JAX model never reaches its flash-attention
Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_dense, apply_rope, declare_dense
from repro_torch.models.module import ParamBuilder, ones_init, torch_dtype

NEG_INF = -2.0**30  # large-but-finite: keeps masked softmax NaN-free

# Sequence length at and above which the JAX model switches to its
# query-chunked attention; the port has not ported that path yet.
CHUNKED_SDPA_THRESHOLD = 8192


def declare_attention(b: ParamBuilder, path: str, cfg: ModelConfig) -> None:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    declare_dense(b, f"{path}.wq", d, h * hd, ("q_in", "heads_proj"))
    declare_dense(b, f"{path}.wk", d, kv * hd, ("kv_in", "kv_proj"))
    declare_dense(b, f"{path}.wv", d, kv * hd, ("kv_in", "kv_proj"))
    declare_dense(b, f"{path}.wo", h * hd, d, ("heads_proj", None))
    if cfg.qk_norm:
        b.declare(f"{path}.q_norm.scale", (hd,), (None,), init=ones_init)
        b.declare(f"{path}.k_norm.scale", (hd,), (None,), init=ones_init)


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    stat = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return x * stat.to(x.dtype) * scale.to(x.dtype)


def sdpa(
    q: torch.Tensor,              # (B, Sq, Hq, hd)
    k: torch.Tensor,              # (B, Sk, Hkv, hd)
    v: torch.Tensor,              # (B, Sk, Hkv, hd)
    *,
    q_positions: torch.Tensor,    # (B, Sq) int
    k_positions: torch.Tensor,    # (B, Sk) int; -1 marks invalid slots
    causal: bool,
    window: int = 0,              # 0: unlimited
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """fp32 scaled-dot-product attention. GQA keeps the JAX grouping:
    q is viewed as (B, Sq, Hkv, g, hd), so query head h reads kv head
    ``h // g``."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    qf = q.float() / math.sqrt(hd)
    kf = k.float()
    vf = v.float()
    qg = qf.reshape(B, Sq, Hkv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, kf)  # (B,Hkv,g,Sq,Sk)
    if logit_softcap:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    kp = k_positions[:, None, None, None, :]
    qp = q_positions[:, None, None, :, None]
    mask = kp >= 0
    if causal:
        mask = mask & (kp <= qp)
    if window:
        mask = mask & (qp - kp < window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, vf)
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)


def _dispatch_sdpa(q, k, v, **kw):
    if q.shape[1] >= CHUNKED_SDPA_THRESHOLD:
        raise NotImplementedError(
            f"sequence length {q.shape[1]} >= {CHUNKED_SDPA_THRESHOLD} needs "
            "the chunked attention path, not ported yet (ROADMAP queue 1, "
            "item 5: sdpa_chunked)"
        )
    return sdpa(q, k, v, **kw)


def attention_block(
    p: dict,
    x: torch.Tensor,                    # (B, Sq, D)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,            # (B, Sq)
    causal: bool = True,
    window: int = 0,
    use_rope: bool = True,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self-attention over the block's own keys (training; no cache).
    Returns ``(y, None)``: the JAX block's ``(y, new_cache)``."""
    dtype = torch_dtype(cfg.compute_dtype)
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    q = _split_heads(apply_dense(p["wq"], x, dtype), h, hd)
    if cfg.qk_norm:
        q = _rms(q, p["q_norm"]["scale"])
    k = _split_heads(apply_dense(p["wk"], x, dtype), kv, hd)
    v = _split_heads(apply_dense(p["wv"], x, dtype), kv, hd)
    if cfg.qk_norm:
        k = _rms(k, p["k_norm"]["scale"])
    if use_rope and cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = _dispatch_sdpa(
        q, k, v,
        q_positions=positions, k_positions=positions,
        causal=causal, window=window, logit_softcap=cfg.logit_softcap,
    )
    y = apply_dense(p["wo"], out.reshape(*x.shape[:-1], h * hd), dtype)
    return y, None
