"""Attention: GQA/MQA, causal, sliding-window and cross-attention over
position arrays, with the explicit-position KV cache of serving.

The port of ``repro.models.attention``. Two execution paths share one
declaration, as in the JAX package:

  * ``sdpa``: plain PyTorch attention over position arrays (with
    softcap), for training and for every cache step but one; from
    ``CHUNKED_SDPA_THRESHOLD`` queries on, ``sdpa_chunked`` runs it one
    block of queries at a time, as the JAX model does;
  * ``repro_torch.kernels.ops.attention``: the hand-written Hopper
    flash-attention kernel on the card (its plain version on the CPU).
    A serving prefill that starts at position 0 runs it over the keys it
    has just written: there, attention over the cache is causal
    attention over the first S keys, which is the kernel's function.
    The same prefill runs it for the encoder's non-causal
    self-attention and for the decoder's cross-attention over the
    encoder output (whisper). The kernel has no softcap and no
    backward, so softcapped configurations, decode steps, later
    prefills and training stay on ``sdpa`` (the backward kernel is a
    later slice of the port).

Decode uses an explicit-position KV cache: positions are stored next to
k/v, so full caches and ring-buffer (sliding-window) caches share one
code path. The port writes caches in place: ``cache_write`` updates the
tensors it is given and returns them, which spares a copy of every
layer's cache on every step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_dense, apply_rope, declare_dense
from repro_torch.models.module import ParamBuilder, ones_init, torch_dtype

NEG_INF = -2.0**30  # large-but-finite: keeps masked softmax NaN-free

# Sequence length at and above which the query-chunked path is used, as in
# the JAX model: below it the full (Sq, Sk) score tensor is small enough.
CHUNKED_SDPA_THRESHOLD = 8192


def declare_attention(
    b: ParamBuilder, path: str, cfg: ModelConfig, *, cross: bool = False
) -> None:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    declare_dense(b, f"{path}.wq", d, h * hd, ("q_in", "heads_proj"))
    declare_dense(b, f"{path}.wk", d, kv * hd, ("kv_in", "kv_proj"))
    declare_dense(b, f"{path}.wv", d, kv * hd, ("kv_in", "kv_proj"))
    declare_dense(b, f"{path}.wo", h * hd, d, ("heads_proj", None))
    if cfg.qk_norm:
        b.declare(f"{path}.q_norm.scale", (hd,), (None,), init=ones_init)
        b.declare(f"{path}.k_norm.scale", (hd,), (None,), init=ones_init)
    del cross  # same parameter structure; kv source differs at apply time


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


def sdpa_chunked(
    q: torch.Tensor,              # (B, Sq, Hq, hd)
    k: torch.Tensor,              # (B, Sk, Hkv, hd)
    v: torch.Tensor,
    *,
    q_positions: torch.Tensor,
    k_positions: torch.Tensor,
    causal: bool,
    window: int = 0,
    logit_softcap: float = 0.0,
    block_q: int = 512,
) -> torch.Tensor:
    """``sdpa`` one block of queries at a time, each block over all keys:
    the temporaries of a block are O(block_q * Sk) per head instead of
    O(Sq * Sk). The block is ``block_q``, halved until it divides Sq; a
    Python loop takes the place of the JAX model's ``lax.scan``. Each
    query row is computed as ``sdpa`` computes it."""
    Sq = q.shape[1]
    bq = min(block_q, Sq)
    while Sq % bq:
        bq //= 2
    outs = [
        sdpa(q[:, i:i + bq], k, v, q_positions=q_positions[:, i:i + bq],
             k_positions=k_positions, causal=causal, window=window,
             logit_softcap=logit_softcap)
        for i in range(0, Sq, bq)
    ]
    return torch.cat(outs, dim=1)


def _dispatch_sdpa(q, k, v, **kw):
    if q.shape[1] >= CHUNKED_SDPA_THRESHOLD:
        return sdpa_chunked(q, k, v, **kw)
    return sdpa(q, k, v, **kw)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CacheSpec:
    length: int        # slots (full seq or sliding window)
    ring: bool         # round-robin writes (window caches)


def init_kv_cache(
    batch: int, spec: CacheSpec, kv_heads: int, head_dim: int, dtype, device
) -> dict:
    shape = (batch, spec.length, kv_heads, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        # explicit absolute positions; -1 = empty slot
        "pos": torch.full((batch, spec.length), -1, dtype=torch.int32, device=device),
    }


def cache_write(
    cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
    positions: torch.Tensor, spec: CacheSpec,
) -> dict:
    """Write Sq new entries at ``positions`` (B, Sq), in place. Ring
    caches wrap; of a run of consecutive positions longer than the ring
    only the last ``length`` land, which is what sequential writes leave."""
    if spec.ring and positions.shape[1] > spec.length:
        keep = slice(positions.shape[1] - spec.length, None)
        positions, k_new, v_new = positions[:, keep], k_new[:, keep], v_new[:, keep]
    B, Sq = positions.shape
    idx = (positions % spec.length if spec.ring else positions).long()
    bidx = torch.arange(B, device=positions.device)[:, None].expand(B, Sq)
    cache["k"][bidx, idx] = k_new.to(cache["k"].dtype)
    cache["v"][bidx, idx] = v_new.to(cache["v"].dtype)
    cache["pos"][bidx, idx] = positions.to(torch.int32)
    return cache


def attention_block(
    p: dict,
    x: torch.Tensor,                    # (B, Sq, D)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,            # (B, Sq)
    causal: bool = True,
    window: int = 0,
    cache: Optional[dict] = None,       # decode/prefill KV cache
    cache_spec: Optional[CacheSpec] = None,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # encoder K/V
    prefill_from_zero: bool = False,
    use_rope: bool = True,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self-attention, or cross-attention over ``cross_kv``. Without a
    cache (training) over the block's own keys; with one, the new keys
    are written and the queries attend over the cache. Cross-attention
    is non-causal over encoder keys at positions ``0..Sk-1``, with no
    rope and no cache. ``prefill_from_zero`` marks a serving prefill
    from position 0 (``positions`` is ``0..S-1``; inference only, the
    kernel has no backward), which runs ``ops.attention``, the flash
    kernel on the card, when the config has no softcap: a multi-token
    cache step over the keys just written, cross-attention over
    ``cross_kv``, and a cache-less call (the encoder's pass) over its
    own keys.

    Returns ``(y, new_cache)``."""
    dtype = torch_dtype(cfg.compute_dtype)
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kernel = not cfg.logit_softcap

    q = _split_heads(apply_dense(p["wq"], x, dtype), h, hd)
    if cfg.qk_norm:
        q = _rms(q, p["q_norm"]["scale"])
    sdpa_kw = dict(causal=causal, window=window, logit_softcap=cfg.logit_softcap)

    if cross_kv is not None:
        k, v = cross_kv
        if kernel and prefill_from_zero:
            out = ops.attention(q, k, v, causal=False)
        else:
            Sk = k.shape[1]
            k_pos = torch.arange(Sk, dtype=torch.int32, device=x.device)
            out = _dispatch_sdpa(q, k, v, q_positions=positions,
                                 k_positions=k_pos[None, :].expand(x.shape[0], Sk),
                                 causal=False, window=0,
                                 logit_softcap=cfg.logit_softcap)
        y = apply_dense(p["wo"], out.reshape(*x.shape[:-1], h * hd), dtype)
        return y, None

    k = _split_heads(apply_dense(p["wk"], x, dtype), kv, hd)
    v = _split_heads(apply_dense(p["wv"], x, dtype), kv, hd)
    if cfg.qk_norm:
        k = _rms(k, p["k_norm"]["scale"])
    if use_rope and cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        if kernel and prefill_from_zero:
            out = ops.attention(q, k, v, causal=causal, window=window)
        else:
            out = _dispatch_sdpa(q, k, v, q_positions=positions,
                                 k_positions=positions, **sdpa_kw)
        new_cache = None
    else:
        assert cache_spec is not None
        new_cache = cache_write(cache, k, v, positions, cache_spec)
        multi = q.shape[1] > 1
        if multi and prefill_from_zero and kernel:
            out = ops.attention(q, k, v, causal=causal, window=window)
        elif cache_spec.ring and multi:
            # Windowed prefill: a ring cache shorter than the chunk has
            # already overwritten the oldest keys, but every query's
            # window lies inside the in-flight chunk (prefill starts at
            # position 0), so attend over k/v directly.
            out = _dispatch_sdpa(q, k, v, q_positions=positions,
                                 k_positions=positions, **sdpa_kw)
        else:
            out = _dispatch_sdpa(q, new_cache["k"], new_cache["v"],
                                 q_positions=positions,
                                 k_positions=new_cache["pos"], **sdpa_kw)
    y = apply_dense(p["wo"], out.reshape(*x.shape[:-1], h * hd), dtype)
    return y, new_cache


def encoder_kv(p: dict, enc_out: torch.Tensor, cfg: ModelConfig):
    """Cross-attention K/V of one layer from the encoder output."""
    dtype = torch_dtype(cfg.compute_dtype)
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    k = _split_heads(apply_dense(p["wk"], enc_out, dtype), kv, hd)
    v = _split_heads(apply_dense(p["wv"], enc_out, dtype), kv, hd)
    return k, v
