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

Under tensor parallel (``repro_torch.models.tp``) the block shards over
heads, following the rules: where ``heads`` / ``kv_heads`` divide the
model axis, ``wq`` / ``wk`` / ``wv`` are column-parallel and each rank
attends with its H/T query and KV/T kv heads (the flash kernel receives
those); where the kv heads do not divide, the rule's ``kv_in`` split
holds ``wk`` / ``wv`` split on ``d_model``, the partial products are
reduced, every rank holds every kv head, and its query heads pick their
GQA group from them (``q_in`` likewise for the query heads, whose block
then runs replicated). ``wo`` is row-parallel. A cache holds the rank's
kv heads; whisper's cross-attention is sharded the same way.

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
from repro_torch.models import tp as tpl
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


@dataclasses.dataclass(frozen=True)
class _Heads:
    """How one attention block splits over the model axis."""

    tp: Optional[tpl.TP]
    q: str          # "heads": column-parallel; "in": split on d_model; "": replicated
    kv: str
    hq: int         # this rank's query heads
    hkv: int        # kv heads its projections give

    @property
    def sharded(self) -> bool:
        return self.q == "heads"


def _heads(cfg: ModelConfig) -> _Heads:
    tp = tpl.context()
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if tp is None:
        return _Heads(None, "", "", h, kv)
    q = "heads" if tp.sharded("heads_proj") else "in" if tp.sharded("q_in") else ""
    k = "heads" if tp.sharded("kv_proj") else "in" if tp.sharded("kv_in") else ""
    return _Heads(tp, q, k, h // tp.size if q == "heads" else h,
                  kv // tp.size if k == "heads" else kv)


def _project(p, x, xm, how: str, dtype) -> torch.Tensor:
    """A q / k / v projection: column-parallel over heads from ``xm``
    (``to_model(x)``), split on ``d_model`` with the partial products
    reduced, or replicated."""
    if how == "heads":
        return apply_dense(p, xm, dtype)
    if how == "in":
        return tpl.reduce_from_model(apply_dense(p, tpl.local(xm, -1, tpl.context()), dtype))
    return apply_dense(p, x, dtype)


def _kv_for_heads(t: torch.Tensor, cfg: ModelConfig, hd: _Heads) -> torch.Tensor:
    """The kv heads this rank's query heads read, from a tensor holding
    every kv head (dim 2), as a sharded tensor. A contiguous run of kv
    heads keeps the GQA grouping; otherwise each local query head gets
    its own copy (groups of 1)."""
    t = tpl.to_model(t)
    g = cfg.num_heads // cfg.num_kv_heads
    lo, hi = hd.tp.part(cfg.num_heads)
    idx = [i // g for i in range(lo, hi)]
    first, n = idx[0], idx[-1] - idx[0] + 1
    if len(idx) % n == 0 and idx == [first + j // (len(idx) // n) for j in range(len(idx))]:
        return t.narrow(2, first, n)
    return t.index_select(2, torch.tensor(idx, device=t.device))


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
    hd_ = _heads(cfg)
    hd = cfg.head_dim
    kernel = not cfg.logit_softcap
    xm = tpl.to_model(x) if hd_.tp is not None else x

    q = _split_heads(_project(p["wq"], x, xm, hd_.q, dtype), hd_.hq, hd)
    if cfg.qk_norm:
        q = _rms(q, tpl.to_model(p["q_norm"]["scale"]) if hd_.sharded
                 else p["q_norm"]["scale"])
    sdpa_kw = dict(causal=causal, window=window, logit_softcap=cfg.logit_softcap)

    def mine(t):
        """k or v as this rank's query heads read it."""
        if hd_.sharded and hd_.kv != "heads":
            return _kv_for_heads(t, cfg, hd_)
        return t

    if cross_kv is not None:
        k, v = mine(cross_kv[0]), mine(cross_kv[1])
        if kernel and prefill_from_zero:
            out = ops.attention(q, k, v, causal=False)
        else:
            Sk = k.shape[1]
            k_pos = torch.arange(Sk, dtype=torch.int32, device=x.device)
            out = _dispatch_sdpa(q, k, v, q_positions=positions,
                                 k_positions=k_pos[None, :].expand(x.shape[0], Sk),
                                 causal=False, window=0,
                                 logit_softcap=cfg.logit_softcap)
        return _out(p, out, x, hd_, dtype), None

    k = _split_heads(_project(p["wk"], x, xm, hd_.kv, dtype), hd_.hkv, hd)
    v = _split_heads(_project(p["wv"], x, xm, hd_.kv, dtype), hd_.hkv, hd)
    if cfg.qk_norm:
        k = _rms(k, tpl.to_model(p["k_norm"]["scale"]) if hd_.kv == "heads"
                 else p["k_norm"]["scale"])
    if use_rope and cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        if kernel and prefill_from_zero:
            out = ops.attention(q, mine(k), mine(v), causal=causal, window=window)
        else:
            out = _dispatch_sdpa(q, mine(k), mine(v), q_positions=positions,
                                 k_positions=positions, **sdpa_kw)
        new_cache = None
    else:
        assert cache_spec is not None
        new_cache = cache_write(cache, k, v, positions, cache_spec)
        multi = q.shape[1] > 1
        if multi and prefill_from_zero and kernel:
            out = ops.attention(q, mine(k), mine(v), causal=causal, window=window)
        elif cache_spec.ring and multi:
            # Windowed prefill: a ring cache shorter than the chunk has
            # already overwritten the oldest keys, but every query's
            # window lies inside the in-flight chunk (prefill starts at
            # position 0), so attend over k/v directly.
            out = _dispatch_sdpa(q, mine(k), mine(v), q_positions=positions,
                                 k_positions=positions, **sdpa_kw)
        else:
            out = _dispatch_sdpa(q, mine(new_cache["k"]), mine(new_cache["v"]),
                                 q_positions=positions,
                                 k_positions=new_cache["pos"], **sdpa_kw)
    return _out(p, out, x, hd_, dtype), new_cache


def _out(p, out: torch.Tensor, x: torch.Tensor, hd_: _Heads, dtype) -> torch.Tensor:
    """``wo``: row-parallel over the rank's heads (the partial products
    reduced), or replicated."""
    y = apply_dense(p["wo"], out.reshape(*x.shape[:-1], -1), dtype)
    return tpl.reduce_from_model(y) if hd_.sharded else y


def encoder_kv(p: dict, enc_out: torch.Tensor, cfg: ModelConfig):
    """Cross-attention K/V of one layer from the encoder output (the
    rank's kv heads, or every kv head, as its projections give them)."""
    dtype = torch_dtype(cfg.compute_dtype)
    hd_ = _heads(cfg)
    xm = tpl.to_model(enc_out) if hd_.tp is not None else enc_out
    k = _split_heads(_project(p["wk"], enc_out, xm, hd_.kv, dtype), hd_.hkv, cfg.head_dim)
    v = _split_heads(_project(p["wv"], enc_out, xm, hd_.kv, dtype), hd_.hkv, cfg.head_dim)
    return k, v
