"""Attention: GQA/MQA, causal, sliding-window and cross-attention over
position arrays, with the explicit-position KV cache of serving.

The port of ``repro.models.attention``. Two execution paths share one
declaration, as in the JAX package:

  * ``sdpa``: plain PyTorch attention over position arrays (with
    softcap), for every cache step but one and for the training calls
    the flash kernel does not take; from ``CHUNKED_SDPA_THRESHOLD``
    queries on, ``sdpa_chunked`` runs it one block of queries at a time,
    as the JAX model does;
  * ``repro_torch.kernels.ops.attention``: the hand-written Hopper
    flash-attention kernel on the card (its plain version on the CPU).
    A serving prefill that starts at position 0 runs it over the keys it
    has just written: there, attention over the cache is causal
    attention over the first S keys, which is the kernel's function.
    The same prefill runs it for the encoder's non-causal
    self-attention and for the decoder's cross-attention over the
    encoder output (whisper). Training's cache-less self-attention runs
    it with its backward kernels (``kernels.flash_attention_bwd``)
    wherever ``flash_route`` allows: on the card (or meta) in bf16 at a
    pair of head widths the backward takes (q / k and v of 64 or of 128,
    latent attention's q / k of 192 over v of 128), with no softcap and
    no window; every other training call (fp32, gemma3's windows, hd 112
    / 192 / 256, cross-attention, softcapped configs), decode steps,
    later prefills and CPU tensors stay on ``sdpa``.

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

Under ``serve_rules(kv_seq_sharded=True)`` the rules map ``kv_seq``
first, so a cache splits over its positions and keeps every kv head
(``kv_seq_split``): each rank holds its contiguous slots of every kv
head, and the whole ``pos`` row. A step gathers the new keys' kv heads
(when the projections split them) and each rank writes the slots it
holds; a prefill from position 0 attends over the new keys as before
(the flash kernel at the rank's heads); any other step attends every
query head over each rank's slots and combines the ranks' partial
softmax as flash-decoding does (``_sdpa_split``): per layer and step a
rank moves its query heads' gather and three all-reduces of ``(B, Sq,
H)`` statistics and ``(B, Sq, H, hd)`` fp32 outputs, not its cache
slice.

``mla_block`` is DeepSeek-V3's multi-head latent attention, for
training: its query / key heads are wider than its value heads, so
``sdpa`` and ``sdpa_chunked`` take v's width, and ``flash_route`` takes
the pair (192, 128) that the flash kernels compile (Moonlight's widths).

Decode uses an explicit-position KV cache: positions are stored next to
k/v, so full caches and ring-buffer (sliding-window) caches share one
code path. The port writes caches in place: ``cache_write`` updates the
tensors it is given and returns them, which spares a copy of every
layer's cache on every step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention_bwd import BACKWARD_HEAD_DIMS, flash_attention_dq
from repro_torch.models import tp as tpl
from repro_torch.models.layers import apply_dense, apply_rope, declare_dense
from repro_torch.models.module import ParamBuilder, ones_init, torch_dtype
from repro_torch.telemetry.blocks import BackwardSpan, current_block_spans

NEG_INF = -2.0**30  # large-but-finite: keeps masked softmax NaN-free

# Checker declaration (``repro_torch.analysis.checks``): the kv-seq-sharded
# decode gathers heads and combines its partial softmax over the model axis.
COLLECTIVE_CONTRACT = {
    "all_gather": {"axes": ("model",)},
    "psum": {"axes": ("model",)},
}

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


def declare_mla(b: ParamBuilder, path: str, cfg: ModelConfig) -> None:
    """Multi-head latent attention's projections (DeepSeek-V3, no query
    LoRA): ``wq`` d -> heads x head_dim, ``wkv_a`` d -> the latent and
    the shared rotated key head, the latent's norm, ``wkv_b`` latent ->
    heads x (unrotated key + value), ``wo`` heads x value -> d."""
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    r, rope, vd = cfg.mla_kv_rank, cfg.mla_rope_dim, cfg.mla_v_dim
    declare_dense(b, f"{path}.wq", d, h * hd)
    declare_dense(b, f"{path}.wkv_a", d, r + rope)
    b.declare(f"{path}.kv_norm.scale", (r,), (None,), init=ones_init)
    declare_dense(b, f"{path}.wkv_b", r, h * (hd - rope + vd))
    declare_dense(b, f"{path}.wo", h * vd, d)


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    stat = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return x * stat.to(x.dtype) * scale.to(x.dtype)


def sdpa(
    q: torch.Tensor,              # (B, Sq, Hq, hd)
    k: torch.Tensor,              # (B, Sk, Hkv, hd)
    v: torch.Tensor,              # (B, Sk, Hkv, hd_v)
    *,
    q_positions: torch.Tensor,    # (B, Sq) int
    k_positions: torch.Tensor,    # (B, Sk) int; -1 marks invalid slots
    causal: bool,
    window: int = 0,              # 0: unlimited
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    """fp32 scaled-dot-product attention, scaled by q's head width; the
    output takes v's (latent attention's differs from q's). GQA keeps the
    JAX grouping: q is viewed as (B, Sq, Hkv, g, hd), so query head h
    reads kv head ``h // g``."""
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
    return out.reshape(B, Sq, Hq, v.shape[-1]).to(q.dtype)


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
    """The plain route: ``sdpa``, or ``sdpa_chunked`` from the
    threshold on; counts its calls in ``_dispatch_sdpa.calls``."""
    _dispatch_sdpa.calls += 1
    if q.shape[1] >= CHUNKED_SDPA_THRESHOLD:
        return sdpa_chunked(q, k, v, **kw)
    return sdpa(q, k, v, **kw)


_dispatch_sdpa.calls = 0


def flash_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                logit_softcap: float, window: int) -> bool:
    """Whether a cache-less self-attention call takes the flash kernel
    and its backward (``ops.attention``, differentiable on the card)
    instead of ``sdpa``: q and k on the card (or meta, the dry run) in
    bf16, k as wide as q, and a (q / k width, v width) pair that the
    backward kernels take (``BACKWARD_HEAD_DIMS``: one width of 64 or
    128, or latent attention's 192 over 128), no softcap, no window, as
    many keys as queries. The rule reads the shapes alone. Its caller
    gives ``sdpa`` the same positions for queries and keys, and every
    builder of them makes an arange, so ``sdpa``'s positional causal mask
    is the kernel's index-causal one whatever the start."""
    return (q.device.type in ("cuda", "meta") and q.dtype == torch.bfloat16
            and k.dtype == q.dtype and k.shape[-1] == q.shape[-1]
            and (q.shape[-1], v.shape[-1]) in BACKWARD_HEAD_DIMS
            and not logit_softcap and not window and q.shape[1] == k.shape[1])


def route_counts() -> dict:
    """Attention calls so far by route, read from the launch counters:
    ``attention_kernel``, the flash forward's launches on the card plus
    its backward's (one dq launch each, then one dk / dv launch: counted
    once); ``attention_plain``, ``_dispatch_sdpa``'s calls."""
    return {"attention_kernel": flash_attention.launches + flash_attention_dq.launches,
            "attention_plain": _dispatch_sdpa.calls}


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CacheSpec:
    length: int        # slots (full seq or sliding window)
    ring: bool         # round-robin writes (window caches)
    start: Optional[int] = None   # the step's first position (kv-seq-sharded writes)


def init_kv_cache(
    batch: int, spec: CacheSpec, kv_heads: int, head_dim: int, dtype, device,
    slots: Optional[int] = None,
) -> dict:
    """Zeroed k / v of ``slots`` slots (``spec.length`` unless split over
    the model ranks, ``kv_seq_split``) and the whole ``pos`` row."""
    shape = (batch, spec.length if slots is None else slots, kv_heads, head_dim)
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
    xm: Optional[torch.Tensor] = None,
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self-attention, or cross-attention over ``cross_kv``. Without a
    cache (training) over the block's own keys; with one, the new keys
    are written and the queries attend over the cache. Cross-attention
    is non-causal over encoder keys at positions ``0..Sk-1``, with no
    rope and no cache. ``prefill_from_zero`` marks a serving prefill
    from position 0 (``positions`` is ``0..S-1``; inference), which runs
    ``ops.attention``, the flash kernel on the card, when the config has
    no softcap: a multi-token cache step over the keys just written,
    cross-attention over ``cross_kv``, and a cache-less call (the
    encoder's pass) over its own keys. A cache-less self-attention call
    (training's) takes the flash kernel with its backward where
    ``flash_route`` allows. ``xm`` is ``x`` as it enters the sharded heads
    (``to_model(x)`` when not given) and ``reduce`` the row-parallel
    output's reduction (``reduce_from_model`` when not given): a
    sequence-parallel sublayer passes its own (``tp.SeqIn``).

    Returns ``(y, new_cache)``."""
    dtype = torch_dtype(cfg.compute_dtype)
    hd_ = _heads(cfg)
    hd = cfg.head_dim
    kernel = not cfg.logit_softcap
    if hd_.tp is None:
        xm = x
    elif xm is None:
        xm = tpl.to_model(x)

    q = _split_heads(_project(p["wq"], x, xm, hd_.q, dtype), hd_.hq, hd)
    if cfg.qk_norm:
        q = _rms(q, tpl.to_model(p["q_norm"]["scale"]) if hd_.sharded
                 else p["q_norm"]["scale"], cfg.rms_eps)
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
        return _out(p, out, x, hd_, dtype, reduce), None

    k = _split_heads(_project(p["wk"], x, xm, hd_.kv, dtype), hd_.hkv, hd)
    v = _split_heads(_project(p["wv"], x, xm, hd_.kv, dtype), hd_.hkv, hd)
    if cfg.qk_norm:
        k = _rms(k, tpl.to_model(p["k_norm"]["scale"]) if hd_.kv == "heads"
                 else p["k_norm"]["scale"], cfg.rms_eps)
    if use_rope and cfg.pos_embed == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        k, v = mine(k), mine(v)
        if flash_route(q, k, v, logit_softcap=cfg.logit_softcap, window=window):
            out = ops.attention(q, k, v, causal=causal)
        elif kernel and prefill_from_zero:
            out = ops.attention(q, k, v, causal=causal, window=window)
        else:
            out = _dispatch_sdpa(q, k, v, q_positions=positions, k_positions=positions,
                                 **sdpa_kw)
        new_cache = None
    elif kv_seq_split(cache_spec.length) is not None:
        # kv-seq-sharded cache: every kv head of the rank's slots
        ks = kv_seq_split(cache_spec.length)
        k_all, v_all = (k, v) if hd_.kv != "heads" else (_gather_heads(k, ks),
                                                          _gather_heads(v, ks))
        new_cache = _write_split(cache, k_all, v_all, positions, cache_spec, ks)
        multi = q.shape[1] > 1
        if multi and prefill_from_zero and kernel:
            out = ops.attention(q, mine(k), mine(v), causal=causal, window=window)
        elif cache_spec.ring and multi:
            out = _dispatch_sdpa(q, mine(k), mine(v), q_positions=positions,
                                 k_positions=positions, **sdpa_kw)
        else:
            out = _attend_split(q, new_cache, positions, hd_, ks, cfg, sdpa_kw)
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
    return _out(p, out, x, hd_, dtype, reduce), new_cache


def mla_block(
    p: dict,
    x: torch.Tensor,                    # (B, S, D)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,            # (B, S)
    causal: bool = True,
    window: int = 0,
    cache: Optional[dict] = None,
    **_,
) -> Tuple[torch.Tensor, None]:
    """Multi-head latent attention (DeepSeek-V3 without query LoRA), a
    cache-less self-attention: q's heads split into ``head_dim -
    mla_rope_dim`` unrotated and ``mla_rope_dim`` rotated dims; keys and
    values come from a ``mla_kv_rank`` latent under an RMSNorm
    (``cfg.rms_eps``), beside one rotated key head that every head
    shares. Scores are scaled by 1/sqrt(head_dim) and the output takes
    v's width (``mla_v_dim``). The rotation is the port's ``apply_rope``
    on split halves; the published weights pair interleaved columns, a
    fixed permutation of the rotated columns of ``wq`` and ``wkv_a``.
    ``flash_route`` decides the route by its rule: on the card in bf16 at
    Moonlight's widths (q / k 192, v 128) the flash kernels and their
    backward; elsewhere ``sdpa`` (``sdpa_chunked`` from the threshold
    on). Spans ``mla`` and ``mla/backward`` on the step's
    block spans (``telemetry.blocks``). Serving caches and tensor
    parallel do not take this block yet: it raises."""
    if cache is not None or tpl.context() is not None:
        raise NotImplementedError("latent attention runs cache-less and without tensor "
                                  "parallel rules: it has no latent cache or sharding yet")
    dtype = torch_dtype(cfg.compute_dtype)
    h, hd, r = cfg.num_heads, cfg.head_dim, cfg.mla_kv_rank
    rope, vd = cfg.mla_rope_dim, cfg.mla_v_dim
    nope = hd - rope
    spans, _ = current_block_spans()
    back = BackwardSpan(spans, "mla/backward")
    with spans("mla"):
        x = back.input(x)
        B, S, _ = x.shape
        q = _split_heads(apply_dense(p["wq"], x, dtype), h, hd)
        q_nope, q_pe = q.split([nope, rope], dim=-1)
        latent, k_pe = apply_dense(p["wkv_a"], x, dtype).split([r, rope], dim=-1)
        latent = _rms(latent, p["kv_norm"]["scale"], cfg.rms_eps)
        kv = _split_heads(apply_dense(p["wkv_b"], latent, dtype), h, nope + vd)
        k_nope, v = kv.split([nope, vd], dim=-1)
        q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
        k_pe = apply_rope(k_pe[:, :, None, :], positions, cfg.rope_theta)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(B, S, h, rope)], dim=-1)
        if flash_route(q, k, v, logit_softcap=cfg.logit_softcap, window=window):
            out = ops.attention(q, k, v, causal=causal)
        else:
            out = _dispatch_sdpa(q, k, v, q_positions=positions, k_positions=positions,
                                 causal=causal, window=window,
                                 logit_softcap=cfg.logit_softcap)
        y = apply_dense(p["wo"], out.reshape(B, S, h * vd), dtype)
        return back.output(y), None


# ---------------------------------------------------------------------------
# kv-seq-sharded caches (serving under ``serve_rules(kv_seq_sharded=True)``)
# ---------------------------------------------------------------------------
def kv_seq_split(length: int) -> Optional[tpl.TP]:
    """The model axis when the rules map ``kv_seq`` and a cache of
    ``length`` slots splits over it (the JAX rules drop a mapping that
    does not divide), else None. Each rank then holds slots ``part(length)``
    of every kv head; the ``pos`` row stays whole on every rank."""
    tp = tpl.context()
    if tp is None or not tp.sharded("kv_seq") or length % tp.size:
        return None
    return tp


def _gather_heads(t: torch.Tensor, tp: tpl.TP) -> torch.Tensor:
    """``(B, S, h, hd)`` head slices of every rank joined along dim 2."""
    from repro_torch.dist import comm

    B, S, h, hd = t.shape
    buf = t.new_empty((tp.size * B, S, h, hd))
    comm.all_gather(buf, t.contiguous(), tp.group)
    return buf.view(tp.size, B, S, h, hd).permute(1, 2, 0, 3, 4).reshape(B, S, tp.size * h, hd)


def _write_split(cache: dict, k_new, v_new, positions, spec: CacheSpec, tp: tpl.TP) -> dict:
    """``cache_write`` on a kv-seq-split cache: every rank writes the
    ``pos`` row; k / v land only in the slots this rank holds. The slots
    are planned on the host from ``spec.start`` (the serving step's
    positions are ``start ..`` in every row)."""
    B, Sq = positions.shape
    keep = range(Sq)
    if spec.ring and Sq > spec.length:
        keep = range(Sq - spec.length, Sq)
    lo, hi = tp.part(spec.length)
    rows, slots = [], []
    for i in keep:
        slot = (spec.start + i) % spec.length if spec.ring else spec.start + i
        if lo <= slot < hi:
            rows.append(i)
            slots.append(slot - lo)
    whole = torch.arange(keep.start, keep.stop, device=positions.device)
    pslots = ((positions[:, whole] % spec.length) if spec.ring else positions[:, whole]).long()
    bidx = torch.arange(B, device=positions.device)[:, None]
    cache["pos"][bidx, pslots] = positions[:, whole].to(torch.int32)
    if rows:
        r = torch.as_tensor(rows, device=positions.device)
        c = torch.as_tensor(slots, device=positions.device)
        cache["k"][:, c] = k_new[:, r].to(cache["k"].dtype)
        cache["v"][:, c] = v_new[:, r].to(cache["v"].dtype)
    return cache


def _sdpa_split(q, k, v, *, q_positions, k_positions, causal: bool, window: int,
                logit_softcap: float, tp: tpl.TP) -> torch.Tensor:
    """Attention of every query head over keys split across the model
    ranks (flash-decoding's combine): each rank attends its slots, giving
    its rows' max m, sum l and unnormalized output o in fp32; the ranks
    all-reduce the max M, then ``sum_r o_r e^(m_r - M)`` and ``sum_r l_r
    e^(m_r - M)``, whose quotient is the softmax over every slot."""
    from repro_torch.dist import comm

    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    qg = (q.float() / math.sqrt(hd)).reshape(B, Sq, Hkv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
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
    m = scores.amax(dim=-1, keepdim=True)
    top = comm.all_reduce(m.clone(), tp.group, "max")
    e = torch.exp(scores - top) * mask
    l = comm.all_reduce(e.sum(dim=-1), tp.group)
    o = comm.all_reduce(torch.einsum("bkgqs,bskd->bqkgd", e, v.float()).contiguous(), tp.group)
    den = l.permute(0, 3, 1, 2)[..., None]                      # (B, Sq, Hkv, g, 1)
    return (o / den).reshape(B, Sq, Hq, v.shape[-1]).to(q.dtype)


def _attend_split(q, new_cache, positions, hd_: _Heads, tp: tpl.TP, cfg: ModelConfig,
                  sdpa_kw: dict) -> torch.Tensor:
    """This rank's query heads attended over a kv-seq-split cache: the
    query heads gathered (when split), every head attended over the
    ranks' slots, this rank's heads kept."""
    if hd_.sharded:
        q = _gather_heads(q, tp)
    lo, hi = tp.part(new_cache["pos"].shape[1])
    out = _sdpa_split(q, new_cache["k"], new_cache["v"], q_positions=positions,
                      k_positions=new_cache["pos"][:, lo:hi], tp=tp, **sdpa_kw)
    if hd_.sharded:
        a, b = tp.part(cfg.num_heads)
        out = out[:, :, a:b]
    return out


def _out(p, out: torch.Tensor, x: torch.Tensor, hd_: _Heads, dtype,
         reduce=None) -> torch.Tensor:
    """``wo``: row-parallel over the rank's heads (the partial products
    reduced by ``reduce``, ``reduce_from_model`` by default), or
    replicated."""
    y = apply_dense(p["wo"], out.reshape(*x.shape[:-1], -1), dtype)
    if not hd_.sharded:
        return y
    return (reduce or tpl.reduce_from_model)(y)


def encoder_kv(p: dict, enc_out: torch.Tensor, cfg: ModelConfig):
    """Cross-attention K/V of one layer from the encoder output (the
    rank's kv heads, or every kv head, as its projections give them)."""
    dtype = torch_dtype(cfg.compute_dtype)
    hd_ = _heads(cfg)
    xm = tpl.to_model(enc_out) if hd_.tp is not None else enc_out
    k = _split_heads(_project(p["wk"], enc_out, xm, hd_.kv, dtype), hd_.hkv, cfg.head_dim)
    v = _split_heads(_project(p["wv"], enc_out, xm, hd_.kv, dtype), hd_.hkv, cfg.head_dim)
    return k, v
