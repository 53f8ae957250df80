"""Transformer assembly: the dense decoder family, Mixture-of-Experts
layers and Mamba2 stacks, for training and serving.

The port of ``repro.models.transformer``. Layer stacking follows the JAX
package: consecutive identical layers form a *segment* whose parameters
are stacked on a leading layer dim, so ``blocks_0.mixer.wq.w`` has shape
``(layers, d, heads * head_dim)`` here and in the JAX tree alike. The
JAX model scans segments of ``SCAN_THRESHOLD`` or more layers with
``lax.scan`` and unrolls shorter ones; both become the same Python loop
over the layer dim here. ``cfg.remat`` maps to
``torch.utils.checkpoint`` (recompute in the backward, same numbers).

Serving (``init_cache`` / ``serve_forward``) threads per-segment caches,
stacked on the layer dim like the parameters, through the layer loop:
KV caches for attention layers, the SSM and conv state for Mamba
layers. The port updates them in place. A prefill from position 0 runs
the hand-written flash-attention and SSD chunk-scan kernels on the card
(``repro_torch.kernels.ops``); decode and training run the models' plain
PyTorch attention and SSD, as the JAX model does.

MoE layers take the JAX model's branch: the einsum path for 8 experts
or fewer, else the ragged path, whose expert products run the
hand-written grouped-matmul kernel on the card (in prefill and decode
alike). Their load-balance and router-z losses are summed over the
layers into the training loss.

Not ported yet (they raise ``NotImplementedError`` naming the ROADMAP
item): periodic hybrid segments, the encoder of encoder-decoder models
and vision prefixes (queue 1, item 12).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import (
    CacheSpec,
    attention_block,
    declare_attention,
    init_kv_cache,
)
from repro_torch.models.ffn import declare_ffn, declare_moe, ffn_block, moe_block
from repro_torch.models.layers import (
    apply_dense,
    apply_norm,
    declare_embedding,
    declare_norm,
    softmax_cross_entropy,
    unembed,
)
from repro_torch.models.ssm import declare_mamba, init_mamba_state, mamba_block
from repro_torch.models.module import (
    ParamBuilder,
    _assign,
    _fold_path,
    embedding_init,
    torch_dtype,
)
from repro_torch.tree import tree_leaves, tree_map

SCAN_THRESHOLD = 8

_FAMILIES = "ROADMAP queue 1, item 12 (the other model families)"


# ---------------------------------------------------------------------------
# Layer segmentation (identical to the JAX package)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str          # attn | local | global | mamba
    is_moe: bool
    count: int
    scanned: bool


@dataclasses.dataclass(frozen=True)
class PeriodicSegment:
    """A repeating heterogeneous layer pattern (jamba, gemma3): the JAX
    model scans the pattern over its repeats. Not ported yet."""

    pattern: Tuple[Segment, ...]
    reps: int

    @property
    def count(self) -> int:
        return len(self.pattern) * self.reps


def _plain_segments(cfg: ModelConfig, kinds, moes, scan: bool) -> List[Segment]:
    segs: List[Segment] = []
    i = 0
    while i < len(kinds):
        kind, moe = kinds[i], moes[i]
        j = i
        while j < len(kinds) and kinds[j] == kind and moes[j] == moe:
            j += 1
        count = j - i
        segs.append(Segment(kind, moe, count,
                            scanned=scan and count >= SCAN_THRESHOLD))
        i = j
    return segs


def segment_layers(cfg: ModelConfig) -> List:
    kinds = list(cfg.layer_kinds())
    moes = [cfg.layer_is_moe(i) for i in range(cfg.num_layers)]
    plain = _plain_segments(cfg, kinds, moes, cfg.scan_layers)
    if not cfg.scan_layers:
        return plain
    if any(s.scanned for s in plain):
        return plain
    # no long uniform run: look for a repeating heterogeneous period
    pattern = list(zip(kinds, moes))
    L = len(pattern)
    for p in range(2, 13):
        reps = L // p
        if reps < 2:
            break
        if len(set(pattern[:p])) <= 1:
            continue
        if all(pattern[i] == pattern[i % p] for i in range(reps * p)):
            body = tuple(
                Segment(kinds[j], moes[j], 1, scanned=False) for j in range(p)
            )
            segs: List = [PeriodicSegment(pattern=body, reps=reps)]
            rem = L - reps * p
            if rem:
                segs.extend(
                    _plain_segments(
                        cfg, kinds[reps * p:], moes[reps * p:], cfg.scan_layers
                    )
                )
            return segs
    return plain


def _has_ffn(cfg: ModelConfig, seg: Segment) -> bool:
    return seg.is_moe or (cfg.d_ff > 0 and seg.kind != "mamba") or (
        cfg.d_ff > 0 and cfg.family == "hybrid"
    )


def _check_supported(cfg: ModelConfig, segments) -> None:
    """Reject, up front, every branch of the JAX model the port lacks."""
    if cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet ({_FAMILIES})"
        )
    if cfg.pos_embed not in ("rope", "learned", "none"):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.pos_embed} position embeddings are not ported "
            f"yet ({_FAMILIES})"
        )
    if cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.frontend} prefix frontends are not ported yet "
            f"({_FAMILIES})"
        )
    for seg in segments:
        if isinstance(seg, PeriodicSegment):
            raise NotImplementedError(
                f"{cfg.name}: periodic (hybrid / local:global) segments are "
                f"not ported yet ({_FAMILIES})"
            )


# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------
def _declare_layer(b: ParamBuilder, path: str, cfg: ModelConfig, seg: Segment) -> None:
    declare_norm(b, f"{path}.norm1", cfg.d_model, cfg.norm)
    if seg.kind == "mamba":
        declare_mamba(b, f"{path}.mixer", cfg)
    else:
        declare_attention(b, f"{path}.mixer", cfg)
    if _has_ffn(cfg, seg):
        declare_norm(b, f"{path}.norm2", cfg.d_model, cfg.norm)
        if seg.is_moe:
            declare_moe(b, f"{path}.ffn", cfg)
        else:
            declare_ffn(b, f"{path}.ffn", cfg.d_model, cfg.d_ff, cfg.gated_ffn)


def _stack_builder(cfg: ModelConfig, seg: Segment) -> ParamBuilder:
    """Builder for ONE layer of a segment (stacked at materialization)."""
    b = ParamBuilder(param_dtype=cfg.param_dtype)
    _declare_layer(b, "layer", cfg, seg)
    return b


def _top_builder(cfg: ModelConfig) -> ParamBuilder:
    top = ParamBuilder(param_dtype=cfg.param_dtype)
    declare_embedding(top, "embed", cfg.padded_vocab, cfg.d_model)
    if not cfg.tie_embeddings:
        top.declare(
            "unembed.w", (cfg.d_model, cfg.padded_vocab), (None, "vocab"),
            init=embedding_init,
        )
    declare_norm(top, "final_norm", cfg.d_model, cfg.norm)
    if cfg.pos_embed == "learned":
        top.declare(
            "pos_embed.table", (cfg.max_position, cfg.d_model),
            (None, None), init=embedding_init,
        )
    return top


def _zero_aux(device) -> Dict[str, torch.Tensor]:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"load_balance": z, "router_z": z}


class Model:
    """Config-driven dense transformer. Pure functions + param dicts."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.segments = segment_layers(cfg)
        _check_supported(cfg, self.segments)

    # -- parameters -----------------------------------------------------------
    def init(self, seed: int, *, device="cuda") -> Dict[str, Any]:
        """Random initial parameters on ``device`` from ``seed``."""
        device = resolve_device(device)
        params: Dict[str, Any] = dict(_top_builder(self.cfg).init(seed, device))
        for s, seg in enumerate(self.segments):
            params[f"blocks_{s}"] = _stacked_init(
                _stack_builder(self.cfg, seg),
                _fold_path(seed, f"blocks_{s}"), seg.count, device,
            )
        return params

    def param_shapes(self) -> Dict[str, Any]:
        """The tree of ``(shape, dtype)`` leaves ``init`` would return."""
        shapes: Dict[str, Any] = dict(_top_builder(self.cfg).abstract())
        for s, seg in enumerate(self.segments):
            shapes[f"blocks_{s}"] = tree_map(
                lambda sd, n=seg.count: ((n,) + sd[0], sd[1]),
                _stack_builder(self.cfg, seg).abstract()["layer"],
            )
        return shapes

    def num_params(self) -> int:
        return int(sum(
            np.prod(shape) for shape, _ in tree_leaves(self.param_shapes())
        ))

    # -- forward ----------------------------------------------------------------
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dtype = torch_dtype(cfg.compute_dtype)
        x = F.embedding(tokens.long(), params["embed"]["table"]).to(dtype)
        if cfg.name.startswith("gemma"):
            # the JAX model multiplies by a numpy float64 scalar, which
            # promotes a bf16 residual stream to fp32; mirror that
            x = x.float() * float(np.sqrt(cfg.d_model))
        return x

    @staticmethod
    def _positions(batch: int, length: int, device, start: int = 0) -> torch.Tensor:
        pos = torch.arange(start, start + length, dtype=torch.int32, device=device)
        return pos[None, :].expand(batch, length)

    def _layer_apply(self, p, x, seg: Segment, *, positions, cache=None,
                     cache_spec=None, prefill_from_zero: bool = False):
        """One layer; returns ``(x, new_cache, aux)``, aux the MoE layer's
        losses (None for other layers: no zeros to add on their path).
        ``prefill_from_zero``: a multi-token cache step from position 0
        (the kernels' path)."""
        cfg = self.cfg
        h = apply_norm(p["norm1"], x, cfg.norm)
        if seg.kind == "mamba":
            y, new_cache = mamba_block(
                p["mixer"], h, cfg, state=cache, return_state=cache is not None,
                from_zero_state=prefill_from_zero,
            )
        else:
            window = cfg.sliding_window if seg.kind == "local" else 0
            y, new_cache = attention_block(
                p["mixer"], h, cfg, positions=positions, causal=True, window=window,
                cache=cache, cache_spec=cache_spec,
                prefill_from_zero=prefill_from_zero,
            )
        x = x + y
        aux = None
        if _has_ffn(cfg, seg):
            h = apply_norm(p["norm2"], x, cfg.norm)
            if seg.is_moe:
                y, aux = moe_block(
                    p["ffn"], h, cfg,
                    impl="einsum" if cfg.moe_num_experts <= 8 else "ragged",
                )
            else:
                y = ffn_block(p["ffn"], h, cfg)
            x = x + y
        return x, new_cache, aux

    def _run_segment(self, params_seg, x, seg: Segment, *, positions, caches=None,
                     cache_spec=None, prefill_from_zero: bool = False):
        """One segment: a loop over the stacked layer dim (the JAX model's
        ``lax.scan`` for scanned segments, its unrolled loop otherwise).
        Layer i reads and updates ``caches`` at index i in place. Returns
        the layers' aux losses summed (zero for dense and Mamba layers)."""
        def one(x, p):
            x, _, aux = self._layer_apply(p, x, seg, positions=positions)
            return x, aux

        aux_total = _zero_aux(x.device)
        for i in range(seg.count):
            p_i = tree_map(lambda a: a[i], params_seg)
            if caches is not None:
                cache_i = {key: a[i] for key, a in caches.items()}
                x, new, aux = self._layer_apply(
                    p_i, x, seg, positions=positions, cache=cache_i,
                    cache_spec=cache_spec, prefill_from_zero=prefill_from_zero,
                )
                for key, t in new.items():
                    if t.data_ptr() != cache_i[key].data_ptr():
                        cache_i[key].copy_(t)
            elif self.cfg.remat and torch.is_grad_enabled():
                x, aux = checkpoint(one, x, p_i, use_reentrant=False)
            else:
                x, aux = one(x, p_i)
            if aux is not None:
                aux_total = {k: aux_total[k] + aux[k] for k in aux_total}
        return x, aux_total

    def forward(self, params, tokens: torch.Tensor) -> Tuple[torch.Tensor, dict]:
        """Teacher-forced forward from position 0: logits at every
        position."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        B, S = x.shape[0], x.shape[1]
        positions = self._positions(B, S, x.device)
        if cfg.pos_embed == "learned":
            x = x + params["pos_embed"]["table"][positions.long()].to(x.dtype)
        aux_total = _zero_aux(x.device)
        for s, seg in enumerate(self.segments):
            x, aux = self._run_segment(
                params[f"blocks_{s}"], x, seg, positions=positions
            )
            aux_total = {k: aux_total[k] + aux[k] for k in aux_total}
        x = apply_norm(params["final_norm"], x, cfg.norm)
        return self._unembed(params, x), aux_total

    def _unembed(self, params, x):
        cfg = self.cfg
        dtype = torch_dtype(cfg.compute_dtype)
        if cfg.tie_embeddings:
            logits = unembed(params["embed"], x, dtype)
        else:
            logits = apply_dense(params["unembed"], x, dtype)
        if cfg.logit_softcap:
            logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
        if cfg.padded_vocab != cfg.vocab_size:
            pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
            neg = torch.tensor(-1e30, dtype=torch.float32).to(logits.dtype)
            logits = torch.where(pad, neg.to(x.device), logits)
        return logits

    # -- loss -------------------------------------------------------------------
    @staticmethod
    def _combine_loss(logits, batch: dict, aux: dict) -> Tuple[torch.Tensor, dict]:
        """ce + aux-regularizer objective and its metrics."""
        ce = softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))
        total = ce + 1e-2 * aux["load_balance"] + 1e-3 * aux["router_z"]
        return total, {"ce": ce, **aux}

    def loss(self, params, batch: dict) -> Tuple[torch.Tensor, dict]:
        """batch: tokens (B,S), labels (B,S), optional mask."""
        logits, aux = self.forward(params, batch["tokens"])
        return self._combine_loss(logits, batch, aux)


    # -- serving ------------------------------------------------------------------
    def cache_specs(self, max_len: int) -> List[Optional[CacheSpec]]:
        """Per-layer cache spec; local layers get ring buffers of window
        size, Mamba layers none (they carry a recurrent state)."""
        cfg = self.cfg
        specs: List[Optional[CacheSpec]] = []
        for kind in cfg.layer_kinds():
            if kind == "local" and cfg.sliding_window:
                specs.append(CacheSpec(length=min(cfg.sliding_window, max_len), ring=True))
            elif kind == "mamba":
                specs.append(None)
            else:
                specs.append(CacheSpec(length=max_len, ring=False))
        return specs

    def _one_layer_cache(self, kind, spec, batch, dtype, device):
        if kind == "mamba":
            return init_mamba_state(batch, self.cfg, dtype, device)
        return init_kv_cache(
            batch, spec, self.cfg.num_kv_heads, self.cfg.head_dim, dtype, device
        )

    def init_cache(self, batch: int, max_len: int, *, device="cuda") -> List[dict]:
        """Per-segment caches, stacked on a leading layer dim, in the
        compute dtype on ``device``."""
        device = resolve_device(device)
        dtype = torch_dtype(self.cfg.compute_dtype)
        specs = self.cache_specs(max_len)
        caches, li = [], 0
        for seg in self.segments:
            one = self._one_layer_cache(seg.kind, specs[li], batch, dtype, device)
            caches.append({
                key: a[None].repeat((seg.count,) + (1,) * a.dim())
                for key, a in one.items()
            })
            li += seg.count
        return caches

    def serve_forward(self, params, tokens: torch.Tensor, caches, *,
                      start_position, max_len: int):
        """One serving step: prefill (S > 1) or decode (S == 1) of
        ``tokens`` (B, S) at positions ``start_position..+S-1``. Updates
        ``caches`` in place and returns ``(logits of the last position
        (B, 1, vocab), caches)``."""
        cfg = self.cfg
        start = int(start_position)
        x = self._embed(params, tokens)
        B, S = x.shape[0], x.shape[1]
        positions = self._positions(B, S, x.device, start)
        if cfg.pos_embed == "learned":
            x = x + params["pos_embed"]["table"][positions.long()].to(x.dtype)
        specs = self.cache_specs(max_len)
        li = 0
        for s, seg in enumerate(self.segments):
            x, _ = self._run_segment(
                params[f"blocks_{s}"], x, seg, positions=positions,
                caches=caches[s], cache_spec=specs[li],
                prefill_from_zero=S > 1 and start == 0,
            )
            li += seg.count
        x = apply_norm(params["final_norm"], x, cfg.norm)
        return self._unembed(params, x[:, -1:, :]), caches


def _stacked_init(builder: ParamBuilder, seed: int, count: int, device):
    """Materialize ``count`` stacked layers, each from its own seed.

    Each stacked leaf is allocated once and layer i is drawn into it in
    place, leaf by leaf, so no more than one layer's copy of one leaf is
    ever held beside the stack (the same numbers as drawing every layer's
    tree and stacking them, at about half the peak memory)."""
    stacked: Dict[str, Any] = {}
    for path, decl in builder.decls.items():
        leaf = torch.empty((count,) + decl.shape, dtype=decl.dtype, device=device)
        for i in range(count):
            gen = torch.Generator(device=device)
            gen.manual_seed(_fold_path(_fold_path(seed, str(i)), path))
            leaf[i].copy_(decl.init(gen, decl.shape, decl.dtype, device))
        _assign(stacked, path, leaf)
    return stacked["layer"]
