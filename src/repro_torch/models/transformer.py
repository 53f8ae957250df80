"""Transformer assembly for every registry family, for training and
serving: dense decoders (GQA/MQA), MoE decoders, pure-SSM (mamba2),
hybrid attention + SSM (jamba), local:global attention (gemma3),
encoder-decoder over stub audio frames (whisper) and a decoder behind a
stub vision prefix (internvl2).

The port of ``repro.models.transformer``. Layer stacking follows the JAX
package: consecutive identical layers form a *segment* whose parameters
are stacked on a leading layer dim, so ``blocks_0.mixer.wq.w`` has shape
``(layers, d, heads * head_dim)`` here and in the JAX tree alike. The
JAX model scans segments of ``SCAN_THRESHOLD`` or more layers with
``lax.scan`` and unrolls shorter ones; both become the same Python loop
over the layer dim here. A stack with no long uniform run but a
repeating heterogeneous pattern (jamba: period 8, gemma3: period 6)
becomes a ``PeriodicSegment``: its parameters sit under ``pos_{j}``, one
sub-tree per position in the period, each stacked over the repeats, and
one loop over the repeats applies the whole pattern per pass, as the
JAX model's scan body does. ``cfg.remat`` maps to
``torch.utils.checkpoint``, one per layer (recompute in the backward,
same numbers).

Serving (``init_cache`` / ``serve_forward``) threads per-segment caches,
stacked on the layer dim like the parameters (``{pos_j: stacked over
the repeats}`` for a periodic segment), through the layer loop: KV
caches for attention layers, the SSM and conv state for Mamba layers.
The port updates them in place. A prefill from position 0 runs the
hand-written flash-attention and SSD chunk-scan kernels on the card
(``repro_torch.kernels.ops``), the encoder's self-attention and the
cross-attention included; decode runs the models' plain PyTorch
attention and SSD, as the JAX model does. Training's cache-less
self-attention takes the flash kernel and its backward where the
routing rule allows (``attention.flash_route``); the rest of training,
SSD included, stays plain.

Encoder-decoder models encode stub frame embeddings (``_encode``:
frontend projection, sinusoidal positions, non-causal layers) and give
every decoder layer a cross-attention over the encoder output. Vision
models prepend the projected ``prefix_embeddings`` to the token
embeddings; the prefix positions' logits are dropped.

MoE layers take the JAX model's branch: the einsum path for a router
over 8 experts or fewer, else the ragged path, whose expert products run the
hand-written grouped-matmul kernel on the card (in prefill and decode
alike, and in training, whose backward runs its dx and dw kernels).
Their router losses (load balance and router z, or the sigmoid
router's sequence-wise balance) are summed over the layers into the
training loss, each weighed by ``ffn.AUX_WEIGHTS``. A config with
``mla_kv_rank`` takes latent attention (``attention.mla_block``) in
every attention layer; its blocks, and the MoE blocks, open their spans
on the step's (``telemetry.blocks``), carried into remat's recompute.

``param_group_specs`` / ``stream_stages`` are the JAX model's streaming
view of the same forward, for the streamed FSDP layouts
(``repro_torch.dist.fsdp``): the parameter tree as ordered layer groups
(embedding, encoder, one group per unrolled block or one per scanned or
periodic segment, head) and the teacher-forced loss as a walk over
stages that each read only the groups they name. A stage over a scanned
or periodic segment also carries a ``ScanStreamBody``, one loop
iteration (a layer, or a whole period) given that iteration's
parameters, so the caller can gather one layer row at a time.

Under tensor parallel (sharding rules with a ``model`` axis current,
``repro_torch.dist.sharding.use_rules``) ``init``, ``param_shapes`` and
``init_cache`` give this model rank's slices and every layer runs its
sharded form (``repro_torch.models.tp``); ``logical_axes`` is the JAX
model's tree of each parameter's logical axes. The loss is
vocab-parallel and ``serve_forward`` makes the last position's logits
whole (``tp.gather_vocab``).

Where PyTorch would raise an opaque indexing error, the port raises a
``PositionRangeError`` (a ``ValueError``) naming the cause: serving positions past ``max_len`` in
a model with a full-length KV cache (it has no room for them; Mamba
states and ring caches have no end) and learned positions past
``max_position``. The JAX model drops such cache writes and clamps such
gathers instead.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import checkpoint, current_rules, no_rules
from repro_torch.models.attention import (
    CacheSpec,
    attention_block,
    declare_attention,
    declare_mla,
    encoder_kv,
    init_kv_cache,
    kv_seq_split,
    mla_block,
)
from repro_torch.models import tp as tpl
from repro_torch.models.ffn import (
    AUX_WEIGHTS,
    aux_names,
    declare_ffn,
    declare_moe,
    ffn_block,
    moe_block,
)
from repro_torch.models.layers import (
    apply_dense,
    apply_norm,
    declare_dense,
    declare_embedding,
    declare_norm,
    embed_lookup,
    sinusoidal_table,
    softmax_cross_entropy,
    unembed,
    vocab_parallel,
)
from repro_torch.models.ssm import declare_mamba, init_mamba_state, mamba_block
from repro_torch.models.module import (
    ParamBuilder,
    _assign,
    _fold_path,
    embedding_init,
    local_shape,
    local_slice,
    split_of,
    torch_dtype,
)
from repro_torch.telemetry.blocks import bind_block_spans
from repro_torch.tree import tree_leaves, tree_map

SCAN_THRESHOLD = 8


class PositionRangeError(ValueError):
    """Positions the model has no room for: past ``max_len`` with a
    full-length KV cache, or past the learned or sinusoidal table. The
    JAX model drops or clamps them; the port refuses."""


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
    """A repeating heterogeneous layer pattern (jamba, gemma3), applied
    whole once per repeat: params are stacked per position in the
    period with a leading ``reps`` dim."""

    pattern: Tuple[Segment, ...]   # one single-layer Segment per position
    reps: int

    @property
    def count(self) -> int:
        return len(self.pattern) * self.reps

    @property
    def period(self) -> int:
        return len(self.pattern)


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


@dataclasses.dataclass(frozen=True)
class ParamGroup:
    """One layer group of the parameter tree (the streaming unit):
    ``keys`` are the top-level keys it covers; a block group of an
    unrolled segment also carries its ``layer`` index into the segment's
    stacked dim; a scanned or periodic segment is one group whose leaves
    carry a leading ``repeats`` dim."""

    name: str
    keys: Tuple[str, ...]
    segment: Optional[int] = None     # segment index for block groups
    layer: Optional[int] = None       # layer index within an unrolled segment
    repeats: Optional[int] = None     # loop iterations of a scanned group


@dataclasses.dataclass(frozen=True)
class ScanStreamBody:
    """One iteration of a scanned or periodic segment:
    ``apply_layer(x, group_view) -> (x, aux)`` advances the residual
    stream by one layer (a whole period for a periodic segment) given a
    view holding that iteration's parameters only (leading dim
    stripped). Positions come from ``x`` (training starts at 0)."""

    repeats: int
    apply_layer: Callable[[torch.Tensor, Dict[str, Any]],
                          Tuple[torch.Tensor, Dict[str, Any]]]


@dataclasses.dataclass(frozen=True)
class StreamStage:
    """One step of the streamed forward walk: the layer groups it reads
    (indices into ``param_group_specs()``) and ``apply(carry,
    group_trees) -> carry``; the caller owns the gathers and the
    recomputation. ``scan``: the per-iteration body of a scanned or
    periodic segment's stage (``apply`` stays its stack-at-once form)."""

    name: str
    group_ids: Tuple[int, ...]
    apply: Callable[[Dict[str, Any], Tuple[Any, ...]], Dict[str, Any]]
    scan: Optional[ScanStreamBody] = None


def _add_aux(total, aux):
    return total if aux is None else {k: total[k] + aux[k] for k in total}


def _has_ffn(cfg: ModelConfig, seg: Segment) -> bool:
    return seg.is_moe or (cfg.d_ff > 0 and seg.kind != "mamba") or (
        cfg.d_ff > 0 and cfg.family == "hybrid"
    )


# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------
def _declare_layer(
    b: ParamBuilder, path: str, cfg: ModelConfig, seg: Segment, *, cross: bool
) -> None:
    declare_norm(b, f"{path}.norm1", cfg.d_model, cfg.norm)
    if seg.kind == "mamba":
        declare_mamba(b, f"{path}.mixer", cfg)
    elif cfg.mla_kv_rank:
        declare_mla(b, f"{path}.mixer", cfg)
    else:
        declare_attention(b, f"{path}.mixer", cfg)
    if cross:
        declare_norm(b, f"{path}.norm_cross", cfg.d_model, cfg.norm)
        declare_attention(b, f"{path}.cross", cfg, cross=True)
    if _has_ffn(cfg, seg):
        declare_norm(b, f"{path}.norm2", cfg.d_model, cfg.norm)
        if seg.is_moe:
            declare_moe(b, f"{path}.ffn", cfg)
        else:
            declare_ffn(b, f"{path}.ffn", cfg.d_model, cfg.d_ff, cfg.gated_ffn)


def _stack_builder(cfg: ModelConfig, seg: Segment, *, cross: bool = False) -> ParamBuilder:
    """Builder for ONE layer of a segment (stacked at materialization);
    ``cross`` adds the decoder layer's cross-attention."""
    b = ParamBuilder(param_dtype=cfg.param_dtype)
    _declare_layer(b, "layer", cfg, seg, cross=cross)
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
    if cfg.frontend:
        fd = cfg.frontend_dim or cfg.d_model
        declare_dense(top, "frontend_proj", fd, cfg.d_model, (None, None))
    if cfg.encoder_layers:
        declare_norm(top, "enc_final_norm", cfg.d_model, cfg.norm)
    return top


def _zero_aux(device, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Zero router losses, under the names a MoE layer of ``cfg`` gives."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {name: z for name in aux_names(cfg)}


class Model:
    """Config-driven transformer. Pure functions + param dicts."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.segments = segment_layers(cfg)
        self._enc_segment = (
            Segment("attn", False, cfg.encoder_layers,
                    cfg.encoder_layers >= SCAN_THRESHOLD)
            if cfg.encoder_layers else None
        )

    # -- parameters -----------------------------------------------------------
    def _stacks(self):
        """Every stacked parameter group as ``(tree path, one-layer
        builder, count)``, in the JAX tree's order: each segment (a
        periodic one as its ``pos_{j}`` sub-trees), then the encoder. A
        group's seed is folded from its path joined with ``_``
        (``blocks_0_pos_3``), as the JAX model folds its keys."""
        cross = self._enc_segment is not None
        for s, seg in enumerate(self.segments):
            if isinstance(seg, PeriodicSegment):
                for j, sub in enumerate(seg.pattern):
                    yield (f"blocks_{s}", f"pos_{j}"), _stack_builder(self.cfg, sub), seg.reps
            else:
                yield (f"blocks_{s}",), _stack_builder(self.cfg, seg, cross=cross), seg.count
        if self._enc_segment is not None:
            yield ("encoder",), _stack_builder(self.cfg, self._enc_segment), self.cfg.encoder_layers

    def init(self, seed: int, *, device="cuda") -> Dict[str, Any]:
        """Random initial parameters on ``device`` from ``seed``: this model
        rank's slices of them under the current rules."""
        device = resolve_device(device)
        params: Dict[str, Any] = dict(_top_builder(self.cfg).init(seed, device))
        for path, builder, count in self._stacks():
            _assign(params, ".".join(path), _stacked_init(
                builder, _fold_path(seed, "_".join(path)), count, device))
        return params

    def param_shapes(self) -> Dict[str, Any]:
        """The tree of ``(shape, dtype)`` leaves ``init`` would return."""
        shapes: Dict[str, Any] = dict(_top_builder(self.cfg).abstract())
        for path, builder, count in self._stacks():
            _assign(shapes, ".".join(path), tree_map(
                lambda sd, n=count: ((n,) + sd[0], sd[1]), builder.abstract()["layer"]))
        return shapes

    def logical_axes(self) -> Dict[str, Any]:
        """Each parameter's logical axes, in the tree ``init`` returns
        (stacked leaves lead with ``"layers"``), as in the JAX model."""
        axes: Dict[str, Any] = dict(_top_builder(self.cfg).logical_axes())
        for path, builder, _ in self._stacks():
            _assign(axes, ".".join(path), tree_map(
                lambda a: ("layers",) + a, builder.logical_axes()["layer"]))
        return axes

    def num_params(self) -> int:
        """The whole model's parameter count (under any rules)."""
        with no_rules():
            return int(sum(
                np.prod(shape) for shape, _ in tree_leaves(self.param_shapes())
            ))

    # -- forward ----------------------------------------------------------------
    def _embed(self, params, tokens: torch.Tensor, prefix_embeddings=None):
        """Token embeddings, behind the projected prefix when one is
        given: ``(x, prefix length)``."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.compute_dtype)
        x = embed_lookup(params["embed"]["table"], tokens).to(dtype)
        if cfg.name.startswith("gemma"):
            # the JAX model multiplies by a numpy float64 scalar, which
            # promotes a bf16 residual stream to fp32; mirror that
            x = x.float() * float(np.sqrt(cfg.d_model))
        if prefix_embeddings is None:
            return x, 0
        proj = apply_dense(params["frontend_proj"], prefix_embeddings, dtype)
        return torch.cat([proj, x], dim=1), prefix_embeddings.shape[1]

    @staticmethod
    def _positions(batch: int, length: int, device, start: int = 0) -> torch.Tensor:
        pos = torch.arange(start, start + length, dtype=torch.int32, device=device)
        return pos[None, :].expand(batch, length)

    def _add_positions(self, params, x, positions, start: int, table_len: int):
        """Learned or sinusoidal position embeddings of ``start..`` (rope
        is applied in attention); ``table_len`` is the sinusoidal table's
        length."""
        cfg = self.cfg
        if cfg.pos_embed not in ("learned", "sinusoidal"):
            return x
        if cfg.pos_embed == "learned":
            table_len = cfg.max_position
        end = start + x.shape[1]
        if end > table_len:
            raise PositionRangeError(
                f"{cfg.name}: positions up to {end - 1} lie past the {cfg.pos_embed} "
                f"position table of {table_len} (max_position); the JAX model clamps "
                "them, the port refuses"
            )
        if cfg.pos_embed == "learned":
            return x + params["pos_embed"]["table"][positions.long()].to(x.dtype)
        table = _sinusoidal_on(table_len, cfg.d_model, x.device, x.dtype)
        return x + table[positions.long()]

    def _layer_apply(self, p, x, seg: Segment, *, positions, cache=None,
                     cache_spec=None, cross_kv=None, prefill_from_zero: bool = False):
        """One layer; returns ``(x, new_cache, aux)``, aux the MoE layer's
        losses (None for other layers: no zeros to add on their path).
        ``cross_kv``: this layer's encoder K/V (decoder layers of an
        encoder-decoder model). ``prefill_from_zero``: a multi-token cache
        step from position 0 (the kernels' path)."""
        cfg = self.cfg
        # sequence parallel (training): x is this rank's slice of the
        # sequence, and each block runs on its gathered input, given as
        # the block's input to sharded work (xm) with the reduce-scatter
        # of its row-parallel output (reduce); an output the block did
        # not reduce is whole, and sliced here
        tp = tpl.seq_parallel() if cache is None else None

        def sublayer(norm, block):
            h = apply_norm(norm if tp is None else tpl.sum_grad(norm), x, cfg.norm,
                           cfg.rms_eps)
            if tp is None:
                return block(h)
            seq = tpl.SeqIn(h, tp)
            out = block(seq.x, xm=seq.xm, reduce=seq.reduce)
            y = out[0] if isinstance(out, tuple) else out
            y = y if seq.done else tpl.seq_slice(y)
            return (y,) + tuple(out[1:]) if isinstance(out, tuple) else y

        if seg.kind == "mamba":
            y, new_cache = sublayer(p["norm1"], lambda h, **seq: mamba_block(
                p["mixer"], h, cfg, state=cache, return_state=cache is not None,
                from_zero_state=prefill_from_zero, **seq,
            ))
        else:
            window = cfg.sliding_window if seg.kind == "local" else 0
            attend = mla_block if cfg.mla_kv_rank else attention_block
            y, new_cache = sublayer(p["norm1"], lambda h, **seq: attend(
                p["mixer"], h, cfg, positions=positions, causal=True, window=window,
                cache=cache, cache_spec=cache_spec,
                prefill_from_zero=prefill_from_zero, **seq,
            ))
        x = x + y
        if cross_kv is not None:
            y, _ = sublayer(p["norm_cross"], lambda h, **seq: attention_block(
                p["cross"], h, cfg, positions=positions, cross_kv=cross_kv,
                prefill_from_zero=prefill_from_zero, **seq))
            x = x + y
        aux = None
        if _has_ffn(cfg, seg):
            if seg.is_moe:
                # the MoE combine is reduced per token chunk: its output is
                # sliced, not reduce-scattered
                y, aux = sublayer(p["norm2"], lambda h, xm=None, reduce=None: moe_block(
                    p["ffn"], h, cfg,
                    impl="einsum" if cfg.router_experts <= 8 else "ragged", xm=xm,
                ))
            else:
                y = sublayer(p["norm2"], lambda h, **seq: ffn_block(p["ffn"], h, cfg, **seq))
            x = x + y
        return x, new_cache, aux

    def _run_layer(self, p, x, seg: Segment, *, positions, cache=None, cache_spec=None,
                   cross_kv=None, prefill_from_zero: bool = False):
        """One layer of a segment loop: ``(x, aux)``. A cache is updated
        in place; without one, under ``cfg.remat`` with grad enabled, the
        layer is recomputed in the backward (``jax.checkpoint`` per layer
        in the JAX model)."""
        if cache is not None:
            x, new, aux = self._layer_apply(
                p, x, seg, positions=positions, cache=cache, cache_spec=cache_spec,
                cross_kv=cross_kv, prefill_from_zero=prefill_from_zero,
            )
            for key, t in new.items():
                if t.data_ptr() != cache[key].data_ptr():
                    cache[key].copy_(t)
            return x, aux

        def one(x, p, cross_kv):
            x, _, aux = self._layer_apply(p, x, seg, positions=positions, cross_kv=cross_kv)
            return x, aux

        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(bind_block_spans(one), x, p, cross_kv)
        return one(x, p, cross_kv)

    def _run_segment(self, params_seg, x, seg, *, positions, caches=None,
                     cache_spec=None, cross_kvs=None, prefill_from_zero: bool = False):
        """One segment: a loop over the stacked layer dim (the JAX model's
        ``lax.scan`` for scanned segments, its unrolled loop otherwise).
        Layer i reads and updates ``caches`` at index i in place and
        attends over ``cross_kvs[i]``. Returns the layers' aux losses
        summed (zero for dense and Mamba layers)."""
        if isinstance(seg, PeriodicSegment):
            return self._run_periodic(params_seg, x, seg, positions=positions,
                                      caches=caches, cache_specs=cache_spec,
                                      prefill_from_zero=prefill_from_zero)
        aux_total = _zero_aux(x.device, self.cfg)
        for i in range(seg.count):
            x, aux = self._run_layer(
                tree_map(lambda a: a[i], params_seg), x, seg, positions=positions,
                cache=None if caches is None else {k: a[i] for k, a in caches.items()},
                cache_spec=cache_spec,
                cross_kv=None if cross_kvs is None else cross_kvs[i],
                prefill_from_zero=prefill_from_zero,
            )
            if aux is not None:
                aux_total = {k: aux_total[k] + aux[k] for k in aux_total}
        return x, aux_total

    def _run_periodic(self, params_seg, x, seg: PeriodicSegment, *, positions,
                      caches=None, cache_specs=None, prefill_from_zero: bool = False):
        """One loop over the repeats; each pass applies the whole pattern,
        position j from ``params_seg[f"pos_{j}"]`` (and its cache) at the
        pass's index (the JAX model's scan body)."""
        aux_total = _zero_aux(x.device, self.cfg)
        for r in range(seg.reps):
            for j, sub in enumerate(seg.pattern):
                key = f"pos_{j}"
                x, aux = self._run_layer(
                    tree_map(lambda a: a[r], params_seg[key]), x, sub,
                    positions=positions,
                    cache=None if caches is None else {
                        k: a[r] for k, a in caches[key].items()},
                    cache_spec=None if cache_specs is None else cache_specs[key],
                    prefill_from_zero=prefill_from_zero,
                )
                if aux is not None:
                    aux_total = {k: aux_total[k] + aux[k] for k in aux_total}
        return x, aux_total

    def _encode(self, params, frames: torch.Tensor, *, prefill: bool = False):
        """Whisper-style encoder over stub frame embeddings (B, S_enc,
        fd). ``prefill``: the encoder pass of a serving prefill, whose
        self-attention runs the flash kernel on the card; in training the
        routing rule (``attention.flash_route``) decides."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.compute_dtype)
        x = apply_dense(params["frontend_proj"], frames, dtype)
        x = x + _sinusoidal_on(frames.shape[1], cfg.d_model, x.device, dtype)[None]
        positions = self._positions(frames.shape[0], frames.shape[1], x.device)

        def one(x, p):
            h = apply_norm(p["norm1"], x, cfg.norm, cfg.rms_eps)
            y, _ = attention_block(p["mixer"], h, cfg, positions=positions,
                                   causal=False, prefill_from_zero=prefill)
            x = x + y
            h = apply_norm(p["norm2"], x, cfg.norm, cfg.rms_eps)
            return x + ffn_block(p["ffn"], h, cfg)

        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(self._enc_segment.count):
            p_i = tree_map(lambda a: a[i], params["encoder"])
            x = checkpoint(one, x, p_i) if remat else one(x, p_i)
        return apply_norm(params["enc_final_norm"], x, cfg.norm, cfg.rms_eps)

    def forward(self, params, tokens: torch.Tensor, *,
                prefix_embeddings: Optional[torch.Tensor] = None,
                encoder_frames: Optional[torch.Tensor] = None,
                start_position: int = 0) -> Tuple[torch.Tensor, dict]:
        """Teacher-forced forward: logits at every token position (a
        vision prefix's positions are dropped)."""
        cfg = self.cfg
        x, prefix_len = self._embed(params, tokens, prefix_embeddings)
        B, S = x.shape[0], x.shape[1]
        positions = self._positions(B, S, x.device, start_position)
        x = self._add_positions(params, x, positions, start_position, start_position + S)
        x = self._seq_split(x)
        enc_out = None
        if encoder_frames is not None:
            enc_out = self._encode(params, encoder_frames)
        aux_total = _zero_aux(x.device, self.cfg)
        for s, seg in enumerate(self.segments):
            cross_kvs = None
            if enc_out is not None:
                cross_kvs = _segment_cross_kv(params[f"blocks_{s}"], enc_out, cfg)
            x, aux = self._run_segment(
                params[f"blocks_{s}"], x, seg, positions=positions, cross_kvs=cross_kvs,
            )
            aux_total = {k: aux_total[k] + aux[k] for k in aux_total}
        x = tpl.seq_gather(x)
        x = apply_norm(params["final_norm"], x, cfg.norm, cfg.rms_eps)
        if prefix_len:
            x = x[:, prefix_len:, :]
        return self._unembed(params, x), aux_total

    @staticmethod
    def _seq_split(x: torch.Tensor) -> torch.Tensor:
        """The residual stream's slice of this rank under sequence
        parallel (``tp.seq_parallel``), which needs the sequence to split
        over the model ranks; ``x`` itself otherwise."""
        tp = tpl.seq_parallel()
        if tp is None:
            return x
        if x.shape[1] % tp.size:
            raise ValueError(f"sequence parallel splits the sequence over {tp.size} model "
                             f"ranks; a sequence of {x.shape[1]} does not split")
        return tpl.seq_slice(x)

    @staticmethod
    def _stream_positions(x: torch.Tensor) -> torch.Tensor:
        """Positions ``0..`` of the whole sequence of a residual stream
        ``x`` (this rank's slice under sequence parallel)."""
        tp = tpl.seq_parallel()
        length = x.shape[1] * (tp.size if tp is not None else 1)
        pos = torch.arange(length, dtype=torch.int32, device=x.device)
        return pos[None, :].expand(x.shape[0], length)

    def _unembed(self, params, x):
        cfg = self.cfg
        dtype = torch_dtype(cfg.compute_dtype)
        if cfg.tie_embeddings:
            logits = unembed(params["embed"], x, dtype)
        else:
            # column-parallel over the vocabulary when it is split
            xin = tpl.to_model(x) if vocab_parallel() is not None else x
            logits = apply_dense(params["unembed"], xin, dtype)
        if cfg.logit_softcap:
            logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
        if cfg.padded_vocab != cfg.vocab_size:
            cols = logits.shape[-1]
            lo = vocab_parallel().rank * cols if cols != cfg.padded_vocab else 0
            pad = torch.arange(lo, lo + cols, device=x.device) >= cfg.vocab_size
            neg = torch.tensor(-1e30, dtype=torch.float32).to(logits.dtype)
            logits = torch.where(pad, neg.to(x.device), logits)
        return logits

    # -- loss -------------------------------------------------------------------
    @staticmethod
    def _combine_loss(logits, batch: dict, aux: dict) -> Tuple[torch.Tensor, dict]:
        """ce + aux-regularizer objective and its metrics."""
        ce = softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))
        total = ce
        for name, value in aux.items():
            total = total + AUX_WEIGHTS[name] * value
        return total, {"ce": ce, **aux}

    def loss(self, params, batch: dict) -> Tuple[torch.Tensor, dict]:
        """batch: tokens (B,S), labels (B,S), optional mask and frontend
        inputs (``prefix_embeddings``, ``encoder_frames``)."""
        logits, aux = self.forward(
            params, batch["tokens"],
            prefix_embeddings=batch.get("prefix_embeddings"),
            encoder_frames=batch.get("encoder_frames"),
        )
        return self._combine_loss(logits, batch, aux)

    # -- streaming (layer-grouped) execution -----------------------------------
    def param_group_specs(self) -> Tuple[ParamGroup, ...]:
        """Ordered layer groups of the parameter tree, in execution order
        (embedding, encoder, blocks by depth, head): the gather order of
        the streamed FSDP step. Every top-level key belongs to one group;
        with tied embeddings the head re-gathers the embedding group."""
        cfg = self.cfg
        has_enc = self._enc_segment is not None
        groups: List[ParamGroup] = []
        embed_keys = ["embed"]
        if cfg.pos_embed == "learned":
            embed_keys.append("pos_embed")
        if cfg.frontend and not has_enc:
            embed_keys.append("frontend_proj")
        groups.append(ParamGroup("embed", tuple(embed_keys)))
        if has_enc:
            enc_keys = ["encoder", "enc_final_norm"]
            if cfg.frontend:
                enc_keys.append("frontend_proj")
            groups.append(ParamGroup("encoder", tuple(enc_keys)))
        for s, seg in enumerate(self.segments):
            key = f"blocks_{s}"
            if isinstance(seg, PeriodicSegment):
                groups.append(ParamGroup(key, (key,), segment=s, repeats=seg.reps))
            elif seg.scanned:
                groups.append(ParamGroup(key, (key,), segment=s, repeats=seg.count))
            else:
                for i in range(seg.count):
                    groups.append(ParamGroup(f"{key}.{i}", (key,), segment=s, layer=i))
        head_keys = ["final_norm"]
        if not cfg.tie_embeddings:
            head_keys.append("unembed")
        groups.append(ParamGroup("head", tuple(head_keys)))
        return tuple(groups)

    def _scan_stream_body(self, seg, key: str) -> ScanStreamBody:
        """One iteration of a scanned or periodic segment, the loop body
        of ``_run_segment`` (``_run_periodic``) op for op, without
        caches or cross-attention."""
        if isinstance(seg, PeriodicSegment):
            def apply_period(x, view):
                p_slice = view[key]
                positions = self._stream_positions(x)
                aux_total = _zero_aux(x.device, self.cfg)
                for j, sub in enumerate(seg.pattern):
                    x, _, aux = self._layer_apply(p_slice[f"pos_{j}"], x, sub,
                                                  positions=positions)
                    aux_total = _add_aux(aux_total, aux)
                return x, aux_total

            return ScanStreamBody(repeats=seg.reps, apply_layer=apply_period)

        def apply_layer(x, view):
            positions = self._stream_positions(x)
            x, _, aux = self._layer_apply(view[key], x, seg, positions=positions)
            return x, _add_aux(_zero_aux(x.device, self.cfg), aux)

        return ScanStreamBody(repeats=seg.count, apply_layer=apply_layer)

    def stream_stages(self, batch: dict) -> Tuple[StreamStage, ...]:
        """The teacher-forced loss as a walk over layer groups, ``loss``
        op for op: each stage reads only the groups it names. The carry
        threads ``batch``, ``x``, ``positions``, ``prefix_len``, ``aux``
        (and ``enc_out`` with encoder frames); the head stage adds
        ``loss`` and ``metrics``. Cross-attention K/V are projected per
        layer from the layer's own group."""
        cfg = self.cfg
        specs = self.param_group_specs()
        index = {g.name: i for i, g in enumerate(specs)}
        has_frames = batch.get("encoder_frames") is not None

        def embed_apply(carry, groups):
            (top,) = groups
            b = carry["batch"]
            x, prefix_len = self._embed(top, b["tokens"], b.get("prefix_embeddings"))
            positions = self._positions(x.shape[0], x.shape[1], x.device)
            x = self._seq_split(self._add_positions(top, x, positions, 0, x.shape[1]))
            return {**carry, "x": x, "positions": positions, "prefix_len": prefix_len,
                    "aux": _zero_aux(x.device, self.cfg)}

        stages = [StreamStage("embed", (index["embed"],), embed_apply)]
        if has_frames:
            def encoder_apply(carry, groups):
                (enc,) = groups
                return {**carry, "enc_out": self._encode(enc, carry["batch"]["encoder_frames"])}

            stages.append(StreamStage("encoder", (index["encoder"],), encoder_apply))

        for g in specs:
            if g.segment is None:
                continue
            seg = self.segments[g.segment]
            if g.layer is None:
                def seg_apply(carry, groups, _g=g, _seg=seg):
                    (sub,) = groups
                    pseg = sub[_g.keys[0]]
                    cross_kvs = (_segment_cross_kv(pseg, carry["enc_out"], cfg)
                                 if has_frames else None)
                    x, aux = self._run_segment(pseg, carry["x"], _seg,
                                               positions=carry["positions"],
                                               cross_kvs=cross_kvs)
                    return {**carry, "x": x, "aux": _add_aux(carry["aux"], aux)}

                # cross-attention threads the encoder K/V through the body:
                # such a segment keeps the stack-at-once form
                body = None if has_frames else self._scan_stream_body(seg, g.keys[0])
                stages.append(StreamStage(g.name, (index[g.name],), seg_apply, scan=body))
            else:
                def layer_apply(carry, groups, _g=g, _seg=seg):
                    (sub,) = groups
                    p = sub[_g.keys[0]]
                    ckv = (encoder_kv(p["cross"], carry["enc_out"], cfg)
                           if has_frames and "cross" in p else None)
                    x, aux = self._run_layer(p, carry["x"], _seg,
                                             positions=carry["positions"], cross_kv=ckv)
                    return {**carry, "x": x, "aux": _add_aux(carry["aux"], aux)}

                stages.append(StreamStage(g.name, (index[g.name],), layer_apply))

        head_ids = (index["head"],)
        if cfg.tie_embeddings:
            head_ids = head_ids + (index["embed"],)

        def head_apply(carry, groups):
            view: Dict[str, Any] = {}
            for sub in groups:
                view.update(sub)
            x = apply_norm(view["final_norm"], tpl.seq_gather(carry["x"]), cfg.norm,
                           cfg.rms_eps)
            if carry["prefix_len"]:
                x = x[:, carry["prefix_len"]:, :]
            total, metrics = self._combine_loss(self._unembed(view, x), carry["batch"],
                                                carry["aux"])
            return {**carry, "loss": total, "metrics": metrics}

        stages.append(StreamStage("head", head_ids, head_apply))
        return tuple(stages)

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

    def _stacked_cache(self, kind, spec, count, batch, dtype, device):
        """``count`` zeroed caches of one layer kind, stacked on dim 0."""
        if kind == "mamba":
            one = init_mamba_state(batch, self.cfg, dtype, device)
        else:
            tp = tpl.context()
            kv, slots = self.cfg.num_kv_heads, None
            if kv_seq_split(spec.length) is not None:
                # kv_seq wins the model axis over kv_heads: the rank's
                # slots of every kv head
                slots = spec.length // tp.size
            elif tp is not None and tp.sharded("kv_proj"):
                kv //= tp.size
            one = init_kv_cache(batch, spec, kv, self.cfg.head_dim, dtype, device, slots)
        return {key: a[None].repeat((count,) + (1,) * a.dim()) for key, a in one.items()}

    def init_cache(self, batch: int, max_len: int, *, device="cuda") -> List[dict]:
        """Per-segment caches, stacked on a leading layer dim (periodic
        segments nest them as ``{pos_j: stacked over the repeats}``), in
        the compute dtype on ``device``: this model rank's kv heads and
        Mamba heads and conv columns under the current rules."""
        device = resolve_device(device)
        dtype = torch_dtype(self.cfg.compute_dtype)
        specs = self.cache_specs(max_len)
        caches, li = [], 0
        for seg in self.segments:
            if isinstance(seg, PeriodicSegment):
                caches.append({
                    f"pos_{j}": self._stacked_cache(sub.kind, specs[li + j], seg.reps,
                                                    batch, dtype, device)
                    for j, sub in enumerate(seg.pattern)
                })
            else:
                caches.append(self._stacked_cache(seg.kind, specs[li], seg.count,
                                                  batch, dtype, device))
            li += seg.count
        return caches

    def serve_forward(self, params, tokens: torch.Tensor, caches, *,
                      start_position, max_len: int,
                      encoder_out: Optional[torch.Tensor] = None,
                      prefix_embeddings: Optional[torch.Tensor] = None):
        """One serving step: prefill (S > 1) or decode (S == 1) of
        ``tokens`` (B, S), behind ``prefix_embeddings`` when given, at
        positions ``start_position..``. ``encoder_out`` (from ``_encode``)
        turns on every decoder layer's cross-attention. Updates
        ``caches`` in place and returns ``(logits of the last position
        (B, 1, vocab), caches)``."""
        cfg = self.cfg
        start = int(start_position)
        x, _ = self._embed(params, tokens, prefix_embeddings)
        B, S = x.shape[0], x.shape[1]
        full_kv = any(spec is not None and not spec.ring for spec in self.cache_specs(max_len))
        if full_kv and start + S > max_len:
            raise PositionRangeError(
                f"{cfg.name}: serving positions {start}..{start + S - 1} do not fit "
                f"max_len {max_len} (prefix + prompt + generated tokens); the JAX "
                "model drops such cache writes, the port refuses"
            )
        positions = self._positions(B, S, x.device, start)
        x = self._add_positions(params, x, positions, start, cfg.max_position or max_len)
        specs = [None if c is None else dataclasses.replace(c, start=start)
                 for c in self.cache_specs(max_len)]
        li = 0
        for s, seg in enumerate(self.segments):
            if isinstance(seg, PeriodicSegment):
                spec = {f"pos_{j}": specs[li + j] for j in range(seg.period)}
            else:
                spec = specs[li]
            cross_kvs = None
            if encoder_out is not None:
                cross_kvs = _segment_cross_kv(params[f"blocks_{s}"], encoder_out, cfg)
            x, _ = self._run_segment(
                params[f"blocks_{s}"], x, seg, positions=positions,
                caches=caches[s], cache_spec=spec, cross_kvs=cross_kvs,
                prefill_from_zero=S > 1 and start == 0,
            )
            li += seg.count
        x = apply_norm(params["final_norm"], x, cfg.norm, cfg.rms_eps)
        return tpl.gather_vocab(self._unembed(params, x[:, -1:, :]), cfg.padded_vocab), caches


@functools.lru_cache(maxsize=16)
def _sinusoidal_on(length: int, d_model: int, device, dtype) -> torch.Tensor:
    """``sinusoidal_table(length, d_model)`` on ``device`` in ``dtype``,
    built and copied once per key (every prefill and training step of an
    audio or sinusoidal model adds it)."""
    with torch.inference_mode(False):     # usable by later training steps too
        return torch.as_tensor(sinusoidal_table(length, d_model), device=device).to(dtype)


def _segment_cross_kv(params_seg, enc_out, cfg: ModelConfig):
    """Per-layer cross-attention K/V of one segment, as a list over its
    stacked layer dim."""
    cross = params_seg["cross"]
    return [
        encoder_kv(tree_map(lambda a: a[i], cross), enc_out, cfg)
        for i in range(cross["wk"]["w"].shape[0])
    ]


def _stacked_init(builder: ParamBuilder, seed: int, count: int, device):
    """Materialize ``count`` stacked layers, each from its own seed.

    Each stacked leaf is allocated once and layer i is drawn into it in
    place, leaf by leaf, so no more than one layer's copy of one leaf is
    ever held beside the stack (the same numbers as drawing every layer's
    tree and stacking them, at about half the peak memory). Under rules
    with a model axis each layer is drawn whole and its model rank's
    slice kept."""
    rules = current_rules()
    stacked: Dict[str, Any] = {}
    for path, decl in builder.decls.items():
        shape = local_shape(decl.axes, decl.shape, rules)
        leaf = torch.empty((count,) + shape, dtype=decl.dtype, device=device)
        for i in range(count if device.type != "meta" else 0):   # meta: nothing to draw
            gen = torch.Generator(device=device)
            gen.manual_seed(_fold_path(_fold_path(seed, str(i)), path))
            one = decl.init(gen, decl.shape, decl.dtype, device)
            if split_of(decl.axes, decl.shape, rules) is not None:
                one = local_slice(one, decl.axes, rules, rules.mesh.model_rank)
            leaf[i].copy_(one)
        _assign(stacked, path, leaf)
    return stacked["layer"]
