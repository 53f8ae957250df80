"""Serving runtime: prefill and decode step builders, and the shardings
of parameters and caches.

The port of ``repro.dist.serve``. The JAX builders close over sharding
rules and run ``Model.serve_forward`` under them; here a step runs
``serve_forward`` under ``use_rules(rules)`` and
``torch.inference_mode()`` on the device its inputs lie on. With rules
over a ``model`` axis each rank runs its tensor-parallel slice of the
model (``repro_torch.models.tp``) on its slices of the parameters and
caches and returns the last position's whole logits; without rules,
one device serves the whole model.

``param_shardings``, ``abstract_caches`` and ``cache_shardings`` give
the per-leaf specs (the port's PartitionSpec: a tuple of mesh-axis names
or ``None``) and the shapes, as the JAX functions do. One leaf is held
otherwise than its spec says: a Mamba conv state, replicated in the
spec, holds on each model rank the rank's x columns and the B and C
columns (``repro_torch.convert.shard_caches``), since the rank's conv
runs over those.

Caches are updated in place (see ``Model.serve_forward``): a step
returns the same cache tensors it was given.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.dist import sharding as shd
from repro_torch.tree import tree_map

PyTree = Any


def make_prefill_step(model, rules: Optional[shd.ShardingRules] = None, *, max_len: int):
    """Prefill step builder.

    The returned function maps ``(params, tokens, caches)``, tokens int
    ``(B, S)`` and caches from ``model.init_cache(B, max_len)``, to
    ``(logits, caches)``: logits ``(B, 1, vocab)`` of the last prompt
    position, and every layer's KV or SSM cache filled for positions
    ``[0, S)``. Optional ``encoder_frames`` (audio frontends, bf16
    ``(B, encoder_seq, frontend_dim)``) are encoded first and attended
    by every decoder layer's cross-attention; ``prefix_embeddings``
    (vision prefix, ``(B, P, frontend_dim)``) sit in front of the
    tokens, which then fill positions ``[0, P + S)``. A prefill from
    position 0 runs the flash-attention kernel (self-, encoder and
    cross-attention) and the SSD chunk-scan kernel on the card, and MoE
    layers of more than 8 experts the grouped-matmul kernel
    (``launch/serve.py`` counts each kernel's launches). ``rules``: the
    serving mesh's (``sharding.serve_rules``), under which ``params``
    and ``caches`` are this model rank's slices."""

    def step(params, tokens, caches, *, encoder_frames=None, prefix_embeddings=None):
        with shd.use_rules(rules), torch.inference_mode():
            encoder_out = None
            if encoder_frames is not None:
                encoder_out = model._encode(params, encoder_frames, prefill=True)
            return model.serve_forward(
                params, tokens, caches, start_position=0, max_len=max_len,
                encoder_out=encoder_out, prefix_embeddings=prefix_embeddings,
            )

    return step


def make_decode_step(model, rules: Optional[shd.ShardingRules] = None, *, max_len: int):
    """Single-token decode step builder.

    The returned function maps ``(params, tokens, caches,
    start_position)``, tokens ``(B, 1)`` and ``start_position`` the
    absolute position the token occupies, to ``(logits (B, 1, vocab),
    caches)`` with the caches advanced by one position. MoE layers of
    more than 8 experts run the grouped-matmul kernel here too. As in
    the JAX runtime, it passes no encoder output: an encoder-decoder
    model's decode steps skip cross-attention (the caches hold no
    cross K/V)."""

    def step(params, tokens, caches, start_position):
        with shd.use_rules(rules), torch.inference_mode():
            return model.serve_forward(
                params, tokens, caches, start_position=start_position,
                max_len=max_len,
            )

    return step


# ---------------------------------------------------------------------------
# Abstract state + shardings
# ---------------------------------------------------------------------------
def param_shardings(model, rules: shd.ShardingRules) -> PyTree:
    """Per-parameter spec tuples for a (non-stacked) serving replica."""
    return shd.param_pspecs(model.logical_axes(), rules)


def abstract_caches(model, batch: int, max_len: int) -> PyTree:
    """The ``(shape, dtype)`` tree of the whole ``model.init_cache(batch,
    max_len)``, allocating nothing (meta tensors)."""
    with shd.no_rules():
        caches = model.init_cache(batch, max_len, device="meta")
    return [tree_map(lambda a: (tuple(a.shape), a.dtype), c) for c in caches]


# logical axes per cache leaf, keyed by the leaf's dict key. All caches
# are stacked per segment, so dim 0 is always the layer dim.
_CACHE_AXES = {
    "k": ("layers", "batch", "kv_seq", "kv_heads", None),
    "v": ("layers", "batch", "kv_seq", "kv_heads", None),
    "pos": ("layers", "batch", None),
    "ssm": ("layers", "batch", "ssm_heads", None, None),
    "conv": ("layers", "batch", None, None),
}


def cache_axes(key: str, ndim: int):
    """The logical axes of a cache leaf named ``key`` of ``ndim`` dims."""
    axes = _CACHE_AXES.get(key)
    if axes is None or len(axes) != ndim:
        axes = ("layers",) + (None,) * (ndim - 1)
    return axes


def cache_shardings(model, rules: shd.ShardingRules,
                    caches_abs: Optional[PyTree] = None) -> PyTree:
    """A spec tuple per cache leaf (the caches' tree structure): KV caches
    over batch (and kv heads where the rules map them), Mamba states over
    batch (and SSM heads)."""
    if caches_abs is None:
        caches_abs = abstract_caches(model, 1, 2)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict)
                else shd.logical_to_pspec(cache_axes(k, len(v[0])), rules, v[0])
                for k, v in tree.items()}

    return [walk(c) for c in caches_abs]
