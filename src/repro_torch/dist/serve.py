"""Serving runtime: prefill and decode step builders.

The port of ``repro.dist.serve`` for one device. The JAX builders close
over sharding rules and run ``Model.serve_forward`` under them; here a
step runs ``serve_forward`` under ``torch.inference_mode()`` on the
device its inputs lie on. The sharded pieces (``param_shardings``,
``abstract_caches``, ``cache_shardings``) wait for the multi-GPU port
(ROADMAP queue 1, item 15).

Caches are updated in place (see ``Model.serve_forward``): a step
returns the same cache tensors it was given.
"""
from __future__ import annotations

import torch


def make_prefill_step(model, *, max_len: int):
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
    (``launch/serve.py`` counts each kernel's launches)."""

    def step(params, tokens, caches, *, encoder_frames=None, prefix_embeddings=None):
        with torch.inference_mode():
            encoder_out = None
            if encoder_frames is not None:
                encoder_out = model._encode(params, encoder_frames, prefill=True)
            return model.serve_forward(
                params, tokens, caches, start_position=0, max_len=max_len,
                encoder_out=encoder_out, prefix_embeddings=prefix_embeddings,
            )

    return step


def make_decode_step(model, *, max_len: int):
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
        with torch.inference_mode():
            return model.serve_forward(
                params, tokens, caches, start_position=start_position,
                max_len=max_len,
            )

    return step
