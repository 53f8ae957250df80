"""Expected launches of each hand-written kernel, from the config alone.

What a call of the port must launch on the card, per wrapper
(``flash_attention`` and its backward's ``flash_attention_dq`` /
``flash_attention_dkdv``, ``ssm_scan``, ``grouped_matmul`` and its
``grouped_matmul_dx`` / ``grouped_matmul_dw``, ``gossip_axpy``), so a run
can be held to it exactly (``chip_smoke.py``, the dry run's meta
launches in ``tests/test_torch_dryrun.py``). The rules, as the model
code takes them:

* a serving prefill from position 0 of more than one token runs flash
  attention once per attention layer (hybrid stacks: their attention
  layers only), and with encoder frames once more per encoder layer and
  per cross-attention; a config with a logit softcap keeps the plain
  attention. Each Mamba layer runs the SSD chunk scan once;
* a MoE layer of more than 8 experts (the ragged branch) runs 3 grouped
  products (w1, w3, w2) per token chunk (``cfg.moe_token_chunks`` when
  it divides the sequence, else one), in the prefill and in every decode
  step; in training 3 forward, 3 more under ``cfg.remat`` (the layer runs
  again in the backward), 3 dx and 3 dw per node;
* in training, each self-attention call the routing rule sends to the
  flash kernel (``models.attention.flash_route``: a bf16 config with no
  softcap at a pair of head widths the backward takes, latent
  attention's (192, 128) among them, layers without a window, whisper's
  encoder layers too, never cross-attention) runs the flash
  forward once per node, once more under ``cfg.remat`` (the layer runs
  again in the backward), and the backward's dq and dk / dv passes once
  each. Training runs no SSD kernel (it has no backward);
* a training step launches the gossip axpy once per float parameter leaf
  (masked, overlap, and static with a matching active), and the
  end-of-run flush once per leaf again;
* a sharded (FSDP) step launches the gossip axpy once per bucket shard of
  its layout (sequential and overlap), and the overlap flush once per
  bucket shard again.
"""
from __future__ import annotations

from typing import Dict

KERNELS = ("flash_attention", "flash_attention_dq", "flash_attention_dkdv", "ssm_scan",
           "grouped_matmul", "grouped_matmul_dx", "grouped_matmul_dw", "gossip_axpy")


def _zero() -> Dict[str, int]:
    return dict.fromkeys(KERNELS, 0)


def _add(*counts: Dict[str, int]) -> Dict[str, int]:
    out = _zero()
    for c in counts:
        for k, v in c.items():
            out[k] += v
    return out


def scale(counts: Dict[str, int], n: int) -> Dict[str, int]:
    return {k: v * n for k, v in counts.items()}


def attention_layers(cfg) -> int:
    return sum(kind != "mamba" for kind in cfg.layer_kinds())


def mamba_layers(cfg) -> int:
    return sum(kind == "mamba" for kind in cfg.layer_kinds())


def flash_training_calls(cfg) -> int:
    """Attention calls of one training forward that take the flash kernel
    and its backward (``models.attention.flash_route``)."""
    from repro_torch.kernels.flash_attention_bwd import BACKWARD_HEAD_DIMS

    v_dim = cfg.mla_v_dim if cfg.mla_kv_rank else cfg.head_dim   # latent attention's v
    if (cfg.logit_softcap or cfg.compute_dtype != "bfloat16" or not cfg.num_heads
            or (cfg.head_dim, v_dim) not in BACKWARD_HEAD_DIMS):
        return 0
    layers = sum(kind == "attn" or kind == "global" or (kind == "local" and
                                                         not cfg.sliding_window)
                 for kind in cfg.layer_kinds())
    return layers + cfg.encoder_layers


def ragged_moe_layers(cfg) -> int:
    """MoE layers that take the grouped-matmul kernel (a router over more
    than 8 experts)."""
    if cfg.router_experts <= 8:
        return 0
    return sum(map(cfg.layer_is_moe, range(cfg.num_layers)))


def token_chunks(cfg, seq: int) -> int:
    n = max(1, cfg.moe_token_chunks)
    return n if seq % n == 0 else 1


def prefill(cfg, *, seq: int, encoder: bool = False) -> Dict[str, int]:
    """One prefill of ``seq`` tokens from position 0 (``encoder``: with
    encoder frames, so the encoder and every cross-attention run too)."""
    out = _zero()
    if seq > 1 and not cfg.logit_softcap:
        out["flash_attention"] = attention_layers(cfg)
        if encoder:
            out["flash_attention"] += cfg.encoder_layers + cfg.num_layers
    out["ssm_scan"] = mamba_layers(cfg)
    out["grouped_matmul"] = 3 * ragged_moe_layers(cfg) * token_chunks(cfg, seq)
    return out


def decode(cfg) -> Dict[str, int]:
    """One decode step (one token)."""
    out = _zero()
    out["grouped_matmul"] = 3 * ragged_moe_layers(cfg)
    return out


def serve_run(cfg, *, prompt_len: int, gen: int, encoder: bool = False) -> Dict[str, int]:
    """``launch/serve.py::run``: a prefill and ``gen - 1`` decode steps."""
    return _add(prefill(cfg, seq=prompt_len, encoder=encoder),
                scale(decode(cfg), max(gen - 1, 0)))


def forward_backward(cfg, *, seq: int, passes: int = 1) -> Dict[str, int]:
    """``passes`` losses and gradients of one replica over sequences of
    ``seq`` tokens."""
    moe = ragged_moe_layers(cfg) * token_chunks(cfg, seq) * passes
    flash = flash_training_calls(cfg) * passes
    out = _zero()
    out["flash_attention"] = flash * (1 + bool(cfg.remat))
    out["flash_attention_dq"] = flash
    out["flash_attention_dkdv"] = flash
    out["grouped_matmul"] = 3 * moe * (1 + bool(cfg.remat))
    out["grouped_matmul_dx"] = 3 * moe
    out["grouped_matmul_dw"] = 3 * moe
    return out


def moe_block(cfg, *, seq: int) -> Dict[str, int]:
    """One MoE block's forward and backward alone (no remat)."""
    n = 3 * token_chunks(cfg, seq) * (cfg.router_experts > 8)
    return dict(_zero(), grouped_matmul=n, grouped_matmul_dx=n, grouped_matmul_dw=n)


def float_leaves(cfg) -> int:
    """Float parameter leaves of one replica: one gossip launch each."""
    from repro_torch.models.transformer import Model
    from repro_torch.tree import tree_leaves

    return sum(dt.is_floating_point for _, dt in tree_leaves(Model(cfg).param_shapes()))


def train_step(cfg, *, nodes: int, seq: int, gossip_mode: str = "masked",
               active: int = 1, steps: int = 1) -> Dict[str, int]:
    """``steps`` decentralized steps over ``nodes`` nodes (``active``:
    the static step's active matchings)."""
    gossips = gossip_mode in ("masked", "overlap") or (gossip_mode == "static" and active)
    out = scale(forward_backward(cfg, seq=seq), nodes * steps)
    out["gossip_axpy"] = float_leaves(cfg) * steps * bool(gossips)
    return out


def fsdp_train_step(num_buckets: int, *, gossip_mode: str = "sequential", steps: int = 1,
                    flush: bool = False) -> Dict[str, int]:
    """The gossip-axpy launches of ``steps`` sharded steps over a layout
    of ``num_buckets`` buckets (``flush``: and the overlap flush)."""
    out = _zero()
    gossips = gossip_mode in ("sequential", "masked", "overlap")
    out["gossip_axpy"] = num_buckets * (steps * gossips + bool(flush))
    return out
