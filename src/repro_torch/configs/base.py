"""Model / run configuration dataclasses.

``ModelConfig`` is a hashable frozen dataclass (usable as a jit static
argument). One file per assigned architecture lives next to this module;
``repro_torch.configs.registry`` exposes them by id for ``--arch <id>``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # feed-forward
    ffn_activation: str = "silu"     # silu | gelu | relu2 (squared ReLU)
    gated_ffn: bool = True           # SwiGLU-style gate (False: plain MLP)

    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    moe_every: int = 1               # MoE FFN every N layers (others dense)
    moe_first_dense: int = 0         # first K layers use dense FFN (kimi: 1)
    moe_shared_expert: bool = False  # one always-on shared expert (kimi)
    moe_shared_d_ff: int = 0         # its width (0 -> moe_d_ff); moonlight: 2 x 1408
    moe_token_chunks: int = 1        # process tokens in N chunks (peak-memory knob)
    moe_router: str = "softmax"      # softmax (top-k renormalized) | sigmoid (deepseek-v3)
    moe_route_scale: float = 1.0     # gates x this (deepseek-v3's routed_scaling_factor)
    # the expert share: a layer holds moe_num_experts experts, from
    # moe_first_expert on, of a router over moe_router_experts (0: the
    # layer holds every expert the router picks from)
    moe_router_experts: int = 0
    moe_first_expert: int = 0

    # multi-head latent attention (deepseek-v3): 0 -> plain attention.
    # head_dim is the query / key width, mla_rope_dim of it rotated
    mla_kv_rank: int = 0             # kv_lora_rank: the latent's width
    mla_rope_dim: int = 0            # qk_rope_head_dim: one rotated key head for all
    mla_v_dim: int = 0               # v_head_dim

    # attention layout
    attn_every: int = 0              # hybrid: one attn layer per N (jamba: 8)
    local_global_ratio: int = 0      # gemma3: 5 local per 1 global
    sliding_window: int = 0          # window for "local" layers
    pos_embed: str = "rope"          # rope | learned | sinusoidal | none
    rope_theta: float = 10_000.0
    max_position: int = 0            # for learned/sinusoidal tables
    logit_softcap: float = 0.0
    qk_norm: bool = False

    # SSM (Mamba2 / SSD)
    ssm_state_dim: int = 0
    ssm_num_heads: int = 0
    ssm_head_dim: int = 0
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 128

    # encoder-decoder (whisper) / prefix frontends (vlm, audio)
    encoder_layers: int = 0
    encoder_seq: int = 0             # stub frontend sequence length
    frontend: str = ""               # "" | audio | vision
    frontend_dim: int = 0            # stub embedding dim (0 -> d_model)

    # norms / embeddings
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    rms_eps: float = 1e-6            # the norms' epsilon
    tie_embeddings: bool = True

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # layer stacking. scan_layers=True is safe for every runtime:
    # streamed FSDP gathers one layer row per scan iteration
    # (--stream-scan, on by default), so flipping this off is a
    # compile-strategy choice only, not a memory escape hatch.
    scan_layers: bool = True         # homogeneous stacks via lax.scan
    remat: bool = True

    # citation of the source model card / paper (assignment requirement)
    source: str = ""

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_kv_heads and self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be divisible by num_kv_heads")
        if self.moe_num_experts and self.moe_first_expert + self.moe_num_experts > \
                self.router_experts:
            raise ValueError(f"experts {self.moe_first_expert}.."
                             f"{self.moe_first_expert + self.moe_num_experts - 1} lie past "
                             f"the router's {self.router_experts}")

    @property
    def router_experts(self) -> int:
        """The router's width: the experts a token picks its top-k from."""
        return self.moe_router_experts or self.moe_num_experts

    @property
    def holds_share(self) -> bool:
        """Whether a MoE layer holds only some of the router's experts."""
        return self.moe_num_experts < self.router_experts

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to a multiple of 128 (TPU lane + TP divisibility).

        Embedding/unembedding tables use this; logits beyond the true
        vocab are masked to -inf in the unembed."""
        return ((self.vocab_size + 127) // 128) * 128

    # ---- derived layer layout ----------------------------------------------
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind: 'attn' | 'local' | 'global' | 'mamba'."""
        kinds = []
        for i in range(self.num_layers):
            if self.family == "ssm":
                kinds.append("mamba")
            elif self.attn_every:  # hybrid (jamba): 1 attn per attn_every
                kinds.append(
                    "attn" if i % self.attn_every == self.attn_every // 2 else "mamba"
                )
            elif self.local_global_ratio:
                r = self.local_global_ratio
                kinds.append("global" if i % (r + 1) == r else "local")
            else:
                kinds.append("attn")
        return tuple(kinds)

    def layer_is_moe(self, i: int) -> bool:
        if not self.moe_num_experts:
            return False
        if i < self.moe_first_dense:
            return False
        return (i - self.moe_first_dense) % self.moe_every == 0

    def uniform_layers(self) -> bool:
        """True when every layer is identical (scan-compatible stack)."""
        kinds = set(self.layer_kinds())
        moe_flags = {self.layer_is_moe(i) for i in range(self.num_layers)}
        return len(kinds) == 1 and len(moe_flags) == 1

    # ---- parameter counting (for roofline MODEL_FLOPS) ----------------------
    def param_counts(self) -> dict:
        """Analytic parameter counts: total and active-per-token."""
        d, hd = self.d_model, self.head_dim
        counts = {"embed": self.vocab_size * d}
        total = active = 0
        for i, kind in enumerate(self.layer_kinds()):
            layer = 0
            if kind in ("attn", "local", "global") and self.mla_kv_rank:
                r, h, v = self.mla_kv_rank, self.num_heads, self.mla_v_dim
                layer += (d * h * hd + d * (r + self.mla_rope_dim)
                          + r * h * (hd - self.mla_rope_dim + v) + h * v * d)
            elif kind in ("attn", "local", "global"):
                q = d * self.num_heads * hd
                kv = 2 * d * self.num_kv_heads * hd
                o = self.num_heads * hd * d
                layer += q + kv + o
            elif kind == "mamba":
                d_in = self.ssm_expand * d
                nh = self.ssm_num_heads or max(1, d_in // max(self.ssm_head_dim, 1))
                layer += d * (2 * d_in + 2 * self.ssm_state_dim + nh)  # in_proj-ish
                layer += d_in * d                                      # out proj
            if self.layer_is_moe(i):
                e_ff = self.moe_d_ff or self.d_ff
                mult = 3 if self.gated_ffn else 2
                per_expert = mult * d * e_ff
                layer_moe = self.moe_num_experts * per_expert + d * self.router_experts
                # a share's experts take their expected part of the top-k pairs
                layer_active = (self.moe_top_k * per_expert * self.moe_num_experts
                                // self.router_experts)
                if self.moe_shared_expert:
                    shared = mult * d * (self.moe_shared_d_ff or e_ff)
                    layer_moe += shared
                    layer_active += shared
                total += layer + layer_moe
                active += layer + layer_active
            else:
                ffn = (3 if self.gated_ffn else 2) * d * self.d_ff
                total += layer + ffn
                active += layer + ffn
        enc = 0
        if self.encoder_layers:
            enc_layer = 4 * d * d + (3 if self.gated_ffn else 2) * d * self.d_ff
            # decoder cross-attention adds ~4 d^2 per decoder layer
            enc = self.encoder_layers * enc_layer + self.num_layers * 4 * d * d
        total += counts["embed"] + enc
        active += counts["embed"] + enc
        if not self.tie_embeddings:
            total += self.vocab_size * d
            active += self.vocab_size * d
        return {"total": int(total), "active": int(active)}


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned workload shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

INPUT_SHAPES = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


@dataclasses.dataclass(frozen=True)
class MatchaConfig:
    """MATCHA run parameters (the paper's inputs: topology + CB)."""

    graph: str = "paper8"            # named_graph key
    num_nodes: int = 8
    comm_budget: float = 0.5
    mode: str = "matcha"             # matcha | vanilla | periodic
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_per_node: int = 8
    seq_len: int = 512
    steps: int = 200
    learning_rate: float = 0.05
    momentum: float = 0.9
    weight_decay: float = 0.0
    optimizer: str = "sgd"           # sgd | adamw (paper uses SGD+momentum)
    lr_schedule: str = "constant"    # constant | cosine | step
    warmup_steps: int = 0
    seed: int = 0
    grad_clip: float = 0.0
    # execution strategy of the sharded-replica (FSDP) runtime: stream
    # per layer group, and per scan iteration inside scanned stacks
    # (launch/train.py --stream-layers / --stream-scan)
    stream_layers: bool = True
    stream_scan: bool = True


def long_context_variant(cfg: "ModelConfig"):
    """long_500k policy (DESIGN.md SSShape/arch skips): native for
    SSM/hybrid archs (recurrent state) and local:global archs; a
    documented sliding-window variant (all layers local, window 4096,
    ring caches) for pure full-attention archs."""
    import dataclasses as _dc

    if cfg.family in ("ssm", "hybrid"):
        return cfg, "native"
    if cfg.local_global_ratio:
        return cfg, "native-local-global"
    return (
        _dc.replace(cfg, local_global_ratio=cfg.num_layers + 1,
                    sliding_window=4096),
        "windowed-variant",
    )
