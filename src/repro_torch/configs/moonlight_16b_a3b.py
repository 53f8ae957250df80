"""moonlight-16b-a3b [moe]: 27L d=2048 16H MLA v=163840.

The DeepSeek-V3 block (arXiv:2412.19437) without multi-token prediction:
multi-head latent attention with no query LoRA (q 2048 -> 16 x 192, 128
dims a head unrotated and 64 rotated; kv 2048 -> a 512-dim latent under
an RMSNorm, plus one 64-dim rotated key head shared by the 16; the latent
-> 16 x (128 key + 128 value); softmax scale 1/sqrt(192)), the first
layer dense (SwiGLU 11264), then 26 MoE layers of 64 routed SwiGLU
experts of width 1408, 6 a token, sigmoid scores with the top-6 weights
normalized and scaled by 2.446, and 2 shared experts (one SwiGLU of
width 2816). RoPE theta 50000, RMSNorm eps 1e-5, an untied head.
[hf:moonshotai/Moonlight-16B-A3B config.json]

The port alone has this architecture (the JAX package does not): its
registry id is in ``registry.PORT_ARCH_IDS``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonlight-16b-a3b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,                # qk_nope_head_dim 128 + qk_rope_head_dim 64
    d_ff=11264,                  # the dense first layer's SwiGLU
    vocab_size=163840,
    ffn_activation="silu",
    gated_ffn=True,
    moe_num_experts=64,
    moe_router_experts=64,       # n_routed_experts: a share keeps the router whole
    moe_top_k=6,
    moe_d_ff=1408,
    moe_every=1,
    moe_first_dense=1,
    moe_shared_expert=True,
    moe_shared_d_ff=2816,        # n_shared_experts 2 x 1408, as one SwiGLU
    moe_router="sigmoid",
    moe_route_scale=2.446,
    mla_kv_rank=512,
    mla_rope_dim=64,
    mla_v_dim=128,
    pos_embed="rope",
    rope_theta=50_000.0,
    rms_eps=1e-5,
    tie_embeddings=False,
    source="hf:moonshotai/Moonlight-16B-A3B",
)


def smoke_config() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG,
        name="moonlight-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=48,
        d_ff=256,
        moe_num_experts=4,
        moe_router_experts=4,
        moe_top_k=2,
        moe_d_ff=64,
        moe_shared_d_ff=128,
        mla_kv_rank=32,
        mla_rope_dim=16,
        mla_v_dim=32,
        vocab_size=512,
    )
