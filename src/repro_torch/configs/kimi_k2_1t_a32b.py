"""kimi-k2-1t-a32b [moe]: 61L d=7168 64H GQA(kv=8) v=163840.

Trillion-parameter MoE: 384 experts, top-8, per-expert ff=2048, one
shared expert, first layer dense. [arXiv:2501.kimi2 (paper-table)]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    d_ff=18432,                  # dense first-layer FFN width
    vocab_size=163840,
    ffn_activation="silu",
    gated_ffn=True,
    moe_num_experts=384,
    moe_top_k=8,
    moe_d_ff=2048,
    moe_every=1,
    moe_first_dense=1,
    moe_shared_expert=True,
    pos_embed="rope",
    rope_theta=50_000.0,
    tie_embeddings=False,
    source="arXiv:2501.kimi2",
)


def smoke_config() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG,
        name="kimi-k2-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        moe_num_experts=4,
        moe_top_k=2,
        moe_d_ff=128,
        moe_first_dense=1,
        vocab_size=512,
    )
