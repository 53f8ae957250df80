"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H GQA(kv=8) ff=14336 v=65536.

Mamba + attention at 1:7 interleave (one attention layer per 8), MoE 16
experts top-2 on every other layer. [arXiv:2403.19887]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    ffn_activation="silu",
    gated_ffn=True,
    moe_num_experts=16,
    moe_top_k=2,
    moe_d_ff=14336,
    moe_every=2,
    attn_every=8,               # layer i is attention iff i % 8 == 4
    pos_embed="none",           # jamba: no positional encoding (mamba provides order)
    ssm_state_dim=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    tie_embeddings=False,
    source="arXiv:2403.19887",
)


def smoke_config() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG,
        name="jamba-smoke",
        num_layers=2,
        attn_every=2,            # layer 0 mamba, layer 1 attention
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        moe_num_experts=4,
        moe_top_k=2,
        moe_d_ff=256,
        ssm_state_dim=32,
        ssm_head_dim=32,
        vocab_size=512,
    )
