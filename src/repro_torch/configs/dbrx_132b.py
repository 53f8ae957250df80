"""dbrx-132b [moe]: 40L d=6144 48H GQA(kv=8) ff/expert=10752 v=100352.

Fine-grained MoE: 16 experts, top-4, gated SiLU. [hf:databricks/dbrx-base]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    ffn_activation="silu",
    gated_ffn=True,
    moe_num_experts=16,
    moe_top_k=4,
    moe_d_ff=10752,
    moe_every=1,
    pos_embed="rope",
    rope_theta=500_000.0,
    tie_embeddings=False,
    source="hf:databricks/dbrx-base",
)


def smoke_config() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG,
        name="dbrx-132b-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        moe_num_experts=4,
        moe_top_k=2,
        moe_d_ff=256,
        vocab_size=512,
    )
