"""granite-20b [dense]: 52L d=6144 48H MQA(kv=1) ff=24576 v=49152.

Llama-style code model with multi-query attention. [arXiv:2405.04324]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    ffn_activation="gelu",
    gated_ffn=False,
    pos_embed="learned",         # granite-20b-code uses absolute positions
    max_position=8192,
    norm="layernorm",
    tie_embeddings=True,
    source="arXiv:2405.04324",
)


def smoke_config() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG,
        name="granite-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        max_position=128,
    )
