"""internlm2-1.8b [dense]: 24L d=2048 16H GQA(kv=8) ff=8192 v=92544.

Plain GQA decoder baseline. [arXiv:2403.17297]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92544,
    ffn_activation="silu",
    gated_ffn=True,
    pos_embed="rope",
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    source="arXiv:2403.17297",
)


def smoke_config() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG,
        name="internlm2-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
    )
