"""nemotron-4-340b [dense]: 96L d=18432 96H GQA(kv=8) ff=73728 v=256000.

Squared-ReLU MLP (no gating), GQA, RoPE. [arXiv:2402.16819]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    ffn_activation="relu2",
    gated_ffn=False,
    pos_embed="rope",
    norm="layernorm",
    tie_embeddings=False,
    source="arXiv:2402.16819",
)


def smoke_config() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG,
        name="nemotron-4-340b-smoke",
        num_layers=2,
        d_model=256,
        num_heads=8,
        num_kv_heads=2,
        head_dim=32,
        d_ff=512,
        vocab_size=512,
    )
