"""internvl2-1b [vlm]: 24L d=896 14H GQA(kv=2) ff=4864 v=151655.

InternViT vision encoder + projector are STUBBED per the assignment:
``input_specs()`` feeds (B, 1024, 896) patch embeddings prepended to the
token stream. The language decoder here is the InternLM2-chat-1.8b-style
backbone at the assigned dims. [arXiv:2404.16821]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    ffn_activation="silu",
    gated_ffn=True,
    pos_embed="rope",
    rope_theta=1_000_000.0,
    frontend="vision",
    frontend_dim=896,
    encoder_seq=1024,            # stub patch count
    tie_embeddings=True,
    source="arXiv:2404.16821",
)


def smoke_config() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG,
        name="internvl2-smoke",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        encoder_seq=16,
        frontend_dim=128,
    )
