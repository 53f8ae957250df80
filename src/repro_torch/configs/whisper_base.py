"""whisper-base [audio]: enc-dec transformer backbone. [arXiv:2212.04356]

6L decoder (and 6L encoder) d_model=512 8H (kv=8) d_ff=2048 vocab=51865.
The mel-spectrogram + conv frontend is STUBBED per the assignment:
``input_specs()`` feeds (B, 1500, 512) precomputed frame embeddings.
Decoder uses learned positions + cross-attention; FFN is plain GELU.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    ffn_activation="gelu",
    gated_ffn=False,
    pos_embed="learned",
    max_position=448,
    encoder_layers=6,
    encoder_seq=1500,
    frontend="audio",
    frontend_dim=512,
    norm="layernorm",
    tie_embeddings=True,
    source="arXiv:2212.04356",
)


def smoke_config() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG,
        name="whisper-base-smoke",
        num_layers=2,
        encoder_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        encoder_seq=24,
        frontend_dim=128,
        max_position=128,
    )
