"""mamba2-370m [ssm]: 48L d=1024, attention-free, ssm_state=128 v=50280.

SSD (state-space duality); d_inner=2048, head_dim=64 -> 32 heads.
[arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,                      # no FFN: the mamba block is the layer
    vocab_size=50280,
    ssm_state_dim=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    pos_embed="none",
    tie_embeddings=True,
    source="arXiv:2405.21060",
)


def smoke_config() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG,
        name="mamba2-smoke",
        num_layers=2,
        d_model=128,
        ssm_state_dim=32,
        ssm_head_dim=32,
        vocab_size=512,
    )
