"""gemma3-4b [dense]: 34L d=2560 8H GQA(kv=4) ff=10240 v=262144.

5:1 local(sliding-window):global attention, 128k context, qk-norm.
[hf:google/gemma-3-1b-pt]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262144,
    ffn_activation="gelu",
    gated_ffn=True,
    local_global_ratio=5,        # 5 local : 1 global
    sliding_window=1024,
    pos_embed="rope",
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)


def smoke_config() -> ModelConfig:
    import dataclasses

    return dataclasses.replace(
        CONFIG,
        name="gemma3-smoke",
        num_layers=2,            # 1 local + ... pattern gives local,local; keep window tiny
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        sliding_window=16,
        local_global_ratio=1,    # alternate local/global in the smoke variant
        vocab_size=512,
    )
