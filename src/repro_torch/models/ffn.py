"""Feed-forward blocks: dense (gated / plain).

The port of the dense half of ``repro.models.ffn``. Mixture-of-Experts
(router, einsum and ragged paths) is not ported yet: ROADMAP queue 1,
item 12.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import activation_fn, apply_dense, declare_dense
from repro_torch.models.module import ParamBuilder, torch_dtype


def declare_ffn(
    b: ParamBuilder, path: str, d_model: int, d_ff: int, gated: bool
) -> None:
    declare_dense(b, f"{path}.w1", d_model, d_ff, (None, "ffn"))
    if gated:
        declare_dense(b, f"{path}.w3", d_model, d_ff, (None, "ffn"))
    declare_dense(b, f"{path}.w2", d_ff, d_model, ("ffn", None))


def ffn_block(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dtype = torch_dtype(cfg.compute_dtype)
    act = activation_fn(cfg.ffn_activation)
    h = act(apply_dense(p["w1"], x, dtype))
    if "w3" in p:
        h = h * apply_dense(p["w3"], x, dtype)
    return apply_dense(p["w2"], h, dtype)
