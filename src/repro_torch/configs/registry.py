"""Architecture registry: ``--arch <id>`` resolution.

Each architecture file exposes ``CONFIG`` (the exact assigned
configuration) and ``smoke_config()`` (a reduced same-family variant for
CPU tests: <=2 layers, d_model <= 512, <= 4 experts).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

ARCH_IDS = (
    "whisper_base",
    "nemotron_4_340b",
    "dbrx_132b",
    "kimi_k2_1t_a32b",
    "jamba_v0_1_52b",
    "gemma3_4b",
    "mamba2_370m",
    "internvl2_1b",
    "granite_20b",
    "internlm2_1_8b",
)
# Architectures the port alone has (the JAX package's registry is
# ``ARCH_IDS``, which the tests pin the port's to id for id).
PORT_ARCH_IDS = ("moonlight_16b_a3b",)

_ALIASES = {
    "whisper-base": "whisper_base",
    "nemotron-4-340b": "nemotron_4_340b",
    "dbrx-132b": "dbrx_132b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "gemma3-4b": "gemma3_4b",
    "mamba2-370m": "mamba2_370m",
    "internvl2-1b": "internvl2_1b",
    "granite-20b": "granite_20b",
    "internlm2-1.8b": "internlm2_1_8b",
    "moonlight-16b-a3b": "moonlight_16b_a3b",
}


def _module(arch_id: str):
    key = _ALIASES.get(arch_id, arch_id).replace("-", "_")
    if key not in ARCH_IDS + PORT_ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCH_IDS + PORT_ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
