"""Minimal parameter substrate: declare once, materialize on a device.

The port of ``repro.models.module``. Models stay plain nested dicts of
tensors plus functions; ``ParamBuilder`` declares every parameter once
with its shape, dtype, initializer and logical sharding axes, and can

  * materialize the tree on a device from an integer seed, drawing each
    parameter from its own ``torch.Generator`` seeded from the seed and
    the parameter's path (so adding a parameter never shifts another's
    numbers), and
  * report the tree's shapes without allocating (``abstract``).

``torch.Generator`` cannot reproduce ``jax.random``: parity tests carry
the JAX package's initial weights across with ``repro_torch.convert``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

PyTree = Any
Axes = Tuple[Optional[str], ...]

_MASK63 = (1 << 63) - 1


def torch_dtype(name) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` (config spelling) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _fold_path(seed: int, path: str) -> int:
    """Deterministic per-parameter seed from a base seed and a path
    (the FNV-1a path hash of the JAX package, folded into the seed)."""
    h = 2166136261
    for ch in path.encode():
        h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
    return (int(seed) * 0x9E3779B97F4A7C15 + h) & _MASK63


@dataclasses.dataclass
class ParamDecl:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: Callable[[torch.Generator, Tuple[int, ...], torch.dtype, Any], torch.Tensor]
    axes: Axes


class ParamBuilder:
    """Declare parameters once; materialize them, or just their shapes.
    Each declaration keeps its logical sharding axes for the multi-GPU
    port (ROADMAP queue 1, item 15)."""

    def __init__(self, param_dtype=torch.float32):
        self.decls: Dict[str, ParamDecl] = {}
        self.param_dtype = torch_dtype(param_dtype)

    def declare(
        self,
        path: str,
        shape: Sequence[int],
        axes: Axes,
        init: Optional[Callable] = None,
        dtype: Any = None,
    ) -> None:
        if path in self.decls:
            raise ValueError(f"duplicate parameter {path!r}")
        shape = tuple(int(s) for s in shape)
        if len(axes) != len(shape):
            raise ValueError(f"{path}: axes {axes} rank != shape {shape} rank")
        self.decls[path] = ParamDecl(
            shape=shape,
            dtype=torch_dtype(dtype) if dtype is not None else self.param_dtype,
            init=init or lecun_normal,
            axes=tuple(axes),
        )

    def init(self, seed: int, device) -> PyTree:
        device = torch.device(device)
        out: Dict[str, Any] = {}
        for path, decl in self.decls.items():
            gen = torch.Generator(device=device)
            gen.manual_seed(_fold_path(seed, path))
            _assign(out, path, decl.init(gen, decl.shape, decl.dtype, device))
        return out

    def abstract(self) -> PyTree:
        """Shapes and dtypes as ``(shape, dtype)`` leaves, no allocation."""
        out: Dict[str, Any] = {}
        for path, decl in self.decls.items():
            _assign(out, path, (decl.shape, decl.dtype))
        return out


def _assign(tree: Dict[str, Any], path: str, value: Any) -> None:
    keys = path.split(".")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise ValueError(f"path {path} collides with leaf {k}")
    if keys[-1] in node:
        raise ValueError(f"path {path} already assigned")
    node[keys[-1]] = value


# ---------------------------------------------------------------------------
# Initializers: (generator, shape, dtype, device) -> tensor. Normal draws
# are taken in fp32 and cast, as the JAX initializers do.
# ---------------------------------------------------------------------------
def _normal(gen, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def lecun_normal(gen, shape, dtype, device):
    """std = 1/sqrt(fan_in), fan_in = prod(shape[:-1]) of the ONE layer
    being declared (stacked layers are initialized per layer, so the
    layer dim never enters the fan-in)."""
    fan_in = shape[0] if len(shape) >= 1 else 1
    if len(shape) >= 2:
        fan_in = int(np.prod(shape[:-1]))
    std = 1.0 / np.sqrt(max(fan_in, 1))
    return (_normal(gen, shape, device) * std).to(dtype)


def zeros_init(gen, shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def ones_init(gen, shape, dtype, device):
    return torch.ones(shape, dtype=dtype, device=device)


def embedding_init(gen, shape, dtype, device):
    return (_normal(gen, shape, device) * 0.02).to(dtype)
