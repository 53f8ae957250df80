"""Minimal parameter substrate: declare once, materialize on a device.

The port of ``repro.models.module``. Models stay plain nested dicts of
tensors plus functions; ``ParamBuilder`` declares every parameter once
with its shape, dtype, initializer and logical sharding axes, and can

  * materialize the tree on a device from an integer seed, drawing each
    parameter from its own ``torch.Generator`` seeded from the seed and
    the parameter's path (so adding a parameter never shifts another's
    numbers), and
  * report the tree's shapes without allocating (``abstract``), and
  * report each parameter's logical axes (``logical_axes``).

Under sharding rules with a ``model`` axis (``repro_torch.dist.sharding``)
``init`` and ``abstract`` give this rank's slice: each parameter is
drawn whole from its own generator and sliced along the dim its axes
split, so every model rank holds a slice of the one-device tree.

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


def split_of(axes: Axes, shape: Sequence[int], rules) -> Optional[int]:
    """The dim of a leaf of ``shape`` and logical ``axes`` that ``rules``
    split over the ``model`` axis, or None (no rules, a model axis of 1,
    or a replicated leaf)."""
    from repro_torch.dist.sharding import logical_to_pspec, model_dim

    if rules is None or rules.tp == 1:
        return None
    return model_dim(logical_to_pspec(axes, rules, shape))


def local_shape(axes: Axes, shape: Sequence[int], rules) -> Tuple[int, ...]:
    """``shape`` with its split dim divided by the model axis."""
    shape = tuple(shape)
    d = split_of(axes, shape, rules)
    if d is None:
        return shape
    return shape[:d] + (shape[d] // rules.tp,) + shape[d + 1:]


def local_slice(t: torch.Tensor, axes: Axes, rules, rank: int) -> torch.Tensor:
    """Model rank ``rank``'s slice of a whole leaf (``t`` itself when the
    leaf is replicated)."""
    d = split_of(axes, tuple(t.shape), rules)
    if d is None:
        return t
    k = t.shape[d] // rules.tp
    return t.narrow(d, rank * k, k)


def _current_rules():
    from repro_torch.dist.sharding import current_rules

    return current_rules()


class ParamBuilder:
    """Declare parameters once; materialize them, or just their shapes,
    whole or as this model rank's slice."""

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
        """The tree on ``device`` from ``seed`` (this model rank's slices
        under the current rules); on the meta device (the dry run) empty
        tensors of the same shapes and dtypes, drawn from nothing."""
        device = torch.device(device)
        rules = _current_rules()
        out: Dict[str, Any] = {}
        for path, decl in self.decls.items():
            if device.type == "meta":
                _assign(out, path, torch.empty(local_shape(decl.axes, decl.shape, rules),
                                               dtype=decl.dtype, device=device))
                continue
            gen = torch.Generator(device=device)
            gen.manual_seed(_fold_path(seed, path))
            leaf = decl.init(gen, decl.shape, decl.dtype, device)
            if split_of(decl.axes, decl.shape, rules) is not None:
                leaf = local_slice(leaf, decl.axes, rules, rules.mesh.model_rank).clone()
            _assign(out, path, leaf)
        return out

    def abstract(self) -> PyTree:
        """Shapes and dtypes as ``(shape, dtype)`` leaves, no allocation
        (this model rank's shapes under the current rules)."""
        rules = _current_rules()
        out: Dict[str, Any] = {}
        for path, decl in self.decls.items():
            _assign(out, path, (local_shape(decl.axes, decl.shape, rules), decl.dtype))
        return out

    def logical_axes(self) -> PyTree:
        """The tree of each parameter's logical axes."""
        out: Dict[str, Any] = {}
        for path, decl in self.decls.items():
            _assign(out, path, decl.axes)
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
