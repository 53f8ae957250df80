"""Carry parameter trees and serving caches between the JAX package and
the port.

Both packages key parameters identically (nested dicts, the same
paths and shapes), so conversion is a leaf-for-leaf copy through numpy.
The JAX side hands over its pytree as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``); nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map


def _to_tensor(a, device) -> torch.Tensor:
    # a private, writable copy: arrays handed over by JAX are read-only
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":
        # numpy's bfloat16 comes from an extension type torch cannot read;
        # carry the bits across as uint16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Any, device) -> Any:
    """Nested dicts of numpy arrays -> the same tree of tensors on
    ``device`` (dtypes kept)."""
    device = torch.device(device)
    return tree_map(lambda a: _to_tensor(a, device), tree)


def params_to_numpy(tree: Any) -> Any:
    """Tree of tensors -> nested dicts of numpy arrays on the host.
    bfloat16 leaves come back as float32 (an exact widening): numpy has
    no bfloat16 of its own."""

    def leaf(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return tree_map(leaf, tree)


def caches_from_numpy(caches, device) -> list:
    """Serving caches as the JAX ``Model.init_cache`` / ``serve_forward``
    hand them over (a list of per-segment dicts of numpy arrays: ``k``,
    ``v``, ``pos`` or ``ssm``, ``conv``; a periodic segment's nested as
    ``{pos_j: {...}}``) -> the port's caches on ``device``."""
    return [params_from_numpy(c, device) for c in caches]


def caches_to_numpy(caches) -> list:
    """The port's caches -> per-segment (possibly nested) dicts of numpy
    arrays (bfloat16 widened to float32, as in ``params_to_numpy``)."""
    return [params_to_numpy(c) for c in caches]
