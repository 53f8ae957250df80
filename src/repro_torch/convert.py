"""Carry parameter trees and serving caches between the JAX package and
the port.

Both packages key parameters identically (nested dicts, the same
paths and shapes), so conversion is a leaf-for-leaf copy through numpy.
The JAX side hands over its pytree as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``); nothing here imports JAX.

``shard_params`` / ``gather_params`` and ``shard_caches`` /
``gather_caches`` cut a whole tree into a model rank's tensor-parallel
slices under sharding rules (``repro_torch.dist.sharding``) and join the
ranks' slices back.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_items, tree_map


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


# ---------------------------------------------------------------------------
# Tensor-parallel slices (``repro_torch.dist.sharding`` rules)
# ---------------------------------------------------------------------------
def _walk(tree, axes, fn):
    if isinstance(tree, dict):
        return {k: _walk(v, axes[k], fn) for k, v in tree.items()}
    return fn(tree, axes)


def _dim(axes, shape, rules):
    """The dim of a whole leaf of ``shape`` (a node-stacked leaf has one
    more, leading) that ``rules`` split over the model axis, or None."""
    from repro_torch.models.module import split_of

    axes = (None,) * (len(shape) - len(axes)) + tuple(axes)
    return split_of(axes, tuple(shape), rules)


def _whole(part_shape, whole_shape):
    """The whole shape of a leaf: ``whole_shape`` behind the leading
    (node) dims of one rank's ``part_shape``."""
    lead = len(part_shape) - len(whole_shape)
    return tuple(part_shape[:lead]) + tuple(whole_shape)


def _slice(a, d: int, rank: int, tp: int):
    k = np.shape(a)[d] // tp
    return a[(slice(None),) * d + (slice(rank * k, (rank + 1) * k),)]


def _cat(parts, d: int):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=d)
    return np.concatenate(parts, axis=d)


def shard_params(tree_np: Any, model, rules, rank: int) -> Any:
    """Model rank ``rank``'s slices of a whole parameter tree (the JAX
    package's numpy parameters, or tensors): every leaf split along the
    dim ``rules`` give its logical axes, the others as they are. A
    node-stacked tree (a leading node dim) is sliced the same way."""
    def leaf(a, axes):
        d = _dim(axes, np.shape(a), rules)
        return a if d is None else _slice(a, d, rank, rules.tp)

    return _walk(tree_np, model.logical_axes(), leaf)


def gather_params(trees: Any, model, rules) -> Any:
    """The inverse of ``shard_params``: every model rank's tree (in rank
    order) joined back into the whole tree, numpy or tensors."""
    from repro_torch.dist.sharding import no_rules

    with no_rules():
        whole = model.param_shapes()

    def walk(ts, axes, shapes):
        if isinstance(ts[0], dict):
            return {k: walk([t[k] for t in ts], axes[k], shapes[k]) for k in ts[0]}
        d = _dim(axes, _whole(np.shape(ts[0]), shapes[0]), rules)
        return ts[0] if d is None else _cat(ts, d)

    return walk(list(trees), model.logical_axes(), whole)


def _conv_split(rules) -> bool:
    """Whether the rules split a Mamba conv state's x columns."""
    return rules is not None and rules.tp > 1 and rules.axis("ssm_inner") == "model"


def shard_caches(caches: list, model, rules, rank: int) -> list:
    """Model rank ``rank``'s slices of whole serving caches (the JAX
    layout: per-segment dicts, numpy or tensors): KV caches on their kv
    heads and Mamba states on their heads, where the rules split them;
    the conv state holds the rank's x columns, then every B and C
    column."""
    from repro_torch.dist.serve import cache_axes
    from repro_torch.models.ssm import ssm_dims

    def leaf(key, a):
        if key == "conv":
            if not _conv_split(rules):
                return a
            di = ssm_dims(model.cfg)["d_inner"]
            return _cat([_slice(a[..., :di], np.ndim(a) - 1, rank, rules.tp),
                         a[..., di:]], np.ndim(a) - 1)
        d = _dim(cache_axes(key, np.ndim(a)), np.shape(a), rules)
        return a if d is None else _slice(a, d, rank, rules.tp)

    def walk(c):
        return {k: walk(v) if isinstance(v, dict) else leaf(k, v) for k, v in c.items()}

    return [walk(c) for c in caches]


def gather_caches(ranks: list, model, rules) -> list:
    """The inverse of ``shard_caches``: every model rank's caches (in rank
    order) joined back into whole caches."""
    from repro_torch.dist.serve import abstract_caches, cache_axes
    from repro_torch.models.ssm import ssm_dims

    # the whole caches' shapes, at the parts' batch and longest KV cache
    # (no rule splits either)
    leaves = [(k.rsplit(".", 1)[-1], a) for c in ranks[0] for k, a in tree_items(c)]
    max_len = max([np.shape(a)[2] for k, a in leaves if k == "pos"], default=1)
    whole = abstract_caches(model, np.shape(leaves[0][1])[1], max_len)

    def join(key, parts, shape):
        last = np.ndim(parts[0]) - 1
        if key == "conv":
            if not _conv_split(rules):
                return parts[0]
            k = ssm_dims(model.cfg)["d_inner"] // rules.tp
            return _cat([p[..., :k] for p in parts] + [parts[0][..., k:]], last)
        d = _dim(cache_axes(key, last + 1), shape, rules)
        return parts[0] if d is None else _cat(parts, d)

    def walk(cs, shapes):
        return {k: walk([c[k] for c in cs], shapes[k]) if isinstance(cs[0][k], dict)
                else join(k, [c[k] for c in cs], shapes[k][0]) for k in cs[0]}

    return [walk([r[s] for r in ranks], whole[s]) for s in range(len(ranks[0]))]
