"""Nested-dict parameter trees: the port's counterpart of ``jax.tree``.

A tree is a dict whose values are dicts or leaves (tensors, arrays,
shapes). Paths join keys with ``.`` (``blocks_0.mixer.wq.w``), the
spelling ``ParamBuilder`` declares parameters with. Iteration order is
insertion order, so leaves come back in declaration order.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Tuple


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        for other in rest:
            if not isinstance(other, dict) or other.keys() != tree.keys():
                raise ValueError("tree structures differ")
        return {
            k: tree_map(fn, v, *(other[k] for other in rest))
            for k, v in tree.items()
        }
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` leafwise, paths as :func:`tree_items` spells them."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}.{k}" if prefix else k)
                for k, v in tree.items()}
    return fn(prefix, tree)


def tree_items(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in declaration order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_items(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def flatten(tree: Any) -> Dict[str, Any]:
    """``{path: leaf}``, one entry per leaf."""
    return dict(tree_items(tree))
