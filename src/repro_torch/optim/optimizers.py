"""Optimizers as functional transforms over nested dicts of tensors.

The port of ``repro.optim.optimizers`` (SGD part). The same
``(init, update)`` pattern as the JAX package:

    opt = sgd(lr=..., momentum=...)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

State and updates are fp32 whatever the parameter dtype;
``apply_updates`` casts back to it. AdamW and the LR schedules are not
ported yet (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple, Union

import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], Tuple[PyTree, PyTree]]


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree: PyTree) -> torch.Tensor:
    sq = [torch.sum(torch.square(g.float())) for g in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads)


def sgd(
    learning_rate: Union[Callable[[torch.Tensor], Any], float],
    momentum: float = 0.0,
    weight_decay: float = 0.0,
    nesterov: bool = False,
) -> Optimizer:
    """SGD with optional momentum (fp32 velocity), nesterov and L2
    weight decay: the paper's optimizer."""
    lr_fn = learning_rate if callable(learning_rate) else (lambda _: learning_rate)

    def init(params):
        leaf = tree_leaves(params)[0]
        state = {"step": torch.zeros((), dtype=torch.int32, device=leaf.device)}
        if momentum:
            state["velocity"] = tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params
            )
        return state

    def update(grads, state, params):
        step = state["step"] + 1
        lr = lr_fn(step)
        g = tree_map(lambda x: x.float(), grads)
        if weight_decay:
            g = tree_map(lambda gi, p: gi + weight_decay * p.float(), g, params)
        if momentum:
            vel = tree_map(lambda v, gi: momentum * v + gi, state["velocity"], g)
            if nesterov:
                g = tree_map(lambda gi, v: gi + momentum * v, g, vel)
            else:
                g = vel
            new_state = {"step": step, "velocity": vel}
        else:
            new_state = {"step": step}
        updates = tree_map(lambda gi: -lr * gi, g)
        return updates, new_state

    return Optimizer(init=init, update=update)
