"""Optimizers as functional transforms over nested dicts of tensors.

The port of ``repro.optim.optimizers``: SGD (the paper's optimizer),
AdamW, the LR schedules and ``make_optimizer``. The same
``(init, update)`` pattern as the JAX package:

    opt = sgd(lr=..., momentum=...)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

State and updates are fp32 whatever the parameter dtype, with an int32
``step``; ``apply_updates`` casts back to the parameter dtype. A
schedule is a function of the int32 step tensor that computes in fp32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple, Union

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


def clip_by_global_norm(grads: PyTree, max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> PyTree:
    """``grads`` scaled to a global norm of at most ``max_norm``; ``norm``,
    where given, is their global norm (a sharded gradient's, summed over
    the ranks that hold its pieces)."""
    if norm is None:
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


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw(
    learning_rate: Union[Callable[[torch.Tensor], Any], float],
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    """AdamW with fp32 moments ``mu`` / ``nu``, bias correction and
    decoupled weight decay, for the transformer workloads."""
    lr_fn = learning_rate if callable(learning_rate) else (lambda _: learning_rate)

    def init(params):
        leaf = tree_leaves(params)[0]
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device),
            "mu": tree_map(zeros, params),
            "nu": tree_map(zeros, params),
        }

    def update(grads, state, params):
        step = state["step"] + 1
        lr = lr_fn(step)
        g = tree_map(lambda x: x.float(), grads)
        mu = tree_map(lambda m, gi: b1 * m + (1 - b1) * gi, state["mu"], g)
        nu = tree_map(lambda n, gi: b2 * n + (1 - b2) * torch.square(gi), state["nu"], g)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()

        def upd(m, n, p):
            u = (m / bc1) / (torch.sqrt(n / bc2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return -lr * u

        updates = tree_map(upd, mu, nu, params)
        return updates, {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init=init, update=update)


# ---------------------------------------------------------------------------
# LR schedules: functions of the int32 step tensor, computed in fp32
# ---------------------------------------------------------------------------
def constant_schedule(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def step_decay_schedule(lr: float, boundaries, factor: float = 0.1):
    """The paper's CIFAR schedule: decay by 10x at epochs 100/150."""
    bounds = [int(b) for b in boundaries]

    def fn(step):
        bs = torch.tensor(bounds, dtype=step.dtype, device=step.device)
        k = torch.sum(step >= bs).float()
        return torch.tensor(lr, dtype=torch.float32, device=step.device) * factor ** k

    return fn


def cosine_schedule(lr: float, total_steps: int, warmup_steps: int = 0,
                    min_ratio: float = 0.1):
    def fn(step):
        step = step.float()
        warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.tensor(lr, dtype=torch.float32, device=step.device) * warm * cos

    return fn


def make_optimizer(train_cfg) -> Optimizer:
    """Build from a ``repro_torch.configs.base.TrainConfig``."""
    if train_cfg.lr_schedule == "constant":
        sched = constant_schedule(train_cfg.learning_rate)
    elif train_cfg.lr_schedule == "cosine":
        sched = cosine_schedule(
            train_cfg.learning_rate, train_cfg.steps, train_cfg.warmup_steps
        )
    elif train_cfg.lr_schedule == "step":
        sched = step_decay_schedule(
            train_cfg.learning_rate,
            [train_cfg.steps // 2, 3 * train_cfg.steps // 4],
        )
    else:
        raise ValueError(train_cfg.lr_schedule)
    if train_cfg.optimizer == "sgd":
        return sgd(sched, momentum=train_cfg.momentum,
                   weight_decay=train_cfg.weight_decay)
    if train_cfg.optimizer == "adamw":
        return adamw(sched, weight_decay=train_cfg.weight_decay)
    raise ValueError(train_cfg.optimizer)
