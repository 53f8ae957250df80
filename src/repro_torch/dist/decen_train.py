"""Decentralized training runtime: node-stacked state + the train step.

The port of ``repro.dist.decen_train`` for one device. Every node owns a
full model replica, so all training state carries a leading node dim,
the JAX package's own layout. One step keeps the reference's order:

    local SGD    every node: fwd/bwd on its own batch, then an SGD update
    gossip       on the post-update params (``repro_torch.dist.gossip``)

Gossip modes (paper Section 3.3):
    "masked"  every matching exchanged, deltas scaled by the schedule
              bits (the main path)
    "static"  only the activated subset is exchanged
    "none"    local SGD only (the no-communication baseline)

The JAX package's "overlap" mode and its fault-injected (``faulted``)
steps are not ported yet (ROADMAP queue 1, items 11 and 10).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist.gossip import mix_matchings, mix_matchings_masked
from repro_torch.optim.optimizers import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


def _stack(tree: PyTree, num_nodes: int) -> PyTree:
    """``num_nodes`` independent copies along a new leading node dim."""
    return tree_map(
        lambda a: a.unsqueeze(0).repeat((num_nodes,) + (1,) * a.dim()), tree
    )


def init_stacked_params(model, num_nodes: int, seed: int = 0, *, device="cuda") -> PyTree:
    """All nodes start from the same replica (standard DecenSGD init);
    divergence comes from per-node data."""
    return _stack(model.init(seed, device=device), num_nodes)


def init_stacked_opt_state(
    opt: Optimizer, model, num_nodes: int, *, device="cuda"
) -> PyTree:
    """Zero-initialized optimizer state per node: every slot gains the
    leading ``(num_nodes,)`` dim (fp32 velocity, int32 step)."""
    device = resolve_device(device)
    zeros_local = tree_map(
        lambda sd: torch.zeros(sd[0], dtype=sd[1], device=device),
        model.param_shapes(),
    )
    return _stack(opt.init(zeros_local), num_nodes)


def consensus_distance(stacked_params: PyTree) -> torch.Tensor:
    """RMS-over-nodes Frobenius distance to the node mean:
    sqrt(mean_i sum_leaves ||x_i - x_bar||^2). The quantity MATCHA's
    Theorem 1 bounds; 'local' (no-gossip) training makes it blow up."""
    acc = None
    for leaf in tree_leaves(stacked_params):
        if not leaf.is_floating_point():
            continue
        x = leaf.float()
        sq = (x - x.mean(dim=0, keepdim=True)).square_()
        d = sq.sum(dim=tuple(range(1, x.dim()))) if x.dim() > 1 else sq
        acc = d if acc is None else acc + d
    if acc is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(torch.mean(acc))


class PhaseTimes:
    """Time per phase of one step, summed over the phase's spans: CUDA
    events on the card (read back lazily; reading synchronizes), the
    host clock on the CPU."""

    def __init__(self, device):
        self._cuda = torch.device(device).type == "cuda"
        self._spans = []

    @contextlib.contextmanager
    def span(self, name: str):
        if self._cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
        else:
            start = time.perf_counter()
            yield
            end = time.perf_counter()
        self._spans.append((name, start, end))

    def ms(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, start, end in self._spans:
            if self._cuda:
                end.synchronize()
                dt = start.elapsed_time(end)
            else:
                dt = (end - start) * 1e3
            out[name] = out.get(name, 0.0) + dt
        return out


class TrainStep:
    """One decentralized step over node-stacked state:

        params, opt_state, losses, metrics = step(params, opt_state, batch, bits)

    ``params``/``opt_state`` are updated in place (and returned);
    ``batch`` leaves are (nodes, per_node_batch, ...); ``bits`` is the
    (M,) activation row of the a-priori schedule (ignored by "static"
    and "none"). ``losses`` and each metric come back per node, shape
    (nodes,). After a call, ``last_phases.ms()`` splits its time into
    fwd_bwd, optimizer and gossip.
    """

    def __init__(self, model, opt: Optimizer, plan, *, gossip_mode: str,
                 active: Sequence[int], grad_clip: float):
        self.model = model
        self.opt = opt
        self.gossip_mode = gossip_mode
        self.perms = np.asarray(plan.permutations)
        self.alpha = float(plan.alpha)
        self.active = tuple(int(j) for j in active)
        self.grad_clip = grad_clip
        self.last_phases = None

    def _local_sgd(self, params, opt_state, batch, i: int, phases: PhaseTimes):
        """Node i's fwd/bwd and SGD update, written into its slices.
        Only this node's grads are alive at a time."""
        with phases.span("fwd_bwd"):
            p_i = tree_map(lambda a: a[i].detach().requires_grad_(), params)
            b_i = {k: v[i] for k, v in batch.items()}
            loss, metrics = self.model.loss(p_i, b_i)
            grads = iter(torch.autograd.grad(loss, tree_leaves(p_i)))
            g_i = tree_map(lambda _: next(grads), p_i)
            if self.grad_clip:
                g_i = clip_by_global_norm(g_i, self.grad_clip)
        with phases.span("optimizer"), torch.no_grad():
            p_view = tree_map(lambda a: a[i], params)
            s_view = tree_map(lambda a: a[i], opt_state)
            updates, s_new = self.opt.update(g_i, s_view, p_view)
            tree_map(lambda dst, src: dst.copy_(src), p_view,
                     apply_updates(p_view, updates))
            tree_map(lambda dst, src: dst.copy_(src), s_view, s_new)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def __call__(self, params, opt_state, batch, bits):
        device = tree_leaves(params)[0].device
        phases = PhaseTimes(device)
        per_node = [
            self._local_sgd(params, opt_state, batch, i, phases)
            for i in range(self.perms.shape[1])
        ]
        with phases.span("gossip"), torch.no_grad():
            # in place: each leaf's fp32 target is complete before its
            # update overwrites the leaf, and nothing reads it afterwards
            if self.gossip_mode == "masked":
                mix_matchings_masked(params, self.alpha, self.perms, bits, inplace=True)
            elif self.gossip_mode == "static":
                mix_matchings(params, self.alpha, self.perms, self.active, inplace=True)
        self.last_phases = phases
        losses = torch.stack([loss for loss, _ in per_node])
        metrics = {
            k: torch.stack([m[k] for _, m in per_node]) for k in per_node[0][1]
        }
        return params, opt_state, losses, metrics


def make_train_step(
    model,
    opt: Optimizer,
    plan,                                 # repro_torch.core.MatchaPlan
    *,
    gossip_mode: str = "masked",
    active: Sequence[int] = (),
    grad_clip: float = 0.0,
) -> TrainStep:
    """Build the decentralized step (see :class:`TrainStep`)."""
    if gossip_mode == "sequential":   # the JAX package's other spelling
        gossip_mode = "masked"
    if gossip_mode == "overlap":
        raise NotImplementedError(
            "gossip_mode 'overlap' is not ported yet (ROADMAP queue 1, item 11)"
        )
    if gossip_mode not in ("masked", "static", "none"):
        raise ValueError(f"unknown gossip_mode {gossip_mode!r}")
    return TrainStep(model, opt, plan, gossip_mode=gossip_mode,
                     active=active, grad_clip=grad_clip)
