"""Faults planted under the timed path, to show that ``correct`` catches
them. Only the tests and ``perfbench/calibrate.py`` plant one; a
benchmark run never does.

    frozen_state   the step returns the params and optimizer state it
                   was given (the losses are still computed)
    half_batch     the step sees half of every node's batch (half of the
                   rows, or half of the positions of a single row) and
                   takes the mean over that half
    no_exchange    the exchange is left out: no node receives its
                   partners' rows, each gets its own
    loss_altered   the loss the step returns for node 0 is 1% high
"""
from __future__ import annotations

import contextlib

import torch

PLANTS = ("frozen_state", "half_batch", "no_exchange", "loss_altered")


class _Wrapped:
    def __init__(self, step, fn):
        self._step, self._fn = step, fn

    def __getattr__(self, name):
        return getattr(self._step, name)

    def __call__(self, params, opt_state, batch, bits, *, step: int = -1):
        return self._fn(self._step, params, opt_state, batch, bits, step)


def _frozen(step, params, opt_state, batch, bits, k):
    from repro_torch.tree import tree_map

    model = step.model
    batch = step.spec.local(batch) if step.spec is not None else batch
    with torch.no_grad():
        losses = torch.stack([
            model.loss(tree_map(lambda a: a[i], params), {n: v[i] for n, v in batch.items()})[0]
            for i in range(step.num_local)])
    return params, opt_state, losses, {}


def _half(step, params, opt_state, batch, bits, k):
    rows = batch["tokens"].shape[-2]
    if rows > 1:
        half = {n: v[..., : rows // 2, :] for n, v in batch.items()}
    else:
        seq = batch["tokens"].shape[-1]
        half = {n: v[..., : seq // 2] for n, v in batch.items()}
    return step(params, opt_state, half, bits, step=k)


def _altered(step, params, opt_state, batch, bits, k):
    params, opt_state, losses, metrics = step(params, opt_state, batch, bits, step=k)
    losses = losses.clone()
    losses[0] *= 1.01
    return params, opt_state, losses, metrics


@contextlib.contextmanager
def planted(name, step):
    """``step`` with the fault ``name`` planted (``None``: as it is)."""
    if name is None:
        yield step
    elif name == "frozen_state":
        yield _Wrapped(step, _frozen)
    elif name == "half_batch":
        yield _Wrapped(step, _half)
    elif name == "loss_altered":
        yield _Wrapped(step, _altered)
    elif name == "no_exchange":
        from repro_torch.dist import gossip

        saved = gossip.Partners.__call__

        def own_rows(self, x, j):
            return x.clone()
        gossip.Partners.__call__ = own_rows
        try:
            yield step
        finally:
            gossip.Partners.__call__ = saved
    else:
        raise ValueError(f"unknown fault {name!r}; known: {PLANTS}")
