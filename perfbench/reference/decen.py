"""Plain reference of decentralized training and the comparison that
decides ``correct``.

``readings`` trains every node from the same replica for a few steps as
the paper's MATCHA DecenSGD does: each node's loss and gradient on its
own batch, SGD with momentum (v <- mu v + g, x <- x - lr v), then the
masked gossip x_i <- x_i + alpha sum_j b_j (x_{pi_j(i)} - x_i) over the
matchings whose bit is set. It returns what the benchmark reads from the
program after the same steps: every step's loss per node, the norm of
each leaf's first gradient per node, and the norm of each leaf's change
over the steps per node.

``compare`` holds one set of readings to another (the program's, or the
control's, to the float32 reference's): the widest loss gap, and for the
norms each leaf's gap between the two norms over the reference's norm of
that leaf or of the median leaf, whichever is larger; the worst leaf's,
and the median leaf's where one small leaf's noise swamps the worst. A
leaf whose reference gradient is under a thousandth of the median leaf's
is left out of the change: it moves by rounding alone.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import torch

ZERO_GRAD = 1e-3
GOSSIP_BLOCK = 1 << 24       # columns of a leaf mixed at a time


def readings(family, c: dict, replica: Dict[str, torch.Tensor], tokens, labels, perms,
             alpha: float, bits, *, lr: float, momentum: float, steps: int,
             precision: str = "fp32") -> dict:
    """``tokens``/``labels``: (steps, nodes, B, S) on the device that
    trains; ``bits``: (steps, M); ``replica`` may lie on the host."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _readings(family, c, replica, tokens, labels, perms, alpha, bits, lr,
                         momentum, steps, precision)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _readings(family, c, replica, tokens, labels, perms, alpha, bits, lr, momentum,
              steps, precision):
    nodes, dev = tokens.shape[1], tokens.device
    X = {k: v.detach().to(dev, torch.float32).unsqueeze(0).repeat((nodes,) + (1,) * v.dim())
         for k, v in replica.items()}
    V = {k: torch.zeros_like(v) for k, v in X.items()}
    losses: List[List[float]] = []
    grad = {k: [0.0] * nodes for k in X}
    perm_idx = [torch.as_tensor(p, dtype=torch.long, device=tokens.device) for p in perms]
    for step in range(steps):
        row = []
        for i in range(nodes):
            leaves = {k: x[i].detach().requires_grad_() for k, x in X.items()}
            loss = family.loss(leaves, tokens[step, i], labels[step, i], c, precision)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            with torch.no_grad():
                for (k, x), g in zip(X.items(), grads):
                    V[k][i].mul_(momentum).add_(g)
                    x[i].sub_(lr * V[k][i])
                    if step == 0:
                        grad[k][i] = float(torch.linalg.vector_norm(g))
            row.append(float(loss.detach()))
            del leaves, loss, grads
        losses.append(row)
        active = [idx for j, idx in enumerate(perm_idx) if float(bits[step][j])]
        with torch.no_grad():
            for x in X.values():
                flat = x.view(nodes, -1)
                # in blocks of columns: the gossip mixes rows (nodes) only
                for c0 in range(0, flat.shape[1], GOSSIP_BLOCK):
                    xs = flat[:, c0:c0 + GOSSIP_BLOCK]
                    delta = torch.zeros_like(xs)
                    for idx in active:
                        delta.add_(xs.index_select(0, idx)).sub_(xs)
                    xs.add_(alpha * delta)
    change = {}
    for k, x in X.items():
        r = replica[k].to(x.device, torch.float32)
        change[k] = [float(torch.linalg.vector_norm(x[i] - r)) for i in range(nodes)]
    return {"loss": losses, "grad": grad, "change": change}


def _leaf_gaps(prog: Dict[str, List[float]], ref: Dict[str, List[float]], keep) -> tuple:
    """Each kept leaf's widest gap over the nodes, and where the widest of
    all lies."""
    gaps, worst, where = {}, -1.0, ""
    nodes = len(next(iter(ref.values())))
    for i in range(nodes):
        med = statistics.median(ref[k][i] for k in ref)
        for k in ref:
            if not keep(k, i):
                continue
            gap = abs(prog[k][i] - ref[k][i]) / max(ref[k][i], med, 1e-30)
            gaps[k] = max(gaps.get(k, 0.0), gap)
            if gap > worst:
                worst, where = gap, f"{k} node {i}"
    return gaps, where


def compare(prog: dict, ref: dict) -> dict:
    """The gaps of ``prog`` against ``ref``: ``loss_gap`` (nats, every
    step and node); ``grad_gap`` and ``change_gap`` (shares, the worst
    leaf), ``grad_med_gap`` and ``change_med_gap`` (the median leaf's
    widest gap over the nodes); the worst leaf and node of each, and the
    leaves left out of the change."""
    loss_gap = max(abs(a - b) for pa, ra in zip(prog["loss"], ref["loss"])
                   for a, b in zip(pa, ra))
    grad = ref["grad"]
    nodes = len(next(iter(grad.values())))
    med = [statistics.median(grad[k][i] for k in grad) for i in range(nodes)]
    still = sorted({k for k in grad for i in range(nodes) if grad[k][i] < ZERO_GRAD * med[i]})
    g, grad_at = _leaf_gaps(prog["grad"], grad, lambda k, i: True)
    c, change_at = _leaf_gaps(prog["change"], ref["change"],
                              lambda k, i: grad[k][i] >= ZERO_GRAD * med[i])
    return {"loss_gap": loss_gap, "grad_gap": max(g.values()), "change_gap": max(c.values()),
            "grad_med_gap": statistics.median(g.values()),
            "change_med_gap": statistics.median(c.values()),
            "grad_at": grad_at, "change_at": change_at, "left_out": still}
