"""MATCHA gossip over node-stacked parameters on one device.

The port of ``repro.dist.gossip``. One MATCHA iteration applies the
mixing matrix (paper eq. 2-3)

    W^(k) = I - alpha * sum_j B_j^(k) L_j

Every matching is a set of vertex-disjoint edges, so its permutation
pi_j is an involution and applying W^(k) to node i's parameters is

    x_i <- x_i + alpha * sum_{active j} (x_{pi_j(i)} - x_i).

Leaves carry a leading node dim. Where the JAX package ppermutes the
pairs ``(i, pi_j(i))`` between devices, delivering ``x[pi_j(d)]`` to
node d, the port gathers ``x[pi_j]`` along the node dim: the same
W @ x. Each leaf's target ``x + sum_j b_j (x[pi_j] - x)`` is built in
fp32 (it is not rounded to x's dtype, so bf16 params keep the
consensus mass) and handed to ``ops.gossip_apply``, the hand-written
gossip-axpy kernel on the card. Leaves are processed one at a time, so
at most one leaf's fp32 target and one gathered partner are alive.

``launch_matchings_masked`` and ``delayed_delta`` are the overlap
mode's two halves on node-stacked fp32 buckets (``dist.bucketing``):
the partners summed at launch, ``recv = sum_j b_j x[pi_j]``, and the
one-step-delayed correction ``recv - (sum_j b_j) x`` the next step
lands. ``delayed_delta_inplace`` is the two composed over column
blocks of each bucket, written back over the bucket: the same
operations in the same order, so the same bits, with temporaries of one
block instead of whole buckets.

``mix_dense`` is the O(m^2) oracle the tests hold the others to.
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.tree import tree_map

PyTree = Any


def _canonical_active(active: Sequence[int], num_matchings: int) -> Tuple[int, ...]:
    """Dedupe + range-check an activated-matching index set (a duplicate
    would double-count a matching's delta; a negative id would wrap)."""
    out = tuple(dict.fromkeys(int(j) for j in active))
    for j in out:
        if not 0 <= j < num_matchings:
            raise ValueError(
                f"matching id {j} out of range for {num_matchings} matchings"
            )
    return out


def _gather_index(permutations, x: torch.Tensor) -> torch.Tensor:
    """The (M, m) permutations as an index tensor on x's device (no copy
    when they are one already: the overlap step keeps its index on the
    card, so its side stream never waits on a host-to-device copy)."""
    if isinstance(permutations, torch.Tensor):
        idx = permutations.to(device=x.device, dtype=torch.int64)
    else:
        idx = torch.as_tensor(np.asarray(permutations), dtype=torch.int64,
                              device=x.device)
    if idx.dim() != 2 or idx.shape[1] != x.shape[0]:
        raise ValueError(
            f"permutations {tuple(idx.shape)} do not match a leaf of "
            f"{x.shape[0]} nodes"
        )
    return idx


def _partner(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """One matching's partners of every node, ``x[pi_j]``: a fresh fp32
    tensor the caller may overwrite."""
    return x.index_select(0, perm).float()


def _as_f32(values, device, shape: Tuple[int, ...], what: str) -> torch.Tensor:
    t = torch.as_tensor(values, dtype=torch.float32).to(device)
    if tuple(t.shape) != shape:
        raise ValueError(
            f"{what} shape {tuple(t.shape)} does not match the expected {shape}"
        )
    return t


def _node_view(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(nodes,) per-node scalars, broadcastable against a stacked leaf."""
    return v.reshape((-1,) + (1,) * (ndim - 1))


def mix_dense(stacked: PyTree, W) -> PyTree:
    """out_i = sum_j W[i, j] x_j with fp32 accumulation (test oracle)."""

    def leaf(a):
        if not a.is_floating_point():
            return a
        w = torch.as_tensor(W, dtype=torch.float32).to(a.device)
        return torch.einsum("ij,j...->i...", w, a.float()).to(a.dtype)

    return tree_map(leaf, stacked)


def mix_matchings(
    stacked: PyTree,
    alpha: float,
    permutations,                         # (M, m) involutions
    active: Sequence[int],
    *,
    impl: str = "auto",
    gate_bits=None,                       # (m, M) per-node gates in {0, 1}
    inplace: bool = False,
) -> PyTree:
    """Static-activation gossip: x + alpha * sum_{j in active} (pi_j(x) - x).

    Only the active matchings are gathered. ``gate_bits`` (optional,
    ``(nodes, M)``) scales each node's delta for each matching, the JAX
    package's fault-degradation path; ``None`` is the plain update."""
    num, m = np.shape(permutations)
    active = _canonical_active(active, num)
    if not active:
        return stacked
    k = float(len(active))

    def target(x):
        idx = _gather_index(permutations, x)
        xf = x.float()
        if gate_bits is None:
            acc = None
            for j in active:
                p = _partner(x, idx[j])
                acc = p if acc is None else acc.add_(p)
            # y with x + alpha*(y - x) == x + alpha * sum_j (partner_j - x)
            return acc.sub_((k - 1.0) * xf)
        gates = _as_f32(gate_bits, x.device, (m, num), "gate_bits")
        delta = torch.zeros_like(xf)
        for j in active:
            delta.add_(_partner(x, idx[j]).sub_(xf).mul_(_node_view(gates[:, j], x.dim())))
        return delta.add_(xf)

    def leaf(x):
        if not x.is_floating_point():
            return x
        return ops.gossip_apply(x, target(x), float(alpha), impl=impl, inplace=inplace)

    return tree_map(leaf, stacked)


def mix_matchings_masked(
    stacked: PyTree,
    alpha: float,
    permutations,                         # (M, m) involutions
    bits,                                 # (M,) activation bits, or (m, M) per node
    *,
    impl: str = "auto",
    inplace: bool = False,
) -> PyTree:
    """Masked gossip: every matching's exchange runs, each delta scaled
    by its activation bit — the JAX package's one-executable schedule
    mode, and the main path's gossip.

    ``bits`` is the (M,) schedule row, or the faulted step's ``(nodes,
    M)`` per-node effective bits (``FaultSchedule.node_bits``: the row
    times the step's edge-symmetric link-survival gates), which scale
    node i's delta for matching j by ``bits[i, j]``. A dropped exchange
    then zeroes the delta at both endpoints: self-weight
    renormalization, which keeps the effective mixing matrix symmetric
    and doubly stochastic. With all-ones gates the result is bit-equal
    to the (M,) row's."""
    num, m = np.shape(permutations)
    per_node = np.ndim(bits) == 2

    def target(x):
        idx = _gather_index(permutations, x)
        if per_node:
            b = _as_f32(bits, x.device, (m, num), "per-node bits")
            scale = [_node_view(b[:, j], x.dim()) for j in range(num)]
        else:
            b = _as_f32(bits, x.device, (num,), "activation bits")
            scale = [b[j] for j in range(num)]
        xf = x.float()
        delta = torch.zeros_like(xf)
        for j in range(num):
            delta.add_(_partner(x, idx[j]).sub_(xf).mul_(scale[j]))
        # y with x + alpha*(y - x) == x + alpha * sum_j b_j (partner_j - x),
        # kept fp32: rounding it to x's dtype would make masked and static
        # modes diverge for bf16 params
        return delta.add_(xf)

    def leaf(x):
        if not x.is_floating_point():
            return x
        return ops.gossip_apply(x, target(x), float(alpha), impl=impl, inplace=inplace)

    return tree_map(leaf, stacked)


# ---------------------------------------------------------------------------
# Overlapped (one-step-delayed, bucketed) gossip
# ---------------------------------------------------------------------------
DELTA_BLOCK = 1 << 24    # columns of a bucket per block of delayed_delta_inplace
                         # (8 nodes: two 0.54 GB fp32 temporaries)


def _bucket_bits(bits, num: int, m: int, device):
    """Per-matching scales and the bit sum, shaped to broadcast against
    a ``(nodes, size)`` bucket: the (M,) row gives 0-dim scalars, the
    faulted step's ``(nodes, M)`` per-node bits give ``(nodes, 1)``
    columns, so node i uses ``bits[i, j]`` and its own sum."""
    if np.ndim(bits) == 2:
        b = _as_f32(bits, device, (m, num), "per-node bits")
        return [b[:, j:j + 1] for j in range(num)], b.sum(dim=1, keepdim=True)
    b = _as_f32(bits, device, (num,), "activation bits")
    return [b[j] for j in range(num)], b.sum()


def _recv(sent: torch.Tensor, idx: torch.Tensor, scale) -> torch.Tensor:
    """``sum_j b_j sent[pi_j]`` in fp32, j ascending, from zeros."""
    acc = torch.zeros_like(sent)
    for j, s in enumerate(scale):
        acc.addcmul_(sent.index_select(0, idx[j]), s)
    return acc


def launch_matchings_masked(
    buckets: Sequence[torch.Tensor],      # fp32 (nodes, B_i) buckets
    bits,                                 # (M,) activation bits, or (m, M) per node
    permutations,                         # (M, m) involutions
) -> Tuple[torch.Tensor, ...]:
    """The launch half of the overlap mode: every matching's partners
    gathered along the node dim and pre-reduced,
    ``recv_i = sum_j bits[j] * pi_j(bucket_i)``. ``delayed_delta`` turns
    it into the correction the next step lands."""
    num, m = np.shape(permutations)
    out = []
    for bkt in buckets:
        idx = _gather_index(permutations, bkt)
        scale, _ = _bucket_bits(bits, num, m, bkt.device)
        out.append(_recv(bkt, idx, scale))
    return tuple(out)


def delayed_delta(
    sent: Sequence[torch.Tensor],         # buckets snapshotted at launch
    recv: Sequence[torch.Tensor],         # launch_matchings_masked output
    bits,                                 # the bits the exchange was launched with
) -> Tuple[torch.Tensor, ...]:
    """Per-bucket one-step-delayed consensus delta:

        delta = sum_j b_j (pi_j(x_delayed) - x_delayed)
              = recv - (sum_j b_j) * sent

    Applying ``x <- x + alpha * delta`` (``ops.gossip_apply`` with target
    ``x + delta``) is the delayed analogue of the masked mode's in-step
    correction; at consensus delta == 0 and the fixed points coincide.
    With ``(nodes, M)`` bits node i subtracts its own bit sum."""
    num = np.shape(bits)[-1]
    out = []
    for s, r in zip(sent, recv):
        _, ksum = _bucket_bits(bits, num, s.shape[0], s.device)
        out.append(r - s * ksum)
    return tuple(out)


def delayed_delta_inplace(
    buckets: Sequence[torch.Tensor],      # fp32 (nodes, B_i), overwritten
    bits,
    permutations,
) -> Sequence[torch.Tensor]:
    """``delayed_delta(buckets, launch_matchings_masked(buckets, bits,
    permutations), bits)`` written over ``buckets``, bit for bit. The
    gather runs along the node dim only, so each block of columns
    depends on that block alone and is written back as soon as it is
    done: the temporaries are two blocks, not two copies of the params.
    Runs on the current stream (the overlap step's side stream)."""
    num, m = np.shape(permutations)
    for bkt in buckets:
        idx = _gather_index(permutations, bkt)
        scale, ksum = _bucket_bits(bits, num, m, bkt.device)
        for c0 in range(0, bkt.shape[1], DELTA_BLOCK):
            part = bkt[:, c0:c0 + DELTA_BLOCK]
            delta = _recv(part, idx, scale)
            delta.sub_(part * ksum)
            part.copy_(delta)
            del delta    # freed before the next block allocates its own
    return buckets
