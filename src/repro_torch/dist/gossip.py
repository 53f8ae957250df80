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

Over a mesh of several data ranks (``repro_torch.launch.mesh``) each
rank holds a consecutive range of the nodes, and a :class:`NodeAxis`
names it. Matching j's partner of a local node is then gathered as
above when it is local too, and exchanged otherwise: every pair whose
endpoints sit on two data ranks moves through one ``batch_isend_irecv``
pair per (matching, peer rank), the rows packed in the pairs' global
order on both sides. That is the port's form of the JAX package's
ppermute; the bytes are the same, so the arithmetic is too, bit for
bit against the single-process run. Masked gossip exchanges all M
matchings, as the JAX package's does.

``mix_dense`` is the O(m^2) oracle the tests hold the others to.

``spans`` (a traced step's ``telemetry.timers.StepSpans``) records each
leaf's ``gossip/target`` (the fp32 target build) and ``gossip/apply``
(``ops.gossip_apply``), with the leaf's path and bytes;
``exchange_counts`` is the step's counter of the (matching, node) pairs
exchanged and of those whose bit was set.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.dist import comm
from repro_torch.kernels import ops
from repro_torch.telemetry.timers import NO_SPANS
from repro_torch.tree import tree_map, tree_map_with_path

PyTree = Any

# Checker declarations (``repro_torch.analysis.checks``): the exchange runs
# over the run's node axes; the functions that may widen sub-fp32 values
# to fp32 (the consensus accumulation dtype).
COLLECTIVE_CONTRACT = {
    "ppermute": {"axes": "nodes"},       # resolved to the run's node axes
}
FP32_UPCAST_SITES = (
    "leaf",                # mix_dense: fp32-accumulated dense oracle
    "target",              # mix_matchings / mix_matchings_masked deltas
    "launch_matchings_masked",
    "delayed_delta",
    "delayed_delta_inplace",
)


@dataclasses.dataclass(frozen=True)
class NodeAxis:
    """The nodes this rank holds of ``num_nodes``: ``lo .. hi - 1``, and
    the global rank of every data rank's peer (the rank with this rank's
    shard index), ``peers[d]``. ``None`` in place of a NodeAxis means
    one process holds every node."""

    num_nodes: int
    lo: int
    hi: int
    peers: Tuple[int, ...]
    group: Any = None         # the node axes' comm.Group (None: a mesh outside a world)

    @property
    def local(self) -> int:
        return self.hi - self.lo

    def owner(self, node: int) -> int:
        return node // self.local

    def rows(self, bits):
        """This rank's rows of per-node ``(num_nodes, M)`` bits."""
        if np.shape(bits)[0] != self.num_nodes:
            raise ValueError(f"per-node bits {tuple(np.shape(bits))} do not "
                             f"cover {self.num_nodes} nodes")
        return bits[self.lo:self.hi]


def _local_bits(bits, nodes: Optional[NodeAxis]):
    return bits if nodes is None or np.ndim(bits) != 2 else nodes.rows(bits)


class Partners:
    """``x[pi_j]`` for every matching j over the nodes a rank holds.

    One process: an index along the node dim (kept on x's device). Over
    several data ranks: the local partners by index, the others by one
    paired send/recv a (matching, peer rank), each side packing its rows
    in the pairs' global order, ``min(i, pi_j(i))``."""

    def __init__(self, permutations, nodes: Optional[NodeAxis], device):
        if nodes is None:
            self.idx = _gather_index(permutations, device)
            self.plans = None
            return
        perms = np.asarray(permutations.cpu() if isinstance(permutations, torch.Tensor)
                           else permutations)
        if perms.ndim != 2 or perms.shape[1] != nodes.num_nodes:
            raise ValueError(f"permutations {perms.shape} do not match "
                             f"{nodes.num_nodes} nodes")
        self.nodes = nodes
        self.idx = None
        self.plans = [self._plan(perm, device) for perm in perms]
        # matching j's (src, dst) node pairs of this rank in its record: the
        # pairs it sends on, and its unmatched nodes' fixed points (i, i),
        # as the JAX package's ppermute lists them
        self.pairs = [tuple((i, int(perm[i])) for i in range(nodes.lo, nodes.hi)
                            if int(perm[i]) == i
                            or self.nodes.owner(int(perm[i])) != self.nodes.owner(i))
                      for perm in perms]

    def _plan(self, perm, device):
        lo, hi = self.nodes.lo, self.nodes.hi
        dst, src, remote = [], [], {}
        for i in range(lo, hi):
            p = int(perm[i])
            if lo <= p < hi:
                dst.append(i - lo)
                src.append(p - lo)
            else:
                remote.setdefault(self.nodes.owner(p), []).append((min(i, p), i - lo))
        as_idx = lambda v: torch.as_tensor(v, dtype=torch.int64, device=device)
        peers = [(self.nodes.peers[d], as_idx([r for _, r in sorted(rows)]))
                 for d, rows in sorted(remote.items())]
        return as_idx(dst), as_idx(src), peers

    def __call__(self, x: torch.Tensor, j: int) -> torch.Tensor:
        """Matching j's partners of every local node, in x's dtype: a
        fresh tensor."""
        if self.plans is None:
            return x.index_select(0, self.idx[j])
        dst, src, peers = self.plans[j]
        out = torch.empty_like(x)
        if dst.numel():
            out.index_copy_(0, dst, x.index_select(0, src))
        # every rank of the node axes exchanges once a matching (no sends
        # when none of its nodes has a partner elsewhere)
        if self.nodes.group is None:
            raise ValueError("an exchange across data ranks needs the node axes' group "
                             "(a mesh made in a world of ranks)")
        recvs = comm.exchange([(peer, x.index_select(0, rows)) for peer, rows in peers],
                              self.nodes.group, self.pairs[j])
        for (_, rows), recv in zip(peers, recvs):
            out.index_copy_(0, rows, recv)
        return out


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


def _gather_index(permutations, device) -> torch.Tensor:
    """The (M, m) permutations as an index tensor on ``device`` (no copy
    when they are one already: the overlap step keeps its index on the
    card, so its side stream never waits on a host-to-device copy)."""
    if isinstance(permutations, torch.Tensor):
        idx = permutations.to(device=device, dtype=torch.int64)
    else:
        idx = torch.as_tensor(np.asarray(permutations), dtype=torch.int64,
                              device=device)
    if idx.dim() != 2:
        raise ValueError(f"permutations {tuple(idx.shape)} are not (M, m)")
    return idx


def _partners(permutations, x: torch.Tensor, nodes: Optional[NodeAxis]) -> Partners:
    """The exchange of x's nodes, checked against x's node dim."""
    want = x.shape[0] if nodes is None else nodes.local
    if x.shape[0] != want or np.shape(permutations)[1] != (
            x.shape[0] if nodes is None else nodes.num_nodes):
        raise ValueError(
            f"permutations {tuple(np.shape(permutations))} do not match a leaf of "
            f"{x.shape[0]} nodes"
        )
    return Partners(permutations, nodes, x.device)


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


def _per_leaf(stacked: PyTree, target, alpha: float, *, impl: str, inplace: bool,
              spans) -> PyTree:
    """Every floating leaf through ``ops.gossip_apply`` with its fp32
    ``target(x)``, one leaf at a time, each half in its span."""

    def leaf(path, x):
        if not x.is_floating_point():
            return x
        nbytes = x.numel() * x.element_size()
        with spans("gossip/target", leaf=path, bytes=nbytes):
            y = target(x)
        with spans("gossip/apply", leaf=path, bytes=nbytes):
            return ops.gossip_apply(x, y, float(alpha), impl=impl, inplace=inplace)

    return tree_map_with_path(leaf, stacked)


def exchange_counts(bits, permutations, local_nodes: int, *, active=None, gate_bits=None,
                    nodes: Optional[NodeAxis] = None, device) -> dict:
    """One step's counter at the gossip boundary, as device tensors:
    ``pairs_exchanged``, the (matching, node) pairs of this rank's nodes
    the exchange ran, and ``pairs_set``, those with their bit set. The
    masked exchange (``active`` None) runs every matching, weighted by
    the ``(M,)`` row or the per-node ``(nodes, M)`` bits; the static one
    runs the ``active`` matchings, each set, or weighted by the per-node
    ``gate_bits``."""
    num = int(np.shape(permutations)[0])
    if active is None:
        per_node = np.ndim(bits) == 2
        shape = (local_nodes, num) if per_node else (num,)
        b = _as_f32(_local_bits(bits, nodes), device, shape, "activation bits")
        pairs = local_nodes * num
        got = b.sum() if per_node else b.sum() * local_nodes
    else:
        active = _canonical_active(active, num)
        pairs = local_nodes * len(active)
        if gate_bits is None or not active:
            got = torch.full((), float(pairs), device=device)
        else:
            g = _as_f32(_local_bits(gate_bits, nodes), device, (local_nodes, num), "gate_bits")
            got = torch.stack([g[:, j].sum() for j in active]).sum()
    return {"pairs_exchanged": torch.full((), float(pairs), device=device), "pairs_set": got}


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
    nodes: Optional[NodeAxis] = None,
    spans=NO_SPANS,
) -> PyTree:
    """Static-activation gossip: x + alpha * sum_{j in active} (pi_j(x) - x).

    Only the active matchings are gathered. ``gate_bits`` (optional,
    ``(nodes, M)``) scales each node's delta for each matching, the JAX
    package's fault-degradation path; ``None`` is the plain update.
    ``nodes``: this rank's node range, when the nodes span data ranks;
    ``spans``: a traced step's spans."""
    num, _ = np.shape(permutations)
    active = _canonical_active(active, num)
    if not active:
        return stacked
    k = float(len(active))
    if gate_bits is not None:
        gate_bits = _local_bits(gate_bits, nodes)

    def target(x):
        partner = _partners(permutations, x, nodes)
        xf = x.float()
        if gate_bits is None:
            acc = None
            for j in active:
                p = partner(x, j).float()
                acc = p if acc is None else acc.add_(p)
            # y with x + alpha*(y - x) == x + alpha * sum_j (partner_j - x)
            return acc.sub_((k - 1.0) * xf)
        gates = _as_f32(gate_bits, x.device, (x.shape[0], num), "gate_bits")
        delta = torch.zeros_like(xf)
        for j in active:
            delta.add_(partner(x, j).float().sub_(xf).mul_(
                _node_view(gates[:, j], x.dim())))
        return delta.add_(xf)

    return _per_leaf(stacked, target, alpha, impl=impl, inplace=inplace, spans=spans)


def mix_matchings_masked(
    stacked: PyTree,
    alpha: float,
    permutations,                         # (M, m) involutions
    bits,                                 # (M,) activation bits, or (m, M) per node
    *,
    impl: str = "auto",
    inplace: bool = False,
    nodes: Optional[NodeAxis] = None,
    spans=NO_SPANS,
) -> PyTree:
    """Masked gossip: every matching's exchange runs, each delta scaled
    by its activation bit — the JAX package's one-executable schedule
    mode, and the main path's gossip. ``nodes``: this rank's node range,
    when the nodes span data ranks (every matching is exchanged);
    ``spans``: a traced step's spans.

    ``bits`` is the (M,) schedule row, or the faulted step's ``(nodes,
    M)`` per-node effective bits (``FaultSchedule.node_bits``: the row
    times the step's edge-symmetric link-survival gates), which scale
    node i's delta for matching j by ``bits[i, j]``. A dropped exchange
    then zeroes the delta at both endpoints: self-weight
    renormalization, which keeps the effective mixing matrix symmetric
    and doubly stochastic. With all-ones gates the result is bit-equal
    to the (M,) row's."""
    num, _ = np.shape(permutations)
    per_node = np.ndim(bits) == 2
    bits = _local_bits(bits, nodes)

    def target(x):
        partner = _partners(permutations, x, nodes)
        if per_node:
            b = _as_f32(bits, x.device, (x.shape[0], num), "per-node bits")
            scale = [_node_view(b[:, j], x.dim()) for j in range(num)]
        else:
            b = _as_f32(bits, x.device, (num,), "activation bits")
            scale = [b[j] for j in range(num)]
        xf = x.float()
        delta = torch.zeros_like(xf)
        for j in range(num):
            delta.add_(partner(x, j).float().sub_(xf).mul_(scale[j]))
        # y with x + alpha*(y - x) == x + alpha * sum_j b_j (partner_j - x),
        # kept fp32: rounding it to x's dtype would make masked and static
        # modes diverge for bf16 params
        return delta.add_(xf)

    return _per_leaf(stacked, target, alpha, impl=impl, inplace=inplace, spans=spans)


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


def _recv(sent: torch.Tensor, partner: Partners, scale) -> torch.Tensor:
    """``sum_j b_j sent[pi_j]`` in fp32, j ascending, from zeros."""
    acc = torch.zeros_like(sent)
    for j, s in enumerate(scale):
        acc.addcmul_(partner(sent, j), s)
    return acc


def launch_matchings_masked(
    buckets: Sequence[torch.Tensor],      # fp32 (nodes, B_i) buckets
    bits,                                 # (M,) activation bits, or (m, M) per node
    permutations,                         # (M, m) involutions
    *,
    nodes: Optional[NodeAxis] = None,
) -> Tuple[torch.Tensor, ...]:
    """The launch half of the overlap mode: every matching's partners
    gathered along the node dim and pre-reduced,
    ``recv_i = sum_j bits[j] * pi_j(bucket_i)``. ``delayed_delta`` turns
    it into the correction the next step lands."""
    num, _ = np.shape(permutations)
    bits = _local_bits(bits, nodes)
    out = []
    for bkt in buckets:
        partner = _partners(permutations, bkt, nodes)
        scale, _ = _bucket_bits(bits, num, bkt.shape[0], bkt.device)
        out.append(_recv(bkt, partner, scale))
    return tuple(out)


def delayed_delta(
    sent: Sequence[torch.Tensor],         # buckets snapshotted at launch
    recv: Sequence[torch.Tensor],         # launch_matchings_masked output
    bits,                                 # the bits the exchange was launched with
    *,
    nodes: Optional[NodeAxis] = None,
) -> Tuple[torch.Tensor, ...]:
    """Per-bucket one-step-delayed consensus delta:

        delta = sum_j b_j (pi_j(x_delayed) - x_delayed)
              = recv - (sum_j b_j) * sent

    Applying ``x <- x + alpha * delta`` (``ops.gossip_apply`` with target
    ``x + delta``) is the delayed analogue of the masked mode's in-step
    correction; at consensus delta == 0 and the fixed points coincide.
    With ``(nodes, M)`` bits node i subtracts its own bit sum."""
    num = np.shape(bits)[-1]
    bits = _local_bits(bits, nodes)
    out = []
    for s, r in zip(sent, recv):
        _, ksum = _bucket_bits(bits, num, s.shape[0], s.device)
        out.append(r - s * ksum)
    return tuple(out)


def delayed_delta_inplace(
    buckets: Sequence[torch.Tensor],      # fp32 (nodes, B_i), overwritten
    bits,
    permutations,
    *,
    nodes: Optional[NodeAxis] = None,
) -> Sequence[torch.Tensor]:
    """``delayed_delta(buckets, launch_matchings_masked(buckets, bits,
    permutations), bits)`` written over ``buckets``, bit for bit. The
    gather runs along the node dim only, so each block of columns
    depends on that block alone and is written back as soon as it is
    done: the temporaries are two blocks, not two copies of the params.
    Runs on the current stream (the overlap step's side stream: the
    exchanges of a ``nodes`` axis make that stream wait for them)."""
    num, _ = np.shape(permutations)
    bits = _local_bits(bits, nodes)
    partner = None
    for bkt in buckets:
        partner = partner or _partners(permutations, bkt, nodes)
        scale, ksum = _bucket_bits(bits, num, bkt.shape[0], bkt.device)
        for c0 in range(0, bkt.shape[1], DELTA_BLOCK):
            part = bkt[:, c0:c0 + DELTA_BLOCK]
            delta = _recv(part, partner, scale)
            delta.sub_(part * ksum)
            part.copy_(delta)
            del delta    # freed before the next block allocates its own
    return buckets
