"""FSDP-style sharded replicas on the gossip bucket layout.

The port of ``repro.dist.fsdp``. The replicated runtime
(``repro_torch.dist.decen_train``) keeps a full fp32 replica and full
optimizer state for every node. Here each node's replica is split over
the ``shard`` axis of the mesh (``repro_torch.launch.mesh``) on the same
contiguous fp32 buckets the overlap gossip mode uses
(``repro_torch.dist.bucketing`` with ``pad_to=S``): shard rank s keeps
slice s of every bucket of its data rank's nodes, one ``(local nodes,
size // S)`` fp32 tensor a bucket, and the optimizer state lives on the
slices too.

One step, for each of the rank's nodes in turn:

    all-gather(bucket shards over "shard")  ->  unravel to the param tree
    fwd/bwd on the node's batch slice       ->  grads
    ravel(grads) -> reduce-scatter, / S     ->  grad shards
    elementwise optimizer update            ->  new param shards

then the gossip runs on the bucket shards (``mix_matchings_masked``
through ``ops.gossip_apply``, one gossip-axpy launch a bucket shard):
shard s of node i meets shard s of its partner, on a rank with the same
s, so each matching moves 1/S of the replicated bytes. The node's batch
splits over the shard axis (``batch_per_node % S == 0``), so the mean of
the S sub-batch gradients is the full batch's and the loss is the mean
over the shard ranks. With fp32 params at S 1 the monolithic step is
bit for bit the replicated ``TrainStep``.

Gossip modes: ``"sequential"`` (``"masked"``: in-step masked exchange),
``"overlap"`` (the one-step-delayed exchange on the same
``GossipState``, launched on a side CUDA stream; ``make_fsdp_gossip_flush``
lands the last one) and ``"none"``.

Layouts:

``FsdpLayout`` (monolithic): byte-target buckets; the step gathers the
whole model before the fwd (transient O(model)) and reduce-scatters the
raveled grads after it.

``FsdpStreamLayout`` (``make_stream_layout``): one bucket per layer group
(``Model.param_group_specs``) and a walk over ``Model.stream_stages``.
Each stage runs under ``torch.utils.checkpoint`` over the group's
shards: the all-gather happens inside, so the backward re-gathers the
group instead of keeping it, and the gather's backward is the group's
reduce-scatter. Transient O(largest group).

Scan-aware streaming (``scan_aware=True``, the default) walks inside a
scanned or periodic segment: its bucket is ``repeats`` shard-major rows
(``bucketing.scan_ravel``) and ``_ScanStreamSegment``, an autograd
Function, runs it one row at a time. Its forward issues layer i+1's row
gather (``async_op=True``) before it computes layer i, so two rows are
live; its backward recomputes the forward keeping each layer's input,
then walks the rows in reverse, re-gathering each row, differentiating
that one layer and reduce-scattering the row's gradient. Transient
O(layer).

Resident state is the same flat tuple of fp32 bucket shards in every
layout, so gossip, the optimizer, ``GossipState`` and checkpoints take
any of them; checkpoints hold the gathered node-stacked tree
(``gather_params``), the replicated runtime's format, and restore into
any shard factor and layout (``scatter_params``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.dist import bucketing
from repro_torch.dist.decen_train import (
    DelayedLaunch,
    DistSpec,
    GossipState,
    TrainStep,
)
from repro_torch.dist.gossip import mix_matchings_masked
from repro_torch.dist import comm
from repro_torch.dist.sharding import bound, checkpoint, use_rules

# Checker declarations (``repro_torch.analysis.checks``): the shard axis's
# gathers and reduce-scatters, and sums over the shard and model axes;
# the one fp32 widening is the consensus logging reduction.
COLLECTIVE_CONTRACT = {
    "all_gather": {"axes": ("shard",)},
    "psum_scatter": {"axes": ("shard",)},
    "psum": {"axes_subset_of": ("shard", "model")},
}
FP32_UPCAST_SITES = (
    "consensus_distance_sharded",
)
from repro_torch.kernels import ops
from repro_torch.optim.optimizers import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.tree import tree_items, tree_leaves, tree_map

PyTree = Any

FSDP_GOSSIP_MODES = ("sequential", "overlap", "none")


# ---------------------------------------------------------------------------
# Abstract trees and layer-group subtrees
# ---------------------------------------------------------------------------
def _cast_like(tree: PyTree, abs_like: PyTree) -> PyTree:
    """fp32 unravel output -> the declared storage dtypes (no copy for
    fp32 leaves)."""
    return tree_map(lambda x, a: x.to(a[1]), tree, abs_like)


def _slice_layer(leaf, dim: int, i: int):
    if isinstance(leaf, tuple):
        shape, dtype = leaf
        return (tuple(shape[:dim]) + tuple(shape[dim + 1:]), dtype)
    return leaf.select(dim, i)


def _group_subtree(tree: PyTree, group, *, stacked: bool = False) -> PyTree:
    """One layer group out of a (possibly node-stacked) tree of tensors
    or ``(shape, dtype)`` pairs: the group's top-level keys, sliced to
    ``group.layer`` along the segment's layer dim for a block of an
    unrolled segment."""
    sub = {k: tree[k] for k in group.keys}
    if group.layer is not None:
        dim = 1 if stacked else 0
        sub = tree_map(lambda a: _slice_layer(a, dim, group.layer), sub)
    return sub


def _join_group_subtrees(groups, subtrees, *, stacked: bool = False) -> PyTree:
    """Inverse of ``_group_subtree`` over a full cover: re-stack the
    per-layer block slices and merge the whole-key groups."""
    out: dict = {}
    sliced: dict = {}
    for g, sub in zip(groups, subtrees):
        if g.layer is None:
            out.update(sub)
        else:
            for k in g.keys:
                sliced.setdefault(k, {})[g.layer] = sub[k]
    dim = 1 if stacked else 0
    for k, by_layer in sliced.items():
        ordered = [by_layer[i] for i in range(len(by_layer))]
        out[k] = tree_map(lambda *xs: torch.stack(xs, dim=dim), *ordered)
    return out


def _abs_params(model, spec: Optional[DistSpec] = None) -> PyTree:
    """One node's ``(shape, dtype)`` tree: this model rank's slices under
    the spec's tensor-parallel rules."""
    with use_rules(getattr(spec, "rules", None)):
        abs_local = model.param_shapes()
    for shape, dtype in tree_leaves(abs_local):
        if not dtype.is_floating_point:
            raise ValueError(
                "fsdp mode shards every param leaf into the fp32 buckets; "
                f"non-float leaf of dtype {dtype} cannot be sharded"
            )
    return abs_local


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FsdpLayout:
    """Monolithic sharded-replica layout: the byte-target bucket plan
    (padded to the shard factor) and the ``(shape, dtype)`` tree of one
    node's params it was built from."""

    plan: bucketing.BucketPlan
    abs_local: PyTree
    num_nodes: int
    num_shards: int

    @property
    def shard_sizes(self) -> Tuple[int, ...]:
        return tuple(s // self.num_shards for s in self.plan.bucket_sizes)

    @property
    def per_device_elements(self) -> int:
        return sum(self.shard_sizes)

    def ravel(self, tree: PyTree) -> Tuple[torch.Tensor, ...]:
        return bucketing.ravel(self.plan, tree)

    def unravel_cast(self, buckets) -> PyTree:
        return _cast_like(bucketing.unravel(self.plan, buckets), self.abs_local)

    def ravel_stacked(self, tree: PyTree) -> Tuple[torch.Tensor, ...]:
        return bucketing.ravel_stacked(self.plan, tree)

    def unravel_stacked(self, buckets) -> PyTree:
        """fp32 node-stacked tree (the optimizer-slot layout)."""
        return bucketing.unravel_stacked(self.plan, buckets)

    def unravel_stacked_cast(self, buckets) -> PyTree:
        return _cast_like(self.unravel_stacked(buckets), self.abs_local)


@dataclasses.dataclass(frozen=True)
class FsdpStreamLayout:
    """Layer-grouped layout (streamed strategy): bucket i holds layer
    group i (``Model.param_group_specs`` order). ``abs_rows[i]`` is the
    per-layer ``(shape, dtype)`` subtree of a scan-aware group (leading
    scan dim stripped), ``None`` otherwise."""

    plan: bucketing.GroupedPlan
    groups: Tuple[Any, ...]
    abs_local: PyTree
    abs_groups: Tuple[PyTree, ...]
    num_nodes: int
    num_shards: int
    abs_rows: Tuple[Any, ...] = ()

    def __post_init__(self):
        if not self.abs_rows:
            object.__setattr__(self, "abs_rows", (None,) * len(self.groups))

    @property
    def shard_sizes(self) -> Tuple[int, ...]:
        return tuple(s // self.num_shards for s in self.plan.bucket_sizes)

    @property
    def per_device_elements(self) -> int:
        return sum(self.shard_sizes)

    @property
    def group_names(self) -> Tuple[str, ...]:
        return self.plan.names

    def ravel(self, tree: PyTree) -> Tuple[torch.Tensor, ...]:
        out = []
        for g, p, r in zip(self.groups, self.plan.plans, self.plan.repeats):
            sub = _group_subtree(tree, g)
            if r > 1:
                out.append(bucketing.scan_ravel(p, sub, r, self.num_shards))
            else:
                out.append(bucketing.ravel(p, sub)[0])
        return tuple(out)

    def unravel_group(self, gi: int, bucket: torch.Tensor) -> PyTree:
        """Group ``gi``'s subtree from its full bucket, in storage dtypes."""
        p, r = self.plan.plans[gi], self.plan.repeats[gi]
        if r > 1:
            sub = bucketing.scan_unravel(p, bucket, r, self.num_shards)
        else:
            sub = bucketing.unravel(p, (bucket,))
        return _cast_like(sub, self.abs_groups[gi])

    def unravel_cast(self, buckets) -> PyTree:
        subs = tuple(self.unravel_group(gi, b) for gi, b in enumerate(buckets))
        return _join_group_subtrees(self.groups, subs)

    def ravel_stacked(self, tree: PyTree) -> Tuple[torch.Tensor, ...]:
        out = []
        for g, p, r in zip(self.groups, self.plan.plans, self.plan.repeats):
            sub = _group_subtree(tree, g, stacked=True)
            if r > 1:
                out.append(bucketing.scan_ravel_stacked(p, sub, r, self.num_shards))
            else:
                out.append(bucketing.ravel_stacked(p, sub)[0])
        return tuple(out)

    def unravel_stacked(self, buckets) -> PyTree:
        """fp32 node-stacked tree (the optimizer-slot layout)."""
        subs = []
        for p, b, r in zip(self.plan.plans, buckets, self.plan.repeats):
            if r > 1:
                subs.append(bucketing.scan_unravel_stacked(p, b, r, self.num_shards))
            else:
                subs.append(bucketing.unravel_stacked(p, (b,)))
        return _join_group_subtrees(self.groups, tuple(subs), stacked=True)

    def unravel_stacked_cast(self, buckets) -> PyTree:
        return _cast_like(self.unravel_stacked(buckets), self.abs_local)


AnyFsdpLayout = Union[FsdpLayout, FsdpStreamLayout]


def make_layout(model, spec: DistSpec, *,
                target_bytes: int = bucketing.DEFAULT_TARGET_BYTES) -> FsdpLayout:
    """Monolithic bucket layout of one node's params, shard-divisible."""
    abs_local = _abs_params(model, spec)
    plan = bucketing.plan_buckets(abs_local, target_bytes=target_bytes,
                                  pad_to=spec.num_shards)
    return FsdpLayout(plan=plan, abs_local=abs_local, num_nodes=spec.num_nodes,
                      num_shards=spec.num_shards)


def param_group_subtrees(model, *, abs_local: PyTree = None, groups=None):
    """``(name, (shape, dtype) subtree)`` per layer group of ``model``:
    what ``bucketing.plan_group_buckets`` takes."""
    if abs_local is None:
        abs_local = _abs_params(model)
    if groups is None:
        groups = tuple(model.param_group_specs())
    return tuple((g.name, _group_subtree(abs_local, g)) for g in groups)


def make_stream_layout(model, spec: DistSpec, *, scan_aware: bool = True) -> FsdpStreamLayout:
    """One shard-divisible bucket per entry of ``model.param_group_specs()``.
    ``scan_aware=True`` lays a scanned or periodic segment out as
    ``repeats`` shard-major rows so the step gathers one iteration's
    params at a time; ``False`` keeps one stack-at-once gather."""
    abs_local = _abs_params(model, spec)
    groups = tuple(model.param_group_specs())
    named = param_group_subtrees(model, abs_local=abs_local, groups=groups)
    gplan = bucketing.plan_group_buckets(
        list(named), pad_to=spec.num_shards, scan_aware=scan_aware,
        scan_repeats=tuple(g.repeats for g in groups))
    abs_rows = tuple(
        bucketing._strip_leading(sub, r, name) if r > 1 else None
        for (name, sub), r in zip(named, gplan.repeats)
    )
    return FsdpStreamLayout(plan=gplan, groups=groups, abs_local=abs_local,
                            abs_groups=tuple(a for _, a in named),
                            num_nodes=spec.num_nodes, num_shards=spec.num_shards,
                            abs_rows=abs_rows)


# ---------------------------------------------------------------------------
# Collectives over the mesh (the identity on a world of one)
# ---------------------------------------------------------------------------
def gather_shard(shard: torch.Tensor, mesh, *, async_op: bool = False):
    """All-gather one contiguous 1-D shard over the shard axis: the full
    ``(S * n,)`` bucket (``(full, work)`` with ``async_op``)."""
    if mesh.shard_group is None:
        return (shard, None) if async_op else shard
    out = shard.new_empty(mesh.shard * shard.numel())
    work = comm.all_gather(out, shard, mesh.shard_group, async_op=async_op)
    return (out, work) if async_op else out


def reduce_scatter_full(full: torch.Tensor, mesh) -> torch.Tensor:
    """Sum a full 1-D bucket over the shard axis and keep this rank's
    slice (the all-gather's transpose)."""
    if mesh.shard_group is None:
        return full
    out = full.new_empty(full.numel() // mesh.shard)
    return comm.reduce_scatter(out, full, mesh.shard_group)


def _shard_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    return comm.all_reduce(t, mesh.shard_group)


class _AllGather(torch.autograd.Function):
    """``gather_shard`` with the reduce-scatter (sum) as its backward."""

    @staticmethod
    def forward(ctx, shard, mesh):
        ctx.mesh = mesh
        out = gather_shard(shard, mesh)
        return out.view_as(out) if out is shard else out

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_full(grad, ctx.mesh), None


def _gather_all(spec: DistSpec, shard: torch.Tensor) -> torch.Tensor:
    """A bucket's ``(local nodes, size // S)`` shards to the full
    ``(nodes, S, size // S)`` array on every rank."""
    mesh = spec.mesh
    if mesh.shard_group is None:
        full = shard.unsqueeze(1)
    else:
        stacked = shard.new_empty((mesh.shard * shard.shape[0],) + tuple(shard.shape[1:]))
        comm.all_gather(stacked, shard, mesh.shard_group)
        full = stacked.view((mesh.shard,) + tuple(shard.shape)).transpose(0, 1)
    return spec.gather_nodes(full.contiguous())


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------
def _check(layout: AnyFsdpLayout, spec: DistSpec) -> None:
    if spec.num_shards != layout.num_shards or spec.num_nodes != layout.num_nodes:
        raise ValueError(
            f"spec has {spec.num_nodes} nodes at shard factor {spec.num_shards} but the "
            f"layout was built for {layout.num_nodes} at {layout.num_shards}")


def _my_slice(spec: DistSpec, sharded: torch.Tensor) -> torch.Tensor:
    """This rank's ``(local nodes, size // S)`` of a ``(nodes, S, size //
    S)`` array, as a tensor of its own."""
    return sharded[spec.node_lo:spec.node_hi, spec.mesh.shard_rank].clone()


def init_fsdp_params(model, layout: AnyFsdpLayout, spec: DistSpec, seed: int = 0, *,
                     device="cuda") -> Tuple[torch.Tensor, ...]:
    """This rank's shards of one init, every node from the same point:
    per bucket ``(local nodes, size // S)`` fp32."""
    _check(layout, spec)
    device = resolve_device(device)
    s, n = spec.mesh.shard_rank, spec.local_nodes
    out = []
    with use_rules(spec.rules):
        full = model.init(seed, device=device)
    for bkt in layout.ravel(full):
        mine = bkt.view(layout.num_shards, -1)[s]
        out.append(mine.unsqueeze(0).repeat(n, 1))
        del bkt, mine
    return tuple(out)


def _as_tree(buckets) -> dict:
    """A bucket tuple as the dict tree the optimizer maps over."""
    return {f"{i:04d}": b for i, b in enumerate(buckets)}


def init_fsdp_opt_state(opt: Optimizer, layout: AnyFsdpLayout, spec: DistSpec, *,
                        device="cuda") -> dict:
    """Optimizer state on this rank's shards: param-shaped slots
    (velocity, mu, nu) a bucket-shard tuple ``(local nodes, size //
    S)``, scalar slots ``(local nodes,)``."""
    _check(layout, spec)
    device = resolve_device(device)
    zeros = _as_tree(torch.zeros((sz,), dtype=torch.float32, device=device)
                     for sz in layout.shard_sizes)
    n = spec.local_nodes
    out = {}
    for key, sub in opt.init(zeros).items():
        stacked = tree_map(lambda a: a.unsqueeze(0).repeat((n,) + (1,) * a.dim()), sub)
        out[key] = tuple(stacked.values()) if isinstance(sub, dict) else stacked
    return out


def init_fsdp_gossip_state(layout: AnyFsdpLayout, spec: DistSpec, *,
                           device="cuda") -> GossipState:
    """Empty in-flight buffers for the overlap mode, on this rank's shards."""
    device = resolve_device(device)
    return GossipState(delta=tuple(
        torch.zeros((spec.local_nodes, sz), dtype=torch.float32, device=device)
        for sz in layout.shard_sizes))


def tp_weights(layout: AnyFsdpLayout, spec: DistSpec, device) -> Optional[Tuple[torch.Tensor, ...]]:
    """Under tensor parallel, this rank's bucket shards of ``spec.weight``
    (1 over a split leaf's elements; over a replicated leaf's, 1 on model
    rank 0 and 0 elsewhere; 0 over the padding): how a sum over the
    model's parameters counts each element. None without tensor parallel."""
    if spec.tp == 1:
        return None
    from repro_torch.models.module import _assign

    tree: dict = {}
    for path, (shape, _) in tree_items(layout.abs_local):
        _assign(tree, path, torch.full(shape, spec.weight(path), dtype=torch.float32,
                                       device=device))
    s = spec.mesh.shard_rank
    return tuple(b.float().view(layout.num_shards, -1)[s].clone() for b in layout.ravel(tree))


def consensus_distance_sharded(shards: Tuple[torch.Tensor, ...],
                               spec: Optional[DistSpec] = None,
                               layout: Optional[AnyFsdpLayout] = None) -> torch.Tensor:
    """``decen_train.consensus_distance`` on the bucket shards, without
    gathering replicas: the squared node deviations decompose over the
    slices (padding is zero on every node and stays so). Without
    ``spec`` the shards are whole ``(nodes, S, size // S)`` arrays (the
    JAX package's form); with it, this rank's ``(local nodes, size //
    S)``, reduced over the data and shard ranks (and, under tensor
    parallel, over the model ranks, weighed by ``tp_weights`` of
    ``layout``)."""
    if spec is None:
        acc = None
        for s in shards:
            x = s.float()
            d = (x - x.mean(dim=0, keepdim=True)).square_().sum(dim=(1, 2))
            acc = d if acc is None else acc + d
        if acc is None:
            return torch.zeros((), dtype=torch.float32)
        return torch.sqrt(torch.mean(acc))
    weights = tp_weights(layout, spec, shards[0].device) if spec.tp > 1 else None
    total = None
    for i, s in enumerate(shards):
        x = s.float()
        mu = spec.node_sum(x.sum(dim=0, keepdim=True)) / spec.num_nodes
        sq = (x - mu).square_()
        d = (sq * weights[i]).sum() if weights is not None else sq.sum()
        total = d if total is None else total + d
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    total = spec.model_sum(spec.node_sum(_shard_sum(total, spec.mesh)))
    return torch.sqrt(total / spec.num_nodes)


# ---------------------------------------------------------------------------
# Gather / scatter: checkpoints and the replicated layout
# ---------------------------------------------------------------------------
def gather_params(layout: AnyFsdpLayout, shards, spec: Optional[DistSpec] = None) -> PyTree:
    """Sharded replicas back to the node-stacked param tree in storage
    dtypes: the replicated runtime's layout and the checkpoint format,
    the same from every shard factor and layout. Without ``spec`` the
    shards are whole ``(nodes, S, size // S)`` arrays; with it, this
    rank's, gathered over the mesh (every rank gets the tree)."""
    if spec is not None:
        shards = tuple(_gather_all(spec, s) for s in shards)
    return layout.unravel_stacked_cast(bucketing.unshard_buckets(shards))


def scatter_params(layout: AnyFsdpLayout, stacked_params: PyTree,
                   spec: Optional[DistSpec] = None) -> Tuple[torch.Tensor, ...]:
    """Node-stacked param tree to sharded replicas (the restore path):
    ``(nodes, S, size // S)`` arrays, or this rank's slices with ``spec``."""
    sharded = bucketing.shard_buckets(layout.ravel_stacked(stacked_params),
                                      layout.num_shards)
    if spec is None:
        return sharded
    return tuple(_my_slice(spec, s) for s in sharded)


def _is_bucket_slot(layout: AnyFsdpLayout, sub) -> bool:
    return isinstance(sub, tuple) and len(sub) == layout.plan.num_buckets


def gather_opt_state(layout: AnyFsdpLayout, sharded_state: dict,
                     spec: Optional[DistSpec] = None) -> dict:
    """Sharded optimizer state to the replicated stacked layout
    (param-shaped slots back to leaf trees, scalar slots to ``(nodes,)``).
    Without ``spec`` the slots are whole ``(nodes, S, ...)`` arrays."""
    out = {}
    for key, sub in sharded_state.items():
        if _is_bucket_slot(layout, sub):
            if spec is not None:
                sub = tuple(_gather_all(spec, s) for s in sub)
            out[key] = layout.unravel_stacked(bucketing.unshard_buckets(tuple(sub)))
        elif spec is None:
            out[key] = tree_map(lambda a: a[:, 0], sub)
        else:
            out[key] = spec.gather_nodes(sub)
    return out


def scatter_opt_state(layout: AnyFsdpLayout, opt: Optimizer, stacked_state: dict,
                      spec: Optional[DistSpec] = None) -> dict:
    """Replicated stacked optimizer state to the sharded layout."""
    s = layout.num_shards
    out = {}
    for key, sub in stacked_state.items():
        if isinstance(sub, dict):
            sharded = bucketing.shard_buckets(layout.ravel_stacked(sub), s)
            out[key] = sharded if spec is None else tuple(
                _my_slice(spec, b) for b in sharded)
        elif spec is None:
            out[key] = tree_map(
                lambda a: a.unsqueeze(1).expand((a.shape[0], s) + tuple(a.shape[1:])), sub)
        else:
            out[key] = tree_map(lambda a: a[spec.node_lo:spec.node_hi].clone(), sub)
    return out


# ---------------------------------------------------------------------------
# The fwd/bwd in each layout
# ---------------------------------------------------------------------------
def _grads_monolithic(model, layout: FsdpLayout, mesh, ps, batch, spans, node: int):
    """Gather the whole replica, fwd/bwd, then ravel and reduce-scatter
    the grads one bucket at a time (sum over the shard ranks)."""
    with spans("gather", node=node), torch.no_grad():
        full = tuple(gather_shard(s, mesh) for s in ps)
    with spans("fwd_bwd", node=node):
        # unravel builds the tree in the plan's (sorted) leaf order
        p = tree_map(lambda a: a.detach().requires_grad_(), layout.unravel_cast(full))
        with spans("forward", node=node):
            loss, metrics = model.loss(p, batch)
        with spans("backward", node=node):
            grads = list(torch.autograd.grad(loss, tree_leaves(p)))
        del p, full
    with spans("reduce_scatter", node=node), torch.no_grad():
        plan = layout.plan
        out = []
        for b, size in enumerate(plan.bucket_sizes):
            # one bucket of grads at a time, each grad dropped once packed
            parts = []
            for i, bi in enumerate(plan.leaf_bucket):
                if bi == b:
                    parts.append(grads[i].reshape(-1).float())
                    grads[i] = None
            filled = sum(t.numel() for t in parts)
            if filled < size:
                parts.append(parts[0].new_zeros(size - filled))
            out.append(reduce_scatter_full(torch.cat(parts), mesh))
            del parts
    return loss, metrics, tuple(out)


def _materialize_group(layout: FsdpStreamLayout, gi: int, shard, mesh) -> PyTree:
    """All-gather ONE group's shard (differentiably) and unravel it to
    the group's subtree in storage dtypes."""
    return layout.unravel_group(gi, _AllGather.apply(shard, mesh))


class _ScanStreamSegment(torch.autograd.Function):
    """A scanned or periodic segment, one gathered layer row at a time.

    ``rows`` is the group's resident shard viewed ``(repeats, per_layer
    // S)``. Forward: row i+1's all-gather is issued before layer i is
    computed (two rows live). Backward: the forward again, keeping each
    layer's input; then, in reverse, row i re-gathered, that one layer
    differentiated, and the row's gradient reduce-scattered (summed over
    the shard ranks, like every streamed stage's)."""

    @staticmethod
    def _rows(rows, mesh, order):
        """Yield ``(i, full row i)`` in ``order``, each next gather
        issued before the current row is handed out."""
        pending = gather_shard(rows[order[0]], mesh, async_op=True)
        for k, i in enumerate(order):
            full, work = pending
            if k + 1 < len(order):
                pending = gather_shard(rows[order[k + 1]], mesh, async_op=True)
            if work is not None:
                work.wait()
            yield i, full

    @staticmethod
    def forward(ctx, x, rows, layout, gi, body, mesh, names):
        # the backward runs on autograd's thread: carry the rules there
        ctx.meta = (layout, gi, bound(body.apply_layer), mesh, names)
        ctx.save_for_backward(x, rows)
        aux = {k: torch.zeros((), dtype=torch.float32, device=x.device) for k in names}
        for _, full in _ScanStreamSegment._rows(rows, mesh, range(rows.shape[0])):
            x, a = body.apply_layer(x, _row_view(layout, gi, full))
            aux = {k: aux[k] + a[k] for k in names}
        return (x,) + tuple(aux[k] for k in names)

    @staticmethod
    def backward(ctx, dx, *daux):
        layout, gi, apply_layer, mesh, names = ctx.meta
        x0, rows = ctx.saved_tensors
        reps = rows.shape[0]
        inputs = []
        with torch.no_grad():
            x = x0
            for _, full in _ScanStreamSegment._rows(rows, mesh, range(reps)):
                inputs.append(x)
                x, _ = apply_layer(x, _row_view(layout, gi, full))
        drows = torch.empty_like(rows)
        for i, full in _ScanStreamSegment._rows(rows, mesh, range(reps - 1, -1, -1)):
            with torch.enable_grad():
                x_in = inputs[i].detach().requires_grad_()
                raw = full.detach().requires_grad_()
                y, aux = apply_layer(x_in, _row_view(layout, gi, raw))
                outs, grads = [y], [dx]
                for k, d in zip(names, daux):
                    if d is not None and aux[k].requires_grad:
                        outs.append(aux[k])
                        grads.append(d)
                dx, draw = torch.autograd.grad(outs, [x_in, raw], grads, allow_unused=True)
            if draw is None:
                draw = torch.zeros_like(raw)
            drows[i] = reduce_scatter_full(draw, mesh)
            inputs[i] = None
        return dx, drows, None, None, None, None, None


def _row_view(layout: FsdpStreamLayout, gi: int, full_row) -> PyTree:
    """One gathered ``(per_layer,)`` row as the layer's subtree in
    storage dtypes."""
    return _cast_like(bucketing.unravel(layout.plan.plans[gi], (full_row,)),
                      layout.abs_rows[gi])


def _stream_loss(model, layout: FsdpStreamLayout, shards, batch, mesh):
    """The streamed fwd+loss over the model's layer groups: each stage
    under ``torch.utils.checkpoint`` over the shards of the groups it
    reads (the gather inside, so the backward re-gathers); a scanned or
    periodic stage over a scan-aware group through
    ``_ScanStreamSegment``, which owns its recomputation."""
    carry = {"batch": batch}
    for st in model.stream_stages(batch):
        if st.scan is not None and len(st.group_ids) == 1:
            gi = st.group_ids[0]
            reps = layout.plan.repeats[gi]
            if reps > 1:
                if reps != st.scan.repeats:
                    raise ValueError(
                        f"group {layout.plan.names[gi]!r}: layout planned {reps} scan rows "
                        f"but the model's scan body has {st.scan.repeats} iterations")
                names = tuple(carry["aux"])     # the model's router losses
                x, *aux = _ScanStreamSegment.apply(
                    carry["x"], shards[gi].view(reps, -1), layout, gi, st.scan, mesh, names)
                carry = {**carry, "x": x, "aux": {
                    k: carry["aux"][k] + a for k, a in zip(names, aux)}}
                continue

        def run(carry, *gshards, _st=st):
            trees = tuple(_materialize_group(layout, gi, sh, mesh)
                          for gi, sh in zip(_st.group_ids, gshards))
            return _st.apply(carry, trees)

        carry = checkpoint(run, carry, *(shards[gi] for gi in st.group_ids))
    return carry["loss"], carry["metrics"]


def _clip_sharded(g_shards, max_norm: float, spec: DistSpec, weights=None):
    """Global-norm clip of the node's full gradient from its shards
    (under tensor parallel weighed by ``tp_weights`` and summed over the
    model ranks too)."""
    if weights is None:
        sq = sum(torch.sum(torch.square(g)) for g in g_shards)
    else:
        sq = sum(torch.sum(torch.square(g) * w) for g, w in zip(g_shards, weights))
    norm = torch.sqrt(spec.model_sum(_shard_sum(sq, spec.mesh)))
    return tuple(clip_by_global_norm(dict(enumerate(g_shards)), max_norm, norm).values())


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------
class FsdpTrainStep(TrainStep):
    """The sharded-replica decentralized step:

        shards, opt_state, losses, metrics = step(shards, opt_state, batch, bits)

    ``shards`` (from ``init_fsdp_params``) and ``opt_state`` (from
    ``init_fsdp_opt_state``) are this rank's and are updated in place;
    ``batch`` leaves are the run's ``(nodes, batch_per_node, ...)``
    (each rank keeps its nodes and its ``1/S`` of each node's rows);
    ``bits`` the (M,) row, or with ``faulted`` the (nodes, M) per-node
    bits. ``losses`` and metrics: this rank's nodes, the mean over the
    shard ranks. With a ``timer``, spans per node: ``gather``,
    ``fwd_bwd`` (``forward``, ``backward``), ``reduce_scatter``
    (monolithic; streamed: ``forward`` and ``backward`` hold them),
    ``optimizer``; then ``gossip``, as the replicated step records
    them, unfenced."""

    def __init__(self, model, opt: Optimizer, plan, spec: DistSpec, layout: AnyFsdpLayout,
                 *, gossip_mode: str, grad_clip: float, faulted: bool, timer=None):
        if gossip_mode == "masked":        # the replicated runtime's spelling
            gossip_mode = "sequential"
        if gossip_mode not in FSDP_GOSSIP_MODES:
            raise ValueError(f"unknown fsdp gossip_mode {gossip_mode!r}; "
                             f"choose from {FSDP_GOSSIP_MODES}")
        _check(layout, spec)
        super().__init__(model, opt, plan, gossip_mode=gossip_mode, active=(),
                         grad_clip=grad_clip, faulted=faulted, timer=timer, spec=spec)
        self.layout = layout
        self.mesh = spec.mesh
        self.streaming = isinstance(layout, FsdpStreamLayout)
        self._weights = None      # tp_weights, built at the first clip

    def _sub_batch(self, batch: dict) -> dict:
        """This rank's nodes and its 1/S of each node's rows."""
        batch = self.spec.local(batch)
        s, S = self.mesh.shard_rank, self.layout.num_shards
        out = {}
        for k, v in batch.items():
            if v.shape[1] % S:
                raise ValueError(f"batch_per_node {v.shape[1]} does not divide by "
                                 f"the shard factor {S}")
            per = v.shape[1] // S
            out[k] = v[:, s * per:(s + 1) * per]
        return out

    def _node(self, shards, opt_state, batch, i: int, spans):
        S = self.layout.num_shards
        b_i = {k: v[i] for k, v in batch.items()}
        with self._rules():
            if self.streaming:
                with spans("fwd_bwd", node=i):
                    ps = tuple(b[i].detach().requires_grad_() for b in shards)
                    with spans("forward", node=i):
                        loss, metrics = _stream_loss(self.model, self.layout, ps, b_i,
                                                     self.mesh)
                    with spans("backward", node=i):
                        g = torch.autograd.grad(loss, ps)
                    del ps
            else:
                loss, metrics, g = _grads_monolithic(
                    self.model, self.layout, self.mesh, tuple(b[i] for b in shards), b_i,
                    spans, i)
        with torch.no_grad():
            if S > 1:
                g = tuple(x / S for x in g)
            if self.grad_clip:
                if self.spec.tp > 1 and self._weights is None:
                    self._weights = tp_weights(self.layout, self.spec, g[0].device)
                g = _clip_sharded(g, self.grad_clip, self.spec, self._weights)
        with spans("optimizer", node=i), torch.no_grad():
            p_view = _as_tree(b[i] for b in shards)
            s_view = {k: _as_tree(t[i] for t in v) if isinstance(v, tuple) else
                      tree_map(lambda a: a[i], v) for k, v in opt_state.items()}
            updates, s_new = self.opt.update(_as_tree(g), s_view, p_view)
            tree_map(lambda dst, src: dst.copy_(src), p_view, apply_updates(p_view, updates))
            tree_map(lambda dst, src: dst.copy_(src), s_view, s_new)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def _every_node(self, shards, opt_state, batch, spans):
        batch = self._sub_batch(batch)
        per_node = [self._node(shards, opt_state, batch, i, spans)
                    for i in range(self.spec.local_nodes)]
        losses = torch.stack([loss for loss, _ in per_node])
        metrics = {k: torch.stack([m[k] for _, m in per_node]) for k in per_node[0][1]}
        S = self.layout.num_shards
        # per node: the mean of the S sub-batch token means
        for t in [losses] + list(metrics.values()):
            _shard_sum(t, self.mesh)
            if S > 1:
                t.div_(S)
        return losses, metrics

    def __call__(self, shards, opt_state, batch, bits, *, step: int = -1):
        self._check_bits(bits)
        spans = self._spans(step, shards[0].device)
        with spans("step", cat="step"):
            losses, metrics = self._every_node(shards, opt_state, batch, spans)
            if self.gossip_mode == "sequential":
                # the masked exchange on the bucket shards: shard s meets
                # shard s of the partner, 1/S of the replicated bytes
                with spans("gossip") as span, torch.no_grad():
                    mix_matchings_masked(_as_tree(shards), self.alpha, self.perms, bits,
                                         inplace=True, nodes=self.nodes, spans=spans)
                    self._count(span, bits)
        return shards, opt_state, losses, metrics


def _land(shards, gstate: GossipState, alpha: float, *, inplace: bool):
    """``x <- x + alpha * delta`` on every bucket shard through the
    gossip-axpy kernel (one launch a bucket); the one definition the
    overlap step and the flush use."""
    return tuple(ops.gossip_apply(x, x + d, alpha, inplace=inplace)
                 for x, d in zip(shards, gstate.delta))


class FsdpOverlapStep(DelayedLaunch, FsdpTrainStep):
    """The sharded overlap step:

        shards, opt_state, gstate, losses, metrics = step(
            shards, opt_state, gstate, batch, bits)

    Land the pending correction on the shards, snapshot them into
    ``gstate``, launch this step's exchange over the snapshot (a side
    CUDA stream on the card), then the local SGD, as the replicated
    ``OverlapStep`` does."""

    def __init__(self, model, opt, plan, spec, layout, *, grad_clip: float, faulted: bool,
                 timer=None):
        super().__init__(model, opt, plan, spec, layout, gossip_mode="overlap",
                         grad_clip=grad_clip, faulted=faulted, timer=timer)
        self._init_launch(layout.plan.num_buckets)

    def __call__(self, shards, opt_state, gstate: GossipState, batch, bits, *,
                 step: int = -1):
        self._check_bits(bits)
        device = shards[0].device
        spans = self._spans(step, device)
        with spans("step", cat="step"):
            with spans("gossip_apply"), torch.no_grad():
                gstate.wait()
                _land(shards, gstate, self.alpha, inplace=True)
                for d, x in zip(gstate.delta, shards):
                    d.copy_(x)
            self._launch(gstate, bits, device, spans)
            losses, metrics = self._every_node(shards, opt_state, batch, spans)
        return shards, opt_state, gstate, losses, metrics


def make_fsdp_train_step(model, opt: Optimizer, plan, spec: DistSpec, layout: AnyFsdpLayout,
                         *, gossip_mode: str = "sequential", grad_clip: float = 0.0,
                         faulted: bool = False, timer=None) -> FsdpTrainStep:
    """Build the sharded step (:class:`FsdpTrainStep`; for
    ``gossip_mode="overlap"`` :class:`FsdpOverlapStep`). The layout
    picks the materialization: ``FsdpLayout`` gathers the whole model,
    ``FsdpStreamLayout`` one layer group (or one scan row) at a time.
    ``faulted=True`` takes per-node ``(nodes, M)`` bits; all-ones gates
    reproduce the default step bit for bit. ``timer`` records every
    step's spans, unfenced; without one, or with ``StepTimer(None)``, as
    ``decen_train.make_train_step``."""
    if gossip_mode == "overlap":
        return FsdpOverlapStep(model, opt, plan, spec, layout, grad_clip=grad_clip,
                               faulted=faulted, timer=timer)
    return FsdpTrainStep(model, opt, plan, spec, layout, gossip_mode=gossip_mode,
                         grad_clip=grad_clip, faulted=faulted, timer=timer)


def make_fsdp_gossip_flush(plan, layout: AnyFsdpLayout):
    """Land the exchange still in flight after the last overlap step,
    on the shards: ``shards = flush(shards, gstate)`` (new tensors;
    ``inplace=True`` writes over ``shards``)."""
    alpha = float(plan.alpha)

    def flush(shards, gstate: GossipState, *, inplace: bool = False):
        gstate.wait()
        with torch.no_grad():
            return _land(shards, gstate, alpha, inplace=inplace)

    return flush
