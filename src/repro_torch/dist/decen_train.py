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
    "overlap" one-step-delayed bucketed gossip: step k's exchange is
              launched before step k's fwd/bwd and its correction lands
              at step k+1. The step lands the pending correction, snapshots
              the corrected params into the in-flight ``GossipState``
              buffers, then computes the new correction over them on a
              side CUDA stream while the main stream runs every node's
              fwd/bwd (on the CPU the same operations run in order)
    "none"    local SGD only (the no-communication baseline)

``faulted=True`` builds the link-failure-tolerant step, as in the JAX
package: ``bits`` is then the ``(nodes, M)`` per-node effective
activation array (``repro_torch.faults.FaultSchedule.node_bits``), which
masked and overlap gossip take as it is and static gossip as its
``gate_bits``.

Over a mesh of several data ranks (``repro_torch.launch.mesh``,
``DistSpec``) each rank holds its consecutive range of the nodes:
the steps take the run's whole batch and bits, keep their own nodes'
rows, and the gossip exchanges partners on other data ranks through
paired send/recv (``repro_torch.dist.gossip.NodeAxis``), bit for bit
the single-process step; ``consensus_distance`` then all-reduces over
the data ranks.

Over a ``model`` axis of T ranks (tensor parallel, ``DistSpec.rules``)
each rank holds its slice of every node's params (and velocities): the
steps run the model's sharded layers under those rules, the gossip is
elementwise and so gives each rank its slices of the whole exchange,
and every reduction over the parameters (``consensus_distance``, the
global-norm clip) counts a split leaf's slices over the model group and
a replicated leaf once.

A step built with a ``timer`` (``repro_torch.telemetry.StepTimer``)
records its spans (``telemetry.timers``): ``step``, and inside it each
node's ``fwd_bwd`` (``forward``, ``backward``) and ``optimizer``, then
``gossip`` (each leaf's ``gossip/target`` and ``gossip/apply``) with the
exchange's counters, or the overlap step's ``gossip_apply`` and
``gossip_launch``; nothing is fenced, and the arithmetic is the same, so
the results are bit-equal to the untraced step's. The model's latent
attention and MoE blocks open theirs inside ``forward`` and ``backward``
(``mla``, ``moe`` and their ``/backward`` spans; ``telemetry.blocks``),
with ``moe``'s pair counters when traced. A step built without a
timer keeps the same spans (not the counters) on a timer of its own, a
call's at a time, for ``last_phases``: the form the benchmark's traced
run reads. A disabled timer (``StepTimer(None)``) turns them off: such a
step reads no clock, creates no CUDA event and keeps no span list.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist import bucketing, comm
from repro_torch.dist import sharding as shd
from repro_torch.dist.gossip import (
    NodeAxis,
    delayed_delta_inplace,
    exchange_counts,
    mix_matchings,
    mix_matchings_masked,
)
from repro_torch.kernels import ops
from repro_torch.models.attention import route_counts
from repro_torch.models.module import _assign
from repro_torch.optim.optimizers import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.telemetry.blocks import block_spans
from repro_torch.telemetry.timers import NO_SPANS, StepSpans, StepTimer
from repro_torch.telemetry.trace import TraceRecorder
from repro_torch.tree import tree_items, tree_leaves, tree_map

PyTree = Any

# Checker declaration (``repro_torch.analysis.checks``): sums over the
# node axes (consensus, logging) and the model axis (clip norms, the
# checkpoint gather); the node rows all-gathered for checkpoints.
COLLECTIVE_CONTRACT = {
    "psum": {"axes_subset_of": ("pod", "data", "model")},
    "all_gather": {"axes_subset_of": ("pod", "data")},
}


@dataclasses.dataclass(frozen=True)
class DistSpec:
    """Mesh + node layout of one decentralized run: the node count, this
    rank's node range ``node_lo .. node_hi - 1`` and the shard factor."""

    mesh: Any
    num_nodes: int
    node_lo: int
    node_hi: int
    num_shards: int = 1
    rules: Any = None                 # tensor-parallel rules (model axis > 1)
    split: Any = None                 # {path: dim} of the leaves the rules split
    multi_pod: bool = False

    @property
    def local_nodes(self) -> int:
        return self.node_hi - self.node_lo

    @property
    def node_axes(self) -> Tuple[str, ...]:
        """The mesh axes the nodes lie on: ``("pod", "data")`` on a
        multi-pod mesh, as in the JAX package."""
        return ("pod", "data") if self.multi_pod else ("data",)

    @property
    def node_axis(self) -> Optional[NodeAxis]:
        """The gossip's node axis: ``None`` when one rank of the node
        axes holds every node (the single-process exchange)."""
        if self.mesh.nodes == 1:
            return None
        return NodeAxis(self.num_nodes, self.node_lo, self.node_hi,
                        tuple(self.mesh.global_rank(d) for d in range(self.mesh.nodes)),
                        self.mesh.nodes_group)

    def local(self, tree: PyTree) -> PyTree:
        """This rank's nodes' rows of a node-leading tree or batch."""
        if self.local_nodes == self.num_nodes:
            return tree
        return tree_map(lambda a: a[self.node_lo:self.node_hi], tree)

    def gather_nodes(self, tree: PyTree) -> PyTree:
        """This rank's ``(local nodes, ...)`` rows of every leaf,
        all-gathered over the node axes to ``(nodes, ...)``."""
        if self.mesh.nodes == 1:
            return tree

        def leaf(a):
            # the ranks' rows concatenated along dim 0, in node-rank order
            out = a.new_empty((self.num_nodes,) + tuple(a.shape[1:]))
            comm.all_gather(out, a, self.mesh.nodes_group)
            return out

        return tree_map(leaf, tree)

    def node_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the node axes, in place (identity for one)."""
        if self.mesh.nodes > 1:
            comm.all_reduce(t, self.mesh.nodes_group)
        return t

    def node_mean(self, per_node: torch.Tensor) -> float:
        """The mean of a ``(local nodes,)`` value over every node."""
        return float(self.node_sum(per_node.float().sum()) / self.num_nodes)

    @property
    def tp(self) -> int:
        return self.mesh.model if self.rules is not None else 1

    def model_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the model ranks, in place (identity for one)."""
        if self.tp > 1:
            comm.all_reduce(t, self.mesh.model_group)
        return t

    def weight(self, path: str) -> float:
        """How this rank counts a leaf in a sum over the model's
        parameters: a split leaf's slice on every model rank, a
        replicated leaf on model rank 0 only."""
        return 1.0 if self.tp == 1 or path in self.split or self.mesh.model_rank == 0 else 0.0

    def gather_model(self, tree: PyTree) -> PyTree:
        """A node-stacked param tree (or optimizer state, whose param-like
        sub-trees are mapped) of this model rank's slices, made whole on
        every rank: the checkpoint format. Only ``all_reduce``: each rank
        writes its slice's bits into a zeroed integer buffer, so the sum
        is the bits, unchanged."""
        if self.tp == 1:
            return tree

        def leaf(path, a):
            d = self.split.get(path)
            if d is None:
                return a
            bits = a.contiguous().view(_BITS[a.element_size()])
            shape = list(bits.shape)
            k = shape[d + 1]
            shape[d + 1] = k * self.tp
            buf = bits.new_zeros(shape)
            buf.narrow(d + 1, self.mesh.model_rank * k, k).copy_(bits)
            comm.all_reduce(buf, self.mesh.model_group)
            return buf.view(a.dtype)

        return _param_like(tree, leaf)

    def slice_model(self, tree: PyTree) -> PyTree:
        """This model rank's slices of a whole node-stacked tree (or
        optimizer state): the restore path."""
        if self.tp == 1:
            return tree

        def leaf(path, a):
            d = self.split.get(path)
            if d is None:
                return a
            k = a.shape[d + 1] // self.tp
            return a.narrow(d + 1, self.mesh.model_rank * k, k).clone()

        return _param_like(tree, leaf)


_BITS = {4: torch.int32, 2: torch.int16, 8: torch.int64, 1: torch.int8}


def _param_like(tree: PyTree, fn) -> PyTree:
    """``fn(path, leaf)`` over a param tree, or over every param-like
    sub-tree of an optimizer state (``velocity``, ``mu``, ``nu``); the
    state's other slots (``step``) stay as they are."""
    if "step" in tree and not isinstance(tree["step"], dict):
        return {k: _param_like(v, fn) if isinstance(v, dict) else v for k, v in tree.items()}
    out: dict = {}
    for path, a in tree_items(tree):
        _assign(out, path, fn(path, a))
    return out


def make_spec(mesh, num_nodes: int, *, multi_pod: bool = False, cfg=None,
              sequence_parallel: bool = False) -> DistSpec:
    """Resolve ``mesh`` and the node count into a ``DistSpec``:
    ``sharding.num_nodes`` (the one authority) checks the split and the
    ``pod`` axis against ``multi_pod``. A mesh with a ``model`` axis
    above 1 needs ``cfg``: the spec then carries ``sharding.train_rules``
    (``sequence_parallel``: the residual stream split over the sequence)
    and the paths of the leaves they split."""
    shd.num_nodes(mesh, num_nodes, multi_pod=multi_pod)
    lo, hi = shd.node_range(mesh, num_nodes)
    rules, split = None, {}
    if sequence_parallel and getattr(mesh, "model", 1) == 1:
        raise ValueError("sequence_parallel needs a model axis above 1")
    if getattr(mesh, "model", 1) > 1:
        if cfg is None:
            raise ValueError(f"a model axis of {mesh.model} needs the model's config "
                             "for its sharding rules")
        from repro_torch.models.module import split_of
        from repro_torch.models.transformer import Model

        rules = shd.train_rules(mesh, cfg, multi_pod=multi_pod,
                                sequence_parallel=sequence_parallel)
        model = Model(cfg)
        with shd.no_rules():
            shapes = dict(tree_items(model.param_shapes()))
        split = {path: split_of(axes, shapes[path][0], rules)
                 for path, axes in tree_items(model.logical_axes())}
        split = {path: d for path, d in split.items() if d is not None}
    return DistSpec(mesh=mesh, num_nodes=int(num_nodes), node_lo=lo, node_hi=hi,
                    num_shards=shd.num_shards(mesh), rules=rules, split=split,
                    multi_pod=multi_pod)


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


def consensus_distance(stacked_params: PyTree, spec: Optional[DistSpec] = None) -> torch.Tensor:
    """RMS-over-nodes Frobenius distance to the node mean:
    sqrt(mean_i sum_leaves ||x_i - x_bar||^2). The quantity MATCHA's
    Theorem 1 bounds; 'local' (no-gossip) training makes it blow up.
    With ``spec`` the params are this rank's nodes and the node mean and
    the sum over nodes are all-reduced over the data ranks; under tensor
    parallel each rank's leaves are its slices, and the sum over the
    leaves is added over the model ranks, a replicated leaf counted once."""
    spread = spec is not None and spec.mesh.nodes > 1
    tp = spec is not None and spec.tp > 1
    acc = None
    for path, leaf in tree_items(stacked_params):
        if not leaf.is_floating_point():
            continue
        x = leaf.float()
        if spread:
            mu = spec.node_sum(x.sum(dim=0, keepdim=True)) / spec.num_nodes
        else:
            mu = x.mean(dim=0, keepdim=True)
        sq = (x - mu).square_()
        d = sq.sum(dim=tuple(range(1, x.dim()))) if x.dim() > 1 else sq
        if tp:
            d = d * spec.weight(path)
        acc = d if acc is None else acc + d
    if acc is None:
        return torch.zeros((), dtype=torch.float32)
    if tp:
        acc = spec.model_sum(acc.contiguous())
    if spread:
        return torch.sqrt(spec.node_sum(acc.sum()) / spec.num_nodes)
    return torch.sqrt(torch.mean(acc))


# ---------------------------------------------------------------------------
# In-flight gossip state (overlap mode)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class GossipState:
    """The exchange in flight between two overlap steps.

    ``delta`` holds, per bucket of the run's ``BucketPlan``, the
    node-stacked ``(nodes, bucket_size)`` fp32 one-step-delayed
    correction ``sum_j b_j (pi_j(x) - x)`` of the params the exchange was
    launched on: everything the next step needs to land
    ``x <- x + alpha * delta``, and exactly one fp32 param copy per node
    in flight, as in the JAX package. The buffers are updated in place
    (each step snapshots its params into them, then overwrites the
    snapshot with the correction), so their storage never changes.

    ``done`` is the CUDA event the side stream records once the
    correction is written (``None`` on the CPU, where the work ran in
    order). Every reader of ``delta`` calls :meth:`wait` first.
    """

    delta: Tuple[torch.Tensor, ...]
    done: Optional[Any] = None

    def wait(self) -> None:
        """Make the current stream wait for the launched correction (the
        host does not block)."""
        if self.done is not None:
            torch.cuda.current_stream(self.delta[0].device).wait_event(self.done)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.delta)


def param_bucket_plan(
    model, *, target_bytes: int = bucketing.DEFAULT_TARGET_BYTES
) -> bucketing.BucketPlan:
    """Bucket layout of one node's (un-stacked) parameter tree (this model
    rank's slices under the current rules)."""
    return bucketing.plan_buckets(model.param_shapes(), target_bytes=target_bytes)


def init_gossip_state(plan, bplan: bucketing.BucketPlan, *, device="cuda",
                      spec: Optional[DistSpec] = None) -> GossipState:
    """Empty in-flight buffers (this rank's nodes with ``spec``): a zero
    delta, so the first step's delayed correction is exactly zero."""
    device = resolve_device(device)
    n = spec.local_nodes if spec is not None else int(np.shape(plan.permutations)[1])
    return GossipState(delta=tuple(
        torch.zeros((n, size), dtype=torch.float32, device=device)
        for size in bplan.bucket_sizes
    ))


def apply_delayed_leaf(x: torch.Tensor, d: torch.Tensor, alpha: float, *,
                       impl: str = "auto", inplace: bool = False) -> torch.Tensor:
    """One stacked leaf ``x`` and its ``(nodes, size)`` slice ``d`` of the
    delta buckets: ``x + alpha * d`` through ``ops.gossip_apply`` with the
    fp32 target ``x + d``."""
    target = (x.reshape(d.shape).float() + d).view(x.shape)
    return ops.gossip_apply(x, target, alpha, impl=impl, inplace=inplace)


def _apply_delayed(
    p: PyTree,
    delta_buckets: Tuple[torch.Tensor, ...],
    bplan: bucketing.BucketPlan,
    alpha: float,
    *,
    inplace: bool = False,
) -> PyTree:
    """Land an in-flight delayed correction on node-stacked params:
    ``x <- x + alpha * delta`` through the gossip-axpy kernel, one leaf at
    a time (one fp32 target alive). The one definition the train step
    and the end-of-run flush use: they must stay identical for flushed
    checkpoints to resume exactly."""
    views = [None] * len(bplan.shapes)
    for i, bkt, off, size in bucketing.leaf_slices(bplan, delta_buckets):
        views[i] = bkt[:, off:off + size]
    delta = bucketing.unflatten(bplan.treedef, views)
    return tree_map(
        lambda x, d: x if d is None else apply_delayed_leaf(x, d, alpha, inplace=inplace),
        p, delta,
    )


def make_gossip_flush(plan, bplan: bucketing.BucketPlan):
    """Land the exchange still in flight after the last overlap step:

        params = flush(params, gstate)

    Training in overlap mode leaves one delayed correction pending;
    apply it before checkpointing or evaluating consensus so the final
    replicas include every exchange the schedule paid for. New tensors,
    as in the JAX package (a checkpoint saves them while the live run
    keeps its correction pending); ``inplace=True`` writes over
    ``params`` instead."""
    alpha = float(plan.alpha)

    def flush(params, gstate: GossipState, *, inplace: bool = False):
        gstate.wait()
        with torch.no_grad():
            return _apply_delayed(params, gstate.delta, bplan, alpha, inplace=inplace)

    return flush


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------
def _since(before: Dict[str, int]) -> Dict[str, int]:
    """The training attention calls by route since ``before``."""
    return {k: v - before[k] for k, v in route_counts().items()}


class TrainStep:
    """One decentralized step over node-stacked state:

        params, opt_state, losses, metrics = step(params, opt_state, batch, bits)

    ``params``/``opt_state`` are updated in place (and returned);
    ``batch`` leaves are (nodes, per_node_batch, ...); ``bits`` is the
    (M,) activation row of the a-priori schedule (ignored by "static"
    and "none"), or with ``faulted`` the (nodes, M) per-node effective
    bits (the gates of "static"). ``losses`` and each metric come back
    per node, shape (nodes,). With a ``spec`` over several data ranks
    ``params``/``opt_state`` hold this rank's nodes, ``batch`` and
    per-node ``bits`` are the run's (each rank keeps its rows), and the
    results are this rank's nodes'. With a ``timer`` the step records
    its spans, unfenced (see the module docstring), and after a call
    ``last_phases`` is their ``telemetry.timers.StepSpans`` view:
    ``last_phases.ms()`` (or ``last_phase_ms``) splits the step's device
    time by span name, and ``last_phases.counts()`` holds the gossip's
    ``pairs_exchanged`` and ``pairs_set`` and the training attention's
    calls by route, ``attention_kernel`` / ``attention_plain``
    (``models.attention.route_counts``: on each ``forward`` span the
    forward's calls, on each ``backward`` span remat's recomputed ones and
    the flash backward's). ``step=k`` names the step in
    the spans. Without a timer ``last_phases`` is the view of the same
    spans on the step's own timer, without the counters; with a disabled
    timer it stays ``None``.
    """

    def __init__(self, model, opt: Optimizer, plan, *, gossip_mode: str,
                 active: Sequence[int], grad_clip: float, faulted: bool,
                 timer=None, spec: Optional[DistSpec] = None):
        self.model = model
        self.spec = spec
        self.nodes = spec.node_axis if spec is not None else None
        self.opt = opt
        self.gossip_mode = gossip_mode
        self.perms = np.asarray(plan.permutations)
        self.alpha = float(plan.alpha)
        self.active = tuple(int(j) for j in active)
        self.grad_clip = grad_clip
        self.faulted = faulted
        self.timer = timer
        # without a timer, the spans of one call at a time for last_phases
        self._own = StepTimer(TraceRecorder(capacity=1024)) if timer is None else None
        self.last_phases = None

    @property
    def last_phase_ms(self) -> Dict[str, float]:
        return self.last_phases.ms() if self.last_phases is not None else {}

    def _spans(self, step: int, device):
        """This call's spans: on the step's timer, on its own without one,
        ``NO_SPANS`` with a disabled one."""
        timer = self._own if self.timer is None else self.timer
        if not timer.enabled:
            self.last_phases = None
            return NO_SPANS
        self.last_phases = StepSpans(timer, step=step, device=device)
        return self.last_phases

    def _count(self, span, bits, *, active=None, gate_bits=None) -> None:
        """The exchange's (matching, node) pairs on ``span``, when traced."""
        if self.timer is not None and self.timer.enabled:
            span.count(**exchange_counts(bits, self.perms, self.num_local, active=active,
                                         gate_bits=gate_bits, nodes=self.nodes,
                                         device=self.last_phases.device))

    def _check_bits(self, bits) -> None:
        ndim, want = (2, "(nodes, M)") if self.faulted else (1, "(M,)")
        if self.gossip_mode != "none" and np.ndim(bits) != ndim:
            raise ValueError(f"a step built with faulted={self.faulted} takes "
                             f"{want} bits, got shape {tuple(np.shape(bits))}")

    def _local_sgd(self, params, opt_state, batch, i: int, spans):
        """Node i's fwd/bwd and SGD update, written into its slices.
        Only this node's grads are alive at a time."""
        traced = self.timer is not None and self.timer.enabled
        with spans("fwd_bwd", node=i):
            p_i = tree_map(lambda a: a[i].detach().requires_grad_(), params)
            b_i = {k: v[i] for k, v in batch.items()}
            with spans("forward", node=i) as span, self._rules(), \
                    block_spans(spans, counters=traced):
                before = route_counts() if traced else None
                loss, metrics = self.model.loss(p_i, b_i)
                if traced:
                    span.count(**_since(before))
            with spans("backward", node=i) as span:
                before = route_counts() if traced else None
                with self._rules():
                    grads = iter(torch.autograd.grad(loss, tree_leaves(p_i)))
                g_i = tree_map(lambda _: next(grads), p_i)
                if self.grad_clip:
                    g_i = self._clip(g_i)
                if traced:
                    span.count(**_since(before))
        with spans("optimizer", node=i), torch.no_grad():
            p_view = tree_map(lambda a: a[i], params)
            s_view = tree_map(lambda a: a[i], opt_state)
            updates, s_new = self.opt.update(g_i, s_view, p_view)
            tree_map(lambda dst, src: dst.copy_(src), p_view,
                     apply_updates(p_view, updates))
            tree_map(lambda dst, src: dst.copy_(src), s_view, s_new)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}

    def _rules(self):
        """The tensor-parallel rules of the run (none on a model axis of 1)."""
        return shd.use_rules(self.spec.rules if self.spec is not None else None)

    def _clip(self, grads: PyTree) -> PyTree:
        """The global-norm clip of one node's gradient; under tensor
        parallel the squares are summed over the model ranks, each
        replicated leaf counted once."""
        norm = None
        if self.spec is not None and self.spec.tp > 1:
            sq = sum(torch.sum(torch.square(g.float())) * self.spec.weight(path)
                     for path, g in tree_items(grads))
            norm = torch.sqrt(self.spec.model_sum(sq.reshape(1)))[0]
        return clip_by_global_norm(grads, self.grad_clip, norm)

    @property
    def num_local(self) -> int:
        return self.spec.local_nodes if self.spec is not None else self.perms.shape[1]

    def _every_node(self, params, opt_state, batch, spans):
        if self.spec is not None:
            batch = self.spec.local(batch)
        per_node = [
            self._local_sgd(params, opt_state, batch, i, spans)
            for i in range(self.num_local)
        ]
        losses = torch.stack([loss for loss, _ in per_node])
        metrics = {
            k: torch.stack([m[k] for _, m in per_node]) for k in per_node[0][1]
        }
        return losses, metrics

    def __call__(self, params, opt_state, batch, bits, *, step: int = -1):
        self._check_bits(bits)
        spans = self._spans(step, tree_leaves(params)[0].device)
        with spans("step", cat="step"):
            losses, metrics = self._every_node(params, opt_state, batch, spans)
            with spans("gossip") as span, torch.no_grad():
                # in place: each leaf's fp32 target is complete before its
                # update overwrites the leaf, and nothing reads it afterwards
                if self.gossip_mode == "masked":
                    mix_matchings_masked(params, self.alpha, self.perms, bits, inplace=True,
                                         nodes=self.nodes, spans=spans)
                    self._count(span, bits)
                elif self.gossip_mode == "static":
                    gates = bits if self.faulted else None
                    mix_matchings(params, self.alpha, self.perms, self.active,
                                  gate_bits=gates, inplace=True, nodes=self.nodes,
                                  spans=spans)
                    self._count(span, bits, active=self.active, gate_bits=gates)
        return params, opt_state, losses, metrics


class DelayedLaunch:
    """The overlap mode's launch of the delayed exchange over the
    in-flight ``GossipState`` buffers, shared by the replicated
    :class:`OverlapStep` and the sharded ``repro_torch.dist.fsdp`` step:
    on the card on a side CUDA stream that waits for the snapshot alone;
    on the CPU in order. With a timer the launch is the ``gossip_launch``
    span (cat ``comm``, tid 1), its device interval on the side stream,
    with the exchange's counters; ``last_launch_ms`` reads the newest
    (waiting for it). The step class supplies ``perms``, ``nodes`` and
    ``alpha``."""

    def _init_launch(self, num_buckets: int) -> None:
        self.num_buckets = num_buckets
        self._side = {}          # device -> (side stream, permutations on it)

    @property
    def last_launch_ms(self) -> Optional[float]:
        """The last call's launch time on the device; ``None`` with a
        disabled timer."""
        return self.last_phase_ms.get("gossip_launch")

    def _launch(self, gstate: GossipState, bits, device, spans) -> None:
        with torch.no_grad():
            if device.type == "cuda":
                self._launch_cuda(gstate, bits, device, spans)
            else:
                with spans("gossip_launch", cat="comm", tid=1,
                           buckets=self.num_buckets) as span:
                    self._count(span, bits)
                    delayed_delta_inplace(gstate.delta, bits, self.perms, nodes=self.nodes)
                gstate.done = None

    def _launch_cuda(self, gstate: GossipState, bits, device, spans) -> None:
        if device not in self._side:
            self._side[device] = (
                torch.cuda.Stream(device),
                torch.as_tensor(self.perms, dtype=torch.int64, device=device),
            )
        side, idx = self._side[device]
        bits = torch.as_tensor(bits, dtype=torch.float32).to(device)
        # the side stream starts once the snapshot is written; the
        # tensors made on the main stream must outlive its work there
        side.wait_stream(torch.cuda.current_stream(device))
        for t in (bits, idx) + tuple(gstate.delta):
            t.record_stream(side)
        # the order the next reader of gstate waits on (not a timer)
        done = torch.cuda.Event()
        with torch.cuda.stream(side):
            with spans("gossip_launch", cat="comm", tid=1, buckets=self.num_buckets) as span:
                self._count(span, bits)
                # over data ranks the exchange plans its own index; its
                # send/recv handles make the side stream wait, not the main one
                delayed_delta_inplace(gstate.delta, bits,
                                      idx if self.nodes is None else self.perms,
                                      nodes=self.nodes)
            done.record(side)
        gstate.done = done


class OverlapStep(DelayedLaunch, TrainStep):
    """The overlap step (``gossip_mode="overlap"``):

        params, opt_state, gstate, losses, metrics = step(
            params, opt_state, gstate, batch, bits)

    In order: land the pending correction in ``gstate`` (``x <- x +
    alpha * delta`` through ``ops.gossip_apply``, the gossip-axpy kernel
    on the card), snapshot every node's corrected params into
    ``gstate``'s buffers, launch this step's exchange over the snapshot,
    then run local SGD on the corrected params. ``gstate`` is updated in
    place and returned.

    On the card the launch runs on a side CUDA stream that waits for the
    snapshot alone, so it can run under the main stream's fwd/bwd;
    nothing in the step waits for it, and the next reader of ``gstate``
    waits on its event. The optimizer writes params in place, which is
    why the launch reads the snapshot and not the params. On the CPU the
    same operations run in order.

    With a ``timer`` the spans are the sequential step's, with
    ``gossip_apply`` and ``gossip_launch`` in place of ``gossip``.
    """

    def __init__(self, model, opt: Optimizer, plan, *, bucket_plan,
                 grad_clip: float, faulted: bool, timer=None,
                 spec: Optional[DistSpec] = None):
        super().__init__(model, opt, plan, gossip_mode="overlap", active=(),
                         grad_clip=grad_clip, faulted=faulted, timer=timer, spec=spec)
        self.bplan = bucket_plan
        self._init_launch(bucket_plan.num_buckets)

    def __call__(self, params, opt_state, gstate: GossipState, batch, bits, *,
                 step: int = -1):
        self._check_bits(bits)
        device = tree_leaves(params)[0].device
        spans = self._spans(step, device)
        with spans("step", cat="step"):
            with spans("gossip_apply"), torch.no_grad():
                gstate.wait()
                _apply_delayed(params, gstate.delta, self.bplan, self.alpha, inplace=True)
                bucketing.ravel_stacked(self.bplan, params, out=gstate.delta)
            self._launch(gstate, bits, device, spans)
            losses, metrics = self._every_node(params, opt_state, batch, spans)
        return params, opt_state, gstate, losses, metrics


def make_train_step(
    model,
    opt: Optimizer,
    plan,                                 # repro_torch.core.MatchaPlan
    *,
    gossip_mode: str = "masked",
    active: Sequence[int] = (),
    grad_clip: float = 0.0,
    bucket_plan: Optional[bucketing.BucketPlan] = None,
    faulted: bool = False,
    timer=None,
    spec: Optional[DistSpec] = None,
) -> TrainStep:
    """Build the decentralized step (see :class:`TrainStep`; for
    ``gossip_mode="overlap"`` :class:`OverlapStep`, which threads the
    in-flight ``GossipState`` through the call, over ``bucket_plan``,
    by default ``param_bucket_plan(model)``). ``faulted=True`` takes
    per-node ``(nodes, M)`` bits; with all-ones gates a masked or overlap
    step's results are bit-equal to the default step's (static gossip
    sums gated deltas where its plain path sums partners, as in the JAX
    package: fp32 rounding apart). ``timer`` (a ``StepTimer``) records
    every step's spans and counters, unfenced; without one the step keeps
    its last call's spans for ``last_phases``, and ``StepTimer(None)``
    turns them off. ``spec``: the run's mesh when its nodes span several
    data ranks."""
    if gossip_mode == "sequential":   # the JAX package's other spelling
        gossip_mode = "masked"
    if gossip_mode not in ("masked", "static", "overlap", "none"):
        raise ValueError(f"unknown gossip_mode {gossip_mode!r}")
    if gossip_mode == "overlap":
        if bucket_plan is None:
            with shd.use_rules(spec.rules if spec is not None else None):
                bucket_plan = param_bucket_plan(model)
        return OverlapStep(model, opt, plan, bucket_plan=bucket_plan,
                           grad_clip=grad_clip, faulted=faulted, timer=timer, spec=spec)
    return TrainStep(model, opt, plan, gossip_mode=gossip_mode,
                     active=active, grad_clip=grad_clip, faulted=faulted,
                     timer=timer, spec=spec)
