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

``make_phased_train_step`` is the telemetry variant: the same step with
every phase span fenced and recorded into a ``StepTimer``
(``repro_torch.telemetry``); overlap is refused there and timed whole
step instead.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist import bucketing
from repro_torch.dist import sharding as shd
from repro_torch.dist.gossip import (
    NodeAxis,
    delayed_delta_inplace,
    mix_matchings,
    mix_matchings_masked,
)
from repro_torch.kernels import ops
from repro_torch.models.module import _assign
from repro_torch.optim.optimizers import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.telemetry.timers import StepTimer
from repro_torch.telemetry.trace import TraceEvent
from repro_torch.tree import tree_items, tree_leaves, tree_map

PyTree = Any


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

    @property
    def local_nodes(self) -> int:
        return self.node_hi - self.node_lo

    @property
    def node_axis(self) -> Optional[NodeAxis]:
        """The gossip's node axis: ``None`` when one data rank holds
        every node (the single-process exchange)."""
        if self.mesh.data == 1:
            return None
        return NodeAxis(self.num_nodes, self.node_lo, self.node_hi,
                        tuple(self.mesh.global_rank(d) for d in range(self.mesh.data)))

    def local(self, tree: PyTree) -> PyTree:
        """This rank's nodes' rows of a node-leading tree or batch."""
        if self.local_nodes == self.num_nodes:
            return tree
        return tree_map(lambda a: a[self.node_lo:self.node_hi], tree)

    def gather_nodes(self, tree: PyTree) -> PyTree:
        """This rank's ``(local nodes, ...)`` rows of every leaf,
        all-gathered over the data ranks to ``(nodes, ...)``."""
        if self.mesh.data == 1:
            return tree
        gather = shd.collective("all_gather_single")

        def leaf(a):
            # the ranks' rows concatenated along dim 0, in data-rank order
            out = a.new_empty((self.num_nodes,) + tuple(a.shape[1:]))
            gather(out, a.contiguous(), group=self.mesh.data_group)
            return out

        return tree_map(leaf, tree)

    def node_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data ranks, in place (identity for one)."""
        if self.mesh.data > 1:
            import torch.distributed as dist

            dist.all_reduce(t, group=self.mesh.data_group)
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
            import torch.distributed as dist

            dist.all_reduce(t, group=self.mesh.model_group)
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
        import torch.distributed as dist

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
            dist.all_reduce(buf, group=self.mesh.model_group)
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


def make_spec(mesh, num_nodes: int, *, multi_pod: bool = False, cfg=None) -> DistSpec:
    """Resolve ``mesh`` and the node count into a ``DistSpec``:
    ``sharding.num_nodes`` (the one authority) checks the split. A mesh
    with a ``model`` axis above 1 needs ``cfg``: the spec then carries
    ``sharding.train_rules`` and the paths of the leaves they split."""
    lo, hi = shd.node_range(mesh, shd.num_nodes(mesh, num_nodes, multi_pod=multi_pod))
    rules, split = None, {}
    if getattr(mesh, "model", 1) > 1:
        if cfg is None:
            raise ValueError(f"a model axis of {mesh.model} needs the model's config "
                             "for its sharding rules")
        from repro_torch.models.module import split_of
        from repro_torch.models.transformer import Model

        rules = shd.train_rules(mesh, cfg)
        model = Model(cfg)
        with shd.no_rules():
            shapes = dict(tree_items(model.param_shapes()))
        split = {path: split_of(axes, shapes[path][0], rules)
                 for path, axes in tree_items(model.logical_axes())}
        split = {path: d for path, d in split.items() if d is not None}
    return DistSpec(mesh=mesh, num_nodes=int(num_nodes), node_lo=lo, node_hi=hi,
                    num_shards=shd.num_shards(mesh), rules=rules, split=split)


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
    spread = spec is not None and spec.mesh.data > 1
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
class PhaseTimes:
    """Time per phase of one step, summed over the phase's spans.

    Without a timer: CUDA events on the card (read back lazily; reading
    synchronizes), the host clock on the CPU, and nothing is fenced.
    With a ``StepTimer`` (the phased step): every span ends with
    ``torch.cuda.synchronize`` and is timed by the host clock, and an
    enabled timer records it as one event (cat ``phase``, tid 0)."""

    def __init__(self, device, timer=None, step: int = -1):
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._timer = timer
        self._step = step
        self._spans = []

    @contextlib.contextmanager
    def span(self, name: str, **args):
        if self._timer is not None:
            with self._timer.phase(name, cat="phase", step=self._step, tid=0, **args):
                t0 = time.perf_counter()
                yield
                if self._cuda:
                    torch.cuda.synchronize(self._device)
                self._spans.append((name, (time.perf_counter() - t0) * 1e3))
        elif self._cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._spans.append((name, start, end))
        else:
            t0 = time.perf_counter()
            yield
            self._spans.append((name, (time.perf_counter() - t0) * 1e3))

    def ms(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, *t in self._spans:
            if len(t) == 2:
                t[1].synchronize()
                dt = t[0].elapsed_time(t[1])
            else:
                dt = t[0]
            out[name] = out.get(name, 0.0) + dt
        return out


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
    results are this rank's nodes'. After a call, ``last_phases.ms()`` (or
    ``last_phase_ms``) splits its time into fwd_bwd, optimizer and
    gossip. With a ``timer`` every phase span is fenced and recorded
    (``make_phased_train_step``); the arithmetic is the same, so the
    results are bit-equal to the unphased step's. ``step=k`` names the
    step in the recorded events.
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
        self.last_phases = None

    @property
    def last_phase_ms(self) -> Dict[str, float]:
        return self.last_phases.ms() if self.last_phases is not None else {}

    def _check_bits(self, bits) -> None:
        ndim, want = (2, "(nodes, M)") if self.faulted else (1, "(M,)")
        if self.gossip_mode != "none" and np.ndim(bits) != ndim:
            raise ValueError(f"a step built with faulted={self.faulted} takes "
                             f"{want} bits, got shape {tuple(np.shape(bits))}")

    def _local_sgd(self, params, opt_state, batch, i: int, phases: PhaseTimes):
        """Node i's fwd/bwd and SGD update, written into its slices.
        Only this node's grads are alive at a time."""
        with phases.span("fwd_bwd", node=i):
            p_i = tree_map(lambda a: a[i].detach().requires_grad_(), params)
            b_i = {k: v[i] for k, v in batch.items()}
            with self._rules():
                loss, metrics = self.model.loss(p_i, b_i)
                grads = iter(torch.autograd.grad(loss, tree_leaves(p_i)))
            g_i = tree_map(lambda _: next(grads), p_i)
            if self.grad_clip:
                g_i = self._clip(g_i)
        with phases.span("optimizer", node=i), torch.no_grad():
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

    def _every_node(self, params, opt_state, batch, phases: PhaseTimes):
        if self.spec is not None:
            batch = self.spec.local(batch)
        per_node = [
            self._local_sgd(params, opt_state, batch, i, phases)
            for i in range(self.num_local)
        ]
        losses = torch.stack([loss for loss, _ in per_node])
        metrics = {
            k: torch.stack([m[k] for _, m in per_node]) for k in per_node[0][1]
        }
        return losses, metrics

    def __call__(self, params, opt_state, batch, bits, *, step: int = -1):
        self._check_bits(bits)
        device = tree_leaves(params)[0].device
        phases = PhaseTimes(device, self.timer, step)
        losses, metrics = self._every_node(params, opt_state, batch, phases)
        with phases.span("gossip"), torch.no_grad():
            # in place: each leaf's fp32 target is complete before its
            # update overwrites the leaf, and nothing reads it afterwards
            if self.gossip_mode == "masked":
                mix_matchings_masked(params, self.alpha, self.perms, bits, inplace=True,
                                     nodes=self.nodes)
            elif self.gossip_mode == "static":
                mix_matchings(params, self.alpha, self.perms, self.active,
                              gate_bits=bits if self.faulted else None, inplace=True,
                              nodes=self.nodes)
        self.last_phases = phases
        return params, opt_state, losses, metrics


class DelayedLaunch:
    """The overlap mode's launch of the delayed exchange over the
    in-flight ``GossipState`` buffers, shared by the replicated
    :class:`OverlapStep` and the sharded ``repro_torch.dist.fsdp`` step:
    on the card on a side CUDA stream that waits for the snapshot alone,
    timed by CUDA events there; on the CPU in order, by the host clock.
    The step class supplies ``perms``, ``nodes`` and ``alpha``."""

    def _init_launch(self, timer, num_buckets: int) -> None:
        self.num_buckets = num_buckets
        self.launch_timer = timer if timer is not None and timer.enabled else None
        self.last_launch_ms = None
        self._side = {}          # device -> (side stream, permutations on it)
        self._pending = []       # launches whose events have not been read

    def _anchor(self, device):
        """Read the finished launches and, with a timer, an event on the
        main stream that places this step's launch on the host clock."""
        if device.type != "cuda":
            return None
        self.record_launch_spans()
        if not self.launch_timer:
            return None
        ref = torch.cuda.Event(enable_timing=True)
        anchor = (self.launch_timer.recorder.now_us(), ref)
        ref.record()
        return anchor

    def _launch(self, gstate: GossipState, bits, device, step: int, anchor) -> None:
        with torch.no_grad():
            if device.type == "cuda":
                self._launch_cuda(gstate, bits, device, step, anchor)
            else:
                self._launch_cpu(gstate, bits, step)

    def record_launch_spans(self, *, wait: bool = False) -> None:
        """Read the timing of every finished launch (every one, waiting
        for the host, with ``wait``) into ``last_launch_ms`` and, with a
        timer, the trace."""
        keep = []
        for step, anchor, start, done in self._pending:
            if not wait and not done.query():
                keep.append((step, anchor, start, done))
                continue
            done.synchronize()
            # the start on the host clock: the anchor's host time plus the
            # card's time from the anchor event to the launch
            ts_us = anchor[0] + anchor[1].elapsed_time(start) * 1e3 if anchor else 0.0
            self._finished(step, ts_us, start.elapsed_time(done))
        self._pending = keep

    def _finished(self, step: int, ts_us: float, ms: float) -> None:
        self.last_launch_ms = ms
        if self.launch_timer:
            self.launch_timer.record(TraceEvent(
                name="gossip_launch", cat="comm", ts_us=ts_us, dur_us=ms * 1e3,
                step=step, pid=self.launch_timer.pid, tid=1,
                args={"buckets": self.num_buckets},
            ))

    def _launch_cpu(self, gstate: GossipState, bits, step: int) -> None:
        ts_us = self.launch_timer.recorder.now_us() if self.launch_timer else 0.0
        t0 = time.perf_counter()
        delayed_delta_inplace(gstate.delta, bits, self.perms, nodes=self.nodes)
        gstate.done = None
        self._finished(step, ts_us, (time.perf_counter() - t0) * 1e3)

    def _launch_cuda(self, gstate: GossipState, bits, device, step: int,
                     anchor) -> None:
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
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side):
            start.record(side)
            # over data ranks the exchange plans its own index; its
            # send/recv handles make the side stream wait, not the main one
            delayed_delta_inplace(gstate.delta, bits,
                                  idx if self.nodes is None else self.perms,
                                  nodes=self.nodes)
            done.record(side)
        gstate.done = done
        self._pending.append((step, anchor, start, done))

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

    Each launch is timed: by CUDA events on the side stream on the card
    (read by ``record_launch_spans`` once they completed; the newest in
    ``last_launch_ms``), by the host clock on the CPU. An enabled
    ``timer`` records each as one ``gossip_launch`` event (cat ``comm``,
    tid 1), placed on the host clock through an event recorded on the
    main stream as the step starts: exact when the card is idle then,
    as it is after a fenced step. Nothing is fenced for it.
    """

    def __init__(self, model, opt: Optimizer, plan, *, bucket_plan,
                 grad_clip: float, faulted: bool, timer=None,
                 spec: Optional[DistSpec] = None):
        super().__init__(model, opt, plan, gossip_mode="overlap", active=(),
                         grad_clip=grad_clip, faulted=faulted, spec=spec)
        self.bplan = bucket_plan
        self._init_launch(timer, bucket_plan.num_buckets)

    def __call__(self, params, opt_state, gstate: GossipState, batch, bits, *,
                 step: int = -1):
        self._check_bits(bits)
        device = tree_leaves(params)[0].device
        anchor = self._anchor(device)
        phases = PhaseTimes(device)
        with phases.span("gossip_apply"), torch.no_grad():
            gstate.wait()
            _apply_delayed(params, gstate.delta, self.bplan, self.alpha, inplace=True)
            bucketing.ravel_stacked(self.bplan, params, out=gstate.delta)
        self._launch(gstate, bits, device, step, anchor)
        losses, metrics = self._every_node(params, opt_state, batch, phases)
        self.last_phases = phases
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
    package: fp32 rounding apart). ``timer`` (a ``StepTimer``) fences and
    records the phases of a sequential step (``make_phased_train_step``)
    and records an overlap step's launches without fencing anything.
    ``spec``: the run's mesh when its nodes span several data ranks."""
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


def make_phased_train_step(
    model,
    opt: Optimizer,
    plan,
    *,
    timer=None,
    gossip_mode: str = "masked",
    active: Sequence[int] = (),
    grad_clip: float = 0.0,
    faulted: bool = False,
    spec: Optional[DistSpec] = None,
) -> TrainStep:
    """Telemetry variant of :func:`make_train_step`: the same update, with
    every fwd_bwd, optimizer (one each per node) and gossip span fenced
    (``torch.cuda.synchronize``) so the host clock attributes wall time
    per phase, and recorded into ``timer`` (``None`` times without
    recording). Same call as the sequential step, with ``step=k``; after
    each call ``step.last_phase_ms`` holds the phase-name ->
    milliseconds dict of that call, and its results are bit-equal to the
    unphased step's.

    The fences cost the overlap of host and card at every boundary, so
    this step is built only when ``--trace`` is on. ``overlap`` mode is
    refused: fencing its phases would serialize the very overlap being
    measured; overlap runs are timed whole-step, with per-matching probes
    and the launch's own span.
    """
    if gossip_mode == "sequential":
        gossip_mode = "masked"
    if gossip_mode not in ("masked", "static", "none"):
        raise ValueError(
            "make_phased_train_step supports gossip_mode in "
            f"('masked', 'static', 'none'); got {gossip_mode!r} "
            "(overlap runs are timed whole-step: fencing phases would "
            "serialize the overlap being measured)"
        )
    return make_train_step(model, opt, plan, gossip_mode=gossip_mode,
                           active=active, grad_clip=grad_clip, faulted=faulted,
                           timer=timer or StepTimer(), spec=spec)
