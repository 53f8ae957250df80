"""Param tree <-> contiguous fp32 gossip buckets.

The port of ``repro.dist.bucketing`` (the byte-target layout the overlap
gossip mode runs on). Bucketing flattens the float leaves of a
parameter tree into a few large contiguous fp32 buffers, greedily filled
to a byte target, a leaf never split across two buckets: the overlap
step exchanges one buffer per (matching, bucket) instead of one per
(matching, leaf).

Leaf order is the JAX package's: ``jax.tree.flatten`` visits each dict
level in sorted key order, where ``repro_torch.tree`` keeps insertion
order. ``plan_buckets`` sorts per dict level, so its ``bucket_sizes``,
``leaf_bucket`` and ``leaf_offset`` equal the JAX plan's field for
field, and ``treedef`` holds each leaf's key path in that order.

A tree's leaves are tensors, numpy arrays or the ``(shape, dtype)``
pairs of ``Model.param_shapes()`` (only the shape and dtype are read).
``pad_to=S`` rounds every bucket up to a multiple of S (zero tail), the
layout contract of the FSDP runtime. ``ravel_stacked`` /
``unravel_stacked`` are the node-stacked variants: every leaf carries a
leading node dim and a bucket is ``(nodes, bucket_size)`` fp32, the
layout of the overlap step's in-flight ``GossipState``.

The FSDP pieces (``repro_torch.dist.fsdp``), as in the JAX package:
``shard_buckets`` / ``unshard_buckets`` split a bucket into S equal
contiguous shards and back; ``plan_group_buckets`` builds a
``GroupedPlan``, one single-bucket plan per layer group in execution
order (the streamed layouts). With ``scan_aware=True`` a scanned or
periodic group's plan describes ONE layer row (the leading ``repeats``
dim stripped) and its bucket holds the ``repeats`` rows in shard-major
order: the flat bucket is the logical ``(S, repeats, per_layer // S)``
array, so the resident shard s is the ``(repeats, per_layer // S)``
stack of every row's s-th piece and an all-gather of one resident row
rebuilds that layer's ``(per_layer,)`` bucket in plan order.
``rows_to_shard_major`` / ``rows_from_shard_major`` are that
permutation; ``scan_ravel*`` / ``scan_unravel*`` compose it with the
per-layer plan.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

PyTree = Any
KeyPath = Tuple[str, ...]

DEFAULT_TARGET_BYTES = 4 << 20   # 4 MiB of fp32 per bucket

# Checker declarations (``repro_torch.analysis.checks``): bucketing issues
# no collective; its ravels widen leaves into the fp32 buckets.
COLLECTIVE_CONTRACT: dict = {}
FP32_UPCAST_SITES = (
    "ravel",
    "ravel_stacked",
)


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Static layout: which slice of which bucket each float leaf owns.

    ``treedef`` is the key path of every leaf, in the JAX package's leaf
    order. Non-float leaves (step counters) take no bucket space: their
    ``leaf_bucket``/``leaf_offset`` entries are -1 and ``unravel``
    returns ``None`` in their positions.
    """

    treedef: Tuple[KeyPath, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    is_float: Tuple[bool, ...]
    leaf_bucket: Tuple[int, ...]      # -1 for non-float leaves
    leaf_offset: Tuple[int, ...]      # -1 for non-float leaves
    bucket_sizes: Tuple[int, ...]     # elements (fp32) per bucket

    @property
    def num_buckets(self) -> int:
        return len(self.bucket_sizes)

    @property
    def total_elements(self) -> int:
        return sum(self.bucket_sizes)


def _flatten(tree: PyTree, prefix: KeyPath = ()) -> Iterator[Tuple[KeyPath, Any]]:
    """``(key path, leaf)`` in ``jax.tree.flatten`` order: each dict
    level sorted by key."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _leaf_meta(leaf) -> Tuple[Tuple[int, ...], bool]:
    """(shape, is floating point) of a tensor, array or (shape, dtype)."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.is_floating_point()
    if isinstance(leaf, tuple) and len(leaf) == 2 and isinstance(leaf[1], torch.dtype):
        return tuple(int(d) for d in leaf[0]), leaf[1].is_floating_point
    arr = np.asarray(leaf)
    return tuple(arr.shape), np.issubdtype(arr.dtype, np.floating)


def _leaf_size(shape: Tuple[int, ...]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def unflatten(paths: Tuple[KeyPath, ...], leaves) -> PyTree:
    """Nested dicts from key paths (a plan's ``treedef``) and leaves."""
    if len(paths) == 1 and paths[0] == ():
        return leaves[0]
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def plan_buckets(
    tree: PyTree,
    *,
    target_bytes: Optional[int] = DEFAULT_TARGET_BYTES,
    pad_to: int = 1,
) -> BucketPlan:
    """Greedy contiguous packing of the float leaves of ``tree``.

    A leaf opens a new bucket whenever appending it would push the
    current bucket past ``target_bytes`` of fp32, so no bucket exceeds
    the target unless a single leaf does; an oversized leaf gets a
    bucket of its own rather than being split. ``target_bytes=None``
    packs every float leaf into one bucket. ``pad_to`` rounds every
    bucket size up to a multiple (zero-padded at the tail by ``ravel``).
    """
    if target_bytes is not None and target_bytes <= 0:
        raise ValueError(f"target_bytes must be positive, got {target_bytes}")
    if pad_to < 1:
        raise ValueError(f"pad_to must be >= 1, got {pad_to}")
    target_elems = None if target_bytes is None else max(1, target_bytes // 4)

    paths, shapes, is_float, leaf_bucket, leaf_offset = [], [], [], [], []
    bucket_sizes: list = []
    fill = 0                       # elements in the currently-open bucket
    for path, leaf in _flatten(tree):
        shape, floaty = _leaf_meta(leaf)
        paths.append(path)
        shapes.append(shape)
        is_float.append(floaty)
        if not floaty:
            leaf_bucket.append(-1)
            leaf_offset.append(-1)
            continue
        size = _leaf_size(shape)
        overflow = target_elems is not None and fill > 0 and fill + size > target_elems
        if not bucket_sizes or overflow:
            bucket_sizes.append(0)
            fill = 0
        leaf_bucket.append(len(bucket_sizes) - 1)
        leaf_offset.append(fill)
        bucket_sizes[-1] += size
        fill += size
    if pad_to > 1:
        bucket_sizes = [-(-s // pad_to) * pad_to for s in bucket_sizes]
    return BucketPlan(
        treedef=tuple(paths),
        shapes=tuple(shapes),
        is_float=tuple(is_float),
        leaf_bucket=tuple(leaf_bucket),
        leaf_offset=tuple(leaf_offset),
        bucket_sizes=tuple(bucket_sizes),
    )


def _leaves(plan: BucketPlan, tree: PyTree, lead: int = 0) -> list:
    """The leaves of ``tree`` in plan order, checked against the plan's
    key paths and shapes (past ``lead`` leading dims)."""
    items = list(_flatten(tree))
    if tuple(path for path, _ in items) != plan.treedef:
        raise ValueError(
            f"tree structure {[p for p, _ in items]} does not match the bucket "
            f"plan's {list(plan.treedef)}"
        )
    leaves = [leaf for _, leaf in items]
    for leaf, shape in zip(leaves, plan.shapes):
        if tuple(leaf.shape[lead:]) != shape:
            raise ValueError(
                f"leaf shape {tuple(leaf.shape)} does not match planned shape {shape}"
            )
    return leaves


def leaf_slices(plan: BucketPlan, buckets):
    """``(leaf index, bucket, offset, size)`` of every float leaf, in
    plan order: where ``ravel`` puts each leaf."""
    for i, (shape, floaty, b, off) in enumerate(
        zip(plan.shapes, plan.is_float, plan.leaf_bucket, plan.leaf_offset)
    ):
        if floaty:
            yield i, buckets[b], off, _leaf_size(shape)


def ravel(plan: BucketPlan, tree: PyTree) -> Tuple[torch.Tensor, ...]:
    """Pack the float leaves of ``tree`` into fp32 buckets, each a
    contiguous 1-D ``(bucket_size,)`` tensor in plan order (zero-padded
    at the tail for a ``pad_to`` plan)."""
    leaves = _leaves(plan, tree)
    parts: list = [[] for _ in range(plan.num_buckets)]
    for leaf, floaty, b in zip(leaves, plan.is_float, plan.leaf_bucket):
        if floaty:
            parts[b].append(leaf.reshape(-1).float())
    out = []
    for p, size in zip(parts, plan.bucket_sizes):
        filled = sum(t.numel() for t in p)
        if filled < size:
            p.append(p[0].new_zeros(size - filled))
        out.append(torch.cat(p))      # a fresh buffer, never a view of a leaf
    return tuple(out)


def unravel(
    plan: BucketPlan,
    buckets: Tuple[torch.Tensor, ...],
    like: Optional[PyTree] = None,
) -> PyTree:
    """Inverse of ``ravel``: the buckets sliced back into leaf shapes.

    Float leaves come back fp32 views of the buckets (no cast to the
    original dtype). Non-float positions are filled from ``like`` when
    given, else ``None``."""
    _check_buckets(plan, buckets, stacked=False)
    like_leaves = _leaves(plan, like) if like is not None else None
    out = [like_leaves[i] if like_leaves is not None else None
           for i in range(len(plan.shapes))]
    for i, bkt, off, size in leaf_slices(plan, buckets):
        out[i] = bkt[off:off + size].view(plan.shapes[i])
    return unflatten(plan.treedef, out)


def _check_buckets(plan: BucketPlan, buckets, *, stacked: bool) -> None:
    if len(buckets) != plan.num_buckets:
        raise ValueError(f"got {len(buckets)} buckets, plan has {plan.num_buckets}")
    for bkt, size in zip(buckets, plan.bucket_sizes):
        ok = (bkt.dim() == 2 and bkt.shape[1] == size) if stacked else \
            tuple(bkt.shape) == (size,)
        if not ok:
            want = f"(nodes, {size})" if stacked else f"({size},)"
            raise ValueError(
                f"bucket shape {tuple(bkt.shape)} does not match planned {want}"
            )


def ravel_stacked(
    plan: BucketPlan, tree: PyTree, out: Optional[Tuple[torch.Tensor, ...]] = None
) -> Tuple[torch.Tensor, ...]:
    """``ravel`` for node-stacked trees: every leaf carries a leading node
    dim; buckets come back ``(nodes, bucket_size)`` fp32. With ``out``
    the buckets are written into those tensors instead (the in-place
    snapshot of the overlap step)."""
    leaves = _leaves(plan, tree, lead=1)
    floats = [leaf for leaf, f in zip(leaves, plan.is_float) if f]
    nums = {int(leaf.shape[0]) for leaf in leaves}
    if len(nums) > 1:
        raise ValueError("inconsistent leading node dim across leaves")
    n = nums.pop() if nums else 0
    device = floats[0].device if floats else None
    if out is None:
        out = tuple(torch.empty((n, s), dtype=torch.float32, device=device)
                    for s in plan.bucket_sizes)
    else:
        _check_buckets(plan, out, stacked=True)
    filled = [0] * plan.num_buckets
    for i, bkt, off, size in leaf_slices(plan, out):
        bkt[:, off:off + size].copy_(leaves[i].reshape(n, size))
        b = plan.leaf_bucket[i]
        filled[b] = max(filled[b], off + size)
    for bkt, end in zip(out, filled):
        if end < bkt.shape[1]:
            bkt[:, end:].zero_()
    return out


def unravel_stacked(
    plan: BucketPlan,
    buckets: Tuple[torch.Tensor, ...],
    like: Optional[PyTree] = None,
) -> PyTree:
    """Inverse of ``ravel_stacked``: ``(nodes, bucket_size)`` buckets back
    to a node-stacked tree (float leaves fp32; non-float positions from
    ``like`` when given, else ``None``)."""
    _check_buckets(plan, buckets, stacked=True)
    like_leaves = _leaves(plan, like, lead=1) if like is not None else None
    out = [like_leaves[i] if like_leaves is not None else None
           for i in range(len(plan.shapes))]
    for i, bkt, off, size in leaf_slices(plan, buckets):
        n = bkt.shape[0]
        out[i] = bkt[:, off:off + size].reshape((n,) + plan.shapes[i])
    return unflatten(plan.treedef, out)


# ---------------------------------------------------------------------------
# Shard slicing (FSDP layout helpers)
# ---------------------------------------------------------------------------
def shard_buckets(
    buckets: Tuple[torch.Tensor, ...], num_shards: int
) -> Tuple[torch.Tensor, ...]:
    """Split buckets into ``num_shards`` equal contiguous slices along the
    last dim: ``(..., size) -> (..., num_shards, size // num_shards)``
    (views). Requires a plan built with ``pad_to=num_shards``."""
    out = []
    for bkt in buckets:
        if bkt.shape[-1] % num_shards:
            raise ValueError(
                f"bucket of {bkt.shape[-1]} elements does not divide into "
                f"{num_shards} shards: plan with pad_to={num_shards}"
            )
        out.append(bkt.reshape(tuple(bkt.shape[:-1]) + (num_shards, -1)))
    return tuple(out)


def unshard_buckets(shards: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    """Inverse of ``shard_buckets``: merge the trailing ``(shards,
    slice)`` dims back into one bucket dim."""
    return tuple(s.reshape(tuple(s.shape[:-2]) + (-1,)) for s in shards)


# ---------------------------------------------------------------------------
# Layer-grouped buckets (streamed FSDP layouts)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GroupedPlan:
    """An ordered set of named single-bucket plans: bucket i holds the
    whole float subtree of layer group i (one block, the embedding, the
    head, ...), padded shard-divisible. ``repeats[i] > 1`` marks a
    scan-aware group whose plan describes one layer row and whose
    bucket is ``repeats[i]`` shard-major rows."""

    names: Tuple[str, ...]
    plans: Tuple[BucketPlan, ...]
    repeats: Tuple[int, ...] = ()

    def __post_init__(self):
        if len(self.names) != len(self.plans):
            raise ValueError(
                f"{len(self.names)} group names but {len(self.plans)} plans"
            )
        if not self.repeats:
            object.__setattr__(self, "repeats", (1,) * len(self.plans))
        if len(self.repeats) != len(self.plans):
            raise ValueError(
                f"{len(self.repeats)} repeat entries but {len(self.plans)} plans"
            )
        for name, plan, r in zip(self.names, self.plans, self.repeats):
            if plan.num_buckets != 1:
                raise ValueError(
                    f"group {name!r} planned {plan.num_buckets} buckets; "
                    "grouped plans require exactly one bucket per group"
                )
            if r < 1:
                raise ValueError(f"group {name!r} has repeats={r} < 1")

    @property
    def num_buckets(self) -> int:
        return len(self.plans)

    @property
    def per_layer_sizes(self) -> Tuple[int, ...]:
        """Elements gathered per streamed iteration of each group: one
        row for a scan-aware group, the whole bucket otherwise."""
        return tuple(p.bucket_sizes[0] for p in self.plans)

    @property
    def bucket_sizes(self) -> Tuple[int, ...]:
        return tuple(p.bucket_sizes[0] * r for p, r in zip(self.plans, self.repeats))

    @property
    def total_elements(self) -> int:
        return sum(self.bucket_sizes)

    @property
    def max_group_elements(self) -> int:
        """Largest full-size view a streamed step gathers at once (a
        scan-aware group contributes one row, not its stack)."""
        return max(self.per_layer_sizes) if self.plans else 0

    @property
    def max_scan_repeats(self) -> int:
        return max(self.repeats) if self.plans else 0


def _strip_leading(tree: PyTree, repeats: int, name: str) -> PyTree:
    """The ``(shape, dtype)`` tree with the leading scan dim (checked to
    be ``repeats``) removed from every leaf."""
    def strip(leaf):
        if isinstance(leaf, dict):
            return {k: strip(v) for k, v in leaf.items()}
        shape, floaty = _leaf_meta(leaf)
        if not shape or shape[0] != repeats:
            raise ValueError(
                f"scan group {name!r}: leaf shape {shape} does not carry "
                f"the leading repeats={repeats} scan dim"
            )
        dtype = leaf[1] if isinstance(leaf, tuple) else (
            leaf.dtype if isinstance(leaf, torch.Tensor) else
            (torch.float32 if floaty else torch.int32))
        return (shape[1:], dtype)
    return strip(tree)


def plan_group_buckets(
    named_trees,
    *,
    pad_to: int = 1,
    scan_aware: bool = False,
    scan_repeats=None,
) -> GroupedPlan:
    """One bucket per named subtree, in the given (execution) order, each
    packed with ``target_bytes=None`` (one contiguous bucket whatever its
    size). A subtree with no float leaf is rejected. ``scan_aware=True``
    with ``scan_repeats[i] = r > 1`` plans group i per layer (every leaf
    carries a leading ``r`` dim, stripped before planning)."""
    if scan_repeats is not None and len(scan_repeats) != len(named_trees):
        raise ValueError(
            f"{len(scan_repeats)} scan_repeats entries for {len(named_trees)} groups"
        )
    names, plans, repeats = [], [], []
    for gi, (name, sub) in enumerate(named_trees):
        r = 1
        if scan_aware and scan_repeats is not None:
            r = int(scan_repeats[gi] or 1)
        if r > 1:
            sub = _strip_leading(sub, r, str(name))
        plan = plan_buckets(sub, target_bytes=None, pad_to=pad_to)
        if plan.num_buckets != 1:
            raise ValueError(f"layer group {name!r} has no float leaves to bucket")
        names.append(str(name))
        plans.append(plan)
        repeats.append(r)
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate layer-group names in {names}")
    return GroupedPlan(names=tuple(names), plans=tuple(plans), repeats=tuple(repeats))


# ---------------------------------------------------------------------------
# Shard-major scan-row layout (scan-aware streamed FSDP)
# ---------------------------------------------------------------------------
def rows_to_shard_major(rows: torch.Tensor, num_shards: int) -> torch.Tensor:
    """``(..., repeats, per_layer) -> (..., repeats * per_layer)`` in
    shard-major order: contiguous shard slice s of the result is the
    ``(repeats, per_layer // num_shards)`` stack of every row's s-th
    piece (a fresh contiguous tensor)."""
    *lead, r, per = rows.shape
    if per % num_shards:
        raise ValueError(
            f"per-layer row of {per} elements does not divide into "
            f"{num_shards} shards: plan with pad_to={num_shards}"
        )
    x = rows.reshape(tuple(lead) + (r, num_shards, per // num_shards))
    x = x.movedim(-2, -3)                  # (..., S, r, per // S)
    return x.reshape(tuple(lead) + (r * per,))


def rows_from_shard_major(flat: torch.Tensor, repeats: int, num_shards: int) -> torch.Tensor:
    """Inverse of ``rows_to_shard_major``:
    ``(..., repeats * per_layer) -> (..., repeats, per_layer)``."""
    *lead, size = flat.shape
    if size % (repeats * num_shards):
        raise ValueError(
            f"bucket of {size} elements does not factor into "
            f"{repeats} shard-divisible rows"
        )
    per = size // repeats
    x = flat.reshape(tuple(lead) + (num_shards, repeats, per // num_shards))
    x = x.movedim(-3, -2)                  # (..., r, S, per // S)
    return x.reshape(tuple(lead) + (repeats, per))


def scan_ravel(plan: BucketPlan, tree: PyTree, repeats: int, num_shards: int) -> torch.Tensor:
    """A scan-stacked subtree (every leaf ``(repeats, ...)``) as one flat
    shard-major fp32 bucket of ``repeats * per_layer`` elements;
    ``plan`` is the per-layer plan."""
    rows = ravel_stacked(plan, tree)[0]          # (repeats, per_layer)
    return rows_to_shard_major(rows, num_shards)


def scan_unravel(plan: BucketPlan, bucket: torch.Tensor, repeats: int,
                 num_shards: int) -> PyTree:
    """Inverse of ``scan_ravel`` (float leaves fp32, leading ``repeats``
    dim)."""
    rows = rows_from_shard_major(bucket, repeats, num_shards)
    return unravel_stacked(plan, (rows,))


def scan_ravel_stacked(plan: BucketPlan, tree: PyTree, repeats: int,
                       num_shards: int) -> torch.Tensor:
    """Node-stacked ``scan_ravel``: leaves ``(nodes, repeats, ...)`` to a
    ``(nodes, repeats * per_layer)`` shard-major bucket."""
    leaves = [leaf for _, leaf in _flatten(tree)]
    if not leaves:
        raise ValueError("scan group subtree has no leaves")
    nodes = int(leaves[0].shape[0])
    merged = _map_leaves(lambda a: a.reshape((-1,) + tuple(a.shape[2:])), tree)
    rows = ravel_stacked(plan, merged)[0]        # (nodes * repeats, per)
    return rows_to_shard_major(rows.reshape(nodes, repeats, -1), num_shards)


def scan_unravel_stacked(plan: BucketPlan, bucket: torch.Tensor, repeats: int,
                         num_shards: int) -> PyTree:
    """Inverse of ``scan_ravel_stacked``: a ``(nodes, size)`` shard-major
    bucket back to ``(nodes, repeats, ...)`` leaves (fp32)."""
    nodes = int(bucket.shape[0])
    rows = rows_from_shard_major(bucket, repeats, num_shards)
    merged = unravel_stacked(plan, (rows.reshape(nodes * repeats, -1),))
    return _map_leaves(
        lambda a: a.reshape((nodes, repeats) + tuple(a.shape[1:])), merged)


def _map_leaves(fn, tree: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    return fn(tree)
