"""The analytic byte model: the port's copy of ``repro.analysis.bytes_model``.

The training CLI's ``--trace`` takes each step's modeled gossip bytes
from ``tree_storage_bytes`` (``bucket_plan_bytes`` for a sharded run).
The formulas are the JAX package's; ``fsdp_bytes_rows`` builds the three
FSDP bucket layouts of a model (``repro_torch.dist.fsdp``) from its
parameter shapes, nothing allocated.

Columns (all bytes, fp32 buckets unless noted):

* ``per_device_param_bytes``            resident shard per device:
                                        ``total_elements / S * 4``.
* ``per_matching_comm_bytes``           one matching's ppermute traffic
                                        per device: each bucket's local
                                        slice sent once,
                                        ``4 * sum(size_b / S)``.
* ``peak_transient_bytes_monolithic``   the whole padded replica — the
                                        monolithic layout gathers every
                                        bucket before the fwd.
* ``peak_transient_bytes_streamed``     largest layer group — streamed
                                        layouts gather one group at a
                                        time (and re-gather in the bwd).
* ``peak_transient_bytes_scan_streamed``  largest group under the
                                        scan-aware plan: a scanned
                                        segment's peak is one *layer
                                        row*, not the stack.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "bucket_plan_bytes",
    "fsdp_bytes_row",
    "fsdp_bytes_rows",
    "train_resident_bytes",
    "train_transient_bound",
    "tree_storage_bytes",
]

_FP32_BYTES = 4  # gossip/fsdp buckets are always fp32 (see dist.bucketing)


def tree_storage_bytes(abs_tree) -> int:
    """Storage bytes of a parameter tree, honoring each leaf's dtype.

    This is the replicated runtime's per-matching gossip traffic: the
    masked/static modes exchange every param leaf as stored (bf16 leaves
    move 2 bytes/element, fp32 leaves 4). Leaves are tensors or the
    ``(shape, dtype)`` pairs of ``Model.param_shapes()``.
    """
    from repro_torch.tree import tree_leaves

    total = 0
    for leaf in tree_leaves(abs_tree):
        if isinstance(leaf, tuple):
            shape, dtype = leaf
            total += int(np.prod(shape)) * dtype.itemsize
        else:
            total += leaf.numel() * leaf.element_size()
    return int(total)


def bucket_plan_bytes(bplan, shard: int) -> dict:
    """Per-device resident and per-matching gossip bytes of a bucket plan."""
    return dict(
        per_device_param_bytes=bplan.total_elements // shard * _FP32_BYTES,
        # one matching's ppermute sends each node's local slice of every
        # bucket exactly once (equal to the per-device resident bytes in
        # this design, but accounted per bucket so the two can diverge
        # if the cost model ever does)
        per_matching_comm_bytes=_FP32_BYTES
        * sum(sz // shard for sz in bplan.bucket_sizes),
    )


def fsdp_bytes_row(
    *, bplan, gplan, splan, shard: int, arch: str, raw_param_bytes: int
) -> dict:
    """One artifact row from the three bucket layouts at one shard factor.

    ``bplan`` is the monolithic ``plan_buckets(pad_to=S)`` plan, ``gplan``
    the per-layer-group plan, ``splan`` the scan-aware group plan.
    """
    reps = int(splan.max_scan_repeats)
    row = dict(
        arch=arch,
        shard=int(shard),
        raw_param_bytes=int(raw_param_bytes),
        padded_param_bytes=bplan.total_elements * _FP32_BYTES,
    )
    bp = bucket_plan_bytes(bplan, shard)
    row.update(
        per_device_param_bytes=int(bp["per_device_param_bytes"]),
        per_matching_comm_bytes=int(bp["per_matching_comm_bytes"]),
        # the largest full-size view the fwd/bwd ever materializes
        peak_transient_bytes_monolithic=bplan.total_elements * _FP32_BYTES,
        peak_transient_bytes_streamed=gplan.max_group_elements * _FP32_BYTES,
        # scan-aware plan: a scanned group's peak is one layer row
        peak_transient_bytes_scan_streamed=splan.max_group_elements
        * _FP32_BYTES,
        num_scan_iterations=reps if reps > 1 else 0,
        num_layer_groups=gplan.num_buckets,
    )
    return row


def fsdp_bytes_rows(
    arch: str = "internlm2_1_8b",
    shard_factors=(1, 2, 4),
    *,
    num_layers: int = 0,
    label: str = "",
    cfg=None,
) -> list:
    """Analytic rows for one smoke arch (or ``cfg``) across shard factors,
    from the real bucket layouts (``pad_to=S``) of its parameter shapes.
    ``num_layers`` / ``label`` deepen the config so a scanned stack forms
    and report it under another label."""
    import dataclasses

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.dist import bucketing
    from repro_torch.dist.fsdp import param_group_subtrees
    from repro_torch.models.transformer import Model
    from repro_torch.tree import tree_leaves

    cfg = cfg if cfg is not None else get_smoke_config(arch)
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    model = Model(cfg)
    abs_local = model.param_shapes()
    groups = tuple(model.param_group_specs())
    named_groups = param_group_subtrees(model, abs_local=abs_local, groups=groups)
    scan_repeats = tuple(g.repeats for g in groups)
    raw_bytes = _FP32_BYTES * int(sum(np.prod(s) for s, _ in tree_leaves(abs_local)))
    rows = []
    for s in shard_factors:
        bplan = bucketing.plan_buckets(abs_local, pad_to=s)
        gplan = bucketing.plan_group_buckets(list(named_groups), pad_to=s)
        splan = bucketing.plan_group_buckets(list(named_groups), pad_to=s,
                                             scan_aware=True, scan_repeats=scan_repeats)
        rows.append(fsdp_bytes_row(bplan=bplan, gplan=gplan, splan=splan, shard=int(s),
                                   arch=label or arch, raw_param_bytes=raw_bytes))
    return rows


# ---------------------------------------------------------------------------
# One card's decentralized step (the port's replicated runtime)
# ---------------------------------------------------------------------------
def train_resident_bytes(cfg, *, nodes: int, batch: int, seq: int,
                         gossip_mode: str = "masked") -> int:
    """Bytes that exist before a step: ``nodes`` replicas in their
    storage dtypes, their fp32 SGD velocities and int32 step counters,
    the int32 tokens and labels, and with overlap gossip the in-flight
    fp32 ``GossipState`` (one fp32 copy of every replica)."""
    from repro_torch.models.transformer import Model
    from repro_torch.tree import tree_leaves

    shapes = Model(cfg).param_shapes()
    elems = sum(int(np.prod(s)) for s, _ in tree_leaves(shapes))
    out = nodes * (tree_storage_bytes(shapes) + _FP32_BYTES * elems + 4)
    out += 2 * 4 * nodes * batch * seq
    if gossip_mode == "overlap":
        out += _FP32_BYTES * nodes * elems
    return int(out)


def train_transient_bound(cfg, *, nodes: int, batch: int, seq: int,
                          gossip_mode: str = "masked") -> int:
    """A bound on what a step allocates beyond its resident state: the
    larger of one node's fwd/bwd with its update, and the gossip.

    fwd/bwd and update: four fp32 replicas (the gradients, the updates,
    the new velocities, the updated params before they are copied in),
    per layer 24 fp32 activations of d_model (or of the widest of
    d_model, the FFN and the heads) per token plus 3 fp32 score tensors
    of (heads, seq, seq), and 3 fp32 logits of the padded vocabulary per
    token. Gossip: 3 node-stacked fp32 copies of the largest leaf (the
    delta, a gathered partner, the target), and with overlap 3 blocks of
    ``DELTA_BLOCK`` columns on the side stream as well."""
    from repro_torch.dist.gossip import DELTA_BLOCK
    from repro_torch.models.transformer import Model
    from repro_torch.tree import tree_leaves

    sizes = [int(np.prod(s)) for s, _ in tree_leaves(Model(cfg).param_shapes())]
    tokens = batch * seq
    width = max(cfg.d_model, cfg.d_ff or 0, cfg.moe_d_ff or 0,
                cfg.num_heads * cfg.head_dim if cfg.num_heads else 0,
                2 * cfg.ssm_expand * cfg.d_model if cfg.ssm_state_dim else 0)
    heads = max(cfg.num_heads, 1)
    layers = cfg.num_layers + cfg.encoder_layers
    acts = layers * (24 * tokens * width + 3 * batch * heads * seq * seq) * _FP32_BYTES
    logits = 3 * tokens * cfg.padded_vocab * _FP32_BYTES
    fwd_bwd = 4 * _FP32_BYTES * sum(sizes) + acts + logits
    gossip = 3 * _FP32_BYTES * nodes * max(sizes)
    if gossip_mode == "overlap":
        gossip += 3 * _FP32_BYTES * nodes * min(DELTA_BLOCK, max(sizes))
    return int(max(fwd_bwd, gossip) + (gossip if gossip_mode == "overlap" else 0))

