"""The analytic byte model: the port's copy of ``repro.analysis.bytes_model``.

The training CLI's ``--trace`` takes each step's modeled gossip bytes
from ``tree_storage_bytes``. The formulas are the JAX package's;
``fsdp_bytes_rows``, which builds the FSDP bucket layouts of a smoke
model, is not copied: it waits for the port of the FSDP runtime
(ROADMAP queue 1, item 15).

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
