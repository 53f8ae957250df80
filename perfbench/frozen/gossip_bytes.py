"""Frozen byte counts of the masked gossip, for the kernel's roofline.

``axpy_bytes``: one launch of the gossip-axpy kernel over n elements
reads x and the fp32 target once and writes x once (the port's
``gossip_axpy.cost``).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12       # one H100 SXM, NVIDIA's data sheet


def axpy_bytes(n: int, x_bytes: int = 4, target_bytes: int = 4) -> int:
    return n * (2 * x_bytes + target_bytes)


def axpy_bytes_per_step(leaf_sizes, local_nodes: int, x_bytes: int = 4) -> int:
    """One step's gossip-axpy bytes on a card: a launch a leaf over its
    local nodes' rows."""
    return sum(axpy_bytes(local_nodes * int(n), x_bytes) for n in leaf_sizes)

