"""Node and shard counts of a mesh: the one authority every layer asks.

The port of ``repro.dist.sharding::num_nodes, num_shards``. On the
port's mesh (``repro_torch.launch.mesh.Mesh``) the nodes are stacked
per data rank, so the node count is the run's, checked against the
mesh: it must split evenly over the data ranks. The JAX package's
``pod`` axis and its logical-axis rules (tensor parallel) are not
ported (ROADMAP queue 1, item 15).
"""
from __future__ import annotations

from typing import Tuple


def num_nodes(mesh, nodes: int, *, multi_pod: bool = False) -> int:
    """``nodes``, checked against ``mesh``: a multi-pod run and a node
    count that does not split over the data ranks raise."""
    if multi_pod:
        raise ValueError(
            "multi_pod=True but the port's mesh has no 'pod' axis (ROADMAP "
            "queue 1, item 15)")
    if nodes < 1 or nodes % mesh.data:
        raise ValueError(
            f"{nodes} nodes do not split evenly over {mesh.data} data ranks")
    return int(nodes)


def num_shards(mesh) -> int:
    """FSDP shard count of ``mesh``: the size of its ``shard`` axis."""
    return int(mesh.shard)


def node_range(mesh, nodes: int) -> Tuple[int, int]:
    """``(lo, hi)``: the consecutive nodes this rank's data rank holds."""
    per = num_nodes(mesh, nodes) // mesh.data
    lo = mesh.data_rank * per
    return lo, lo + per


def collective(name: str):
    """``torch.distributed``'s ``all_gather_single`` /
    ``reduce_scatter_single`` where torch has them (newer releases
    deprecate the ``all_gather_into_tensor`` / ``reduce_scatter_tensor``
    spellings), else the older names: the same collectives."""
    import torch.distributed as dist

    old = {"all_gather_single": "all_gather_into_tensor",
           "reduce_scatter_single": "reduce_scatter_tensor"}[name]
    return getattr(dist, name, None) or getattr(dist, old)
