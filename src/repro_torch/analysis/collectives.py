"""Structured inventory of the collectives a step issues.

The port's counterpart of ``repro.analysis.collectives``. The JAX package
folds a traced jaxpr into one :class:`CollectiveRecord` per ``ppermute``
/ ``all_gather`` / ``psum_scatter`` / ``psum`` equation. The port has no
jaxpr: its collectives are explicit calls, every one issued through
``repro_torch.dist.comm``, which records each call as the step's real
code makes it (:func:`collect` runs the step). The kinds are JAX's:

* ``psum``          an all-reduce (``c10d.allreduce_``), operand bytes;
* ``all_gather``    ``c10d._allgather_base_``, sized by its *output*;
* ``psum_scatter``  ``c10d._reduce_scatter_base_``, operand bytes;
* ``ppermute``      one matching's exchange: the paired ``c10d.send`` /
                    ``c10d.recv_`` of every rank of the node axes, with
                    the ``(src, dst)`` node pairs; bytes are what one rank
                    sends.

A step runs as one rank. In a world of ranks (:func:`collect` with
``c10d=True``) a ``TorchDispatchMode`` also counts the c10d ops the
backend receives, and the inventory must account for every one of them:
no collective bypasses ``comm``. On a virtual mesh
(``repro_torch.launch.mesh.virtual_mesh``) the same step runs one rank's
view on meta tensors, in one process (``analysis.check.run_views`` runs
each rank's view in turn), and :func:`join` unites the views of one
node-axes group,
so a ``ppermute`` record carries the whole permutation, as the JAX
package's SPMD trace does. ``axes`` are the mesh axes of the group;
``source`` is the innermost frame of the port that issued the call.
"""
from __future__ import annotations

import collections
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.dist import comm

__all__ = ["COLLECTIVE_KINDS", "CollectiveRecord", "C10dCounter", "collect", "join",
           "inventory", "ppermute_totals"]

COLLECTIVE_KINDS = comm.KINDS

# the c10d op each kind reaches the backend as
_C10D_TO_KIND = {
    "allreduce_": "psum",
    "_allgather_base_": "all_gather",
    "_reduce_scatter_base_": "psum_scatter",
    "send": "ppermute",
    "recv_": "ppermute",
}


@dataclass(frozen=True)
class CollectiveRecord:
    kind: str  # one of COLLECTIVE_KINDS
    axes: tuple  # mesh axis names the collective runs over
    dtype: str
    shape: tuple  # the shape the byte count is derived from
    bytes: int  # bytes per rank per execution (see module doc)
    scan_trips: int  # executions per step call (1: the port loops in Python)
    in_manual: bool  # per-rank shapes (always: the port's steps are per rank)
    perm: tuple | None  # ppermute only: ((src, dst), ...) node pairs
    path: tuple  # enclosing primitive names (none: no jaxpr)
    source: tuple  # innermost port frame (file, function, line), or ()

    def to_json(self) -> dict:
        return {
            "kind": self.kind,
            "axes": list(self.axes),
            "dtype": self.dtype,
            "shape": list(self.shape),
            "bytes": self.bytes,
            "scan_trips": self.scan_trips,
            "in_manual": self.in_manual,
            "perm": [list(p) for p in self.perm] if self.perm is not None else None,
            "path": list(self.path),
            "source": list(self.source) if self.source else None,
        }


def _record(call: comm.Call) -> CollectiveRecord:
    return CollectiveRecord(
        kind=call.kind, axes=tuple(call.axes), dtype=call.dtype, shape=tuple(call.shape),
        bytes=int(call.bytes), scan_trips=1, in_manual=True,
        perm=tuple(sorted(call.pairs)) if call.kind == "ppermute" else None,
        path=(), source=tuple(call.source) if call.source[0] else (),
    )


class C10dCounter(TorchDispatchMode):
    """Count the c10d ops the backend receives, by record kind (a send and
    its recv count once each)."""

    def __init__(self):
        super().__init__()
        self.ops: Dict[str, int] = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket.__name__)
        if func.namespace == "c10d" and name in _C10D_TO_KIND:
            self.ops[name] += 1
        return func(*args, **(kwargs or {}))


def collect(step: Callable, *args: Any, c10d: bool = False,
            **kwargs: Any) -> List[CollectiveRecord]:
    """Run ``step(*args, **kwargs)`` as this rank and inventory every
    collective it issues. ``c10d``: also count the c10d ops the backend
    receives (a world of ranks) and raise unless ``comm`` issued every
    one of them."""
    counter = C10dCounter() if c10d else None
    with comm.recording() as calls:
        if counter is None:
            step(*args, **kwargs)
        else:
            with counter:
                step(*args, **kwargs)
    if counter is not None:
        want = collections.Counter()
        for call in calls:
            if call.kind == "ppermute":
                want["send"] += call.ops // 2
                want["recv_"] += call.ops // 2
            else:
                want[{"psum": "allreduce_", "all_gather": "_allgather_base_",
                      "psum_scatter": "_reduce_scatter_base_"}[call.kind]] += call.ops
        if +want != +counter.ops:
            raise RuntimeError(f"c10d ops {dict(counter.ops)} do not match the collectives "
                               f"issued through repro_torch.dist.comm {dict(want)}")
    return [_record(c) for c in calls]


def join(views: Sequence[List[CollectiveRecord]]) -> List[CollectiveRecord]:
    """One inventory from the views of the ranks of one node-axes group
    (views[0] first): the k-th ``ppermute`` of every view is one
    exchange, whose permutation is the union of the views' pairs and
    whose bytes the largest any rank sends; the other records are
    views[0]'s (every rank issues the same ones). Exchanges no rank
    sends on are dropped."""
    out: List[CollectiveRecord] = []
    perms = [[r for r in v if r.kind == "ppermute"] for v in views]
    if len({len(p) for p in perms}) > 1:
        raise ValueError(f"the views issue {[len(p) for p in perms]} exchanges: they are "
                         "not one step's ranks")
    k = 0
    for r in views[0]:
        if r.kind != "ppermute":
            out.append(r)
            continue
        parts = [p[k] for p in perms]
        k += 1
        pairs = tuple(sorted(set(pair for p in parts for pair in p.perm)))
        if not pairs:
            continue
        big = max(parts, key=lambda p: p.bytes)
        out.append(CollectiveRecord(
            kind="ppermute", axes=r.axes, dtype=big.dtype, shape=big.shape, bytes=big.bytes,
            scan_trips=r.scan_trips, in_manual=r.in_manual, perm=pairs, path=r.path,
            source=r.source))
    return out


def inventory(records: Sequence[CollectiveRecord]) -> Dict[tuple, int]:
    """``(kind, axes, dtype, bytes) -> count``: what two inventories of
    one rank are compared on, op for op."""
    return dict(collections.Counter((r.kind, tuple(r.axes), r.dtype, int(r.bytes))
                                    for r in records))


def ppermute_totals(records: list) -> dict:
    """Total ppermute bytes per distinct permutation.

    Distinct matchings produce distinct permutations, so grouping by the
    ``(src, dst)`` pair tuple recovers per-matching link traffic even
    when one matching's exchange is split across many buckets.
    """
    totals: dict = {}
    for r in records:
        if r.kind != "ppermute":
            continue
        totals[r.perm] = totals.get(r.perm, 0) + r.bytes * r.scan_trips
    return totals


def source_module(record: CollectiveRecord) -> Optional[str]:
    """The port module (``dist.fsdp``, ``models.tp``, ...) that issued a
    record, or None."""
    if not record.source:
        return None
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rel = os.path.relpath(os.path.abspath(record.source[0]), pkg)
    return os.path.splitext(rel)[0].replace(os.sep, ".")
