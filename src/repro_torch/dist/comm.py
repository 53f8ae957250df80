"""The one place that issues the port's collectives.

Every collective of the port (the gossip's paired send/recv, the FSDP
all-gathers and reduce-scatters, the tensor- and sequence-parallel
reductions, the node and consensus sums) goes through the functions
here, over a :class:`Group`: one process group of the mesh
(``repro_torch.launch.mesh``) with the mesh axes it spans. Each call

* records itself into every active recorder (:func:`recording`), with
  its kind (``psum``, ``all_gather``, ``psum_scatter``, ``ppermute``, the
  JAX package's names), axes, dtype, shape and bytes: the inventory that
  ``repro_torch.analysis.collectives`` reads;
* issues the ``torch.distributed`` call over the group's process group;
  or, on a *virtual* group (``pg`` None: one process running one rank's
  view of a mesh on the meta device, the checker's and the dry run's
  lanes), answers it itself, which on meta tensors means only giving
  outputs their shapes.

Transport. NCCL takes every call on CUDA tensors. Gloo takes
``all_reduce`` of CUDA tensors, but not its all-gather, reduce-scatter or
send/recv, so on a gloo group those move through host copies: the call
is still the collective it is (recorded as such), the host only carries
its bytes. This is how ranks that share one card run sequence parallel,
kv-seq-sharded serving and the gossip; the compute stays on the card.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Any, List, Optional, Sequence, Tuple

import torch

KINDS = ("ppermute", "all_gather", "psum_scatter", "psum")


@dataclasses.dataclass(frozen=True)
class Group:
    """One instance of a mesh axis (or of several, ``("pod", "data")``):
    its global ``ranks`` in order, this rank's ``index`` among them, and
    the process group (``None`` on a virtual mesh)."""

    axes: Tuple[str, ...]
    ranks: Tuple[int, ...]
    index: int
    pg: Any = None

    @property
    def size(self) -> int:
        return len(self.ranks)


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Call:
    """One collective as this rank issued it. ``pairs``: a ppermute's
    ``(src, dst)`` node pairs this rank sends on (each rank records its
    own; ``collectives.join`` unites the ranks' views)."""

    kind: str
    axes: Tuple[str, ...]
    dtype: str
    shape: Tuple[int, ...]
    bytes: int
    pairs: Optional[Tuple[Tuple[int, int], ...]]
    source: Tuple[str, str, int]
    ops: int            # c10d ops issued (0 when answered on a virtual group)


_RECORDERS: List[List[Call]] = []       # global: autograd's backward runs on its own thread
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HERE = os.path.abspath(__file__)
_ANALYSIS = os.path.join(_PKG, "analysis") + os.sep


class recording:
    """``with recording() as calls:`` appends every collective issued
    inside, on any thread, to ``calls``."""

    def __enter__(self) -> List[Call]:
        self.calls: List[Call] = []
        _RECORDERS.append(self.calls)
        return self.calls

    def __exit__(self, *exc):
        _RECORDERS.remove(self.calls)
        return False


def _source() -> Tuple[str, str, int]:
    """The innermost frame of the port outside this module and the
    analysis package (which records steps and issues nothing)."""
    f = sys._getframe(2)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path != _HERE and path.startswith(_PKG) and not path.startswith(_ANALYSIS):
            return (path, f.f_code.co_name, f.f_lineno)
        f = f.f_back
    return ("", "", 0)


def _record(kind: str, group: Group, t: torch.Tensor, pairs=None, nbytes=None,
            ops: int = 1) -> None:
    if not _RECORDERS:
        return
    call = Call(kind, tuple(group.axes), str(t.dtype).replace("torch.", ""),
                tuple(t.shape), int(t.numel() * t.element_size() if nbytes is None else nbytes),
                None if pairs is None else tuple(pairs), _source(),
                0 if group.pg is None else ops)
    for calls in _RECORDERS:
        calls.append(call)


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------
def _answer(group: Group, *tensors: torch.Tensor) -> bool:
    """True when ``group`` is virtual: the call is answered here, which
    only meta tensors allow (they hold no values)."""
    if group.pg is not None:
        return False
    if any(t.device.type != "meta" for t in tensors):
        raise RuntimeError(f"a virtual {group.axes} group answers collectives on meta "
                           "tensors only; a world of ranks needs a process group")
    return True


def _via_host(group: Group, t: torch.Tensor) -> bool:
    """Gloo carries this CUDA tensor through a host copy."""
    if t.device.type != "cuda":
        return False
    import torch.distributed as dist

    return dist.get_backend(group.pg) == "gloo"


def _collective(name: str):
    """``all_gather_single`` / ``reduce_scatter_single`` where torch has
    them (newer releases deprecate ``all_gather_into_tensor`` /
    ``reduce_scatter_tensor``), else the older names."""
    import torch.distributed as dist

    old = {"all_gather_single": "all_gather_into_tensor",
           "reduce_scatter_single": "reduce_scatter_tensor"}[name]
    return getattr(dist, name, None) or getattr(dist, old)


def all_reduce(t: torch.Tensor, group: Optional[Group], op: str = "sum") -> torch.Tensor:
    """``t`` reduced over ``group`` in place (``op``: sum or max);
    identity without a group."""
    if group is None:
        return t
    _record("psum", group, t)
    if _answer(group, t):
        return t
    import torch.distributed as dist

    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
                    group=group.pg)
    return t


class _Done:
    def wait(self):
        return None


def all_gather(out: torch.Tensor, t: torch.Tensor, group: Group, *, async_op: bool = False):
    """The ranks' ``t`` concatenated along dim 0 into ``out`` (sized
    ``group.size`` times ``t``), in rank order. Returns a work handle with
    ``async_op`` (already done when the host carries the bytes)."""
    _record("all_gather", group, out)
    if _answer(group, out, t):
        return _Done() if async_op else None
    gather = _collective("all_gather_single")
    if _via_host(group, t):
        host = out.new_empty(out.shape, device="cpu")
        gather(host, t.contiguous().cpu(), group=group.pg)
        out.copy_(host)
        return _Done() if async_op else None
    return gather(out, t.contiguous(), group=group.pg, async_op=async_op)


def reduce_scatter(out: torch.Tensor, t: torch.Tensor, group: Group) -> torch.Tensor:
    """``t`` summed over ``group``, this rank's ``1 / size`` of dim 0
    into ``out``."""
    _record("psum_scatter", group, t)
    if _answer(group, out, t):
        return out
    scatter = _collective("reduce_scatter_single")
    if _via_host(group, t):
        host = out.new_empty(out.shape, device="cpu")
        scatter(host, t.contiguous().cpu(), group=group.pg)
        return out.copy_(host)
    scatter(out, t.contiguous(), group=group.pg)
    return out


def exchange(sends: Sequence[Tuple[int, torch.Tensor]], group: Group,
             pairs: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """One matching's exchange: to each ``(peer, tensor)`` (peer a global
    rank of ``group``) send ``tensor`` and receive one of its shape back,
    as one ``batch_isend_irecv``. ``pairs``: the ``(src, dst)`` node pairs
    the sends carry (the record's permutation). Every rank of the group
    calls it once a matching, with no sends when none of its nodes has a
    partner elsewhere."""
    recvs = [torch.empty_like(t) for _, t in sends]
    nbytes = sum(t.numel() * t.element_size() for _, t in sends)
    like = sends[0][1] if sends else torch.empty(0)
    _record("ppermute", group, like, pairs=pairs, nbytes=nbytes, ops=2 * len(sends))
    if not sends or _answer(group, *(t for _, t in sends)):
        return recvs
    import torch.distributed as dist

    host = _via_host(group, sends[0][1])
    bufs = [(t.cpu() if host else t.contiguous(), r.new_empty(r.shape, device="cpu")
             if host else r) for (_, t), r in zip(sends, recvs)]
    ops = []
    for (peer, _), (send, recv) in zip(sends, bufs):
        ops += [dist.P2POp(dist.isend, send, peer, group.pg),
                dist.P2POp(dist.irecv, recv, peer, group.pg)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()         # the current stream waits (the side stream in overlap)
    if host:
        for r, (_, recv) in zip(recvs, bufs):
            r.copy_(recv)
    return recvs
