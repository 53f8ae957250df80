"""Invariant checkers over collective inventories and the steps' ops.

The port of ``repro.analysis.checks``. Each checker returns a list of
:class:`Violation` records (empty = clean) instead of raising, so the
CLI (``repro_torch.analysis.check``) can run every check on every
execution strategy and emit one JSON report. The expectations come from
the declarations the port's modules export (``COLLECTIVE_CONTRACT``,
``FP32_UPCAST_SITES``) and from the plan (``MatchaPlan.ppermute_pairs``):
the checker verifies the collectives a step issues
(``repro_torch.analysis.collectives``) against the declared contract.

Violation names are the JAX package's (tests grep for them):

``ppermute-bad-axes``            gossip exchange not on the node axes
``ppermute-out-of-range``        pair endpoint outside [0, num_nodes)
``ppermute-duplicate-dest``      node receives from two sources
``ppermute-not-involution``      partners don't swap symmetrically
``ppermute-unplanned``           exchanged permutation matches no plan row
``matching-not-exchanged``       a plan row never exchanged (masked modes
                                 exchange every matching)
``collective-bad-axes``          all_gather / psum_scatter / psum off the
                                 axes its issuing module declares
``collective-in-bucketing``      a collective issued from the
                                 collective-free bucketing module
``unexpected-collective``        gossip exchange in a no-gossip step
``bytes-mismatch``               recorded bytes disagree with the analytic
                                 model (> tolerance)
``artifact-mismatch``            analytic model disagrees with the
                                 committed BENCH_comm_time.json
``ladder-bound-exceeded``        fp intermediate above the layout's
                                 memory-ladder bound
``scan-residual-materialized``   scan-streamed step holds a stacked
                                 (repeats, per_layer) intermediate
``monolithic-not-materialized``  monolithic step's largest intermediate
                                 below the full replica
``fp32-upcast-unwhitelisted``    fp32 widening in the dist layer outside
                                 the declared accumulation sites

The port issues its collectives explicitly, so each module that issues
any declares a ``COLLECTIVE_CONTRACT`` (``dist.gossip``, ``dist.fsdp``,
``dist.decen_train``, ``models.tp``, ``models.attention``; ``dist.bucketing``
declares none: it is collective-free), and a record is held to the
contract of the module it was issued from. The step checks of one card
(float64 ops, the gathers, the memory bound) are in
``repro_torch.analysis.check``.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.collectives import ppermute_totals, source_module

__all__ = [
    "Violation",
    "DtypeLint",
    "check_bytes_fsdp",
    "check_collective_axes",
    "check_memory_ladder",
    "check_ppermutes",
    "check_within",
    "cross_check_artifact",
    "ladder_bound",
]


@dataclasses.dataclass(frozen=True)
class Violation:
    name: str
    detail: str
    where: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def check_within(
    name: str, got: float, want: float, *, tol: float = 0.01, where: str = ""
) -> list:
    """``got`` within ``tol`` (relative) of ``want``, else one
    ``bytes-mismatch`` violation labelled ``name``."""
    if abs(got - want) <= tol * max(abs(want), 1):
        return []
    return [
        Violation(
            "bytes-mismatch",
            f"{name}: traced {got} vs analytic {want} "
            f"(> {tol:.0%} apart)",
            where,
        )
    ]


# ---------------------------------------------------------------------------
# Matching validity + gossip axis contract (per ppermute record)
# ---------------------------------------------------------------------------
def _perm_violations(perm, num_nodes: int, where: str) -> list:
    out = []
    seen_src: dict = {}
    seen_dst: dict = {}
    for s, d in perm:
        if not (0 <= s < num_nodes and 0 <= d < num_nodes):
            out.append(Violation("ppermute-out-of-range",
                                 f"pair ({s}, {d}) outside [0, {num_nodes})", where))
            continue
        if d in seen_dst:
            out.append(Violation("ppermute-duplicate-dest",
                                 f"node {d} receives from both {seen_dst[d]} and {s} "
                                 "- matching degree > 1", where))
        seen_dst[d] = s
        seen_src[s] = d
    if not out:
        for s, d in perm:
            if seen_src.get(d) != s:
                out.append(Violation("ppermute-not-involution",
                                     f"node {s} sends to {d} but {d} sends to "
                                     f"{seen_src.get(d)} - partners must swap", where))
                break
    return out


def check_ppermutes(records, *, num_nodes: int, node_axes, planned_pairs=None,
                    expect_all_planned: bool = False, where: str = "") -> list:
    """Matching validity + node-axis contract for every exchange.

    ``planned_pairs`` is ``MatchaPlan.ppermute_pairs()`` (or None to skip
    plan matching); ``expect_all_planned`` additionally requires every
    plan row to appear (the masked / sequential / overlap modes exchange
    all M matchings every step)."""
    out = []
    node_axes = tuple(node_axes)
    planned = None if planned_pairs is None else {tuple(sorted(p)) for p in planned_pairs}
    traced = set()
    for r in records:
        if r.kind != "ppermute":
            continue
        if tuple(r.axes) != node_axes:
            out.append(Violation("ppermute-bad-axes",
                                 f"ppermute over {tuple(r.axes)}; gossip exchanges run over "
                                 f"the node axes {node_axes} only", where))
        out.extend(_perm_violations(r.perm, num_nodes, where))
        key = tuple(sorted(r.perm))
        traced.add(key)
        if planned is not None and key not in planned:
            out.append(Violation("ppermute-unplanned",
                                 f"permutation {list(r.perm)} matches no plan matching",
                                 where))
    if planned is not None and expect_all_planned:
        for j, p in enumerate(planned_pairs):
            if tuple(sorted(p)) not in traced:
                out.append(Violation("matching-not-exchanged",
                                     f"plan matching {j} never exchanged in this step", where))
    return out


# ---------------------------------------------------------------------------
# Collective axis contract (declared by the issuing modules)
# ---------------------------------------------------------------------------
def _contracts() -> Dict[str, dict]:
    """``{module: COLLECTIVE_CONTRACT}`` of every port module that issues
    collectives, and the collective-free bucketing module's."""
    from repro_torch.dist import bucketing, decen_train, fsdp, gossip
    from repro_torch.models import attention, tp

    mods = {"dist.gossip": gossip, "dist.fsdp": fsdp, "dist.decen_train": decen_train,
            "dist.bucketing": bucketing, "models.tp": tp, "models.attention": attention}
    return {name: m.COLLECTIVE_CONTRACT for name, m in mods.items()}


def check_collective_axes(records, *, where: str = "") -> list:
    """all_gather / psum_scatter / psum against the ``COLLECTIVE_CONTRACT``
    of the module that issued each, plus the bucketing module's
    collective-free declaration. ppermute axes are checked by
    :func:`check_ppermutes` (they resolve against the run's node axes)."""
    out = []
    contracts = _contracts()
    for r in records:
        mod = source_module(r)
        if mod == "dist.bucketing":
            out.append(Violation("collective-in-bucketing",
                                 f"{r.kind} issued from {r.source[1]} in the "
                                 "collective-free bucketing module", where))
            continue
        if r.kind == "ppermute":
            continue
        spec = contracts.get(mod, {}).get(r.kind)
        axes = tuple(r.axes)
        if spec is None:
            out.append(Violation("collective-bad-axes",
                                 f"{r.kind} over {axes} issued from {mod}, whose contract "
                                 "declares no such collective", where))
        elif "axes" in spec and axes != tuple(spec["axes"]):
            out.append(Violation("collective-bad-axes",
                                 f"{r.kind} over {axes}; {mod}'s contract requires "
                                 f"{tuple(spec['axes'])}", where))
        elif "axes_subset_of" in spec and not set(axes) <= set(spec["axes_subset_of"]):
            out.append(Violation("collective-bad-axes",
                                 f"{r.kind} over {axes}; {mod}'s contract allows only axes "
                                 f"within {tuple(spec['axes_subset_of'])}", where))
    return out


# ---------------------------------------------------------------------------
# Byte-budget cross-checks
# ---------------------------------------------------------------------------
def check_bytes_fsdp(records, row: dict, *, layout_kind: str, gossip: bool,
                     tol: float = 0.01, where: str = "") -> list:
    """Recorded bytes vs one analytic ``fsdp_bytes_row``.

    * per-matching: every distinct permutation's total exchanged bytes
      must equal ``per_matching_comm_bytes`` (each matching sends each
      bucket's local slice exactly once);
    * gathers: the monolithic step's all-gathers must sum to the padded
      replica (its peak transient); a streamed step's *largest* gather
      must equal its peak-transient column (streamed steps re-gather in
      the backward, so the sum over-counts by design)."""
    out = []
    if gossip:
        totals = ppermute_totals(records)
        if not totals:
            out.append(Violation("bytes-mismatch", "gossip step exchanged nothing", where))
        for _, total in totals.items():
            out.extend(check_within("per_matching_comm_bytes", total,
                                    row["per_matching_comm_bytes"], tol=tol, where=where))
    gathers = [r for r in records if r.kind == "all_gather" and tuple(r.axes) == ("shard",)]
    if not gathers:
        return out + [Violation("bytes-mismatch", "fsdp step issued zero all_gathers", where)]
    if layout_kind == "monolithic":
        out.extend(check_within("peak_transient_bytes_monolithic (sum of gathers)",
                                sum(r.bytes for r in gathers),
                                row["peak_transient_bytes_monolithic"], tol=tol, where=where))
    else:
        col = ("peak_transient_bytes_scan_streamed" if layout_kind == "scan_streamed"
               else "peak_transient_bytes_streamed")
        out.extend(check_within(f"{col} (largest gather)", max(r.bytes for r in gathers),
                                row[col], tol=tol, where=where))
    return out


def cross_check_artifact(analytic_row: dict, artifact_row: dict, *, tol: float = 0.01,
                         where: str = "") -> list:
    """The committed ``BENCH_comm_time.json`` row vs the freshly-derived
    analytic row: the artifact is only trustworthy if the formulas that
    produced it still describe the current layouts."""
    out = []
    for field in ("per_device_param_bytes", "per_matching_comm_bytes",
                  "peak_transient_bytes_monolithic", "peak_transient_bytes_streamed",
                  "peak_transient_bytes_scan_streamed"):
        if field not in artifact_row:
            continue
        got, want = analytic_row[field], artifact_row[field]
        if abs(got - want) > tol * max(abs(want), 1):
            out.append(Violation("artifact-mismatch",
                                 f"{field}: analytic {got} vs committed artifact {want}",
                                 where))
    return out


# ---------------------------------------------------------------------------
# Memory-ladder bounds
# ---------------------------------------------------------------------------
def ladder_bound(layout) -> int:
    """Upper bound (fp32 elements) on any per-rank fp intermediate of a
    *streamed* step: one gathered group view (a scanned group contributes
    one layer row) plus the resident shard slice."""
    return layout.plan.max_group_elements + layout.per_device_elements


def check_memory_ladder(max_fp: int, layout, *, where: str = "") -> list:
    """The memory-ladder rule for one step's largest per-rank fp
    intermediate (``CostMode.max_fp_elements``), per layout. Run with
    gossip ``"none"``: the gossip's fp32 targets are layout-independent
    intermediates."""
    from repro_torch.dist.fsdp import FsdpStreamLayout

    out = []
    if isinstance(layout, FsdpStreamLayout):
        bound = ladder_bound(layout)
        if max_fp > bound:
            out.append(Violation("ladder-bound-exceeded",
                                 f"largest fp intermediate {max_fp} elements > max_group + "
                                 f"resident slice = {bound}", where))
        scanned = [size for size, r in zip(layout.plan.bucket_sizes, layout.plan.repeats)
                   if r > 1]
        if scanned and max_fp >= min(scanned):
            out.append(Violation("scan-residual-materialized",
                                 f"largest fp intermediate {max_fp} elements >= a scanned "
                                 f"group's stacked size {min(scanned)}", where))
    else:
        total = layout.plan.total_elements
        if max_fp < total:
            out.append(Violation("monolithic-not-materialized",
                                 f"monolithic step's largest fp intermediate {max_fp} < full "
                                 f"replica {total}", where))
    return out


# ---------------------------------------------------------------------------
# Dtype lint
# ---------------------------------------------------------------------------
def _dist_upcast_whitelist() -> dict:
    """{abs file path: declared FP32_UPCAST_SITES} for the dist layer."""
    from repro_torch.dist import bucketing, fsdp, gossip

    return {os.path.abspath(m.__file__): tuple(m.FP32_UPCAST_SITES)
            for m in (gossip, fsdp, bucketing)}


_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NARROW = (torch.bfloat16, torch.float16)


class DtypeLint(TorchDispatchMode):
    """``with DtypeLint(where) as lint:`` around a step: every bf16 / fp16
    -> fp32 conversion whose innermost port frame lies in
    ``dist/{gossip,fsdp,bucketing}.py`` must sit in a function that module
    declares in ``FP32_UPCAST_SITES`` (model code upcasts activations
    under its own compute-dtype policy; a stray widening in the dist layer
    doubles gossip and optimizer traffic). ``lint.violations`` holds the
    rest."""

    def __init__(self, where: str = ""):
        super().__init__()
        self.where = where
        self.sites = _dist_upcast_whitelist()
        self.violations: List[Violation] = []
        self._seen: set = set()

    def _frame(self):
        f = sys._getframe(2)
        while f is not None:
            path = os.path.abspath(f.f_code.co_filename)
            if path.startswith(_PKG) and not path.startswith(os.path.join(_PKG, "analysis")):
                return path, f.f_code.co_name, f.f_lineno
            f = f.f_back
        return None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        src = dst = None
        if packet in (torch.ops.aten._to_copy, torch.ops.aten.to) and args:
            src, dst = args[0], out
        elif packet is torch.ops.aten.copy_ and len(args) > 1:
            dst, src = args[0], args[1]
        # a conversion the autograd engine runs is the transpose of a forward
        # op, linted where that op ran (JAX gives it the forward's frame)
        if (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
                and src.dtype in _NARROW and dst.dtype == torch.float32
                and torch._C._current_autograd_node() is None):
            frame = self._frame()
            if frame is not None and frame[0] in self.sites \
                    and frame[1] not in self.sites[frame[0]] and frame not in self._seen:
                self._seen.add(frame)
                fname, fn, line = frame
                self.violations.append(Violation(
                    "fp32-upcast-unwhitelisted",
                    f"{src.dtype} -> float32 at {os.path.basename(fname)}:{line} in {fn}() "
                    "- not a declared FP32_UPCAST_SITES accumulation point", self.where))
        return out
