"""Kernel lint over the CUDA launches: the port's ``pallas_lint``.

The JAX lint opens every traced ``pallas_call`` and checks its grid
against the kernel's ``KERNEL_CONTRACT``, block divisibility, index maps
in bounds, output writes disjoint but along declared reduction axes,
masked tails guarded, the accumulator dtype and VMEM, and flags a case
that traces no ``pallas_call`` (``repro.analysis.pallas_lint``). Here
the card checks what the card runs, and no code that decides a mapping is
copied into Python:

* **Launch rules** (:func:`lint_config`). Each ``csrc/*.cu`` library
  exports ``<name>_launch_config(...)``: the grid, block and dynamic
  shared memory its launch uses, the output extent that grid covers, the
  path taken and the accumulator's width, from the one function the
  launch itself calls. Held to the card: every grid dim in [1, its
  limit]; whole warps, at most 1024 threads; at most 227 KB (232,448
  bytes) of dynamic shared memory; ``cover >= extent`` along each output
  dim (the extent computed here from the operands); fp32 accumulators.
* **The contract** (:func:`check_contract`). Each wrapper module declares
  ``KERNEL_CONTRACT`` (the grouped module one for each of its three
  kernels): the grid axes in ``blockIdx`` order (for a persistent or
  ticketed kernel, the axes of its tiles), the output dims in the order
  of the config's cover, ``reduction_axes``, ``masked`` (the JAX names
  where the JAX kernel masks the same thing), ``acc_dtype``,
  ``smem_limit_bytes`` and the ``launches`` one call makes. A config
  whose grid uses more dims than the contract names, a reduction axis
  outside the grid, or a case guard on an axis the contract lists
  unmasked is ``kernel-contract-mismatch``; shared memory over the
  contract's limit ``smem-over-contract``.
* **Tiles** (:func:`lint_tiles`). Each library exports
  ``<name>_tile_probe``: a probe kernel on the launch's own grid that
  calls the kernel's own block -> tile ``__device__`` functions and
  writes the output box of every block (of every tile a persistent or
  grid-stride block visits), before the per-element store guards. The
  boxes are painted over the output: ``tile-out-of-bounds`` for a box past
  the extent along an axis the contract does not mask,
  ``output-overlap-undeclared`` for an element two writers store that
  differ on more than the declared reduction axes,
  ``output-not-covered`` for an element none stores.
* **Tails and guards** (:func:`poison_case`), the dynamic counterpart of
  ``masked-tail-guard-missing`` / ``-dead`` (``compute-sanitizer`` does not
  run where the card is): every input a prefix view of a longer buffer
  whose tail is poisoned, once with the dtype's largest finite value and
  once with NaN (in the grouped cases also the rows past the groups, in
  place); every output a view between two canary bands, its body filled
  with a sentinel NaN no arithmetic produces. A changed canary is
  ``write-out-of-bounds``, a sentinel left ``output-not-covered``, a
  finite-poison output that is not bit-equal to the clean launch's
  ``masked-tail-read``, and a NaN where the plain version on the same
  NaN-poisoned operands has none ``masked-tail-guard-missing``.
* **Launches** (:func:`launch_violations`, the counterpart of
  ``pallas-call-missing``): a case run through ``kernels.ops`` with
  ``impl="auto"`` must launch its kernel as often as the contract says
  (once), on meta tensors under ``CostMode`` and on the card by the
  wrapper's ``launches`` counter; none is a silent fall-back to the plain
  path (``kernel-launch-missing``).
* **Source** (:func:`check_impl_literals`, the counterpart of
  ``check_interpret_literals``): a literal ``impl=`` naming a kernel mode
  passed to a call anywhere in ``src/repro_torch`` but ``kernels/ops.py``
  (``hardcoded-impl``): the choice is ``ops.resolve_mode``'s.

The launch, tile and poison checks need the built libraries and run on
the card (``chip_smoke.py`` phase 9 over every registry case,
``python -m repro_torch.analysis.check --kernel-sweep registry``); the
CPU tests hold the rest to hand-made configs, boxes and plain versions.
"""
from __future__ import annotations

import ast
import os
import time
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.checks import Violation

SMEM_LIMIT = 232448                     # dynamic shared memory an sm_90 block may opt in to
MAX_THREADS = 1024
GRID_LIMITS = (2**31 - 1, 65535, 65535)
ACC_BYTES = 4                           # fp32 accumulators
CONTRACT_FIELDS = ("kernel", "grid", "out_dims", "reduction_axes", "masked", "acc_dtype",
                   "smem_limit_bytes", "launches")

POISON_PAD = 1 << 18        # elements of poison past each input (512 KiB of bf16)
GUARD_BYTES = 4096          # canary band on each side of an output (keeps its alignment)
CANARY = 0xA5               # the bands' byte
SENTINELS = {torch.float32: (torch.int32, 0x7FBADBAD),   # signalling NaNs, which no
             torch.bfloat16: (torch.int16, 0x7F81)}      # arithmetic produces
SLICE_ELEMS = 1 << 27       # elements a comparison takes at a time


def lint_config(cfg: Dict, extent: Sequence[int], *, where: str = "") -> list:
    """Violations of one launch configuration (a dict of ``grid``,
    ``cover``, ``threads``, ``smem_bytes``, ``path``, ``acc_bytes``)
    against the launch rules, for an output of ``extent`` along the
    config's three output dims."""
    out = []
    for i, (g, lim) in enumerate(zip(cfg["grid"], GRID_LIMITS)):
        if not 1 <= g <= lim:
            out.append(Violation("grid-out-of-range",
                                 f"grid[{i}] = {g} outside [1, {lim}]", where))
    t = cfg["threads"]
    if not 0 < t <= MAX_THREADS or t % 32:
        out.append(Violation("block-threads",
                             f"{t} threads a block: not a whole number of warps "
                             f"up to {MAX_THREADS}", where))
    if not 0 <= cfg["smem_bytes"] <= SMEM_LIMIT:
        out.append(Violation("smem-over-limit",
                             f"{cfg['smem_bytes']} bytes of dynamic shared memory a block, "
                             f"over the {SMEM_LIMIT} an sm_90 block may use", where))
    for i, (c, e) in enumerate(zip(cfg["cover"], extent)):
        if c < e:
            out.append(Violation("grid-drops-tail",
                                 f"the grid covers {c} of the output's {e} along dim {i}",
                                 where))
    if cfg["acc_bytes"] != ACC_BYTES:
        out.append(Violation("accumulator-dtype",
                             f"{cfg['acc_bytes']}-byte accumulators, not fp32", where))
    return out


# ---------------------------------------------------------------------------
# Contracts
# ---------------------------------------------------------------------------
def _module(kernel: str):
    """The wrapper module of a kernel, by the wrapper's name."""
    from repro_torch.kernels import (
        flash_attention,
        flash_attention_bwd,
        gossip_axpy,
        grouped_matmul,
        ssm_scan,
    )

    for mod in (flash_attention, gossip_axpy, grouped_matmul, ssm_scan, flash_attention_bwd):
        if callable(getattr(mod, kernel, None)):
            return mod
    raise ValueError(f"unknown kernel {kernel!r}")


def contract_for(kernel: str) -> dict:
    """The ``KERNEL_CONTRACT`` of a wrapper, by the wrapper's name (the
    grouped module's dx and dw: ``KERNEL_CONTRACT_DX`` / ``_DW``; the
    flash backward's passes: ``KERNEL_CONTRACT_DQ`` / ``_DKDV``)."""
    name = {"grouped_matmul_dx": "KERNEL_CONTRACT_DX",
            "grouped_matmul_dw": "KERNEL_CONTRACT_DW",
            "flash_attention_dq": "KERNEL_CONTRACT_DQ",
            "flash_attention_dkdv": "KERNEL_CONTRACT_DKDV"}.get(kernel, "KERNEL_CONTRACT")
    return getattr(_module(kernel), name)


def wrapper_for(kernel: str):
    """The wrapper function of a kernel, whose ``launches`` counter counts
    its launches on the card."""
    return getattr(_module(kernel), kernel)


def check_contract(cfg: Dict, contract: dict, guards=(), *, where: str = "") -> list:
    """A launch configuration against its kernel's contract, and the
    case's ``guards`` (masked axis -> bound) against the masked axes."""
    out = []
    missing = [f for f in CONTRACT_FIELDS if f not in contract]
    if missing:
        return [Violation("kernel-contract-mismatch",
                          f"the contract lacks {missing}", where)]
    axes = tuple(contract["grid"])
    if not 1 <= len(axes) <= 3 or any(g != 1 for g in cfg["grid"][len(axes):]):
        out.append(Violation("kernel-contract-mismatch",
                             f"grid {tuple(cfg['grid'])} uses more dims than the "
                             f"{len(axes)} the contract names {axes}", where))
    for ax in contract["reduction_axes"]:
        if not 0 <= ax < len(axes):
            out.append(Violation("kernel-contract-mismatch",
                                 f"declared reduction axis {ax} outside the "
                                 f"{len(axes)}-axis grid", where))
    for axis in dict(guards):
        if axis not in contract["masked"]:
            out.append(Violation("kernel-contract-mismatch",
                                 f"case declares a guard for axis {axis!r} but the "
                                 "contract lists it unmasked", where))
    if cfg["smem_bytes"] > contract["smem_limit_bytes"]:
        out.append(Violation("smem-over-contract",
                             f"{cfg['smem_bytes']} bytes of dynamic shared memory a block, "
                             f"over the contract's {contract['smem_limit_bytes']}", where))
    want = torch.empty((), dtype=getattr(torch, contract["acc_dtype"])).element_size()
    if cfg["acc_bytes"] != want:
        out.append(Violation("accumulator-dtype",
                             f"{cfg['acc_bytes']}-byte accumulators, the contract's "
                             f"{contract['acc_dtype']} has {want}", where))
    return out


def launch_violations(case, launches: int, *, where: str = "") -> list:
    """``kernel-launch-missing`` unless one call of ``case`` launched its
    kernel as often as its contract says."""
    want = contract_for(case.kernel)["launches"]
    if launches == want:
        return []
    return [Violation("kernel-launch-missing",
                      f"{launches} launches of {case.kernel} for one call through "
                      f"impl='auto', the contract expects {want} (none: the wrapper fell "
                      "back to its plain path)", where or case.label)]


def run_counted(case, t):
    """``case.run_kernel(*t)`` on the card and the launches its wrapper
    counted: ``(output, launches)``."""
    fn = wrapper_for(case.kernel)
    before = fn.launches
    got = case.run_kernel(*t)
    return got, fn.launches - before


# ---------------------------------------------------------------------------
# Tiles
# ---------------------------------------------------------------------------
def _pad3(v, fill):
    v = tuple(int(x) for x in v)
    return v + (fill,) * (3 - len(v))


def as_boxes(boxes) -> np.ndarray:
    """Boxes as an ``(n, 9)`` int64 array of ``writer[3], lo[3], hi[3]``:
    a probe's array as it is, or ``(writer, lo, hi)`` tuples of up to
    three dims (a missing dim is ``[0, 1)``)."""
    if isinstance(boxes, np.ndarray):
        return boxes.astype(np.int64).reshape(-1, 9)
    rows = [_pad3(w, 0) + _pad3(lo, 0) + _pad3(hi, 1) for w, lo, hi in boxes]
    return np.asarray(rows, dtype=np.int64).reshape(-1, 9)


def shift_box(boxes, i: int = None) -> np.ndarray:
    """A copy of ``boxes`` with one box moved by its own width along dim 0
    (the box at the lowest position there unless ``i`` is given): a
    planted fault that must give an overlap and an uncovered tile."""
    arr = as_boxes(boxes).copy()
    if i is None:
        live = np.nonzero(arr[:, 6] > arr[:, 3])[0]
        i = int(live[np.argmin(arr[live, 3])])
    width = arr[i, 6] - arr[i, 3]
    arr[i, 3] += width
    arr[i, 6] += width
    return arr


def _paint(lo, hi, shape):
    """Counts of the boxes ``[lo, hi)`` (cell indices, ``(n, 3)``) over a
    grid of ``shape`` cells, by a 3-D difference array."""
    diff = np.zeros(tuple(s + 1 for s in shape), dtype=np.int64)
    for corner in range(8):
        bits = [(corner >> d) & 1 for d in range(3)]
        at = tuple(np.where(b, hi[:, d], lo[:, d]) for d, b in enumerate(bits))
        np.add.at(diff, at, (-1) ** sum(bits))
    for d in range(3):
        diff = np.cumsum(diff, axis=d)
    return diff[:shape[0], :shape[1], :shape[2]]


def lint_tiles(boxes, extent: Sequence[int], contract: dict, *, where: str = ""):
    """Violations of a probe's output boxes over an output of ``extent``
    (along the contract's ``out_dims``): ``(violations, stats)``. Boxes are
    clipped to the extent before they are painted, so a box past a masked
    axis counts only where it lies inside."""
    arr = as_boxes(boxes)
    ext = np.asarray(_pad3(extent, 1), dtype=np.int64)
    names = list(contract["out_dims"]) + [f"dim{d}" for d in range(len(contract["out_dims"]),
                                                                    3)]
    writer, lo, hi = arr[:, 0:3], arr[:, 3:6], arr[:, 6:9]
    out = []
    for d in range(3):
        bad = np.nonzero((lo[:, d] < 0) | (hi[:, d] > ext[d]))[0]
        if bad.size and names[d] not in contract["masked"]:
            i = bad[0]
            out.append(Violation(
                "tile-out-of-bounds",
                f"{bad.size} boxes leave [0, {ext[d]}) along {names[d]!r}, which the "
                f"contract does not mask; first: writer {tuple(int(x) for x in writer[i])} "
                f"[{lo[i, d]}, {hi[i, d]})", where))
    clo, chi = np.clip(lo, 0, ext), np.clip(hi, 0, ext)
    live = (chi > clo).all(axis=1)
    writer, clo, chi = writer[live], clo[live], chi[live]
    cuts = [np.unique(np.concatenate([[0, ext[d]], clo[:, d], chi[:, d]])) for d in range(3)]
    shape = tuple(len(c) - 1 for c in cuts)
    ilo = np.stack([np.searchsorted(cuts[d], clo[:, d]) for d in range(3)], axis=1)
    ihi = np.stack([np.searchsorted(cuts[d], chi[:, d]) for d in range(3)], axis=1)
    red = set(contract["reduction_axes"])
    if red:
        # writers that differ only along reduction axes may share elements:
        # each such set paints its union once
        keep = [d for d in range(3) if d not in red]
        keys = writer[:, keep]
        count = np.zeros(shape, dtype=np.int64)
        for key in np.unique(keys, axis=0):
            mine = (keys == key).all(axis=1)
            count += _paint(ilo[mine], ihi[mine], shape) > 0
    else:
        count = _paint(ilo, ihi, shape)
    volume = np.einsum("i,j,k->ijk", *[np.diff(c) for c in cuts])

    def first(mask):
        c = tuple(int(x[0]) for x in np.nonzero(mask))
        return tuple((int(cuts[d][c[d]]), int(cuts[d][c[d] + 1])) for d in range(3)), c

    over = count > 1
    if over.any():
        span, c = first(over)
        at = np.nonzero((ilo <= c).all(axis=1) & (ihi > c).all(axis=1))[0]
        out.append(Violation(
            "output-overlap-undeclared",
            f"{int(volume[over].sum())} output elements stored by writers that differ on "
            f"more than the reduction axes {tuple(sorted(red))}; first {span} by writers "
            f"{[tuple(int(x) for x in writer[i]) for i in at[:4]]}", where))
    uncovered = count == 0
    if uncovered.any():
        span, _ = first(uncovered)
        out.append(Violation(
            "output-not-covered",
            f"{int(volume[uncovered].sum())} output elements no block stores; first {span}",
            where))
    stats = dict(boxes=int(arr.shape[0]), writers=int(len(np.unique(arr[:, 0:3], axis=0))),
                 elements=int(np.prod(ext)))
    return out, stats


def case_tiles(case, t) -> np.ndarray:
    """The probe's boxes for a case's operands ``t`` (CUDA tensors), from
    its wrapper's ``tile_probe``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import gossip_axpy as ga
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import ssm_scan as ss

    k = case.kernel
    if k == "flash_attention":
        return fa.tile_probe(t[0], t[1], t[2])
    if k.startswith("flash_attention_d"):
        return fab.tile_probe(k.removeprefix("flash_attention_"), t[0], t[1], t[2])
    if k == "ssm_scan":
        return ss.tile_probe(t[0], t[3], case.opts["chunk"], t[4])
    if k == "gossip_axpy":
        return ga.tile_probe(t[0], t[1])
    kind = {"grouped_matmul": "forward", "grouped_matmul_dx": "dx",
            "grouped_matmul_dw": "dw"}[k]
    return gm.tile_probe(t[0], t[1], t[2], kind=kind)


def output_extent(case, t) -> Tuple[int, int, int]:
    """The output's three dims, in the order the case's config reports
    them (``launch_config`` of each wrapper)."""
    k = case.kernel
    if k in ("flash_attention", "flash_attention_dq"):
        B, Sq, Hq, _ = t[0].shape
        return Sq, Hq, B
    if k == "flash_attention_dkdv":
        B, S, Hkv, _ = t[1].shape
        return S, Hkv, B
    if k == "ssm_scan":
        B, S, H, _ = t[0].shape
        return S, H, B
    if k == "gossip_axpy":
        return t[0].numel(), 1, 1
    if k == "grouped_matmul":
        return t[0].shape[0], t[1].shape[2], 1
    if k == "grouped_matmul_dx":
        return t[0].shape[0], t[1].shape[1], 1
    if k == "grouped_matmul_dw":
        return t[0].shape[1], t[1].shape[1], t[2].shape[0]
    raise ValueError(f"unknown kernel {k!r}")


def case_config(case, t) -> Tuple[Dict, str]:
    """``(launch config, kernel_path)`` of a case's operands ``t`` (CUDA
    tensors) from its wrapper."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import gossip_axpy as ga
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import ssm_scan as ss

    k = case.kernel
    if k == "flash_attention":
        return fa.launch_config(t[0], t[1], t[2]), fa.kernel_path(t[0], t[1], t[2])
    if k.startswith("flash_attention_d"):
        kind = k.removeprefix("flash_attention_")
        return (fab.launch_config(kind, t[0], t[1], t[2]),
                fab.kernel_path(t[0], t[1], t[2]))
    if k == "ssm_scan":
        chunk = case.opts["chunk"]
        return (ss.launch_config(t[0], t[3], chunk, t[4]),
                ss.kernel_path(t[0], t[3], chunk, t[4]))
    if k == "gossip_axpy":
        return ga.launch_config(t[0], t[1]), "vector"
    kind = {"grouped_matmul": "forward", "grouped_matmul_dx": "dx",
            "grouped_matmul_dw": "dw"}[k]
    G = t[2].shape[0]
    return (gm.launch_config(t[0], t[1], G, kind=kind),
            gm.kernel_path(t[0], t[1], kind=kind))


def lint_case(case, t) -> Tuple[list, Dict]:
    """Violations and stats of one case's launch on its operands ``t``
    (CUDA tensors): the launch rules, the contract and the tiles."""
    from repro_torch.kernels import ssm_scan as ss

    cfg, path = case_config(case, t)
    extent = output_extent(case, t)
    contract = contract_for(case.kernel)
    out = lint_config(cfg, extent, where=case.label)
    out += check_contract(cfg, contract, case.guards, where=case.label)
    if path != "vector" and cfg["path"] != (path in ("wgmma", "mma")):
        out.append(Violation("path-mismatch",
                             f"launch config path {cfg['path']} but kernel_path {path!r}",
                             case.label))
    if case.kernel == "ssm_scan":
        P, N = t[0].shape[3], t[3].shape[2]
        chunk = min(case.opts["chunk"], t[0].shape[1])
        want = ss.meta_path(t[0].dtype, P, N, chunk)
        if want != path:
            out.append(Violation("meta-path-mismatch",
                                 f"the meta branch assumes {want!r}, the card takes {path!r}",
                                 case.label))
        smem = ss._library().ssm_scan_smem_bytes(P, N, chunk)
        if ss.scalar_smem_bytes(P, N, chunk) != smem:
            out.append(Violation("meta-smem-mismatch",
                                 f"the meta branch counts {ss.scalar_smem_bytes(P, N, chunk)} "
                                 f"bytes of scalar shared memory, the library {smem}",
                                 case.label))
    t0 = time.perf_counter()
    tv, tstats = lint_tiles(case_tiles(case, t), extent, contract, where=case.label)
    tstats["seconds"] = time.perf_counter() - t0
    out += tv
    return out, dict(cfg, extent=extent, kernel_path=path, tiles=tstats)


# ---------------------------------------------------------------------------
# Poisoned tails, canaries and sentinels
# ---------------------------------------------------------------------------
def with_tail(a: torch.Tensor, pad: int = POISON_PAD):
    """``(view, tail)``: ``a`` and the ``pad`` elements of its storage
    right after it when it has them (a ``KernelCase.make(pad=...)``
    operand), else a copy of ``a`` at the head of a buffer ``pad``
    elements longer and that buffer's tail."""
    from repro_torch.analysis.kernel_cases import padded

    end = a.storage_offset() + a.numel()
    if not (a.is_contiguous()
            and a.untyped_storage().nbytes() >= (end + pad) * a.element_size()):
        a = padded(a, pad)
        end = a.numel()
    return a, a.as_strided((pad,), (1,), end)


class Guarded:
    """An output buffer between two canary bands, its body filled with a
    sentinel the kernel cannot produce."""

    def __init__(self, shape, dtype, device):
        self.nbytes = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        self.raw = torch.empty(2 * GUARD_BYTES + self.nbytes, dtype=torch.uint8, device=device)
        self.raw[:GUARD_BYTES] = CANARY
        self.raw[GUARD_BYTES + self.nbytes:] = CANARY
        self.body = self.raw[GUARD_BYTES:GUARD_BYTES + self.nbytes].view(dtype).view(shape)
        self.int_dtype, self.sentinel = SENTINELS[dtype]
        self.body.view(self.int_dtype).fill_(self.sentinel)

    def check(self, tag: str, where: str) -> list:
        out = []
        bands = torch.cat([self.raw[:GUARD_BYTES], self.raw[GUARD_BYTES + self.nbytes:]])
        changed = int((bands != CANARY).sum())
        if changed:
            out.append(Violation("write-out-of-bounds",
                                 f"{tag}: {changed} canary bytes around the output changed",
                                 where))
        left = _count(lambda b: b.view(self.int_dtype) == self.sentinel, self.body)
        if left:
            out.append(Violation("output-not-covered",
                                 f"{tag}: {left} output elements still hold the sentinel",
                                 where))
        return out


def _count(fn, *ts) -> int:
    """``fn(*slices).sum()`` over slices of ``ts`` along dim 0, a few
    hundred MB at a time (the full-width dw outputs are GBs)."""
    a = ts[0]
    if a.dim() == 0:
        return int(fn(*ts).sum())
    step = max(1, SLICE_ELEMS // max(1, a[0].numel()))
    return sum(int(fn(*(t[i:i + step] for t in ts)).sum()) for i in range(0, a.shape[0], step))


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(SENTINELS[x.dtype][0])


def _outputs(res) -> list:
    return list(res) if isinstance(res, (tuple, list)) else [res]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def poison_case(case, t, *, launch=None, plain=None, where: str = None):
    """The guarded launches of a case on its operands ``t``: a clean one,
    one with every input's tail (and, where the case guards ``rows``, the
    rows past the groups) poisoned with the dtype's largest finite value,
    one with NaN. ``launch(*operands, out=buffers)`` is the kernel
    (``case.launch``), ``plain(*operands)`` its plain version
    (``case.run_plain``), both given the wrapper's operands
    (``case.kernel_operands``). The operands are left as they were.
    Returns ``(violations, stats)``."""
    where = where or case.label
    launch = launch or case.launch
    plain = plain or case.run_plain
    views, tails = [], []
    for a in case.kernel_operands(t):
        if a.is_floating_point():
            a, tail = with_tail(a)
            tails.append(tail)
        views.append(a)
    rows = []
    if "rows" in dict(case.guards):
        past = int(views[2].sum())
        rows = [a[past:] for a in views[:2] if a.dim() == 2]
    saved = [r.clone() for r in rows]
    # the outputs' shapes and dtypes, from the wrapper's meta branch
    specs = [(tuple(o.shape), o.dtype) for o in _outputs(case.run_kernel(
        *(torch.empty_like(a, device="meta") for a in t)))]
    device = views[0].device
    out = []

    def run(tag):
        bufs = [Guarded(shape, dtype, device) for shape, dtype in specs]
        launch(*views, out=[b.body for b in bufs])
        _sync(device)
        for b in bufs:
            out.extend(b.check(tag, where))
        return [b.body for b in bufs]

    def poison(nan: bool):
        for x in tails + rows:
            x.fill_(float("nan") if nan else torch.finfo(x.dtype).max)

    clean = run("clean launch")
    poison(nan=False)
    finite = run("finite poison")
    differ = sum(_count(lambda a, b: _bits(a) != _bits(b), c, f) for c, f in zip(clean, finite))
    if differ:
        out.append(Violation("masked-tail-read",
                             f"{differ} output elements change when the inputs' tails hold "
                             "their dtype's largest value: the kernel reads past a masked "
                             "bound", where))
    del finite
    poison(nan=True)
    nan_out = run("NaN poison")
    want = _outputs(plain(*views))
    leaked = sum(_count(lambda a, b: torch.isnan(a) & ~torch.isnan(b), k, w.to(k.dtype))
                 for k, w in zip(nan_out, want))
    if leaked:
        out.append(Violation("masked-tail-guard-missing",
                             f"{leaked} output elements are NaN with NaN in the inputs' tails "
                             "where the plain version on the same operands has none", where))
    del nan_out, want, clean
    for x in tails:
        x.zero_()
    for r, s in zip(rows, saved):
        r.copy_(s)
    stats = dict(launches=3, poisoned_inputs=len(tails), poisoned_rows=sum(len(r) for r in rows),
                 outputs=[list(shape) for shape, _ in specs])
    return out, stats


# ---------------------------------------------------------------------------
# Source lint: hardcoded impl= outside ops.py
# ---------------------------------------------------------------------------
def check_impl_literals(root: str = None) -> list:
    """Walk the AST of every file under ``root`` (``src/repro_torch``) for
    a literal ``impl=`` naming a kernel mode (``ops.MODES`` or ``"meta"``)
    passed to a call anywhere but ``kernels/ops.py``: such a literal pins
    a kernel to one path behind ``ops.resolve_mode``'s back. Other
    ``impl=`` values (the MoE layer's ``"einsum"`` / ``"ragged"``) are not
    kernel modes."""
    import repro_torch
    from repro_torch.kernels import ops

    if root is None:
        root = os.path.dirname(os.path.abspath(repro_torch.__file__))
    modes = set(ops.MODES) | {"meta"}
    allowed = os.path.abspath(os.path.join(root, "kernels", "ops.py"))
    out = []
    for dirpath, _dirs, files in sorted(os.walk(root)):
        for fname in sorted(files):
            path = os.path.join(dirpath, fname)
            if not fname.endswith(".py") or os.path.abspath(path) == allowed:
                continue
            with open(path) as f:
                try:
                    tree = ast.parse(f.read(), filename=path)
                except SyntaxError:
                    continue
            rel = os.path.relpath(path, root)
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                for kw in node.keywords:
                    if (kw.arg == "impl" and isinstance(kw.value, ast.Constant)
                            and kw.value.value in modes):
                        out.append(Violation(
                            "hardcoded-impl",
                            f"impl={kw.value.value!r} hardcoded at {rel}:{node.lineno}: "
                            "pass impl through, kernels.ops.resolve_mode decides",
                            rel))
    return out
