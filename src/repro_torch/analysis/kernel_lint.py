"""Kernel lint over the CUDA launch rules: the port's ``pallas_lint``.

The JAX lint opens every traced ``pallas_call`` and checks its grid,
block divisibility, masked tails, accumulator dtype and VMEM budget
(``repro.analysis.pallas_lint``). Here each ``csrc/*.cu`` library
exports ``<name>_launch_config(...)``: the grid, block and dynamic
shared memory its launch uses, the output extent that grid covers, the
path taken and the accumulator's width, from the one function the launch
itself calls. :func:`lint_config` holds such a config to the card's
launch rules:

* every grid dim at least 1 and within its limit (2^31 - 1, 65535,
  65535); threads a whole number of warps, at most 1024 a block;
* dynamic shared memory at most 227 KB (232,448 bytes) a block;
* the grid covers the output along each of its dims, tails included
  (``cover >= extent``, the extent computed here from the operands);
* fp32 accumulators (4 bytes).

:func:`lint_case` asks a wrapper for the config of a
``kernel_cases.KernelCase``'s operands, checks it, and checks that the
path it reports is the one ``kernel_path`` names (and, for the SSD scan,
the one its meta branch assumes). It needs the built library, so it
runs on the card (``chip_smoke.py`` sweeps every registry case); the
CPU tests hold :func:`lint_config` to hand-made configs.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

from repro_torch.analysis.checks import Violation

SMEM_LIMIT = 232448                     # dynamic shared memory an sm_90 block may opt in to
MAX_THREADS = 1024
GRID_LIMITS = (2**31 - 1, 65535, 65535)
ACC_BYTES = 4                           # fp32 accumulators


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


def output_extent(case, t) -> Tuple[int, int, int]:
    """The output's three dims, in the order the case's config reports
    them (``launch_config`` of each wrapper)."""
    k = case.kernel
    if k == "flash_attention":
        B, Sq, Hq, _ = t[0].shape
        return Sq, Hq, B
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
    from repro_torch.kernels import gossip_axpy as ga
    from repro_torch.kernels import grouped_matmul as gm
    from repro_torch.kernels import ssm_scan as ss

    k = case.kernel
    if k == "flash_attention":
        return fa.launch_config(t[0], t[1]), fa.kernel_path(t[0], t[1])
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
    (CUDA tensors)."""
    from repro_torch.kernels import ssm_scan as ss

    cfg, path = case_config(case, t)
    extent = output_extent(case, t)
    out = lint_config(cfg, extent, where=case.label)
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
    return out, dict(cfg, extent=extent, kernel_path=path)
