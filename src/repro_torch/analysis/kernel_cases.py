"""Registry-driven kernel cases: every shape a hand-written kernel sees.

The port's counterpart of ``repro.analysis.kernel_cases``, with its
cases, labels and shapes: from each registry config, tiny and full,
flash attention at two blocks (256 positions, aligned) and at a ragged
197 (a 59-position tail past the last whole block), and windowed where
the config has a window; the SSD chunk scan at two chunks; the grouped
matmul at 512 rows and a ragged 549 (4 whole 128-row tiles and a 37-row
tail); and two shared gossip-axpy cases (512 x 1024 fp32, 33 x 129
bf16). The port adds its grouped matmul's backward, dx and dw, at the
same two row counts.

A case holds its operands' shapes and dtypes (``args``, the JAX case's
for the cases both packages have), the masked axes it exercises
(``guards``, the JAX case's names: ``kv`` at the ragged length, ``rows``
past the groups) and builds torch tensors on a requested device from a
seed (:meth:`KernelCase.make`, optionally each a prefix of a longer
buffer whose tail the kernel lint poisons). ``run_kernel`` goes through
``kernels.ops`` with ``impl="auto"``, the dispatch a model's call takes
(the kernel on a CUDA tensor, its meta branch on a meta one);
``launch`` calls the wrapper itself into given output buffers;
``run_plain`` is the plain PyTorch version. The card's sweep
(``chip_smoke.py``) holds the kernel to the plain version and
``kernel_lint`` checks the launch, its tiles and its tails.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config

__all__ = ["KernelCase", "cases_for_config", "shared_cases", "sweep_cases"]

SEQ_ALIGNED = 256
SEQ_RAGGED = 197
BATCH = 2
ROWS_ALIGNED = 512
ROWS_RAGGED = 4 * 128 + 37
ROWS_PAST_GROUPS = 5        # sorted rows past sum(group_sizes), which stay 0


@dataclasses.dataclass(frozen=True)
class KernelCase:
    label: str
    kernel: str                                  # the wrapper's name
    args: Tuple[Tuple[Tuple[int, ...], str], ...]   # (shape, dtype name) per operand
    options: Tuple[Tuple[str, object], ...] = ()  # keyword options of the call
    guards: Tuple[Tuple[str, object], ...] = ()   # masked axis -> its bound here

    @property
    def opts(self) -> dict:
        return dict(self.options)

    def make(self, device, seed: int = 0, pad: int = 0) -> Tuple[torch.Tensor, ...]:
        """The operands on ``device``, drawn from ``seed`` there (a
        ``torch.Generator`` on the device: the full-width expert weights
        are GBs); on the meta device their shapes alone. Group sizes come
        from numpy, the same on every device: ``ROWS_PAST_GROUPS`` rows
        short of the row count, cut at random points, so some groups are
        empty. With ``pad`` each floating operand is the first elements
        of a buffer ``pad`` elements longer (zeros past it), the same
        values and alignment."""
        device = torch.device(device)
        rng = np.random.default_rng(seed)
        gen = None if device.type == "meta" else torch.Generator(device).manual_seed(seed)
        out = []
        for i, (shape, dtype) in enumerate(self.args):
            dt = getattr(torch, dtype)
            if dt == torch.int32:                 # group sizes
                rows = self.args[0][0][0] - ROWS_PAST_GROUPS
                cut = np.sort(rng.integers(0, rows + 1, size=shape[0] - 1))
                sizes = np.diff(np.concatenate([[0], cut, [rows]])).astype(np.int32)
                out.append(torch.as_tensor(sizes, device=device))
                continue
            if gen is None:
                out.append(torch.empty(shape, dtype=dt, device=device))
                continue
            a = torch.randn(shape, generator=gen, device=device)
            if self.kernel == "ssm_scan" and i == 1:     # dt > 0
                a = 0.01 + 0.1 * torch.rand(shape, generator=gen, device=device)
            elif self.kernel == "ssm_scan" and i == 2:   # A < 0
                a = -torch.rand(shape, generator=gen, device=device).exp()
            elif self.kernel == "ssm_scan":
                a = 0.5 * a
            elif self.kernel.startswith("grouped_matmul") and len(shape) == 3:
                a = a / math.sqrt(shape[1])
            out.append(padded(a, pad, dt) if pad else a.to(dt))
        return tuple(out)

    def run_kernel(self, *t):
        """``t`` through ``kernels.ops`` with ``impl="auto"``: the
        hand-written kernel on the card, its meta branch on meta tensors
        (and the plain version on the CPU)."""
        from repro_torch.kernels import ops

        o = self.opts
        if self.kernel == "flash_attention":
            return ops.attention(*t, causal=True, window=o["window"], impl="auto")
        if self.kernel == "ssm_scan":
            return ops.ssd(*t, chunk=o["chunk"], impl="auto")
        if self.kernel == "gossip_axpy":
            return ops.gossip_update({"x": t[0]}, {"x": t[1]}, o["alpha"], impl="auto")["x"]
        return getattr(ops, self.kernel)(*t, impl="auto")

    def kernel_operands(self, t) -> Tuple[torch.Tensor, ...]:
        """``t`` as the wrapper takes them: the scan's dt and A in fp32
        (``ops.ssd`` casts them), the rest as they are."""
        if self.kernel == "ssm_scan":
            x, dt, A, Bm, Cm = t
            return x, dt.float(), A.float(), Bm, Cm
        return tuple(t)

    def launch(self, *t, out):
        """The wrapper itself on the wrapper's operands ``t``
        (:meth:`kernel_operands`), writing into the buffers ``out`` (one
        for each output, in the wrapper's order): the kernel lint's
        guarded launches."""
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import gossip_axpy as ga
        from repro_torch.kernels import grouped_matmul as gm
        from repro_torch.kernels import ssm_scan as ss

        o = self.opts
        if self.kernel == "flash_attention":
            return fa.flash_attention(*t, causal=True, window=o["window"], out=out[0])
        if self.kernel == "ssm_scan":
            return ss.ssm_scan(*t, chunk=o["chunk"], out=tuple(out))
        if self.kernel == "gossip_axpy":
            return ga.gossip_axpy(t[0], t[1], o["alpha"], out=out[0])
        return getattr(gm, self.kernel)(*t, out=out[0])

    def run_plain(self, *t):
        """The kernel's plain PyTorch version on ``t``."""
        from repro_torch.kernels import ref

        o = self.opts
        if self.kernel == "flash_attention":
            return ref.attention_ref(*t, causal=True, window=o["window"])
        if self.kernel == "ssm_scan":
            x, dt, A, Bm, Cm = t
            return ref.ssm_scan_ref(x, dt.float(), A.float(), Bm, Cm)
        if self.kernel == "gossip_axpy":
            return ref.gossip_axpy_ref(t[0], t[1], o["alpha"])
        return getattr(ref, self.kernel + "_ref")(*t)


def padded(a: torch.Tensor, pad: int, dtype: torch.dtype = None) -> torch.Tensor:
    """``a``'s values (cast to ``dtype``) as the first elements of a zeroed
    buffer ``pad`` elements longer: a contiguous view, aligned as a fresh
    tensor is."""
    buf = torch.zeros(a.numel() + pad, dtype=dtype or a.dtype, device=a.device)
    view = buf[:a.numel()].view(a.shape)
    view.copy_(a)
    return view


def _dtype(cfg) -> str:
    return str(cfg.compute_dtype)


def _attention_cases(arch, preset, cfg):
    hd, dt = cfg.head_dim, _dtype(cfg)

    def case(tag, seq, window, guards=()):
        return KernelCase(
            label=f"{arch}/{preset}/flash_attention/{tag}", kernel="flash_attention",
            args=(((BATCH, seq, cfg.num_heads, hd), dt),
                  ((BATCH, seq, cfg.num_kv_heads, hd), dt),
                  ((BATCH, seq, cfg.num_kv_heads, hd), dt)),
            options=(("window", window),), guards=guards,
        )

    # ragged: the last k tile runs 59 keys past the keys, the last q tile
    # 59 rows past the queries
    out = [case("aligned", SEQ_ALIGNED, 0),
           case("ragged", SEQ_RAGGED, 0, (("kv", SEQ_RAGGED), ("q", SEQ_RAGGED)))]
    if cfg.sliding_window:
        out.append(case("windowed", SEQ_ALIGNED, cfg.sliding_window))
    return out


def _ssd_cases(arch, preset, cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim or 64
    H = cfg.ssm_num_heads or max(1, d_inner // P)
    N, chunk, dt = cfg.ssm_state_dim, cfg.ssm_chunk, _dtype(cfg)
    S = 2 * chunk
    return [KernelCase(
        label=f"{arch}/{preset}/ssm_scan/aligned", kernel="ssm_scan",
        args=(((BATCH, S, H, P), dt), ((BATCH, S, H), dt), ((H,), "float32"),
              ((BATCH, S, N), dt), ((BATCH, S, N), dt)),
        options=(("chunk", chunk),),
    )]


def _gmm_cases(arch, preset, cfg):
    G, K, N, dt = cfg.moe_num_experts, cfg.d_model, cfg.moe_d_ff or cfg.d_ff, _dtype(cfg)
    out = []
    # the group offsets mask the rows past sum(group_sizes) in every case
    rows = (("rows", "group_sizes"),)
    for tag, M in (("aligned", ROWS_ALIGNED), ("ragged", ROWS_RAGGED)):
        sizes = ((G,), "int32")
        out += [
            KernelCase(f"{arch}/{preset}/grouped_matmul/{tag}", "grouped_matmul",
                       (((M, K), dt), ((G, K, N), dt), sizes), guards=rows),
            KernelCase(f"{arch}/{preset}/grouped_matmul_dx/{tag}", "grouped_matmul_dx",
                       (((M, N), dt), ((G, K, N), dt), sizes), guards=rows),
            KernelCase(f"{arch}/{preset}/grouped_matmul_dw/{tag}", "grouped_matmul_dw",
                       (((M, K), dt), ((M, N), dt), sizes), guards=rows),
        ]
    return out


def cases_for_config(arch: str, preset: str, cfg) -> list:
    out = []
    if cfg.num_heads:
        out += _attention_cases(arch, preset, cfg)
    if cfg.ssm_state_dim:
        out += _ssd_cases(arch, preset, cfg)
    if cfg.moe_num_experts:
        out += _gmm_cases(arch, preset, cfg)
    return out


def shared_cases() -> list:
    """The arch-independent gossip-axpy cases: one aligned fp32, one
    ragged bf16."""
    return [
        KernelCase("shared/gossip_axpy/aligned_f32", "gossip_axpy",
                   (((512, 1024), "float32"), ((512, 1024), "float32")),
                   (("alpha", 0.375),)),
        KernelCase("shared/gossip_axpy/ragged_bf16", "gossip_axpy",
                   (((33, 129), "bfloat16"), ((33, 129), "bfloat16")),
                   (("alpha", 0.375),), (("tail", 33 * 129),)),
    ]


def sweep_cases(arch: str = None) -> list:
    """Every kernel case of the registry (``arch=None``: all
    architectures, tiny and full) or of one architecture; the shared
    gossip cases always."""
    archs = ARCH_IDS if arch is None else (arch,)
    out = list(shared_cases())
    for a in archs:
        for preset, cfg in (("tiny", get_smoke_config(a)), ("full", get_config(a))):
            out += cases_for_config(a, preset, cfg)
    return out
