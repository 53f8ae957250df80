"""Grouped (ragged) matmul, the MoE expert products, and its gradients:
the Hopper kernels' wrappers and the autograd Function over them.

The port of ``repro.kernels.grouped_matmul``. The CUDA C++ kernel
(``csrc/grouped_matmul.cu``) computes ``out[r] = x[r] @ w[g(r)]`` for
rows sorted by group, ``g(r)`` from the cumulative ``group_sizes``, with
fp32 sums and the output in x's dtype; rows past ``sum(group_sizes)``
are 0. Two more kernels in the same source compute its gradients (JAX
differentiates ``lax.ragged_dot``; no TPU kernel stands behind them):
``grouped_matmul_dx`` (``dx[r] = dy[r] @ w[g(r)]^T``, rows past the
groups 0) and ``grouped_matmul_dw`` (``dw[g]``, the sum over the group's
rows of ``x[r]^T dy[r]``; an empty group's is 0). Their plain PyTorch
versions are ``grouped_matmul_ref``, ``grouped_matmul_dx_ref`` and
``grouped_matmul_dw_ref`` in ``repro_torch.kernels.ref``.

``group_sizes`` stays on the card: the kernels read it themselves, so
the wrappers never synchronize with the host (the MoE layers call them
three times per layer, in every decode step too). bf16 operands whose
widths are multiples of 8 take the tensor-core path (wgmma fed by TMA);
fp32, and any other bf16 shape, the scalar one. ``kernel_path`` says
which a call takes; the rule lives in the CUDA source.

``GroupedMatmul`` is the autograd Function ``ops.grouped_matmul`` takes
on the card: the forward kernel, then ``grouped_matmul_dx`` when x needs
a gradient and ``grouped_matmul_dw`` when w does. Given CPU tensors it
runs the plain versions instead, forward and backward, which is how the
CPU tests reach its wiring.

The wrappers launch on PyTorch's current stream and count their
launches in ``<wrapper>.launches``. They raise on anything their kernel
does not take (and on a card other than sm_90); they never fall back to
the plain version.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import build
from repro_torch.kernels.ref import (
    grouped_matmul_dw_ref,
    grouped_matmul_dx_ref,
    grouped_matmul_ref,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KINDS = {"forward": 0, "dx": 1, "dw": 2}
_LAUNCH_ARGS = [
    ctypes.c_int,                                        # dtype
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # two operands, sizes
    ctypes.c_void_p,                                     # out
    ctypes.c_int, ctypes.c_int, ctypes.c_int,            # M, K, N
    ctypes.c_int, ctypes.c_void_p,                       # G, stream
]


def _library():
    lib = build.load("grouped_matmul")
    for name in ("grouped_matmul_launch", "grouped_matmul_dx_launch",
                 "grouped_matmul_dw_launch"):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = _LAUNCH_ARGS
            fn.restype = ctypes.c_int
    path = lib.grouped_matmul_path
    if path.argtypes is None:
        path.argtypes = [
            ctypes.c_int, ctypes.c_int,                          # kind, dtype
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # a, b, out
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # M, K, N
        ]
        path.restype = ctypes.c_int
    return lib


def kernel_path(a: torch.Tensor, b: torch.Tensor, *, kind: str = "forward") -> str:
    """The kernel a call launches for these operands: ``"wgmma"``
    (tensor cores, TMA) or ``"scalar"``. ``kind`` ``"forward"`` takes
    (x, w), ``"dx"`` (dy, w) and ``"dw"`` (x, dy). The output is the
    wrapper's own fresh (aligned) allocation, so only the operands
    decide: a null pointer stands in for it."""
    if kind == "forward":
        M, K, N = a.shape[0], a.shape[1], b.shape[2]
        G = b.shape[0]
    elif kind == "dx":
        M, N, K = a.shape[0], a.shape[1], b.shape[1]
        G = b.shape[0]
    elif kind == "dw":
        M, K, N = a.shape[0], a.shape[1], b.shape[1]
        G = 1
    else:
        raise ValueError(f"unknown kind {kind!r}: expected one of {tuple(_KINDS)}")
    sizes = torch.zeros(G, dtype=torch.int32, device=a.device)
    {"forward": _check, "dx": _check_dx, "dw": _check_dw}[kind](a, b, sizes)
    code = _library().grouped_matmul_path(
        _KINDS[kind], _DTYPE_CODES[a.dtype], a.data_ptr(), b.data_ptr(), 0, M, K, N)
    return "wgmma" if code else "scalar"


def _check_operands(kernel: str, named, group_sizes: torch.Tensor) -> None:
    """Device, dtype, rank and layout rules every kernel shares: ``named``
    is ``[(name, tensor, rank), ...]``, the first tensor decides the
    device and dtype."""
    first, t0, _ = named[0]
    if t0.device.type != "cuda":
        raise ValueError(
            f"{kernel} runs on CUDA tensors, got {first} on {t0.device}; "
            "its plain version is in repro_torch.kernels.ref"
        )
    for name, t, _ in [*named[1:], ("group_sizes", group_sizes, 1)]:
        if t.device != t0.device:
            raise ValueError(f"{first} on {t0.device} but {name} on {t.device}")
    if t0.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {t0.dtype} is not float32 or bfloat16")
    for name, t, _ in named[1:]:
        if t.dtype != t0.dtype:
            raise ValueError(f"{name} dtype {t.dtype} differs from {first}'s {t0.dtype}")
    if group_sizes.dtype != torch.int32:
        raise ValueError(f"group_sizes must be int32, got {group_sizes.dtype}")
    if any(t.dim() != rank for _, t, rank in named) or group_sizes.dim() != 1:
        raise ValueError(
            "expected " + ", ".join(f"{n} of rank {r}" for n, _, r in named)
            + ", group_sizes (G,); got "
            + ", ".join(str(tuple(t.shape)) for _, t, _ in named)
            + f", {tuple(group_sizes.shape)}"
        )
    for name, t, _ in [*named, ("group_sizes", group_sizes, 1)]:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> None:
    _check_operands("grouped_matmul", [("x", x, 2), ("w", w, 3)], group_sizes)
    if w.shape[1] != x.shape[1] or w.shape[0] != group_sizes.shape[0] or not w.shape[0]:
        raise ValueError(
            f"w {tuple(w.shape)} does not fit x {tuple(x.shape)} and "
            f"{group_sizes.shape[0]} groups"
        )
    build.require_hopper(x.device, "grouped_matmul")


def _check_dx(dy: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> None:
    _check_operands("grouped_matmul_dx", [("dy", dy, 2), ("w", w, 3)], group_sizes)
    if w.shape[2] != dy.shape[1] or w.shape[0] != group_sizes.shape[0] or not w.shape[0]:
        raise ValueError(
            f"w {tuple(w.shape)} does not fit dy {tuple(dy.shape)} and "
            f"{group_sizes.shape[0]} groups"
        )
    build.require_hopper(dy.device, "grouped_matmul_dx")


def _check_dw(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor) -> None:
    _check_operands("grouped_matmul_dw", [("x", x, 2), ("dy", dy, 2)], group_sizes)
    if dy.shape[0] != x.shape[0] or not group_sizes.shape[0]:
        raise ValueError(
            f"dy {tuple(dy.shape)} does not fit x {tuple(x.shape)} and "
            f"{group_sizes.shape[0]} groups"
        )
    build.require_hopper(x.device, "grouped_matmul_dw")


def _launch(fn_name: str, a, b, group_sizes, out, M, K, N, G) -> None:
    launch = getattr(_library(), fn_name)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = launch(
            _DTYPE_CODES[a.dtype], a.data_ptr(), b.data_ptr(),
            group_sizes.data_ptr(), out.data_ptr(), M, K, N, G, stream,
        )
    if err:
        raise RuntimeError(f"{fn_name} failed: cudaError {err}")


def grouped_matmul(
    x: torch.Tensor,             # (M, K), rows sorted by group
    w: torch.Tensor,             # (G, K, N)
    group_sizes: torch.Tensor,   # (G,) int32, on the card
) -> torch.Tensor:
    """``out (M, N)`` in x's dtype on the card: row r of group g is
    ``x[r] @ w[g]``, summed in fp32; rows past ``sum(group_sizes)`` are
    0. Rows past M of a group whose sizes overrun M are dropped."""
    _check(x, w, group_sizes)
    M, K = x.shape
    G, _, N = w.shape
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    _launch("grouped_matmul_launch", x, w, group_sizes, out, M, K, N, G)
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0


def grouped_matmul_dx(
    dy: torch.Tensor,            # (M, N), the output's gradient
    w: torch.Tensor,             # (G, K, N)
    group_sizes: torch.Tensor,   # (G,) int32, on the card
) -> torch.Tensor:
    """``dx (M, K)`` in dy's dtype on the card: row r of group g is
    ``dy[r] @ w[g]^T``, summed in fp32; rows past ``sum(group_sizes)``
    are 0, groups clipped to M as in the forward."""
    _check_dx(dy, w, group_sizes)
    M, N = dy.shape
    G, K, _ = w.shape
    dx = torch.empty((M, K), dtype=dy.dtype, device=dy.device)
    if dx.numel() == 0:
        return dx
    _launch("grouped_matmul_dx_launch", dy, w, group_sizes, dx, M, K, N, G)
    grouped_matmul_dx.launches += 1
    return dx


grouped_matmul_dx.launches = 0


def grouped_matmul_dw(
    x: torch.Tensor,             # (M, K), rows sorted by group
    dy: torch.Tensor,            # (M, N), the output's gradient
    group_sizes: torch.Tensor,   # (G,) int32, on the card
) -> torch.Tensor:
    """``dw (G, K, N)`` in x's dtype on the card: ``dw[g]`` is the fp32
    sum over group g's rows, in ascending order, of ``x[r]^T dy[r]``; an
    empty group's is 0 and rows past the groups add nothing."""
    _check_dw(x, dy, group_sizes)
    M, K = x.shape
    N = dy.shape[1]
    G = group_sizes.shape[0]
    dw = torch.empty((G, K, N), dtype=x.dtype, device=x.device)
    if dw.numel() == 0:
        return dw
    _launch("grouped_matmul_dw_launch", x, dy, group_sizes, dw, M, K, N, G)
    grouped_matmul_dw.launches += 1
    return dw


grouped_matmul_dw.launches = 0


class GroupedMatmul(torch.autograd.Function):
    """``out = grouped_matmul(x, w, group_sizes)`` with its gradients
    from ``grouped_matmul_dx`` and ``grouped_matmul_dw``; on CPU tensors
    from the plain versions. No gradient flows to ``group_sizes``."""

    @staticmethod
    def forward(x, w, group_sizes):
        if x.device.type == "cpu":
            with torch.no_grad():
                return grouped_matmul_ref(x, w, group_sizes)
        return grouped_matmul(x, w, group_sizes)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, group_sizes = inputs
        ctx.save_for_backward(x, w, group_sizes)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        cpu = dy.device.type == "cpu"
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (grouped_matmul_dx_ref if cpu else grouped_matmul_dx)(dy, w, group_sizes)
        if ctx.needs_input_grad[1]:
            dw = (grouped_matmul_dw_ref if cpu else grouped_matmul_dw)(x, dy, group_sizes)
        return dx, dw, None
