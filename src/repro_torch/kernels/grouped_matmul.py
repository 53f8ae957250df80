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
the plain version. Given meta tensors (the dry run) each checks them as
it checks CUDA ones, allocates its kernel's output and reports the
launch and its ``cost(...)`` to ``meta.report`` (the ``launches``
counters count the card's launches only); ``GroupedMatmul`` then runs
the meta branches forward and backward.

``KERNEL_CONTRACT`` (the forward), ``KERNEL_CONTRACT_DX`` and
``KERNEL_CONTRACT_DW`` are the launches' contracts for
``repro_torch.analysis.kernel_lint``; ``tile_probe`` returns the output
box of every tile a launch stores, from the kernels' own ``tile_coords``,
``locate_tile`` and ``dw_tile`` on the launch's grid; ``out=`` takes a
caller's output buffer (the lint's guarded launches; nothing on the main
path passes one).
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import build, meta
from repro_torch.kernels.ref import (
    grouped_matmul_dw_ref,
    grouped_matmul_dx_ref,
    grouped_matmul_ref,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KINDS = {"forward": 0, "dx": 1, "dw": 2}

# The forward's contract. The JAX grid is (row block, column block, group)
# with the group a reduction axis (every group visits every row block and
# masks the rows it does not own); here a tile belongs to one group (or to
# the rows past the groups), the 1-D grid's blocks map to (row tile, column
# tile) through tile_coords' bands, and no two blocks store one element.
# Rows past sum(group_sizes) are written as 0 and their x rows are never
# stored from; columns past N are guarded.
KERNEL_CONTRACT = dict(
    kernel="grouped_matmul",
    grid=("tile",),
    out_dims=("rows", "cols"),
    reduction_axes=(),
    masked={"rows": "group_sizes", "cols": "N"},
    acc_dtype="float32",
    smem_limit_bytes=232448,
    launches=1,
)
# dx: the forward's tiles over (M, K).
KERNEL_CONTRACT_DX = dict(KERNEL_CONTRACT, kernel="grouped_matmul_dx",
                          masked={"rows": "group_sizes", "cols": "K"})
# dw: tiles of (group, K, N), a tile's rows the reduction inside its block
# (rows of a slice past the group are zeroed before the product); the
# tensor-core kernel is persistent, each block walking tiles with the
# grid's stride, so the grid axis names the tile.
KERNEL_CONTRACT_DW = dict(KERNEL_CONTRACT, kernel="grouped_matmul_dw",
                          out_dims=("k", "n", "group"),
                          masked={"rows": "group_sizes", "k": "K", "n": "N"})
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


def cost(kind: str, M: int, K: int, N: int, G: int, dtype: torch.dtype, *,
         rows: int = None, live: int = None):
    """``(flops, bytes)`` of one launch of ``kind`` (``"forward"``,
    ``"dx"`` or ``"dw"``) over x (M, K), w or dw (G, K, N) and the (M, N)
    output or dy: 2 K N flops per row inside the groups (``rows``, all M
    when not given: a meta tensor has no sizes); each operand read once
    and the output written once, of w only the ``live`` groups' (non-empty;
    all G when not given), and the (G,) int32 sizes."""
    rows = M if rows is None else rows
    live = G if live is None else live
    elem = torch.empty((), dtype=dtype).element_size()
    flops = 2 * rows * K * N
    if kind == "dw":
        nbytes = (M * K + M * N + G * K * N) * elem
    elif kind in ("forward", "dx"):
        nbytes = (M * K + live * K * N + M * N) * elem
    else:
        raise ValueError(f"unknown kind {kind!r}: expected one of {tuple(_KINDS)}")
    return flops, nbytes + 4 * G


def launch_config(a: torch.Tensor, b: torch.Tensor, G: int, *, kind: str = "forward") -> dict:
    """The launch configuration a call of ``kind`` uses for these operands
    (the C function its launch calls), ``G`` groups: output dims
    ``(M, N, 1)`` forward, ``(M, K, 1)`` dx, ``(K, N, G)`` dw."""
    if a.device.type != "cuda":
        raise ValueError(f"the grouped matmul runs on CUDA tensors, got one on {a.device}")
    if kind == "forward":
        M, K, N = a.shape[0], a.shape[1], b.shape[2]
    elif kind == "dx":
        M, N, K = a.shape[0], a.shape[1], b.shape[1]
    elif kind == "dw":
        M, K, N = a.shape[0], a.shape[1], b.shape[1]
    else:
        raise ValueError(f"unknown kind {kind!r}: expected one of {tuple(_KINDS)}")
    fn = _library().grouped_matmul_launch_config
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.POINTER(build.LaunchConfig)]
    fn.restype = ctypes.c_int
    return build.launch_config(fn, _KINDS[kind], _DTYPE_CODES[a.dtype], a.data_ptr(),
                               b.data_ptr(), None, M, K, N, G)


def tile_probe(a: torch.Tensor, b: torch.Tensor, group_sizes: torch.Tensor, *,
               kind: str = "forward", out: torch.Tensor = None):
    """The output box of every tile a launch of ``kind`` stores for these
    operands (``out`` the output buffer, a fresh one when not given), from
    the kernels' own tile functions on the launch's grid: an ``(n, 9)``
    int64 array of ``writer (tile), lo, hi`` along the output dims of
    ``launch_config``."""
    if kind == "forward":
        _check(a, b, group_sizes)
        M, K, N = a.shape[0], a.shape[1], b.shape[2]
    elif kind == "dx":
        _check_dx(a, b, group_sizes)
        M, N, K = a.shape[0], a.shape[1], b.shape[1]
    elif kind == "dw":
        _check_dw(a, b, group_sizes)
        M, K, N = a.shape[0], a.shape[1], b.shape[1]
    else:
        raise ValueError(f"unknown kind {kind!r}: expected one of {tuple(_KINDS)}")
    fn = _library().grouped_matmul_tile_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    which, code, G = _KINDS[kind], _DTYPE_CODES[a.dtype], group_sizes.shape[0]
    o = None if out is None else out.data_ptr()
    return build.tile_boxes(
        lambda boxes, cap, count, stream: fn(which, code, a.data_ptr(), b.data_ptr(),
                                             group_sizes.data_ptr(), o, M, K, N, G, boxes,
                                             cap, count, stream), a.device)


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
    if t0.device.type not in ("cuda", "meta"):
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
    if not meta.is_meta(x):
        build.require_hopper(x.device, "grouped_matmul")


def _check_dx(dy: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> None:
    _check_operands("grouped_matmul_dx", [("dy", dy, 2), ("w", w, 3)], group_sizes)
    if w.shape[2] != dy.shape[1] or w.shape[0] != group_sizes.shape[0] or not w.shape[0]:
        raise ValueError(
            f"w {tuple(w.shape)} does not fit dy {tuple(dy.shape)} and "
            f"{group_sizes.shape[0]} groups"
        )
    if not meta.is_meta(dy):
        build.require_hopper(dy.device, "grouped_matmul_dx")


def _check_dw(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor) -> None:
    _check_operands("grouped_matmul_dw", [("x", x, 2), ("dy", dy, 2)], group_sizes)
    if dy.shape[0] != x.shape[0] or not group_sizes.shape[0]:
        raise ValueError(
            f"dy {tuple(dy.shape)} does not fit x {tuple(x.shape)} and "
            f"{group_sizes.shape[0]} groups"
        )
    if not meta.is_meta(x):
        build.require_hopper(x.device, "grouped_matmul_dw")


def _meta_launch(wrapper, kind: str, out, M, K, N, G):
    """The dry run's launch: the output is already allocated; the cost
    (every row and group taken as live) goes to ``meta.report``."""
    meta.report(wrapper.__name__, *cost(kind, M, K, N, G, out.dtype), out.dtype)
    return out


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


def _output(kernel: str, out, shape, like: torch.Tensor) -> torch.Tensor:
    """A new output of ``shape`` in ``like``'s dtype and device, or the
    caller's ``out`` checked against it."""
    if out is None:
        return torch.empty(shape, dtype=like.dtype, device=like.device)
    build.check_out(kernel, out, shape, like.dtype, like.device)
    return out


def grouped_matmul(
    x: torch.Tensor,             # (M, K), rows sorted by group
    w: torch.Tensor,             # (G, K, N)
    group_sizes: torch.Tensor,   # (G,) int32, on the card
    *,
    out: torch.Tensor = None,
) -> torch.Tensor:
    """``out (M, N)`` in x's dtype on the card (a new tensor, or
    ``out``): row r of group g is ``x[r] @ w[g]``, summed in fp32; rows
    past ``sum(group_sizes)`` are 0. Rows past M of a group whose sizes
    overrun M are dropped."""
    _check(x, w, group_sizes)
    M, K = x.shape
    G, _, N = w.shape
    out = _output("grouped_matmul", out, (M, N), x)
    if out.numel() == 0:
        return out
    if meta.is_meta(x):
        return _meta_launch(grouped_matmul, "forward", out, M, K, N, G)
    _launch("grouped_matmul_launch", x, w, group_sizes, out, M, K, N, G)
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0


def grouped_matmul_dx(
    dy: torch.Tensor,            # (M, N), the output's gradient
    w: torch.Tensor,             # (G, K, N)
    group_sizes: torch.Tensor,   # (G,) int32, on the card
    *,
    out: torch.Tensor = None,
) -> torch.Tensor:
    """``dx (M, K)`` in dy's dtype on the card (a new tensor, or
    ``out``): row r of group g is ``dy[r] @ w[g]^T``, summed in fp32;
    rows past ``sum(group_sizes)`` are 0, groups clipped to M as in the
    forward."""
    _check_dx(dy, w, group_sizes)
    M, N = dy.shape
    G, K, _ = w.shape
    dx = _output("grouped_matmul_dx", out, (M, K), dy)
    if dx.numel() == 0:
        return dx
    if meta.is_meta(dy):
        return _meta_launch(grouped_matmul_dx, "dx", dx, M, K, N, G)
    _launch("grouped_matmul_dx_launch", dy, w, group_sizes, dx, M, K, N, G)
    grouped_matmul_dx.launches += 1
    return dx


grouped_matmul_dx.launches = 0


def grouped_matmul_dw(
    x: torch.Tensor,             # (M, K), rows sorted by group
    dy: torch.Tensor,            # (M, N), the output's gradient
    group_sizes: torch.Tensor,   # (G,) int32, on the card
    *,
    out: torch.Tensor = None,
) -> torch.Tensor:
    """``dw (G, K, N)`` in x's dtype on the card (a new tensor, or
    ``out``): ``dw[g]`` is the fp32 sum over group g's rows, in ascending
    order, of ``x[r]^T dy[r]``; an empty group's is 0 and rows past the
    groups add nothing."""
    _check_dw(x, dy, group_sizes)
    M, K = x.shape
    N = dy.shape[1]
    G = group_sizes.shape[0]
    dw = _output("grouped_matmul_dw", out, (G, K, N), x)
    if dw.numel() == 0:
        return dw
    if meta.is_meta(x):
        return _meta_launch(grouped_matmul_dw, "dw", dw, M, K, N, G)
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
