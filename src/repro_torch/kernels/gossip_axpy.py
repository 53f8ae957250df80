"""Fused gossip-consensus update: the Hopper kernel's wrapper.

The port of ``repro.kernels.gossip_axpy``. MATCHA's consensus step on a
matched node is, per parameter leaf,

    x <- x + alpha * (y - x)

with ``y`` the node's fp32 gossip target. The CUDA C++ kernel
(``csrc/gossip_axpy.cu``) does it in one pass over device memory, in
fp32, and stores in x's dtype; ``repro_torch.kernels.ref.gossip_axpy_ref``
is its plain PyTorch version.

The wrapper launches on PyTorch's current stream without synchronizing
and counts its launches in ``gossip_axpy.launches``, so a run can show
that its main path went through the kernel. It raises on anything the
kernel does not take (and on a card other than sm_90); it never falls
back to the plain version. Given meta tensors (the dry run) it checks
them as it checks CUDA ones, allocates the kernel's output and reports
the launch and its ``cost(...)`` to ``repro_torch.kernels.meta``; the
``launches`` counter counts the card's launches only.

``KERNEL_CONTRACT`` is the launch's contract for
``repro_torch.analysis.kernel_lint``; ``tile_probe`` returns the element
boxes each block stores, from the kernel's own split and tile stride on
the launch's grid; ``out=`` takes a caller's output buffer (the lint's
guarded launches; nothing on the main path passes one).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, meta

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The JAX kernel pads to whole blocks and slices the pad off (masked {}).
# The port pads nothing: a tile's vectors past the whole vectors are
# guarded (v < nvec), and the elements after the last whole vector run on a
# scalar tail, the port's own masked axis. No shared memory.
KERNEL_CONTRACT = dict(
    kernel="gossip_axpy",
    grid=("block",),
    out_dims=("n",),
    reduction_axes=(),
    masked={"tail": "n"},
    acc_dtype="float32",
    smem_limit_bytes=0,
    launches=1,
)


def _library():
    lib = build.load("gossip_axpy")
    fn = lib.gossip_axpy_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int, ctypes.c_int,                      # x, y dtype codes
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # x, y, out
            ctypes.c_int64, ctypes.c_float,                  # n, alpha
            ctypes.c_void_p,                                 # stream
        ]
        fn.restype = ctypes.c_int
    return fn


def cost(n: int, x_dtype: torch.dtype, y_dtype: torch.dtype):
    """``(flops, bytes)`` of one launch over n elements: 3 fp32 flops an
    element (a subtract, a multiply, an add); x and y read once, the
    result written once in x's dtype."""
    ex = torch.empty((), dtype=x_dtype).element_size()
    ey = torch.empty((), dtype=y_dtype).element_size()
    return 3 * n, n * (2 * ex + ey)


def launch_config(x: torch.Tensor, y: torch.Tensor) -> dict:
    """The launch configuration ``gossip_axpy(x, y, alpha)`` uses (the C
    function its launch calls): output dims ``(n, 1, 1)``."""
    _check(x, y)
    fn = build.load("gossip_axpy").gossip_axpy_launch_config
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                   ctypes.POINTER(build.LaunchConfig)]
    fn.restype = ctypes.c_int
    return build.launch_config(fn, _DTYPE_CODES[x.dtype], _DTYPE_CODES[y.dtype], x.numel())


def tile_probe(x: torch.Tensor, y: torch.Tensor, out: torch.Tensor = None):
    """The element boxes every block of ``gossip_axpy(x, y, alpha)``
    stores (its split depends on the addresses: ``out`` is the output
    buffer, a fresh one when not given): an ``(n, 9)`` int64 array of
    ``writer (block), lo, hi`` along ``(n, 1, 1)``."""
    _check(x, y)
    out = torch.empty_like(x) if out is None else out
    fn = build.load("gossip_axpy").gossip_axpy_tile_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    cx, cy = _DTYPE_CODES[x.dtype], _DTYPE_CODES[y.dtype]
    return build.tile_boxes(
        lambda boxes, cap, count, stream: fn(cx, cy, x.data_ptr(), y.data_ptr(),
                                             out.data_ptr(), x.numel(), boxes, cap, count,
                                             stream), x.device)


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(
            f"gossip_axpy runs on a CUDA tensor, got one on {x.device}; "
            "the plain version is repro_torch.kernels.ref.gossip_axpy_ref"
        )
    if y.device != x.device:
        raise ValueError(f"x on {x.device} but y on {y.device}")
    for name, t in (("x", x), ("y", y)):
        if t.dtype not in _DTYPE_CODES:
            raise ValueError(f"{name} dtype {t.dtype} is not float32 or bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.shape != y.shape:
        raise ValueError(f"operand shapes differ: {tuple(x.shape)} vs {tuple(y.shape)}")
    if not meta.is_meta(x):
        build.require_hopper(x.device, "gossip_axpy")


def gossip_axpy(
    x: torch.Tensor, y: torch.Tensor, alpha: float, *, inplace: bool = False,
    out: torch.Tensor = None,
) -> torch.Tensor:
    """``x + alpha * (y - x)`` in fp32, stored in x's dtype, on the card.

    x and y are contiguous CUDA tensors of one shape, each float32 or
    bfloat16 (y may be fp32 while x is bf16). With ``inplace=True`` the
    result overwrites x, which is returned; else it goes to ``out`` when
    given, a new tensor when not."""
    _check(x, y)
    if out is not None:
        if inplace:
            raise ValueError("gossip_axpy takes inplace=True or out=, not both")
        build.check_out("gossip_axpy", out, x.shape, x.dtype, x.device)
    elif inplace:
        out = x
    else:
        out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    if meta.is_meta(x):
        meta.report("gossip_axpy", *cost(n, x.dtype, y.dtype), torch.float32)
        return out
    launch = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[y.dtype],
            x.data_ptr(), y.data_ptr(), out.data_ptr(),
            n, float(alpha), stream,
        )
    if err:
        raise RuntimeError(f"gossip_axpy launch failed: cudaError {err}")
    gossip_axpy.launches += 1
    return out


gossip_axpy.launches = 0
