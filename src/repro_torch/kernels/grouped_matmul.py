"""Grouped (ragged) matmul, the MoE expert products: the Hopper kernel's
wrapper.

The port of ``repro.kernels.grouped_matmul``. The CUDA C++ kernel
(``csrc/grouped_matmul.cu``) computes ``out[r] = x[r] @ w[g(r)]`` for
rows sorted by group, ``g(r)`` from the cumulative ``group_sizes``, with
fp32 sums and the output in x's dtype; rows past ``sum(group_sizes)``
are 0. ``repro_torch.kernels.ref.grouped_matmul_ref`` is its plain
PyTorch version.

``group_sizes`` stays on the card: the kernel reads it itself, so the
wrapper never synchronizes with the host (the MoE layers call it three
times per layer, in every decode step too). bf16 operands whose K and N
are multiples of 8 take the tensor-core path (wgmma fed by TMA); fp32,
and any other bf16 shape, the scalar one. ``kernel_path`` says which a
call takes; the rule lives in the CUDA source. It has no backward: the
serving path runs it, and ``ops.grouped_matmul`` refuses autograd on the
card.

The wrapper launches on PyTorch's current stream and counts its
launches in ``grouped_matmul.launches``. It raises on anything the
kernel does not take (and on a card other than sm_90); it never falls
back to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _library():
    lib = build.load("grouped_matmul")
    fn = lib.grouped_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int,                                        # dtype
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # x, w, sizes
            ctypes.c_void_p,                                     # out
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # M, K, N
            ctypes.c_int, ctypes.c_void_p,                       # G, stream
        ]
        fn.restype = ctypes.c_int
    path = lib.grouped_matmul_path
    if path.argtypes is None:
        path.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,      # dtype, x, w
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,         # out, K, N
        ]
        path.restype = ctypes.c_int
    return lib


def kernel_path(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel ``grouped_matmul(x, w, sizes)`` launches for these
    operands: ``"wgmma"`` (tensor cores, TMA) or ``"scalar"``. The output
    is the wrapper's own fresh (aligned) allocation, so only x and w
    decide: a null pointer stands in for it."""
    _check(x, w, torch.zeros(w.shape[0], dtype=torch.int32, device=x.device))
    K, N = x.shape[1], w.shape[2]
    code = _library().grouped_matmul_path(
        _DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(), 0, K, N)
    return "wgmma" if code else "scalar"


def _check(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(
            f"grouped_matmul runs on CUDA tensors, got x on {x.device}; "
            "the plain version is repro_torch.kernels.ref.grouped_matmul_ref"
        )
    for name, t in (("w", w), ("group_sizes", group_sizes)):
        if t.device != x.device:
            raise ValueError(f"x on {x.device} but {name} on {t.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {x.dtype} is not float32 or bfloat16")
    if w.dtype != x.dtype:
        raise ValueError(f"w dtype {w.dtype} differs from x's {x.dtype}")
    if group_sizes.dtype != torch.int32:
        raise ValueError(f"group_sizes must be int32, got {group_sizes.dtype}")
    if x.dim() != 2 or w.dim() != 3 or group_sizes.dim() != 1:
        raise ValueError(
            f"expected x (M, K), w (G, K, N), group_sizes (G,); got "
            f"{tuple(x.shape)}, {tuple(w.shape)}, {tuple(group_sizes.shape)}"
        )
    if w.shape[1] != x.shape[1] or w.shape[0] != group_sizes.shape[0] or not w.shape[0]:
        raise ValueError(
            f"w {tuple(w.shape)} does not fit x {tuple(x.shape)} and "
            f"{group_sizes.shape[0]} groups"
        )
    for name, t in (("x", x), ("w", w), ("group_sizes", group_sizes)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    build.require_hopper(x.device, "grouped_matmul")


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
    launch = _library().grouped_matmul_launch
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(
            _DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
            group_sizes.data_ptr(), out.data_ptr(), M, K, N, G, stream,
        )
    if err:
        raise RuntimeError(f"grouped_matmul launch failed: cudaError {err}")
    grouped_matmul.launches += 1
    return out


grouped_matmul.launches = 0
