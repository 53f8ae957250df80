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
back to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if x.device.type != "cuda":
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
    build.require_hopper(x.device, "gossip_axpy")


def gossip_axpy(
    x: torch.Tensor, y: torch.Tensor, alpha: float, *, inplace: bool = False
) -> torch.Tensor:
    """``x + alpha * (y - x)`` in fp32, stored in x's dtype, on the card.

    x and y are contiguous CUDA tensors of one shape, each float32 or
    bfloat16 (y may be fp32 while x is bf16). With ``inplace=True`` the
    result overwrites x, which is returned."""
    _check(x, y)
    out = x if inplace else torch.empty_like(x)
    n = x.numel()
    if n == 0:
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
