"""Mamba2 SSD chunk scan: the Hopper kernel's wrapper.

The port of ``repro.kernels.ssm_scan``. The CUDA C++ kernel
(``csrc/ssm_scan.cu``) runs the selective state-space recurrence chunk
by chunk with an fp32 ``(N, P)`` state per (batch, head), starting from
zero, and returns ``y`` in x's dtype and the final state in fp32.
``repro_torch.kernels.ref.ssm_scan_ref`` (the sequential recurrence) is
its plain PyTorch version.

It needs ``S % chunk == 0`` (``ops.ssd`` halves the chunk until it
divides) and has no backward: the serving prefill runs it, training
keeps the model's ``ssd_chunked``.

The wrapper launches on PyTorch's current stream without synchronizing
and counts its launches in ``ssm_scan.launches``. It raises on anything
the kernel does not take (and on a card other than sm_90); it never
falls back to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 128
MAX_SMEM_BYTES = 232448     # what one sm_90 block may opt in to


def _library():
    lib = build.load("ssm_scan")
    fn = lib.ssm_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int,                                        # dtype
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # x, dt, A
            ctypes.c_void_p, ctypes.c_void_p,                    # B, C
            ctypes.c_void_p, ctypes.c_void_p,                    # y, h_out
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, S, H
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # P, N, chunk
            ctypes.c_void_p,                                     # stream
        ]
        fn.restype = ctypes.c_int
        lib.ssm_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.ssm_scan_smem_bytes.restype = ctypes.c_longlong
    return lib


def _check(x, dt, A, B_mat, C_mat, chunk: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(
            f"ssm_scan runs on CUDA tensors, got x on {x.device}; "
            "the plain version is repro_torch.kernels.ref.ssm_scan_ref"
        )
    named = (("x", x), ("dt", dt), ("A", A), ("B", B_mat), ("C", C_mat))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"x on {x.device} but {name} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x dtype {x.dtype} is not float32 or bfloat16")
    for name, t in (("B", B_mat), ("C", C_mat)):
        if t.dtype != x.dtype:
            raise ValueError(f"{name} dtype {t.dtype} differs from x's {x.dtype}")
    for name, t in (("dt", dt), ("A", A)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    Bsz, S, H, _ = x.shape
    if dt.shape != (Bsz, S, H) or A.shape != (H,):
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    if B_mat.shape != C_mat.shape or B_mat.dim() != 3 or B_mat.shape[:2] != (Bsz, S):
        raise ValueError(f"B {tuple(B_mat.shape)} / C {tuple(C_mat.shape)} do not "
                         f"fit x {tuple(x.shape)}")
    if not 0 < chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"chunk {chunk} must be in 1..{MAX_CHUNK} and divide S={S}")
    build.require_hopper(x.device, "ssm_scan")


def ssm_scan(
    x: torch.Tensor,        # (B, S, H, P)
    dt: torch.Tensor,       # (B, S, H) float32
    A: torch.Tensor,        # (H,) float32
    B_mat: torch.Tensor,    # (B, S, N)
    C_mat: torch.Tensor,    # (B, S, N)
    *,
    chunk: int = 128,
):
    """Returns ``(y (B,S,H,P) in x's dtype, final state (B,H,N,P) fp32)``."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    chunk = min(chunk, x.shape[1])
    _check(x, dt, A, B_mat, C_mat, chunk)
    Bsz, S, H, P = x.shape
    N = B_mat.shape[-1]
    y = torch.empty_like(x)
    h_out = torch.empty((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    lib = _library()
    smem = lib.ssm_scan_smem_bytes(P, N, chunk)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"P={P}, N={N}, chunk={chunk} needs {smem} bytes of shared memory "
            f"per block, over the {MAX_SMEM_BYTES} an sm_90 block may use"
        )
    if y.numel() == 0:
        return y, h_out.zero_()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssm_scan_launch(
            _DTYPE_CODES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B_mat.data_ptr(), C_mat.data_ptr(), y.data_ptr(), h_out.data_ptr(),
            Bsz, S, H, P, N, chunk, stream,
        )
    if err:
        raise RuntimeError(f"ssm_scan launch failed: cudaError {err}")
    ssm_scan.launches += 1
    return y, h_out


ssm_scan.launches = 0
