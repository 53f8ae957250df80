"""Mamba2 SSD chunk scan: the Hopper kernel's wrapper.

The port of ``repro.kernels.ssm_scan``. The CUDA C++ kernels
(``csrc/ssm_scan.cu``) run the selective state-space recurrence chunk
by chunk with an fp32 ``(N, P)`` state per (batch, head), starting from
zero, and return ``y`` in x's dtype and the final state in fp32.
``repro_torch.kernels.ref.ssm_scan_ref`` (the sequential recurrence) is
their plain PyTorch version. bf16 with P one of 16, 32, 48, 64 or 128,
N a multiple of 16 up to 128, a chunk that is a multiple of 16 and
16-byte aligned x, B and C runs on the tensor cores, chunks in parallel
with one chained pass over the state; fp32 and every other shape on the
scalar kernel. ``kernel_path`` says which a call takes; the rule lives
in the CUDA source.

It needs ``S % chunk == 0`` (``ops.ssd`` halves the chunk until it
divides) and has no backward: the serving prefill runs it, training
keeps the model's ``ssd_chunked``.

The tensor-core kernel hands the state from chunk to chunk through a
two-slot fp32 ring (allocated per call) under per-(b, h, chunk) flags
and a work ticket: a small int32 scratch, zeroed once per (device,
stream) and left zeroed by every call (``scratch_sizes`` gives both
sizes).

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


_SCRATCH = {}   # (device index, stream) -> zeroed int32 scratch


def _library():
    lib = build.load("ssm_scan")
    fn = lib.ssm_scan_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int,                                        # dtype
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # x, dt, A
            ctypes.c_void_p, ctypes.c_void_p,                    # B, C
            ctypes.c_void_p, ctypes.c_void_p,                    # y, h_out
            ctypes.c_void_p, ctypes.c_void_p,                    # ring, scratch
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, S, H
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # P, N, chunk
            ctypes.c_void_p,                                     # stream
        ]
        fn.restype = ctypes.c_int
        lib.ssm_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.ssm_scan_smem_bytes.restype = ctypes.c_longlong
        lib.ssm_scan_path.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
        lib.ssm_scan_path.restype = ctypes.c_int
    return lib


def scratch_sizes(Bsz: int, S: int, H: int, P: int, N: int, chunk: int):
    """``(ring, scratch)`` element counts of the tensor-core kernel: the
    fp32 state ring (2 slots of ``(B, H, N, P)``) and the int32 scratch
    (ticket, done count, one flag per (b, h, chunk))."""
    return 2 * Bsz * H * N * P, 2 + Bsz * H * (S // chunk)


def _scratch(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 for calls on this device and stream.
    Every call leaves its scratch zeroed, so it is zeroed only when made;
    a larger need makes a new one (the old one is freed in stream order)."""
    key = (device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _SCRATCH[key] = buf
    return buf


def kernel_path(x: torch.Tensor, B_mat: torch.Tensor, chunk: int,
                C_mat: torch.Tensor = None) -> str:
    """The kernel ``ssm_scan(x, dt, A, B_mat, C_mat, chunk=chunk)``
    launches: ``"mma"`` (tensor cores, chunks in parallel) or
    ``"scalar"``. C's alignment is taken to be B's unless C is given."""
    C_mat = B_mat if C_mat is None else C_mat
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on CUDA tensors, got x on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x dtype {x.dtype} is not float32 or bfloat16")
    chunk = min(chunk, x.shape[1])
    code = _library().ssm_scan_path(_DTYPE_CODES[x.dtype], x.shape[3], B_mat.shape[-1],
                                    chunk, x.data_ptr(), B_mat.data_ptr(), C_mat.data_ptr())
    return "mma" if code else "scalar"


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
    mma = kernel_path(x, B_mat, chunk, C_mat) == "mma"
    smem = lib.ssm_scan_smem_bytes(P, N, chunk)
    if not mma and smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"P={P}, N={N}, chunk={chunk} needs {smem} bytes of shared memory "
            f"per block, over the {MAX_SMEM_BYTES} an sm_90 block may use"
        )
    if y.numel() == 0:
        return y, h_out.zero_()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ring = scratch = None
        if mma:
            n_ring, n_scratch = scratch_sizes(Bsz, S, H, P, N, chunk)
            ring = torch.empty(n_ring, dtype=torch.float32, device=x.device)
            scratch = _scratch(x.device, stream, n_scratch)
        err = lib.ssm_scan_launch(
            _DTYPE_CODES[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B_mat.data_ptr(), C_mat.data_ptr(), y.data_ptr(), h_out.data_ptr(),
            None if ring is None else ring.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            Bsz, S, H, P, N, chunk, stream,
        )
    if err:
        raise RuntimeError(f"ssm_scan launch failed: cudaError {err}")
    ssm_scan.launches += 1
    return y, h_out


ssm_scan.launches = 0
