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
falls back to the plain version. Given meta tensors (the dry run) it
checks them as it checks CUDA ones, allocates what the kernel's launch
allocates (y, the final state and, on the tensor-core path, the state
ring; the path from ``meta_path``, which the card's kernel lint holds to
the C rule) and reports the launch and its ``cost(...)`` to
``meta.report``; the ``launches`` counter counts the card's launches
only.

``KERNEL_CONTRACT`` is the launch's contract for
``repro_torch.analysis.kernel_lint``; ``tile_probe`` returns the y box of
every block (the scalar kernel's ``scalar_item``, the tensor-core
kernel's ``decode_ticket`` of ticket i for block i) on the launch's grid;
``out=(y, final_state)`` takes a caller's output buffers (the lint's
guarded launches; nothing on the main path passes them).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, meta

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 128
MAX_SMEM_BYTES = 232448     # what one sm_90 block may opt in to

# The JAX grid is (batch, head, chunk) with the chunk axis sequential and a
# reduction for the final state. Here a block owns one work item, (b, h)
# on the scalar kernel and one ticket's (chunk, b, heads) on the tensor-core
# kernel, whose final state the last chunk's block alone writes: no
# reduction across blocks. S is a multiple of the chunk (ops.ssd halves the
# chunk until it divides), so nothing is masked.
KERNEL_CONTRACT = dict(
    kernel="ssm_scan",
    grid=("work",),
    out_dims=("s", "head", "batch"),
    reduction_axes=(),
    masked={},
    acc_dtype="float32",
    smem_limit_bytes=MAX_SMEM_BYTES,
    launches=1,
)


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


TC_WIDTHS = (16, 32, 48, 64, 128)    # P compiled for the tensor-core kernel


def scalar_smem_bytes(P: int, N: int, Q: int) -> int:
    """``ssm_scan_smem_bytes`` of ``csrc/ssm_scan.cu``: the scalar block's
    shared memory, which the meta branch holds to the card's limit as the
    CUDA branch does (the kernel lint compares the two on the card)."""
    ldn, ldm = N + 1 - N % 2, Q + 1 - Q % 2       # odd_stride
    return 4 * (N * P + Q * P + 2 * Q * ldn + min(Q, 32) * ldm + 3 * Q)


def meta_path(dtype: torch.dtype, P: int, N: int, chunk: int) -> str:
    """The kernel a call with these widths takes when x, B and C are
    16-byte aligned (a fresh allocation is): the C rule ``tc_path``,
    which a meta tensor cannot be asked (it has no address). Its shared
    memory test is left out: at these widths the block needs at most
    220,176 bytes. The card's kernel lint holds this to ``tc_path``."""
    tc = (dtype == torch.bfloat16 and P in TC_WIDTHS and N % 16 == 0 and 0 < N <= 128
          and chunk % 16 == 0 and 0 < chunk <= MAX_CHUNK)
    return "mma" if tc else "scalar"


def cost(B: int, S: int, H: int, P: int, N: int, chunk: int, dtype: torch.dtype):
    """``(flops, bytes)`` of one launch: per chunk of Q = chunk positions
    and head, the masked C B^T (2 tri N), its product with x (2 tri P)
    and the state's update and read-out (4 Q N P), tri = Q (Q + 1) / 2;
    x, B, C, dt and A read once, y and the fp32 final state written
    once."""
    Q = chunk
    tri = Q * (Q + 1) // 2
    elem = torch.empty((), dtype=dtype).element_size()
    flops = B * H * (S // Q) * (2 * tri * N + 2 * tri * P + 4 * Q * N * P)
    nbytes = (2 * B * S * H * P * elem + B * S * H * 4 + H * 4 + 2 * B * S * N * elem
              + B * H * N * P * 4)
    return flops, nbytes


def launch_config(x: torch.Tensor, B_mat: torch.Tensor, chunk: int,
                  C_mat: torch.Tensor = None) -> dict:
    """The launch configuration ``ssm_scan(x, dt, A, B_mat, C_mat,
    chunk=chunk)`` uses (the C function its launch calls): output dims
    ``(S, H, B)``."""
    C_mat = B_mat if C_mat is None else C_mat
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on CUDA tensors, got x on {x.device}")
    fn = _library().ssm_scan_launch_config
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3 + [
        ctypes.POINTER(build.LaunchConfig)]
    fn.restype = ctypes.c_int
    Bsz, S, H, P = x.shape
    return build.launch_config(fn, _DTYPE_CODES[x.dtype], Bsz, S, H, P, B_mat.shape[-1],
                               min(chunk, S), x.data_ptr(), B_mat.data_ptr(),
                               C_mat.data_ptr())


def tile_probe(x: torch.Tensor, B_mat: torch.Tensor, chunk: int,
               C_mat: torch.Tensor = None):
    """The y box of every block ``ssm_scan(x, dt, A, B_mat, C_mat,
    chunk=chunk)`` launches, from the kernels' own block -> work
    functions on the launch's grid: an ``(n, 9)`` int64 array of
    ``writer (block), lo, hi`` in ``(S, H, B)``."""
    C_mat = B_mat if C_mat is None else C_mat
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on CUDA tensors, got x on {x.device}")
    fn = _library().ssm_scan_tile_probe
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    Bsz, S, H, P = x.shape
    args = (_DTYPE_CODES[x.dtype], Bsz, S, H, P, B_mat.shape[-1], min(chunk, S),
            x.data_ptr(), B_mat.data_ptr(), C_mat.data_ptr())
    return build.tile_boxes(
        lambda boxes, cap, count, stream: fn(*args, boxes, cap, count, stream), x.device)


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
    if x.device.type not in ("cuda", "meta"):
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
    if not meta.is_meta(x):
        build.require_hopper(x.device, "ssm_scan")


def ssm_scan(
    x: torch.Tensor,        # (B, S, H, P)
    dt: torch.Tensor,       # (B, S, H) float32
    A: torch.Tensor,        # (H,) float32
    B_mat: torch.Tensor,    # (B, S, N)
    C_mat: torch.Tensor,    # (B, S, N)
    *,
    chunk: int = 128,
    out=None,
):
    """Returns ``(y (B,S,H,P) in x's dtype, final state (B,H,N,P) fp32)``,
    new tensors or the pair ``out``."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    chunk = min(chunk, x.shape[1])
    _check(x, dt, A, B_mat, C_mat, chunk)
    Bsz, S, H, P = x.shape
    N = B_mat.shape[-1]
    if out is None:
        y = torch.empty_like(x)
        h_out = torch.empty((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    else:
        y, h_out = out
        build.check_out("ssm_scan", y, x.shape, x.dtype, x.device)
        build.check_out("ssm_scan", h_out, (Bsz, H, N, P), torch.float32, x.device)
    if meta.is_meta(x):
        return _meta_launch(x, y, h_out, Bsz, S, H, P, N, chunk)
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


def _meta_launch(x, y, h_out, Bsz, S, H, P, N, chunk):
    """The dry run's launch: what the card's launch allocates (the state
    ring on the tensor-core path; the zeroed scratch is kept per stream
    and not counted) and the report of the launch and its cost."""
    path = meta_path(x.dtype, P, N, chunk)
    smem = scalar_smem_bytes(P, N, chunk)
    if path == "scalar" and smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"P={P}, N={N}, chunk={chunk} needs {smem} bytes of shared memory "
            f"per block, over the {MAX_SMEM_BYTES} an sm_90 block may use"
        )
    if y.numel() == 0:
        return y, h_out
    if path == "mma":
        ring = torch.empty(scratch_sizes(Bsz, S, H, P, N, chunk)[0], dtype=torch.float32,
                           device=x.device)
        del ring
    meta.report("ssm_scan", *cost(Bsz, S, H, P, N, chunk, x.dtype), x.dtype)
    return y, h_out
