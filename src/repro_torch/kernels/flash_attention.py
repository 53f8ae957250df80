"""Flash attention (forward): the Hopper kernel's wrapper.

The port of ``repro.kernels.flash_attention``. The CUDA C++ kernels
(``csrc/flash_attention.cu``) compute blocked online-softmax attention
with causal and sliding-window masks, GQA (query head h reads kv head
``h // (Hq // Hkv)``) and ``kv_len`` masking of padded keys, with fp32
running statistics; a row with no live key is written as 0.
``repro_torch.kernels.ref.attention_ref`` is their plain PyTorch version.
bf16 with head_dim 64, 112, 128, 192 or 256 runs on the tensor cores
(wgmma fed by TMA; two warpgroups a block at 192 and 256); fp32, bf16 at
32 and a k/v with no keys on the scalar kernel. ``HEAD_DIMS`` holds
every ``head_dim`` of the model registry. v may be narrower than q and k
where ``HEAD_DIM_PAIRS`` holds the pair (q / k width, v width): latent
attention's (192, 128), bf16 on the wgmma kernel only; the output then
takes v's width and the scale stays 1/sqrt(q's width).
``kernel_path`` says which a call takes; the rule lives in the CUDA
source.

It masks the ragged q and k edges itself, so unlike the JAX wrapper no
caller pads to block multiples. Given ``lse=`` (an fp32 ``(B, Hq, Sq)``
buffer) it also writes each row's log-sum-exp of the scaled scores:
training's forward does (``kernels.flash_attention_bwd.FlashAttention``,
whose backward kernels rebuild P from it); the serving prefill passes
none and runs the kernel as before.

The wrapper launches on PyTorch's current stream without synchronizing
and counts its launches in ``flash_attention.launches``. It raises on
anything the kernel does not take (and on a card other than sm_90); it
never falls back to the plain version. Given meta tensors (the dry run)
it checks them as it checks CUDA ones, allocates the kernel's output
(no scores: the plain version's (Sq, Sk) tensor is not the kernel's),
and reports the launch and its ``cost(...)`` to ``meta.report``; the
``launches`` counter counts the card's launches only.

``KERNEL_CONTRACT`` is the launch's contract, which
``repro_torch.analysis.kernel_lint`` holds the card to: the grid axes
(``flash_tile`` in the CUDA source), the output dims in the order of
``launch_config``'s cover, the axes whose tails the kernels guard, fp32
accumulators and the shared-memory limit. ``tile_probe`` runs
``flash_tile`` on the launch's own grid and returns each block's output
box; ``out=`` takes a caller's output buffer (the lint's guarded
launches; nothing on the main path passes one).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, meta

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 112, 128, 192, 256)
# (q / k width, v width) pairs of unequal widths the wgmma kernel compiles
HEAD_DIM_PAIRS = ((192, 128),)

# The JAX kernel's contract, on the card: a block owns one (q tile, query
# head, batch row) tile and walks its k tiles itself, so no axis is a
# reduction across blocks. Keys past kv_len (and past Sk: TMA reads zeros,
# the scalar kernel guards its loads) never reach the softmax, as in the JAX
# kernel; the last q tile's rows past Sq are not stored (the port masks
# instead of padding).
KERNEL_CONTRACT = dict(
    kernel="flash_attention",
    grid=("q_tile", "q_head", "batch"),
    out_dims=("q", "q_head", "batch"),
    reduction_axes=(),
    masked={"kv": "kv_len", "q": "Sq"},
    acc_dtype="float32",
    smem_limit_bytes=232448,
    launches=1,
)


def _library():
    lib = build.load("flash_attention")
    path = lib.flash_attention_path
    if path.argtypes is None:
        path.argtypes = [ctypes.c_int] * 4                   # dtype, hd, hd_v, Sk
        path.restype = ctypes.c_int
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int,                                        # dtype
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
            ctypes.c_void_p, ctypes.c_void_p,                    # out, lse
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, Sq, Sk
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # Hq, Hkv, hd
            ctypes.c_int,                                        # hd_v
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # causal, window, kv_len
            ctypes.c_float, ctypes.c_void_p,                     # sm_scale, stream
        ]
        fn.restype = ctypes.c_int
    return lib


def live_pairs(Sq: int, Sk: int, causal: bool, window: int, kv_len: int) -> int:
    """Live (query, key) pairs: the work this input needs."""
    n = kv_len or Sk
    total = 0
    for i in range(Sq):
        hi = min(n, i + 1) if causal else n
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def cost(B: int, Sq: int, Sk: int, Hq: int, Hkv: int, hd: int, dtype: torch.dtype, *,
         causal: bool, window: int = 0, kv_len: int = 0, hd_v: int = None):
    """``(flops, bytes)`` of one launch: 2 (hd + hd_v) flops per live
    (query, key) pair and query head (q k^T over q / k's width ``hd``, p v
    over v's ``hd_v``, which defaults to ``hd``); q, k, v read once and the
    output written once."""
    hd_v = hd if hd_v is None else hd_v
    elem = torch.empty((), dtype=dtype).element_size()
    flops = 2 * (hd + hd_v) * B * Hq * live_pairs(Sq, Sk, causal, window, kv_len)
    nbytes = elem * B * (hd + hd_v) * (Sq * Hq + Sk * Hkv)
    return flops, nbytes


def launch_config(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor = None) -> dict:
    """The launch configuration ``flash_attention(q, k, v)`` uses (the C
    function its launch calls): output dims ``(Sq, Hq, B)``. ``v``
    defaults to k (one width)."""
    v = k if v is None else v
    _check(q, k, v, 0)
    fn = _library().flash_attention_launch_config
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(build.LaunchConfig)]
    fn.restype = ctypes.c_int
    B, Sq, Hq, hd = q.shape
    return build.launch_config(fn, _DTYPE_CODES[q.dtype], B, Sq, k.shape[1], Hq, hd,
                               v.shape[3])


def tile_probe(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor = None):
    """The output box of every block ``flash_attention(q, k, v)``
    launches, from the kernels' own ``flash_tile`` on the launch's grid:
    an ``(n, 9)`` int64 array of ``writer (q tile, head, batch), lo, hi``
    in ``(Sq, Hq, B)``. ``v`` defaults to k."""
    v = k if v is None else v
    _check(q, k, v, 0)
    fn = _library().flash_attention_tile_probe
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, Sq, Hq, hd = q.shape
    code, Sk, hd_v = _DTYPE_CODES[q.dtype], k.shape[1], v.shape[3]
    return build.tile_boxes(
        lambda boxes, cap, count, stream: fn(code, B, Sq, Sk, Hq, hd, hd_v, boxes, cap, count,
                                             stream), q.device)


def kernel_path(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor = None) -> str:
    """The kernel ``flash_attention(q, k, v)`` launches for these
    operands: ``"wgmma"`` (tensor cores, TMA) or ``"scalar"``. ``v``
    defaults to k."""
    v = k if v is None else v
    _check(q, k, v, 0)
    code = _library().flash_attention_path(_DTYPE_CODES[q.dtype], q.shape[3], v.shape[3],
                                           k.shape[1])
    return "wgmma" if code else "scalar"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: int) -> None:
    on_meta = meta.is_meta(q)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(
            f"flash_attention runs on CUDA tensors, got q on {q.device}; "
            "the plain version is repro_torch.kernels.ref.attention_ref"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"q on {q.device} but {name} on {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} differs from q's {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, S, heads, head_dim), got {tuple(t.shape)}")
        if not t.is_contiguous() or (not on_meta and t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype} is not float32 or bfloat16")
    B, _, Hq, hd = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(
            f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}"
        )
    hd_v = v.shape[3]
    if hd_v != hd:
        if (hd, hd_v) not in HEAD_DIM_PAIRS:
            raise ValueError(f"q / k width {hd} over v width {hd_v} is not one of the "
                             f"compiled pairs {HEAD_DIM_PAIRS}")
        if q.dtype != torch.bfloat16 or k.shape[1] == 0:
            raise ValueError(f"the pair ({hd}, {hd_v}) runs on the wgmma kernel only: bf16 "
                             f"with at least one key, got {q.dtype} over {k.shape[1]} keys")
    elif hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one of the compiled widths {HEAD_DIMS}")
    if k.shape[2] == 0 or Hq % k.shape[2]:
        raise ValueError(f"{Hq} query heads do not group over {k.shape[2]} kv heads")
    if not 0 <= kv_len <= k.shape[1]:
        raise ValueError(f"kv_len {kv_len} out of range for Sk={k.shape[1]}")
    if not on_meta:
        build.require_hopper(q.device, "flash_attention")


def flash_attention(
    q: torch.Tensor,            # (B, Sq, Hq, hd)
    k: torch.Tensor,            # (B, Sk, Hkv, hd)
    v: torch.Tensor,            # (B, Sk, Hkv, hd_v)
    *,
    causal: bool = True,
    window: int = 0,
    kv_len: int = 0,
    out: torch.Tensor = None,
    lse: torch.Tensor = None,
) -> torch.Tensor:
    """Attention of q over k/v on the card; out (B, Sq, Hq, hd_v) in q's
    dtype (a new tensor, or ``out``). Query i and key j sit at positions
    i and j; ``kv_len > 0`` masks keys at positions >= kv_len. ``lse``, a
    contiguous fp32 (B, Hq, Sq) buffer, takes each row's log-sum-exp
    ``log sum_j exp(q_i . k_j / sqrt(hd))`` over its live keys (+inf for
    a row with none); only the wgmma kernel writes it, and a launch off
    its path (``kernel_path``) with ``lse`` is refused."""
    _check(q, k, v, kv_len)
    B, Sq, Hq, hd = q.shape
    Sk, Hkv, hd_v = k.shape[1], k.shape[2], v.shape[3]
    if out is None:
        out = torch.empty((B, Sq, Hq, hd_v), dtype=q.dtype, device=q.device)
    else:
        build.check_out("flash_attention", out, (B, Sq, Hq, hd_v), q.dtype, q.device)
    if lse is not None:
        build.check_out("flash_attention (lse)", lse, (B, Hq, Sq), torch.float32, q.device)
    if out.numel() == 0:
        return out
    if meta.is_meta(q):
        meta.report("flash_attention", *cost(B, Sq, Sk, Hq, Hkv, hd, q.dtype, causal=causal,
                                             window=window, kv_len=kv_len, hd_v=hd_v), q.dtype)
        return out
    launch = _library().flash_attention_launch
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), B, Sq, Sk, Hq, Hkv, hd,
            hd_v, int(bool(causal)), int(window), int(kv_len),
            1.0 / math.sqrt(hd), stream,
        )
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
