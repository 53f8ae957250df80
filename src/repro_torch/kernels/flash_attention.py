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
every ``head_dim`` of the model registry.
``kernel_path`` says which a call takes; the rule lives in the CUDA
source.

It masks the ragged q and k edges itself, so unlike the JAX wrapper no
caller pads to block multiples. It has no backward: the serving prefill
runs it, training keeps the model's ``sdpa``.

The wrapper launches on PyTorch's current stream without synchronizing
and counts its launches in ``flash_attention.launches``. It raises on
anything the kernel does not take (and on a card other than sm_90); it
never falls back to the plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 112, 128, 192, 256)


def _library():
    lib = build.load("flash_attention")
    path = lib.flash_attention_path
    if path.argtypes is None:
        path.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]   # dtype, hd, Sk
        path.restype = ctypes.c_int
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int,                                        # dtype
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # q, k, v
            ctypes.c_void_p,                                     # out
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # B, Sq, Sk
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # Hq, Hkv, hd
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # causal, window, kv_len
            ctypes.c_float, ctypes.c_void_p,                     # sm_scale, stream
        ]
        fn.restype = ctypes.c_int
    return lib


def kernel_path(q: torch.Tensor, k: torch.Tensor) -> str:
    """The kernel ``flash_attention(q, k, v)`` launches for these
    operands: ``"wgmma"`` (tensor cores, TMA) or ``"scalar"``."""
    _check(q, k, k, 0)
    code = _library().flash_attention_path(_DTYPE_CODES[q.dtype], q.shape[3], k.shape[1])
    return "wgmma" if code else "scalar"


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: int) -> None:
    if q.device.type != "cuda":
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
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype} is not float32 or bfloat16")
    B, _, Hq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(
            f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}"
        )
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one of the compiled widths {HEAD_DIMS}")
    if k.shape[2] == 0 or Hq % k.shape[2]:
        raise ValueError(f"{Hq} query heads do not group over {k.shape[2]} kv heads")
    if not 0 <= kv_len <= k.shape[1]:
        raise ValueError(f"kv_len {kv_len} out of range for Sk={k.shape[1]}")
    build.require_hopper(q.device, "flash_attention")


def flash_attention(
    q: torch.Tensor,            # (B, Sq, Hq, hd)
    k: torch.Tensor,            # (B, Sk, Hkv, hd)
    v: torch.Tensor,            # (B, Sk, Hkv, hd)
    *,
    causal: bool = True,
    window: int = 0,
    kv_len: int = 0,
) -> torch.Tensor:
    """Attention of q over k/v on the card; out (B, Sq, Hq, hd) in q's
    dtype. Query i and key j sit at positions i and j; ``kv_len > 0``
    masks keys at positions >= kv_len."""
    _check(q, k, v, kv_len)
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    launch = _library().flash_attention_launch
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = launch(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, Sq, Sk, Hq, Hkv, hd,
            int(bool(causal)), int(window), int(kv_len),
            1.0 / math.sqrt(hd), stream,
        )
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
