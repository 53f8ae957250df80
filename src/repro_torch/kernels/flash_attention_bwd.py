"""Flash attention backward: the Hopper kernels' wrappers, and training's
differentiable flash attention.

No TPU kernel is ported here: the JAX model trains through a plain
einsum attention, and its Pallas flash kernel has no backward. The port
trains through :class:`FlashAttention`, a ``torch.autograd.Function``
whose forward is the flash kernel with its log-sum-exp output
(``kernels.flash_attention``) and whose backward is two kernels of
``csrc/flash_attention_bwd.cu``, bf16 on ``wgmma`` fed by TMA, at the
(q / k width, v width) pairs ``BACKWARD_HEAD_DIMS`` (hd 64 and 128, and
latent attention's q / k of 192 over a v of 128), causal or not, any GQA
group, Sq == Sk:

* ``flash_attention_dq`` (the dq pass): a block per (q tile, query head,
  batch row) computes ``D = rowsum(do * o)`` for its rows (and writes it),
  rebuilds ``P = exp(q k^T / sqrt(hd) - lse)`` tile by tile and sums
  ``dq = dS k / sqrt(hd)`` with ``dS = P (do v^T - D)`` in fp32 registers;
* ``flash_attention_dkdv`` (the dk / dv pass): a block per (k tile, kv
  head, batch row) sums ``dv = P^T do`` and ``dk = dS^T q / sqrt(hd)``
  over every query head of its group and every live q tile, in fp32
  registers.

Tiles wholly above the causal diagonal are skipped; the ragged end (S not
a multiple of 64) is masked in the kernels. No floating-point atomic is
used, so two launches on the same inputs give the same bits.
``repro_torch.kernels.ref.flash_attention_dq_ref`` / ``_dkdv_ref`` are the
plain versions, from the same lse and D.

Each wrapper launches on PyTorch's current stream without synchronizing,
allocates its outputs with ``torch.empty`` (or takes a caller's pair,
``out=``: the kernel lint's guarded launches), counts its launches in
``launches`` (the card's only) and raises on anything its kernel does not
take; given meta tensors it checks them alike, allocates the outputs and
reports the launch and its ``pass_cost`` to ``meta.report`` (the dry
run). ``KERNEL_CONTRACT_DQ`` / ``KERNEL_CONTRACT_DKDV`` are the launches'
contracts (``analysis.kernel_lint``); ``tile_probe`` runs the kernels' own
``dq_tile`` / ``dkdv_tile`` on the launch's grid.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import build, meta
from repro_torch.kernels.flash_attention import flash_attention, live_pairs

# (q / k width, v width) pairs the backward kernels compile
BACKWARD_HEAD_DIMS = ((64, 64), (128, 128), (192, 128))
_PASSES = {"dq": 0, "dkdv": 1}

# The dq pass: a block owns one (q tile, query head, batch row) tile of dq
# (and its rows of D) and walks the k tiles itself. Rows past S are read as
# TMA's zeros and not stored; keys past S are masked.
KERNEL_CONTRACT_DQ = dict(
    kernel="flash_attention_dq",
    grid=("q_tile", "q_head", "batch"),
    out_dims=("q", "q_head", "batch"),
    reduction_axes=(),
    masked={"q": "S", "kv": "S"},
    acc_dtype="float32",
    smem_limit_bytes=232448,
    launches=1,
)

# The dk / dv pass: a block owns one (k tile, kv head, batch row) tile of dk
# and dv and sums its group's query heads in registers, so no axis is a
# reduction across blocks. Queries past S are masked; keys past S are not
# stored.
KERNEL_CONTRACT_DKDV = dict(
    kernel="flash_attention_dkdv",
    grid=("kv_tile", "kv_head", "batch"),
    out_dims=("kv", "kv_head", "batch"),
    reduction_axes=(),
    masked={"kv": "S", "q": "S"},
    acc_dtype="float32",
    smem_limit_bytes=232448,
    launches=1,
)


def _library():
    lib = build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_int]                                   # pass
            + [ctypes.c_void_p] * 10                         # q k v o do lse delta dq dk dv
            + [ctypes.c_int] * 7                             # B, S, Hq, Hkv, hd, hd_v, causal
            + [ctypes.c_float, ctypes.c_void_p]              # sm_scale, stream
        )
        fn.restype = ctypes.c_int
    return lib


def takes(dtype: torch.dtype, head_dim: int, v_dim: int = None) -> bool:
    """Whether the backward kernels take operands of this dtype, q / k
    width and v width (``v_dim``, by default ``head_dim``)."""
    pair = (head_dim, head_dim if v_dim is None else v_dim)
    return dtype == torch.bfloat16 and pair in BACKWARD_HEAD_DIMS


def pass_cost(kind: str, B: int, S: int, Hq: int, Hkv: int, hd: int, *, causal: bool,
              hd_v: int = None):
    """``(flops, bytes)`` one pass computes: per live (query, key) pair and
    query head, with q / k ``hd`` and v ``hd_v`` (by default ``hd``) wide,
    the dq pass 2 (2 hd + hd_v) flops (q k^T, dP, dq) and the dk / dv pass
    2 (2 hd + 2 hd_v) (q k^T, dP, dv, dk); each reads its bf16 operands
    and fp32 statistics once and writes its outputs once."""
    hd_v = hd if hd_v is None else hd_v
    pairs = B * Hq * live_pairs(S, S, causal, 0, 0)
    col_q, col_kv = B * S * Hq * 2, B * S * Hkv * 2   # bf16 bytes of one column of every row
    stats = B * Hq * S * 4
    if kind == "dq":       # q, o, do, k, v, lse in; dq, D out
        return (2 * (2 * hd + hd_v) * pairs,
                col_q * (2 * hd + 2 * hd_v) + col_kv * (hd + hd_v) + 2 * stats)
    # q, do, k, v, lse, D in; dk, dv out
    return (2 * (2 * hd + 2 * hd_v) * pairs,
            col_q * (hd + hd_v) + col_kv * (2 * hd + 2 * hd_v) + 2 * stats)


def cost(B: int, S: int, Hq: int, Hkv: int, hd: int, *, causal: bool, hd_v: int = None):
    """``(flops, bytes)`` the backward needs, its bound: 2 (3 hd + 2 hd_v)
    flops per live pair and query head, with q / k ``hd`` and v ``hd_v``
    (by default ``hd``) wide (q k^T, dq, dk over hd; dP, dv over hd_v; the
    dq pass's second q k^T and dP are the price of determinism, not
    counted), q, k, v, o, do and lse read once, dq, dk and dv written
    once."""
    hd_v = hd if hd_v is None else hd_v
    pairs = B * Hq * live_pairs(S, S, causal, 0, 0)
    return (2 * (3 * hd + 2 * hd_v) * pairs,
            B * S * 2 * (Hq * (2 * hd + 2 * hd_v) + Hkv * (2 * hd + 2 * hd_v)) + B * Hq * S * 4)


def _check(q, k, v, others, name: str) -> None:
    on_meta = meta.is_meta(q)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name} runs on CUDA tensors, got q on {q.device}; the plain "
                         f"version is repro_torch.kernels.ref.{name}_ref")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{name} takes bfloat16 q, k, v, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, heads, head_dim), got {tuple(q.shape)}")
    B, S, Hq, hd = q.shape
    if (k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3] or k.shape[0] != B
            or k.shape[3] != hd):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if k.shape[1] != S:
        raise ValueError(f"{name} takes self-attention (Sq == Sk), got {S} queries over "
                         f"{k.shape[1]} keys")
    if (hd, v.shape[3]) not in BACKWARD_HEAD_DIMS:
        raise ValueError(f"q / k width {hd} over v width {v.shape[3]} is not one of the "
                         f"backward's pairs {BACKWARD_HEAD_DIMS}")
    if k.shape[2] == 0 or Hq % k.shape[2]:
        raise ValueError(f"{Hq} query heads do not group over {k.shape[2]} kv heads")
    for label, t, shape, dtype in [("q", q, q.shape, torch.bfloat16),
                                   ("k", k, k.shape, torch.bfloat16),
                                   ("v", v, v.shape, torch.bfloat16)] + others:
        if t.device != q.device:
            raise ValueError(f"q on {q.device} but {label} on {t.device}")
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{label} is {tuple(t.shape)} {t.dtype}, {name} takes "
                             f"{tuple(shape)} {dtype}")
        if not t.is_contiguous() or (not on_meta and t.data_ptr() % 16):
            raise ValueError(f"{label} must be contiguous and 16-byte aligned")
    if not on_meta:
        build.require_hopper(q.device, name)


def _outputs(name, out, specs, device):
    """``out`` checked against ``specs`` ((shape, dtype) each), or new
    tensors."""
    if out is None:
        return tuple(torch.empty(shape, dtype=dtype, device=device) for shape, dtype in specs)
    for o, (shape, dtype) in zip(out, specs):
        build.check_out(name, o, shape, dtype, device)
    return tuple(out)


def _launch(kind, q, k, v, o, do, lse, delta, dq, dk, dv, causal):
    B, S, Hq, hd = q.shape
    fn = _library().flash_attention_bwd_launch
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_PASSES[kind], ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lse), ptr(delta),
                 ptr(dq), ptr(dk), ptr(dv), B, S, Hq, k.shape[2], hd, v.shape[3],
                 int(bool(causal)), 1.0 / math.sqrt(hd), stream)
    if err:
        raise RuntimeError(f"flash_attention_{kind} launch failed: cudaError {err}")


def flash_attention_dq(q, k, v, o, do, lse, *, causal: bool = True, out=None):
    """The dq pass on the card: ``(dq, D)``, dq (B, S, Hq, hd) in q's
    dtype and ``D = rowsum(do * o)`` (B, Hq, S) fp32 (new tensors, or the
    pair ``out``). ``o`` and ``lse`` are the forward's output (v's width)
    and log-sum-exp, ``do`` the output's gradient."""
    B, S, Hq, hd = q.shape
    stats = ((B, Hq, S), torch.float32)
    rows = (B, S, Hq, v.shape[-1])
    _check(q, k, v, [("o", o, rows, q.dtype), ("do", do, rows, q.dtype),
                     ("lse", lse, *stats)], "flash_attention_dq")
    dq, delta = _outputs("flash_attention_dq", out, [(q.shape, q.dtype), stats], q.device)
    if q.numel() == 0:
        return dq, delta
    if meta.is_meta(q):
        meta.report("flash_attention_dq", *pass_cost("dq", B, S, Hq, k.shape[2], hd,
                                                     causal=causal, hd_v=v.shape[3]), q.dtype)
        return dq, delta
    _launch("dq", q, k, v, o, do, lse, delta, dq, None, None, causal)
    flash_attention_dq.launches += 1
    return dq, delta


def flash_attention_dkdv(q, k, v, do, lse, delta, *, causal: bool = True, out=None):
    """The dk / dv pass on the card: ``(dk, dv)`` in k's and v's shapes and
    dtype (new tensors, or the pair ``out``), from the forward's ``lse`` and
    the dq pass's ``delta`` (both (B, Hq, S) fp32)."""
    B, S, Hq, hd = q.shape
    stats = ((B, Hq, S), torch.float32)
    _check(q, k, v, [("do", do, (B, S, Hq, v.shape[-1]), q.dtype), ("lse", lse, *stats),
                     ("delta", delta, *stats)], "flash_attention_dkdv")
    dk, dv = _outputs("flash_attention_dkdv", out, [(k.shape, k.dtype), (v.shape, v.dtype)],
                      q.device)
    if q.numel() == 0:
        return dk, dv
    if meta.is_meta(q):
        meta.report("flash_attention_dkdv", *pass_cost("dkdv", B, S, Hq, k.shape[2], hd,
                                                       causal=causal, hd_v=v.shape[3]), q.dtype)
        return dk, dv
    _launch("dkdv", q, k, v, None, do, lse, delta, None, dk, dv, causal)
    flash_attention_dkdv.launches += 1
    return dk, dv


flash_attention_dq.launches = 0
flash_attention_dkdv.launches = 0


def launch_config(kind: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor = None) -> dict:
    """The launch configuration of the ``kind`` pass ("dq" or "dkdv") for
    these operands (the C function its launch calls): output dims
    ``(S, Hq, B)`` for dq, ``(S, Hkv, B)`` for dk / dv. ``v`` defaults to
    k (one width)."""
    v = k if v is None else v
    _check(q, k, v, [], f"flash_attention_{kind}")
    fn = _library().flash_attention_bwd_launch_config
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(build.LaunchConfig)]
    fn.restype = ctypes.c_int
    B, S, Hq, hd = q.shape
    return build.launch_config(fn, _PASSES[kind], B, S, Hq, k.shape[2], hd, v.shape[3])


def tile_probe(kind: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor = None):
    """The output box of every block the ``kind`` pass launches, from the
    kernels' own ``dq_tile`` / ``dkdv_tile`` on the launch's grid: an
    ``(n, 9)`` int64 array of ``writer, lo, hi`` in the pass's output
    dims. ``v`` defaults to k."""
    v = k if v is None else v
    _check(q, k, v, [], f"flash_attention_{kind}")
    fn = _library().flash_attention_bwd_tile_probe
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, S, Hq, hd = q.shape
    args = (_PASSES[kind], B, S, Hq, k.shape[2], hd, v.shape[3])
    return build.tile_boxes(
        lambda boxes, cap, count, stream: fn(*args, boxes, cap, count, stream), q.device)


def kernel_path(q: torch.Tensor, k: torch.Tensor = None, v: torch.Tensor = None) -> str:
    """The kernel the backward launches for these operands: ``"wgmma"``
    (the only one; anything else is refused). ``k`` defaults to q, ``v``
    to k (one width)."""
    k = q if k is None else k
    v = k if v is None else v
    _check(q, k, v, [], "flash_attention_bwd")
    fn = _library().flash_attention_bwd_path
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    if not fn(q.shape[3], v.shape[3]):
        raise ValueError(f"no backward kernel for q / k width {q.shape[3]} over v width "
                         f"{v.shape[3]}")
    return "wgmma"


class FlashAttention(torch.autograd.Function):
    """``out = attention(q, k, v)`` (causal or not, Sq == Sk, positions
    ``0..S-1``) through the flash kernel, which also writes each row's
    log-sum-exp; the backward runs the dq pass, then the dk / dv pass,
    from q, k, v, the output and the log-sum-exp saved by the forward.
    Refuses at the forward what the backward would refuse."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        B, S, Hq, hd = q.shape
        _check(q, k, v, [], "flash_attention_bwd")
        lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
        out = flash_attention(q, k, v, causal=causal, lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        dq, delta = flash_attention_dq(q, k, v, out, dout, lse, causal=ctx.causal)
        dk, dv = flash_attention_dkdv(q, k, v, dout, lse, delta, causal=ctx.causal)
        return dq, dk, dv, None
