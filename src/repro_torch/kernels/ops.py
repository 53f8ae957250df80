"""Public wrappers that dispatch between the kernels and their plain
versions.

The port of ``repro.kernels.ops``: ``attention`` (flash attention,
differentiable on the card through its backward kernels) and its two
backward passes alone (``attention_dq``, ``attention_dkdv``: the kernel
lint's cases), ``ssd`` (the Mamba2 chunk scan), ``grouped_matmul`` (the MoE expert
products) and its two gradients alone (``grouped_matmul_dx``,
``grouped_matmul_dw``: the kernel lint's cases; training reaches them
through ``grouped_matmul``'s backward) and the gossip update. ``resolve_mode`` is the one place the
decision is made, per tensor device:

  * ``"auto"``  -> ``"cuda"`` for a CUDA tensor, ``"torch"`` for a CPU one;
  * ``"cuda"``  -> the hand-written kernel (it raises on a CPU tensor, and
    on a card other than sm_90);
  * ``"torch"`` -> the plain PyTorch version, on any device (the tests
    and the chip smoke compare the kernel with it);
  * ``"meta"``  -> the kernel wrapper's meta branch (the dry run): taken
    for a meta tensor under ``"auto"`` or ``"cuda"``, and for nothing
    else.

A CUDA tensor under ``"auto"`` always takes the kernel: there is no
silent fall-back to the plain path. Unknown impl strings raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import gossip_axpy as _ga
from repro_torch.kernels import grouped_matmul as _gm
from repro_torch.kernels import ssm_scan as _ss
from repro_torch.kernels.ref import (
    attention_ref,
    flash_attention_dkdv_ref,
    flash_attention_dq_ref,
    gossip_axpy_ref,
    grouped_matmul_dw_ref,
    grouped_matmul_dx_ref,
    grouped_matmul_ref,
    ssm_scan_ref,
)
from repro_torch.tree import tree_map

MODES = ("torch", "cuda")


def resolve_mode(impl: str, device) -> str:
    """Resolve an ``impl`` string to an execution mode for ``device``."""
    kind = torch.device(device).type
    if impl not in ("auto", "meta") + MODES:
        raise ValueError(
            f"unknown impl/mode {impl!r}: expected 'auto', 'meta' or one of {MODES}"
        )
    if kind == "meta" and impl != "torch":
        return "meta"
    if impl == "meta":
        raise ValueError(f"impl='meta' runs on meta tensors, got one on {kind}")
    if impl == "auto":
        return "cuda" if kind == "cuda" else "torch"
    return impl


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------
def attention(q, k, v, *, causal: bool = True, window: int = 0, impl: str = "auto"):
    """Attention of q (B,Sq,Hq,hd) over k/v (B,Sk,Hkv,hd), query i and
    key j at positions i and j. The kernel masks ragged lengths itself,
    so nothing is padded here (the JAX wrapper pads to block multiples
    and masks the pad with ``kv_len``). Differentiable on both paths: the
    plain version through autograd; the kernel, when grad is enabled and
    an operand needs it, through ``FlashAttention`` (Sq == Sk, no window,
    bf16 at the backward's head widths: it raises on anything else),
    whose backward launches the dq and dk / dv kernels."""
    if resolve_mode(impl, q.device) == "torch":
        return attention_ref(q, k, v, causal=causal, window=window)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if window:
            raise ValueError("the flash backward takes no window: a windowed attention "
                             "that needs its gradient runs the plain version")
        return _fab.FlashAttention.apply(q, k, v, causal)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def attention_dq(q, k, v, o, do, lse, *, causal: bool = True, impl: str = "auto"):
    """The backward's dq pass: ``(dq, D)`` from the forward's output
    ``o`` and log-sum-exp ``lse`` and the output's gradient ``do``, with
    ``D = rowsum(do * o)`` (``FlashAttention``'s first backward launch)."""
    if resolve_mode(impl, q.device) == "torch":
        return flash_attention_dq_ref(q, k, v, o, do, lse, causal=causal)
    return _fab.flash_attention_dq(q, k, v, o, do, lse, causal=causal)


def attention_dkdv(q, k, v, do, lse, delta, *, causal: bool = True, impl: str = "auto"):
    """The backward's dk / dv pass: ``(dk, dv)`` from ``lse`` and the dq
    pass's ``delta`` (``FlashAttention``'s second backward launch)."""
    if resolve_mode(impl, q.device) == "torch":
        return flash_attention_dkdv_ref(q, k, v, do, lse, delta, causal=causal)
    return _fab.flash_attention_dkdv(q, k, v, do, lse, delta, causal=causal)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------
def ssd(x, dt, A, B_mat, C_mat, *, chunk: int = 128, impl: str = "auto"):
    """Mamba2 SSD from a zero state: ``(y, final_state)``. The kernel
    needs the chunk to divide S, so the chunk halves until it does; its
    final state is fp32 (the plain version's is in x's dtype, as in the
    JAX oracle)."""
    if resolve_mode(impl, x.device) == "torch":
        return ssm_scan_ref(x, dt, A, B_mat, C_mat)
    S = x.shape[1]
    c = min(chunk, S)
    while S % c:
        c //= 2
    return _ss.ssm_scan(
        x.contiguous(), dt.float().contiguous(), A.float().contiguous(),
        B_mat.contiguous(), C_mat.contiguous(), chunk=c,
    )


# ---------------------------------------------------------------------------
# Grouped matmul
# ---------------------------------------------------------------------------
def grouped_matmul(x, w, group_sizes, *, impl: str = "auto"):
    """``out[r] = x[r] @ w[g(r)]`` for x (M, K) sorted by group, w
    (G, K, N), group_sizes (G,) int32: fp32 sums, x's dtype out, rows
    past ``sum(group_sizes)`` zero (``lax.ragged_dot``). Differentiable
    on both paths: the plain version through autograd, the kernel
    through ``GroupedMatmul``, whose backward launches the dx and dw
    kernels (``ctx.needs_input_grad`` decides which)."""
    if resolve_mode(impl, x.device) == "torch":
        return grouped_matmul_ref(x, w, group_sizes)
    if x.device.type == "cpu":      # GroupedMatmul would take the plain versions
        raise ValueError(f"impl='cuda' runs on CUDA tensors, got x on {x.device}")
    return _gm.GroupedMatmul.apply(
        x.contiguous(), w.contiguous(), group_sizes.to(torch.int32).contiguous()
    )


def grouped_matmul_dx(dy, w, group_sizes, *, impl: str = "auto"):
    """``dx (M, K)``: row r of group g is ``dy[r] @ w[g]^T``, rows past
    ``sum(group_sizes)`` zero (``GroupedMatmul``'s input gradient)."""
    if resolve_mode(impl, dy.device) == "torch":
        return grouped_matmul_dx_ref(dy, w, group_sizes)
    return _gm.grouped_matmul_dx(dy.contiguous(), w.contiguous(),
                                 group_sizes.to(torch.int32).contiguous())


def grouped_matmul_dw(x, dy, group_sizes, *, impl: str = "auto"):
    """``dw (G, K, N)``: the sum over group g's rows of ``x[r]^T dy[r]``
    (``GroupedMatmul``'s weight gradient)."""
    if resolve_mode(impl, x.device) == "torch":
        return grouped_matmul_dw_ref(x, dy, group_sizes)
    return _gm.grouped_matmul_dw(x.contiguous(), dy.contiguous(),
                                 group_sizes.to(torch.int32).contiguous())


# ---------------------------------------------------------------------------
# Gossip consensus update
# ---------------------------------------------------------------------------
def _gossip_tree_map(x_tree, y_tree, alpha: float, impl: str, inplace: bool):
    """Leaf dispatcher for x + alpha * (y - x); non-float leaves pass
    through untouched."""

    def leaf(x, y):
        if not x.is_floating_point():
            return x
        if resolve_mode(impl, x.device) == "torch":
            out = gossip_axpy_ref(x, y, alpha)
            return x.copy_(out) if inplace else out
        return _ga.gossip_axpy(x, y, alpha, inplace=inplace)

    return tree_map(leaf, x_tree, y_tree)


def gossip_update(x_tree, partner_tree, alpha: float, *, impl: str = "auto"):
    """Tree-wide consensus update x + alpha (partner - x), new tensors."""
    return _gossip_tree_map(x_tree, partner_tree, alpha, impl, inplace=False)


def gossip_apply(
    x_tree, target_tree, alpha: float, *, impl: str = "auto", inplace: bool = False
):
    """Gossip hot-path entry used by ``repro_torch.dist.gossip`` once each
    leaf's fp32 target is built. ``inplace=True`` writes the result over
    x (each target is complete before its update runs, so nothing reads
    the old x afterwards) and returns the same tree."""
    return _gossip_tree_map(x_tree, target_tree, alpha, impl, inplace=inplace)
