"""Public wrappers that dispatch between the kernels and their plain
versions.

The port of ``repro.kernels.ops``: ``attention`` (flash attention),
``ssd`` (the Mamba2 chunk scan), ``grouped_matmul`` (the MoE expert
products) and the gossip update. ``resolve_mode`` is the one place the
decision is made, per tensor device:

  * ``"auto"``  -> ``"cuda"`` for a CUDA tensor, ``"torch"`` for a CPU one;
  * ``"cuda"``  -> the hand-written kernel (it raises on a CPU tensor, and
    on a card other than sm_90);
  * ``"torch"`` -> the plain PyTorch version, on any device (the tests
    and the chip smoke compare the kernel with it).

A CUDA tensor under ``"auto"`` always takes the kernel: there is no
silent fall-back to the plain path. Unknown impl strings raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gossip_axpy as _ga
from repro_torch.kernels import grouped_matmul as _gm
from repro_torch.kernels import ssm_scan as _ss
from repro_torch.kernels.ref import (
    attention_ref,
    gossip_axpy_ref,
    grouped_matmul_ref,
    ssm_scan_ref,
)
from repro_torch.tree import tree_map

MODES = ("torch", "cuda")


def resolve_mode(impl: str, device) -> str:
    """Resolve an ``impl`` string to an execution mode for ``device``."""
    if impl == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    if impl not in MODES:
        raise ValueError(
            f"unknown impl/mode {impl!r}: expected 'auto' or one of {MODES}"
        )
    return impl


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------
def attention(q, k, v, *, causal: bool = True, window: int = 0, impl: str = "auto"):
    """Attention of q (B,Sq,Hq,hd) over k/v (B,Sk,Hkv,hd), query i and
    key j at positions i and j. The kernel masks ragged lengths itself,
    so nothing is padded here (the JAX wrapper pads to block multiples
    and masks the pad with ``kv_len``)."""
    if resolve_mode(impl, q.device) == "torch":
        return attention_ref(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=causal, window=window
    )


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
    if x.device.type != "cuda":     # GroupedMatmul would take the plain versions
        raise ValueError(f"impl='cuda' runs on CUDA tensors, got x on {x.device}")
    return _gm.GroupedMatmul.apply(
        x.contiguous(), w.contiguous(), group_sizes.to(torch.int32).contiguous()
    )


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
