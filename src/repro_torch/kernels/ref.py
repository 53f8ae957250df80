"""Plain PyTorch versions of the port's hand-written kernels.

The correctness contract: the CPU tests run these, and on the card the
kernels are held against them on the same inputs. Each mirrors its
oracle in ``repro.kernels.ref``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0**30  # large-but-finite, as in the JAX oracle


def gossip_axpy_ref(x: torch.Tensor, y: torch.Tensor, alpha: float) -> torch.Tensor:
    """Consensus update on matched nodes: x + alpha * (y - x) in fp32,
    cast to x's dtype."""
    xf = x.float()
    yf = y.float()
    return (xf + alpha * (yf - xf)).to(x.dtype)


def attention_ref(
    q: torch.Tensor,            # (B, Sq, Hq, hd)
    k: torch.Tensor,            # (B, Sk, Hkv, hd)
    v: torch.Tensor,            # (B, Sk, Hkv, hd_v)
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """fp32 masked softmax attention, scaled by q's width; query head h
    reads kv head ``h // (Hq // Hkv)`` and the output takes v's width
    (latent attention's is narrower). Query i and key j sit at positions
    i and j. A row with no live key gets uniform weights over NEG_INF
    scores (the JAX oracle's behaviour; the kernel writes 0 there)."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qf = q.float() / math.sqrt(hd)
    qg = qf.reshape(B, Sq, Hkv, g, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, Sq, Hq, v.shape[-1]).to(q.dtype)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool):
    """fp32 scaled scores ``(B, Hkv, g, Sq, Sk)`` of q over k (query head h
    reads kv head ``h // g``) and the live mask ``(Sq, Sk)``."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = (q.float() / math.sqrt(hd)).reshape(B, Sq, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    live = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        live = torch.arange(Sk, device=q.device)[None, :] <= torch.arange(
            Sq, device=q.device)[:, None]
    return s, live


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True):
    """The log-sum-exp (B, Hq, Sq) fp32 of each row's scaled scores over its
    live keys, ``log sum_j exp(q_i . k_j / sqrt(hd))``: what the flash
    kernel's ``lse`` output holds."""
    B, Sq, Hq, _ = q.shape
    s, live = _scores(q, k, causal)
    lse = torch.logsumexp(torch.where(live, s, -math.inf), dim=-1)     # (B, Hkv, g, Sq)
    return lse.reshape(B, Hq, Sq)


def _probs(q, k, lse, causal):
    """P = exp(s - lse) over the live keys, 0 elsewhere: (B, Hkv, g, Sq, Sk)."""
    s, live = _scores(q, k, causal)
    B, Hkv, g, Sq, _ = s.shape
    p = torch.exp(s - lse.reshape(B, Hkv, g, Sq, 1))
    return torch.where(live, p, 0.0)


def flash_attention_dq_ref(q, k, v, o, do, lse, *, causal: bool = True):
    """The backward's dq pass in fp32: ``(dq, D)`` with ``D = rowsum(do *
    o)`` (B, Hq, S) fp32, ``dS = P (do v^T - D)`` from P rebuilt from the
    given ``lse``, and ``dq = dS k / sqrt(hd)`` in q's dtype. ``o`` and
    ``do`` take v's width, which may be narrower than q's and k's."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()     # (B, Hq, S)
    p = _probs(q, k, lse, causal)
    dog = do.float().reshape(B, S, Hkv, Hq // Hkv, v.shape[-1])
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    ds = p * (dp - delta.reshape(B, Hkv, Hq // Hkv, S, 1))
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) / math.sqrt(hd)
    return dq.reshape(B, S, Hq, hd).to(q.dtype), delta


def flash_attention_dkdv_ref(q, k, v, do, lse, delta, *, causal: bool = True):
    """The backward's dk / dv pass in fp32: ``dv = P^T do`` (v's width) and
    ``dk = dS^T q / sqrt(hd)`` summed over each kv head's query heads, from
    the given ``lse`` and ``delta`` (B, Hq, S), in k's dtype."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    p = _probs(q, k, lse, causal)
    dog = do.float().reshape(B, S, Hkv, g, v.shape[-1])
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    ds = p * (dp - delta.reshape(B, Hkv, g, S, 1))
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, q.float().reshape(B, S, Hkv, g, hd))
    return (dk / math.sqrt(hd)).to(k.dtype), dv.to(k.dtype)


def ssm_scan_ref(
    x: torch.Tensor,            # (B, S, H, P)
    dt: torch.Tensor,           # (B, S, H), positive
    A: torch.Tensor,            # (H,), negative
    B_mat: torch.Tensor,        # (B, S, N)
    C_mat: torch.Tensor,        # (B, S, N)
    *,
    h0: Optional[torch.Tensor] = None,
):
    """Exact sequential SSD recurrence; returns ``(y, final_state)``,
    both in x's dtype."""
    from repro_torch.models.ssm import ssd_sequential

    return ssd_sequential(x, dt, A, B_mat, C_mat, h0=h0, return_final_state=True)


def _group_bounds(group_sizes: torch.Tensor, M: int):
    """``(g, start, end)`` of each group's rows, clipped to M as the
    forward clips them. Reads the sizes on the host (one sync)."""
    start = 0
    for g, size in enumerate(group_sizes.tolist()):
        end = min(start + max(int(size), 0), M)
        yield g, start, end
        start = end


def grouped_matmul_ref(
    x: torch.Tensor,             # (M, K), rows sorted by group
    w: torch.Tensor,             # (G, K, N)
    group_sizes: torch.Tensor,   # (G,) int
) -> torch.Tensor:
    """``lax.ragged_dot``: row r of group g is ``x[r] @ w[g]``, an fp32
    product per group cast to x's dtype; rows past ``sum(group_sizes)``
    are 0. Reads the sizes on the host (one sync); differentiable."""
    M, N = x.shape[0], w.shape[2]
    pieces, end = [], 0
    for g, start, end in _group_bounds(group_sizes, M):
        pieces.append(x[start:end].float() @ w[g].float())
    pieces.append(x.new_zeros((M - end, N), dtype=torch.float32))
    return torch.cat(pieces).to(x.dtype)


def grouped_matmul_dx_ref(
    dy: torch.Tensor,            # (M, N), the output's gradient
    w: torch.Tensor,             # (G, K, N)
    group_sizes: torch.Tensor,   # (G,) int
) -> torch.Tensor:
    """The input gradient of ``grouped_matmul_ref``: row r of group g is
    ``dy[r] @ w[g]^T``, an fp32 product per group cast to w's dtype (x's,
    which it shares); rows past ``sum(group_sizes)`` are 0, as in the
    VJP of ``lax.ragged_dot``."""
    M, K = dy.shape[0], w.shape[1]
    dx = torch.zeros((M, K), dtype=torch.float32, device=dy.device)
    for g, start, end in _group_bounds(group_sizes, M):
        dx[start:end] = dy[start:end].float() @ w[g].float().T
    return dx.to(w.dtype)


def grouped_matmul_dw_ref(
    x: torch.Tensor,             # (M, K), rows sorted by group
    dy: torch.Tensor,            # (M, N), the output's gradient
    group_sizes: torch.Tensor,   # (G,) int
) -> torch.Tensor:
    """The weight gradient of ``grouped_matmul_ref``: ``dw[g]`` is the
    fp32 sum over the group's rows of ``x[r]^T dy[r]``, cast to x's dtype
    (w's, which it shares). An empty group's ``dw`` is 0, and rows past
    the groups add nothing, as in the VJP of ``lax.ragged_dot``."""
    M, K, N = x.shape[0], x.shape[1], dy.shape[1]
    G = group_sizes.shape[0]
    dw = torch.zeros((G, K, N), dtype=torch.float32, device=x.device)
    for g, start, end in _group_bounds(group_sizes, M):
        dw[g] = x[start:end].float().T @ dy[start:end].float()
    return dw.to(x.dtype)
