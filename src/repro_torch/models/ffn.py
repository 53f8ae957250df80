"""Feed-forward blocks: dense (gated / plain) and Mixture-of-Experts.

The port of ``repro.models.ffn``. MoE has the JAX package's two
execution paths:

  * ``einsum``: every expert on every token, masked combine; the model
    takes it for 8 experts or fewer;
  * ``ragged``: sort the token-expert pairs by expert and run the three
    expert products as grouped matmuls (``ops.grouped_matmul``: the
    hand-written Hopper kernel on the card, its plain version on the
    CPU). Both differentiate: on the card the backward launches the dx
    and dw kernels, so one MoE layer of a training step makes 3 forward
    launches (6 under ``cfg.remat``, which runs the layer again in the
    backward), 3 dx and 3 dw per node.

Two departures from the JAX ragged path, neither changing a number
beyond summation order: the JAX model dispatches each example on its
own (``lax.map``, one ``ragged_dot`` per example and weight); here all
B*S*k pairs of the batch are sorted at once, so a MoE layer makes one
launch per weight and reads each expert's weights once. Each output row
depends only on its own x row and its expert, so the two agree; the
router and its aux losses stay per example. And the combine adds each
token's k terms in ascending expert order in fp32, as the JAX
``.at[tok].add`` does, by gathering them back through the inverse
permutation rather than by a float ``index_add_`` (whose CUDA atomics
add in an order that varies between runs).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import activation_fn, apply_dense, declare_dense
from repro_torch.models.module import ParamBuilder, torch_dtype


def declare_ffn(
    b: ParamBuilder, path: str, d_model: int, d_ff: int, gated: bool
) -> None:
    declare_dense(b, f"{path}.w1", d_model, d_ff, (None, "ffn"))
    if gated:
        declare_dense(b, f"{path}.w3", d_model, d_ff, (None, "ffn"))
    declare_dense(b, f"{path}.w2", d_ff, d_model, ("ffn", None))


def ffn_block(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dtype = torch_dtype(cfg.compute_dtype)
    act = activation_fn(cfg.ffn_activation)
    h = act(apply_dense(p["w1"], x, dtype))
    if "w3" in p:
        h = h * apply_dense(p["w3"], x, dtype)
    return apply_dense(p["w2"], h, dtype)


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------
def declare_moe(b: ParamBuilder, path: str, cfg: ModelConfig) -> None:
    d, e = cfg.d_model, cfg.moe_num_experts
    f = cfg.moe_d_ff or cfg.d_ff
    declare_dense(b, f"{path}.router", d, e, (None, None))
    b.declare(f"{path}.w1", (e, d, f), ("experts", None, "ffn"), init=_expert_init)
    if cfg.gated_ffn:
        b.declare(f"{path}.w3", (e, d, f), ("experts", None, "ffn"), init=_expert_init)
    b.declare(f"{path}.w2", (e, f, d), ("experts", "ffn", None), init=_expert_init)
    if cfg.moe_shared_expert:
        declare_ffn(b, f"{path}.shared", d, f, cfg.gated_ffn)


def _expert_init(gen, shape, dtype, device):
    """Normal with std ``1/sqrt(shape[1])``: the fan-in is the middle dim
    (per-expert matrices stacked on dim 0)."""
    std = 1.0 / np.sqrt(shape[1])
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def _router(p, x: torch.Tensor, cfg: ModelConfig):
    """Top-k routing of tokens x (..., T, D). Returns gates (..., T, k),
    expert ids (..., T, k) and the aux losses over the T tokens (one
    value per leading index; scalars for a 2-D x, as in JAX)."""
    logits = x.float() @ p["router"]["w"].float()                # (..., T, E)
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(logits, cfg.moe_top_k, dim=-1)
    gates = torch.softmax(top_vals, dim=-1)                      # renormalize
    # switch-style load balance: E * sum_e fraction_e * prob_e
    E = cfg.moe_num_experts
    onehot = F.one_hot(top_idx, E).float()                       # (..., T, k, E)
    frac = onehot.sum(dim=-2).mean(dim=-2)                       # tokens per e
    lb = E * torch.sum(frac * probs.mean(dim=-2), dim=-1)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2, dim=-1)
    return gates, top_idx, {"load_balance": lb, "router_z": z}


def _moe_einsum(p, x2d, gates, idx, cfg: ModelConfig) -> torch.Tensor:
    """Every expert on every token, masked combine. (T, E, F) memory."""
    dtype = torch_dtype(cfg.compute_dtype)
    act = activation_fn(cfg.ffn_activation)
    xd = x2d.to(dtype)
    h = act(torch.einsum("td,edf->tef", xd, p["w1"].to(dtype)))
    if "w3" in p:
        h = h * torch.einsum("td,edf->tef", xd, p["w3"].to(dtype))
    y_all = torch.einsum("tef,efd->ted", h, p["w2"].to(dtype))   # (T, E, D)
    onehot = F.one_hot(idx, cfg.moe_num_experts).float()         # (T, k, E)
    weights = (gates[..., None] * onehot).sum(dim=1)             # (T, E)
    return torch.einsum("ted,te->td", y_all.float(), weights).to(dtype)


def _moe_ragged(p, x2d, gates, idx, cfg: ModelConfig) -> torch.Tensor:
    """Sort the (token, expert) pairs by expert, run the expert products
    as grouped matmuls, and add each token's k gated outputs back in
    ascending expert order in fp32. No step of the forward waits for the
    host, nor do the dx and dw kernels of the backward on the card."""
    dtype = torch_dtype(cfg.compute_dtype)
    act = activation_fn(cfg.ffn_activation)
    T, D = x2d.shape
    k = cfg.moe_top_k
    E = cfg.moe_num_experts
    flat_e = idx.reshape(-1)                                     # (P,) P = T*k
    order = torch.argsort(flat_e, stable=True)
    tok = order // k                                             # token per pair
    xs = x2d[tok].to(dtype)                                      # (P, D)
    group_sizes = torch.zeros(E, dtype=torch.int32, device=x2d.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.int32)
    )
    h = act(ops.grouped_matmul(xs, p["w1"].to(dtype), group_sizes))
    if "w3" in p:
        h = h * ops.grouped_matmul(xs, p["w3"].to(dtype), group_sizes)
    y = ops.grouped_matmul(h, p["w2"].to(dtype), group_sizes)    # (P, D)
    g = gates.reshape(-1)[order]                                 # (P,)
    # where each token's pairs landed in the sorted order, ascending,
    # which is ascending expert order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    slots = torch.sort(inv.reshape(T, k), dim=-1).values         # (T, k)
    out = torch.zeros((T, D), dtype=torch.float32, device=x2d.device)
    for j in range(k):
        s = slots[:, j]
        out = out + y[s].float() * g[s][:, None]
    return out.to(dtype)


def moe_block(
    p: dict, x: torch.Tensor, cfg: ModelConfig, *, impl: str = "ragged"
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (y, aux losses).

    ``ragged`` routes each example on its own and takes the mean of the
    per-example aux losses, as the JAX model does; the dispatch then runs
    over the whole batch at once (see the module docstring).
    ``cfg.moe_token_chunks > 1`` (when it divides S) splits every
    example's tokens into that many chunks and dispatches chunk j of all
    examples together: a peak-memory knob, at identical numbers."""
    B, S, D = x.shape
    if impl == "einsum":
        x2d = x.reshape(B * S, D)
        gates, idx, aux = _router(p, x2d, cfg)
        y = _moe_einsum(p, x2d, gates, idx, cfg).reshape(B, S, D)
    elif impl == "ragged":
        gates, idx, aux_b = _router(p, x, cfg)                   # per example
        aux = {key: v.mean() for key, v in aux_b.items()}
        n = max(1, cfg.moe_token_chunks)
        n = n if S % n == 0 else 1
        c = S // n
        parts = [
            _moe_ragged(
                p, x[:, j * c:(j + 1) * c].reshape(B * c, D),
                gates[:, j * c:(j + 1) * c].reshape(B * c, -1),
                idx[:, j * c:(j + 1) * c].reshape(B * c, -1), cfg,
            ).reshape(B, c, D)
            for j in range(n)
        ]
        y = parts[0] if n == 1 else torch.cat(parts, dim=1)
    else:
        raise ValueError(f"unknown moe impl {impl!r}")
    if cfg.moe_shared_expert:
        y = y + ffn_block(p["shared"], x, cfg)
    return y, aux
