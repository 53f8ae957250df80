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
add in an order that varies between runs). The backward of the dispatch
gather ``x2d[tok]`` (each token's row read by its k pairs) is likewise
a gather, each token's k pair gradients added in ascending pair order
in fp32 (``_PairRows``): autograd's own backward, an accumulating
``index_put``, adds repeated indices in an order that varies with the
CPU's threads, run to run.

Under tensor parallel (``repro_torch.models.tp``): the dense block is
column-parallel in ``w1`` / ``w3`` and row-parallel in ``w2``. A MoE
layer whose experts divide the model axis is expert-parallel: the
router stays replicated (its aux losses counted once), the gates enter
the sharded region through ``to_model``, each rank dispatches only the
pairs routed to its experts (sorted to the front, with its local group
sizes; their count, read on the host, sizes the pair buffers) and adds
each token's local terms in ascending expert order before the sum over
the ranks.
Where the experts do not divide but the expert ``ffn`` dim does, every
rank runs every pair on its slice of that dim. The shared expert is a
dense block.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import tp as tpl
from repro_torch.models.layers import activation_fn, apply_dense, declare_dense
from repro_torch.models.module import ParamBuilder, torch_dtype


def declare_ffn(
    b: ParamBuilder, path: str, d_model: int, d_ff: int, gated: bool
) -> None:
    declare_dense(b, f"{path}.w1", d_model, d_ff, (None, "ffn"))
    if gated:
        declare_dense(b, f"{path}.w3", d_model, d_ff, (None, "ffn"))
    declare_dense(b, f"{path}.w2", d_ff, d_model, ("ffn", None))


def ffn_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              xm: Optional[torch.Tensor] = None,
              reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
              ) -> torch.Tensor:
    """The dense FFN. Split over ``ffn``, ``xm`` is ``x`` as it enters the
    sharded columns (``to_model(x)`` when not given) and ``reduce`` the
    row-parallel output's reduction (``reduce_from_model`` when not
    given): a sequence-parallel sublayer passes its own (``tp.SeqIn``)."""
    dtype = torch_dtype(cfg.compute_dtype)
    act = activation_fn(cfg.ffn_activation)
    tp = tpl.context()
    split = tp is not None and tp.sharded("ffn")
    if split:
        x = tpl.to_model(x) if xm is None else xm
    h = act(apply_dense(p["w1"], x, dtype))
    if "w3" in p:
        h = h * apply_dense(p["w3"], x, dtype)
    y = apply_dense(p["w2"], h, dtype)
    return (reduce or tpl.reduce_from_model)(y) if split else y


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


def _moe_einsum(p, x2d, gates, idx, cfg: ModelConfig, experts=None) -> torch.Tensor:
    """Every expert on every token, masked combine, in fp32. (T, E, F)
    memory. ``experts``: the ``(lo, hi)`` this rank holds (expert
    parallel)."""
    dtype = torch_dtype(cfg.compute_dtype)
    act = activation_fn(cfg.ffn_activation)
    xd = x2d.to(dtype)
    h = act(torch.einsum("td,edf->tef", xd, p["w1"].to(dtype)))
    if "w3" in p:
        h = h * torch.einsum("td,edf->tef", xd, p["w3"].to(dtype))
    y_all = torch.einsum("tef,efd->ted", h, p["w2"].to(dtype))   # (T, E, D)
    onehot = F.one_hot(idx, cfg.moe_num_experts).float()         # (T, k, E)
    weights = (gates[..., None] * onehot).sum(dim=1)             # (T, E)
    if experts is not None:
        weights = weights[:, experts[0]:experts[1]]
    return torch.einsum("ted,te->td", y_all.float(), weights)


class _PairRows(torch.autograd.Function):
    """``x2d[tok]``: each pair's token row, in sorted pair order (``tok``
    may hold only the first pairs: a rank's own, under expert parallel).
    The backward adds each token's k pair gradients through ``slots`` (the
    token's pair positions, ascending) in fp32: a fixed order, where an
    accumulating ``index_put`` adds in the order of the CPU's threads.
    Positions past ``tok`` read a zero row."""

    @staticmethod
    def forward(ctx, x2d, tok, slots):
        ctx.save_for_backward(slots)
        return x2d[tok]

    @staticmethod
    def backward(ctx, grad):
        (slots,) = ctx.saved_tensors
        m = grad.shape[0]
        if m < slots.numel():
            grad = torch.cat([grad, grad.new_zeros((1,) + grad.shape[1:])])
            slots = slots.clamp(max=m)
        acc = grad[slots[:, 0]].float()
        for j in range(1, slots.shape[1]):
            acc = acc + grad[slots[:, j]].float()
        return acc.to(grad.dtype), None, None


def _moe_ragged(p, x2d, gates, idx, cfg: ModelConfig, experts=None) -> torch.Tensor:
    """Sort the (token, expert) pairs by expert, run the expert products
    as grouped matmuls, and add each token's k gated outputs back in
    ascending expert order in fp32 (returned in fp32). Without
    ``experts`` no step of the forward waits for the host, nor do the dx
    and dw kernels of the backward on the card. ``experts``: the
    ``(lo, hi)`` this rank holds (expert parallel); the pairs routed to
    them sort to the front and only those are dispatched, at least one
    row: their count is read on the host (one wait a call), which sizes
    the pair buffers to the rank's pairs. The others add nothing."""
    dtype = torch_dtype(cfg.compute_dtype)
    act = activation_fn(cfg.ffn_activation)
    T, D = x2d.shape
    k = cfg.moe_top_k
    E = cfg.moe_num_experts
    flat_e = idx.reshape(-1)                                     # (P,) P = T*k
    lo, hi = experts if experts is not None else (0, E)
    key = flat_e if lo == 0 else torch.remainder(flat_e - lo, E)
    order = torch.argsort(key, stable=True)
    tok = order // k                                             # token per pair
    # where each token's pairs landed in the sorted order, ascending,
    # which is ascending expert order (local experts first)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    slots = torch.sort(inv.reshape(T, k), dim=-1).values         # (T, k)
    group_sizes = torch.zeros(E, dtype=torch.int32, device=x2d.device).scatter_add_(
        0, key, torch.ones_like(key, dtype=torch.int32)
    )[:hi - lo]
    n = m = T * k                                                # pairs, rows dispatched
    if experts is not None:
        n = int(group_sizes.sum())
        m = max(n, 1)                    # a row past the groups: the kernels write 0 there
    xs = _PairRows.apply(x2d, tok[:m], slots).to(dtype)          # (m, D)
    h = act(ops.grouped_matmul(xs, p["w1"].to(dtype), group_sizes))
    if "w3" in p:
        h = h * ops.grouped_matmul(xs, p["w3"].to(dtype), group_sizes)
    y = ops.grouped_matmul(h, p["w2"].to(dtype), group_sizes)    # (m, D)
    g = gates.reshape(-1)[order]                                 # (P,)
    out = torch.zeros((T, D), dtype=torch.float32, device=x2d.device)
    for j in range(k):
        s = slots[:, j]
        gs = g[s]
        if m < T * k:                    # another rank's pair: gate 0, any row
            gs = torch.where(s < n, gs, torch.zeros_like(gs))
            s = s.clamp(max=m - 1)
        out = out + y[s].float() * gs[:, None]
    return out


def moe_block(
    p: dict, x: torch.Tensor, cfg: ModelConfig, *, impl: str = "ragged",
    xm: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (y, aux losses).

    ``ragged`` routes each example on its own and takes the mean of the
    per-example aux losses, as the JAX model does; the dispatch then runs
    over the whole batch at once (see the module docstring).
    ``cfg.moe_token_chunks > 1`` (when it divides S) splits every
    example's tokens into that many chunks and dispatches chunk j of all
    examples together: a peak-memory knob, at identical numbers.
    ``xm`` is ``x`` as it enters the sharded experts (``to_model(x)``
    when not given; ``tp.SeqIn.xm`` under sequence parallel). The combine
    is reduced per token chunk over the whole sequence, so the output is
    whole."""
    B, S, D = x.shape
    dtype = torch_dtype(cfg.compute_dtype)
    tp = tpl.context()
    experts = None
    split = tp is not None and (tp.sharded("experts") or tp.sharded("ffn"))
    if tp is not None and tp.sharded("experts"):
        experts = tp.part(cfg.moe_num_experts)

    def combined(y):
        """The fp32 combine, summed over the ranks, in the compute dtype."""
        return tpl.reduce_from_model(y).to(dtype) if split else y.to(dtype)

    xe = (tpl.to_model(x) if xm is None else xm) if split else x
    if impl == "einsum":
        x2d = x.reshape(B * S, D)
        gates, idx, aux = _router(p, x2d, cfg)
        if split:
            gates = tpl.to_model(gates)
        y = combined(_moe_einsum(p, xe.reshape(B * S, D), gates, idx, cfg,
                                 experts)).reshape(B, S, D)
    elif impl == "ragged":
        gates, idx, aux_b = _router(p, x, cfg)                   # per example
        aux = {key: v.mean() for key, v in aux_b.items()}
        if split:
            gates = tpl.to_model(gates)
        n = max(1, cfg.moe_token_chunks)
        n = n if S % n == 0 else 1
        c = S // n
        parts = [
            combined(_moe_ragged(
                p, xe[:, j * c:(j + 1) * c].reshape(B * c, D),
                gates[:, j * c:(j + 1) * c].reshape(B * c, -1),
                idx[:, j * c:(j + 1) * c].reshape(B * c, -1), cfg, experts,
            )).reshape(B, c, D)
            for j in range(n)
        ]
        y = parts[0] if n == 1 else torch.cat(parts, dim=1)
    else:
        raise ValueError(f"unknown moe impl {impl!r}")
    if cfg.moe_shared_expert:
        y = y + ffn_block(p["shared"], x, cfg, xm=xm)
    return y, aux
