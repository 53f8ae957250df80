"""Feed-forward blocks: dense (gated / plain) and Mixture-of-Experts.

The port of ``repro.models.ffn``. MoE has the JAX package's two
execution paths:

  * ``einsum``: every expert on every token, masked combine; the model
    takes it for a router over 8 experts or fewer;
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
dense block (``moe_shared_d_ff`` wide: DeepSeek-V3's shared experts as
one SwiGLU).

Routers: ``softmax`` (the JAX package's: softmax, top-k, the k weights
renormalized; switch load balance and z-loss) and ``sigmoid``
(DeepSeek-V3's, ``_sigmoid_router``; its sequence-wise balance loss).
``AUX_WEIGHTS`` weighs each in the objective.

The expert share (a config whose ``moe_num_experts`` is less than its
router's ``moe_router_experts``; guide: one chip's part of an
expert-parallel layer): the layer holds experts ``moe_first_expert`` ..
of the router's, routes every token over all of them (the top-k
normalization divides by the k picked scores, the absent experts'
included), and adds only its own experts' terms; the result, partial by
the absent experts' terms, goes on to the next layer. On the ragged path
every pair is dispatched, the held experts' first: the kernels write 0
for the rest, so nothing waits for the host. Spans ``moe`` and
``moe/backward``, and on ``moe`` the counters ``moe_pairs_held`` /
``moe_pairs_routed`` (``telemetry.blocks``).
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
from repro_torch.telemetry.blocks import BackwardSpan, current_block_spans

# The objective's weight of each router loss: the switch load balance and
# the router z-loss of the softmax routers, DeepSeek-V3's sequence-wise
# balance (its alpha, arXiv:2412.19437 section 4.2) of the sigmoid router.
AUX_WEIGHTS = {"load_balance": 1e-2, "router_z": 1e-3, "seq_balance": 1e-4}


def aux_names(cfg: ModelConfig) -> Tuple[str, ...]:
    """The router losses a MoE layer of ``cfg`` gives, in the order the
    objective adds them."""
    return ("seq_balance",) if cfg.moe_router == "sigmoid" else ("load_balance", "router_z")


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
    """The router over ``cfg.router_experts``, the ``moe_num_experts``
    experts the layer holds, and the shared expert (``moe_shared_d_ff``
    wide)."""
    d, e = cfg.d_model, cfg.moe_num_experts
    f = cfg.moe_d_ff or cfg.d_ff
    declare_dense(b, f"{path}.router", d, cfg.router_experts, (None, None))
    b.declare(f"{path}.w1", (e, d, f), ("experts", None, "ffn"), init=_expert_init)
    if cfg.gated_ffn:
        b.declare(f"{path}.w3", (e, d, f), ("experts", None, "ffn"), init=_expert_init)
    b.declare(f"{path}.w2", (e, f, d), ("experts", "ffn", None), init=_expert_init)
    if cfg.moe_shared_expert:
        declare_ffn(b, f"{path}.shared", d, cfg.moe_shared_d_ff or f, cfg.gated_ffn)


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
    if cfg.moe_router == "sigmoid":
        return _sigmoid_router(logits, cfg)
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(logits, cfg.moe_top_k, dim=-1)
    gates = torch.softmax(top_vals, dim=-1)                      # renormalize
    # switch-style load balance: E * sum_e fraction_e * prob_e
    E = cfg.router_experts
    onehot = F.one_hot(top_idx, E).float()                       # (..., T, k, E)
    frac = onehot.sum(dim=-2).mean(dim=-2)                       # tokens per e
    lb = E * torch.sum(frac * probs.mean(dim=-2), dim=-1)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2, dim=-1)
    return gates, top_idx, {"load_balance": lb, "router_z": z}


def _sigmoid_router(logits: torch.Tensor, cfg: ModelConfig):
    """DeepSeek-V3's router (``noaux_tc`` with one group): sigmoid scores;
    the top-k of the scores plus ``e_score_correction_bias``, a bias its
    training recipe moves and the published config does not fix, held at
    0 here, so the top-k of the scores; the k scores normalized to sum 1
    and scaled by ``moe_route_scale``. The aux loss is the sequence-wise
    balance (arXiv:2412.19437 eq. 17-20) over the T tokens: sum over the
    experts of ``E / (k T)`` x the tokens that picked expert i, times the
    mean over the tokens of its score over the sum of every expert's."""
    k, E = cfg.moe_top_k, cfg.router_experts
    scores = torch.sigmoid(logits)                               # (..., T, E)
    top_vals, top_idx = torch.topk(scores, k, dim=-1)
    gates = top_vals / top_vals.sum(dim=-1, keepdim=True) * cfg.moe_route_scale
    T = scores.shape[-2]
    picked = F.one_hot(top_idx, E).float().sum(dim=(-3, -2))    # (..., E)
    share = (scores / scores.sum(dim=-1, keepdim=True)).mean(dim=-2)
    balance = torch.sum(picked * (E / (k * T)) * share, dim=-1)
    return gates, top_idx, {"seq_balance": balance}


def _held(cfg: ModelConfig, experts=None) -> Tuple[int, int]:
    """The ``(lo, hi)`` router ids of the experts a layer holds: this
    rank's under expert parallel (``experts``), else the config's share."""
    if experts is not None:
        return experts
    return cfg.moe_first_expert, cfg.moe_first_expert + cfg.moe_num_experts


def _moe_einsum(p, x2d, gates, idx, cfg: ModelConfig, experts=None) -> torch.Tensor:
    """Every held expert on every token, masked combine, in fp32. (T, E,
    F) memory. ``experts``: the ``(lo, hi)`` this rank holds (expert
    parallel); otherwise the config's share."""
    dtype = torch_dtype(cfg.compute_dtype)
    act = activation_fn(cfg.ffn_activation)
    xd = x2d.to(dtype)
    h = act(torch.einsum("td,edf->tef", xd, p["w1"].to(dtype)))
    if "w3" in p:
        h = h * torch.einsum("td,edf->tef", xd, p["w3"].to(dtype))
    y_all = torch.einsum("tef,efd->ted", h, p["w2"].to(dtype))   # (T, E, D)
    onehot = F.one_hot(idx, cfg.router_experts).float()          # (T, k, E)
    weights = (gates[..., None] * onehot).sum(dim=1)             # (T, E)
    lo, hi = _held(cfg, experts)
    return torch.einsum("ted,te->td", y_all.float(), weights[:, lo:hi])


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
    ascending expert order in fp32 (returned in fp32). The pairs routed
    to the held experts sort to the front. Without ``experts`` no step of
    the forward waits for the host, nor do the dx and dw kernels of the
    backward on the card: every pair is dispatched, and the kernels write
    0 for the rows past the held experts' groups (a config's share, whose
    other pairs add nothing). ``experts``: the ``(lo, hi)`` this rank
    holds (expert parallel); only its pairs are dispatched, at least one
    row: their count is read on the host (one wait a call), which sizes
    the pair buffers to the rank's pairs. The others add nothing."""
    dtype = torch_dtype(cfg.compute_dtype)
    act = activation_fn(cfg.ffn_activation)
    T, D = x2d.shape
    k = cfg.moe_top_k
    E = cfg.router_experts
    flat_e = idx.reshape(-1)                                     # (P,) P = T*k
    lo, hi = _held(cfg, experts)
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
    spans, counting = current_block_spans()
    back = BackwardSpan(spans, "moe/backward")
    with spans("moe") as span:
        y, aux, idx = _moe(p, back.input(x), cfg, impl=impl, xm=xm)
        if counting:
            lo, hi = _held(cfg)
            span.count(moe_pairs_held=((idx >= lo) & (idx < hi)).sum(),
                       moe_pairs_routed=idx.numel())
        return back.output(y), aux


def _moe(p, x, cfg: ModelConfig, *, impl: str, xm):
    """``moe_block``'s work: ``(y, aux, expert ids)``."""
    B, S, D = x.shape
    dtype = torch_dtype(cfg.compute_dtype)
    tp = tpl.context()
    experts = None
    split = tp is not None and (tp.sharded("experts") or tp.sharded("ffn"))
    if split and cfg.holds_share:
        raise NotImplementedError(f"{cfg.name} holds {cfg.moe_num_experts} of its router's "
                                  f"{cfg.router_experts} experts: no tensor parallel on top")
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
    return y, aux, idx
