"""Plain float32 reference of the DeepSeek-V3 block (arXiv:2412.19437;
Moonlight-16B-A3B's config) as one chip's expert share trains it.

Every layer: RMSNorm, multi-head latent attention (no query LoRA: q
projected to H heads of ``head_dim``, ``mla_rope_dim`` of each rotated;
k and v from a ``mla_kv_rank`` latent under an RMSNorm, beside one rotated
key head that every head shares; causal softmax scaled by
1/sqrt(head_dim), the output ``mla_v_dim`` a head), then RMSNorm and a
feed-forward: a SwiGLU of ``d_ff`` in the first ``moe_first_dense``
layers, after them the MoE layer. Its router is DeepSeek-V3's: sigmoid
scores over ``moe_router_experts`` experts, the top-k scores normalized
to sum 1 and scaled by ``moe_route_scale`` (the correction bias of
``noaux_tc`` is 0: it is a training-recipe state the published config
does not give). The layer holds experts ``moe_first_expert`` ..
``moe_first_expert + moe_num_experts - 1`` and adds only their gated
SwiGLU outputs (width ``moe_d_ff``), each routed token's rows gathered
per expert, plus the shared experts as one SwiGLU of ``moe_shared_d_ff``;
the absent experts' terms are left out, as on the chip that holds this
share. Rotary positions on split halves of the rotated dims (the
published weights pair interleaved columns: a fixed permutation of
them), an untied head over the sliced vocabulary, and the objective:
the mean token cross-entropy plus 1e-4 (DeepSeek-V3's alpha) x the sum
over the MoE layers of the sequence-wise balance loss (eq. 17-20: per
sequence, the sum over experts of ``E / (k T)`` x its picks times its
mean normalized score, averaged over the sequences).

``param_specs`` gives the parameter tree in the layout the program under
test stores it (the leading dense layers under ``blocks_0``, the MoE
layers under ``blocks_1``, each stacked over its layers) with the law
each leaf is drawn from. ``flops_per_token`` is the model's count for
``mfu``. No file of the repository's packages is imported.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.base import cross_entropy, lecun, matmul, rms

SEQ_BALANCE_WEIGHT = 1e-4
QUERY_BLOCK = 1024          # attention's queries a block: each over the keys up to it


def _segments(c: dict):
    """``(tree key, layers, MoE or not)`` of each stacked group."""
    dense, total = c["moe_first_dense"], c["num_layers"]
    out = []
    if dense:
        out.append(("blocks_0", dense, False))
    if total > dense:
        out.append((f"blocks_{len(out)}", total - dense, True))
    return out


def param_specs(c: dict):
    d, H, hd = c["d_model"], c["num_heads"], c["head_dim"]
    r, rope, vd = c["mla_kv_rank"], c["mla_rope_dim"], c["mla_v_dim"]
    E, Er, f, fs = (c["moe_num_experts"], c["moe_router_experts"], c["moe_d_ff"],
                    c["moe_shared_d_ff"])
    rows = c["vocab_rows"]
    out = [("embed.table", (rows, d), "normal:0.02"),
           ("unembed.w", (d, rows), "normal:0.02"),
           ("final_norm.scale", (d,), "ones")]
    for key, L, moe in _segments(c):
        out += [
            (f"{key}.norm1.scale", (L, d), "ones"),
            (f"{key}.mixer.wq.w", (L, d, H * hd), lecun(d)),
            (f"{key}.mixer.wkv_a.w", (L, d, r + rope), lecun(d)),
            (f"{key}.mixer.kv_norm.scale", (L, r), "ones"),
            (f"{key}.mixer.wkv_b.w", (L, r, H * (hd - rope + vd)), lecun(r)),
            (f"{key}.mixer.wo.w", (L, H * vd, d), lecun(H * vd)),
            (f"{key}.norm2.scale", (L, d), "ones"),
        ]
        if not moe:
            ff = c["d_ff"]
            out += [(f"{key}.ffn.w1.w", (L, d, ff), lecun(d)),
                    (f"{key}.ffn.w3.w", (L, d, ff), lecun(d)),
                    (f"{key}.ffn.w2.w", (L, ff, d), lecun(ff))]
            continue
        out += [
            (f"{key}.ffn.router.w", (L, d, Er), lecun(d)),
            (f"{key}.ffn.w1", (L, E, d, f), lecun(d)),
            (f"{key}.ffn.w3", (L, E, d, f), lecun(d)),
            (f"{key}.ffn.w2", (L, E, f, d), lecun(f)),
            (f"{key}.ffn.shared.w1.w", (L, d, fs), lecun(d)),
            (f"{key}.ffn.shared.w3.w", (L, d, fs), lecun(d)),
            (f"{key}.ffn.shared.w2.w", (L, fs, d), lecun(fs)),
        ]
    return out


def flops_per_token(c: dict, seq: int) -> float:
    """6 x the matmul parameters a token meets (the output head over the
    vocabulary counts, the input lookup does not; the held experts at
    their expected ``k x held / router`` pairs a token, 6 x 8 / 64 = 0.75
    in the cell), plus causal attention's score products (``head_dim``)
    and value products (``mla_v_dim``): fwd 2 x (hd + hd_v) x H flops per
    (query, earlier key) pair, S (S + 1) / 2 pairs a sequence, x 3 for
    the backward. Recomputation is not counted."""
    d, L, H, hd, V = (c["d_model"], c["num_layers"], c["num_heads"], c["head_dim"],
                      c["vocab_size"])
    r, rope, vd = c["mla_kv_rank"], c["mla_rope_dim"], c["mla_v_dim"]
    dense = c["moe_first_dense"]
    attn = d * H * hd + d * (r + rope) + r * H * (hd - rope + vd) + H * vd * d
    pairs = c["moe_top_k"] * c["moe_num_experts"] / c["moe_router_experts"]
    moe = (d * c["moe_router_experts"] + 3 * d * c["moe_shared_d_ff"]
           + pairs * 3 * d * c["moe_d_ff"])
    matmul_params = L * attn + dense * 3 * d * c["d_ff"] + (L - dense) * moe + d * V
    attention = 3 * L * 2 * (hd + vd) * H * (seq + 1) / 2
    return 6.0 * matmul_params + attention


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, dims), position s at index s; halves rotated."""
    S, dims = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, dims, 2, dtype=torch.float64) / dims)
    ang = torch.arange(S, dtype=torch.float64)[:, None] * freqs[None, :]
    cos = torch.cos(ang).to(x.device, torch.float32)[None, :, None, :]
    sin = torch.sin(ang).to(x.device, torch.float32)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v) -> torch.Tensor:
    """Causal softmax attention, q / k (B, S, H, hd), v (B, S, H, hd_v):
    a block of queries at a time over the keys up to its last query (the
    later keys are masked out, so leaving them out is exact)."""
    S, hd = q.shape[1], q.shape[-1]
    outs = []
    for q0 in range(0, S, QUERY_BLOCK):
        q1 = min(S, q0 + QUERY_BLOCK)
        scores = torch.einsum("bqhd,bkhd->bhqk", q[:, q0:q1], k[:, :q1]) / math.sqrt(hd)
        causal = (torch.arange(q1, device=q.device)[None, :]
                  <= torch.arange(q0, q1, device=q.device)[:, None])
        att = scores.masked_fill(~causal, -math.inf).softmax(dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", att, v[:, :q1]))
    return torch.cat(outs, dim=1)


def _mla(h: torch.Tensor, w: dict, c: dict, mm) -> torch.Tensor:
    B, S = h.shape[:2]
    H, hd, r = c["num_heads"], c["head_dim"], c["mla_kv_rank"]
    rope, vd = c["mla_rope_dim"], c["mla_v_dim"]
    nope = hd - rope
    q_nope, q_pe = mm(h, w["mixer.wq.w"]).view(B, S, H, hd).split([nope, rope], dim=-1)
    latent, k_pe = mm(h, w["mixer.wkv_a.w"]).split([r, rope], dim=-1)
    kv = mm(rms(latent, w["mixer.kv_norm.scale"], c["rms_eps"]), w["mixer.wkv_b.w"])
    k_nope, v = kv.view(B, S, H, nope + vd).split([nope, vd], dim=-1)
    q = torch.cat([q_nope, _rope(q_pe, c["rope_theta"])], dim=-1)
    k_pe = _rope(k_pe[:, :, None, :], c["rope_theta"]).expand(B, S, H, rope)
    k = torch.cat([k_nope, k_pe], dim=-1)
    return mm(_attention(q, k, v).reshape(B, S, H * vd), w["mixer.wo.w"])


def _swiglu(x, w1, w3, w2, mm):
    return mm(F.silu(mm(x, w1)) * mm(x, w3), w2)


def _moe(h: torch.Tensor, w: dict, c: dict, mm):
    """The held experts' part of the MoE layer, the shared experts whole,
    and the layer's sequence-wise balance loss."""
    B, S, D = h.shape
    k, Er, lo = c["moe_top_k"], c["moe_router_experts"], c["moe_first_expert"]
    scores = torch.sigmoid(mm(h, w["ffn.router.w"]))                  # (B, S, Er)
    top, idx = scores.topk(k, dim=-1)
    gates = top / top.sum(dim=-1, keepdim=True) * c["moe_route_scale"]
    picked = torch.zeros(B, Er, device=h.device).scatter_add_(
        1, idx.reshape(B, -1), torch.ones(B, S * k, device=h.device))
    share = (scores / scores.sum(dim=-1, keepdim=True)).mean(dim=1)
    balance = (picked * (Er / (k * S)) * share).sum(dim=-1).mean()
    x = h.reshape(B * S, D)
    idx, gates = idx.reshape(B * S, k), gates.reshape(B * S, k)
    out = torch.zeros_like(x)
    for e in range(c["moe_num_experts"]):
        hit = idx == lo + e                                           # (T, k)
        rows = hit.any(dim=-1).nonzero().squeeze(1)
        if not rows.numel():                 # no token picked this expert
            continue
        gate = (gates * hit).sum(dim=-1)[rows]
        y = _swiglu(x[rows], w["ffn.w1"][e], w["ffn.w3"][e], w["ffn.w2"][e], mm)
        out = out.index_add(0, rows, y * gate[:, None])
    shared = _swiglu(h, w["ffn.shared.w1.w"], w["ffn.shared.w3.w"], w["ffn.shared.w2.w"], mm)
    return out.view(B, S, D) + shared, balance


def _layer(x: torch.Tensor, w: dict, c: dict, mm, moe: bool):
    eps = c["rms_eps"]
    x = x + _mla(rms(x, w["norm1.scale"], eps), w, c, mm)
    h = rms(x, w["norm2.scale"], eps)
    if not moe:
        return x + _swiglu(h, w["ffn.w1.w"], w["ffn.w3.w"], w["ffn.w2.w"], mm), x.new_zeros(())
    y, balance = _moe(h, w, c, mm)
    return x + y, balance


def loss(p: dict, tokens: torch.Tensor, labels: torch.Tensor, c: dict,
         precision: str = "fp32") -> torch.Tensor:
    """The objective of one node's batch (B, S). Each layer is recomputed
    in the backward (``torch.utils.checkpoint``), so that only the
    layers' inputs are kept."""
    mm = matmul(precision)
    x = p["embed.table"][tokens.long()]
    balance = x.new_zeros(())
    for key, L, moe in _segments(c):
        for layer in range(L):
            w = {name[len(key) + 1:]: v[layer] for name, v in p.items()
                 if name.startswith(key + ".")}
            x, b = checkpoint(_layer, x, w, c, mm, moe, use_reentrant=False)
            balance = balance + b
    x = rms(x, p["final_norm.scale"], c["rms_eps"])
    head = p["unembed.w"][:, :c["vocab_size"]]
    return cross_entropy(mm(x, head), labels) + SEQ_BALANCE_WEIGHT * balance
