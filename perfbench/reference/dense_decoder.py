"""Plain float32 reference of a dense decoder with grouped-query
attention (InternLM2, arXiv:2403.17297): RMSNorm before attention and
before a SwiGLU feed-forward, rotary positions on split halves, causal
softmax attention in which query head h reads kv head h // (H / KV), an
untied output head, and the mean token cross-entropy.

``param_specs`` gives the parameter tree in the layout the program under
test stores it (stacked over layers, ``blocks_0.*``) with the law each
leaf is drawn from, so that the benchmark can make one set of weights
and hand it to both sides. ``flops_per_token`` is the model's count for
``mfu``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.base import cross_entropy, lecun, matmul, rms


def param_specs(c: dict):
    d, L, H, KV, hd, ff = (c["d_model"], c["num_layers"], c["num_heads"],
                           c["num_kv_heads"], c["head_dim"], c["d_ff"])
    rows = c["vocab_rows"]
    out = [("embed.table", (rows, d), "normal:0.02")]
    if not c["tie_embeddings"]:
        out.append(("unembed.w", (d, rows), "normal:0.02"))
    out += [
        ("final_norm.scale", (d,), "ones"),
        ("blocks_0.norm1.scale", (L, d), "ones"),
        ("blocks_0.mixer.wq.w", (L, d, H * hd), lecun(d)),
        ("blocks_0.mixer.wk.w", (L, d, KV * hd), lecun(d)),
        ("blocks_0.mixer.wv.w", (L, d, KV * hd), lecun(d)),
        ("blocks_0.mixer.wo.w", (L, H * hd, d), lecun(H * hd)),
        ("blocks_0.norm2.scale", (L, d), "ones"),
        ("blocks_0.ffn.w1.w", (L, d, ff), lecun(d)),
        ("blocks_0.ffn.w3.w", (L, d, ff), lecun(d)),
        ("blocks_0.ffn.w2.w", (L, ff, d), lecun(ff)),
    ]
    return out


def flops_per_token(c: dict, seq: int) -> float:
    """6 x the parameters that do a matmul (the output head over the real
    vocabulary counts; the input lookup does not), plus causal
    attention's score and value products: fwd 2 x 2 hd H flops per
    (query, earlier key) pair, S (S + 1) / 2 pairs a sequence, x 3 for
    the backward. Recomputation is not counted."""
    d, L, H, KV, hd, ff, V = (c["d_model"], c["num_layers"], c["num_heads"],
                              c["num_kv_heads"], c["head_dim"], c["d_ff"], c["vocab_size"])
    layer = d * H * hd * 2 + d * KV * hd * 2 + 3 * d * ff
    matmul_params = L * layer + d * V
    attention = 3 * L * 4 * hd * H * (seq + 1) / 2
    return 6.0 * matmul_params + attention


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, hd), position s at index s; halves rotated."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64) / hd)
    ang = torch.arange(S, dtype=torch.float64)[:, None] * freqs[None, :]
    cos = torch.cos(ang).to(x.device, torch.float32)[None, :, None, :]
    sin = torch.sin(ang).to(x.device, torch.float32)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer(x: torch.Tensor, w: dict, c: dict, mm, causal: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    H, KV, hd, eps = c["num_heads"], c["num_kv_heads"], c["head_dim"], c["rms_eps"]
    h = rms(x, w["norm1.scale"], eps)
    q = _rope(mm(h, w["mixer.wq.w"]).view(B, S, H, hd), c["rope_theta"])
    k = _rope(mm(h, w["mixer.wk.w"]).view(B, S, KV, hd), c["rope_theta"])
    v = mm(h, w["mixer.wv.w"]).view(B, S, KV, hd)
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    att = scores.masked_fill(~causal, -math.inf).softmax(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, S, H * hd)
    x = x + mm(o, w["mixer.wo.w"])
    h = rms(x, w["norm2.scale"], eps)
    return x + mm(F.silu(mm(h, w["ffn.w1.w"])) * mm(h, w["ffn.w3.w"]), w["ffn.w2.w"])


def loss(p: dict, tokens: torch.Tensor, labels: torch.Tensor, c: dict,
         precision: str = "fp32") -> torch.Tensor:
    """The mean next-token cross-entropy of one node's batch (B, S). Each
    layer is recomputed in the backward (``torch.utils.checkpoint``), so
    that only the layers' inputs are kept: a whole sequence's float32
    scores stay within one layer."""
    mm = matmul(precision)
    S = tokens.shape[1]
    x = p["embed.table"][tokens.long()]
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    for layer in range(c["num_layers"]):
        w = {k[len("blocks_0."):]: v[layer] for k, v in p.items() if k.startswith("blocks_0.")}
        x = checkpoint(_layer, x, w, c, mm, causal, use_reentrant=False)
    x = rms(x, p["final_norm.scale"], c["rms_eps"])
    V = c["vocab_size"]
    head = p["embed.table"][:V].T if c["tie_embeddings"] else p["unembed.w"][:, :V]
    return cross_entropy(mm(x, head), labels)
