"""Mamba2 (SSD, state-space duality) blocks. [arXiv:2405.21060]

The port of ``repro.models.ssm``. Selective state space with a scalar
decay per head:

    h_t = exp(dt_t * A) h_{t-1} + dt_t * (B_t (x) x_t)        (N x P state)
    y_t = C_t . h_t + D * x_t

Three execution paths, as in the JAX package:

  * ``ssd_sequential``: the step-by-step recurrence, the oracle, and
    what a decode step (one token) runs;
  * ``ssd_chunked``: intra-chunk masked matmul plus an inter-chunk
    state scan, with autograd; training and any prefill that does not
    start at position 0 run it;
  * ``repro_torch.kernels.ops.ssd``: the hand-written Hopper chunk-scan
    kernel on the card, its plain version on the CPU. A serving prefill
    from position 0 runs it: the state before position 0 is zero, which
    is the kernel's own starting state. The kernel has no backward, so
    training stays on ``ssd_chunked`` (the backward kernel is a later
    slice of the port).

dt and A are fp32; the gated RMSNorm keeps fp32 statistics; the final
state is cast to x's dtype, as in the JAX package.

Under tensor parallel (``repro_torch.models.tp``) the mixer shards over
its heads, following the rules: ``in_z`` / ``in_x`` are column-parallel
over ``ssm_inner``, ``in_dt``, ``A_log``, ``D`` and ``dt_bias`` over
``ssm_heads``; ``in_b`` / ``in_c`` stay replicated and enter the
sharded region through ``to_model``. The depthwise conv runs over the
rank's x columns plus B and C: ``conv_w`` / ``conv_b`` are replicated
(as in JAX) and each rank slices their columns. The gated RMSNorm's
mean runs over the whole ``d_inner`` (the sum of squares is reduced),
``out`` is row-parallel, ``ops.ssd`` receives the rank's H/T heads, and
a rank's Mamba cache holds its heads and its conv columns.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import tp as tpl
from repro_torch.models.layers import apply_dense, declare_dense
from repro_torch.models.module import ParamBuilder, ones_init, torch_dtype, zeros_init


def ssm_dims(cfg: ModelConfig, tp: Optional[tpl.TP] = None) -> dict:
    """The mixer's dims; with ``tp``, this rank's share of them (x
    columns and heads; B and C stay whole)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    head_dim = cfg.ssm_head_dim or 64
    nheads = cfg.ssm_num_heads or d_inner // head_dim
    if tp is not None and _split(tp):
        d_inner, nheads = d_inner // tp.size, nheads // tp.size
    return dict(
        d_inner=d_inner,
        head_dim=head_dim,
        nheads=nheads,
        dstate=cfg.ssm_state_dim,
        conv_width=cfg.ssm_conv_width,
        conv_dim=d_inner + 2 * cfg.ssm_state_dim,   # x, B, C are conv'd
    )


def _split(tp: Optional[tpl.TP]) -> bool:
    """Whether the mixer is sharded: its inner columns and its heads
    split together (a head's P columns are contiguous), or neither."""
    if tp is None:
        return False
    inner, heads = tp.sharded("ssm_inner"), tp.sharded("ssm_heads")
    if inner != heads:
        raise ValueError(
            "the rules split the Mamba2 mixer's inner dim and its heads differently "
            f"(ssm_inner {inner}, ssm_heads {heads}): a head's columns would cross ranks")
    return inner


# ---------------------------------------------------------------------------
# Declarations
# ---------------------------------------------------------------------------
def declare_mamba(b: ParamBuilder, path: str, cfg: ModelConfig) -> None:
    d = cfg.d_model
    dims = ssm_dims(cfg)
    di, H, N = dims["d_inner"], dims["nheads"], dims["dstate"]
    declare_dense(b, f"{path}.in_z", d, di, (None, "ssm_inner"))
    declare_dense(b, f"{path}.in_x", d, di, (None, "ssm_inner"))
    declare_dense(b, f"{path}.in_b", d, N, (None, None))
    declare_dense(b, f"{path}.in_c", d, N, (None, None))
    declare_dense(b, f"{path}.in_dt", d, H, (None, "ssm_heads"))
    b.declare(f"{path}.conv_w", (dims["conv_width"], dims["conv_dim"]),
              (None, None), init=_conv_init)
    b.declare(f"{path}.conv_b", (dims["conv_dim"],), (None,), init=zeros_init)
    b.declare(f"{path}.A_log", (H,), ("ssm_heads",), init=_a_log_init)
    b.declare(f"{path}.D", (H,), ("ssm_heads",), init=ones_init)
    b.declare(f"{path}.dt_bias", (H,), ("ssm_heads",), init=_dt_bias_init)
    b.declare(f"{path}.norm_scale", (di,), ("ssm_inner",), init=ones_init)
    declare_dense(b, f"{path}.out", di, d, ("ssm_inner", None))


def _uniform(gen, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device, dtype=torch.float32)


def _a_log_init(gen, shape, dtype, device):
    # A in [1, 16] as in the mamba2 reference init
    a = 1.0 + 15.0 * _uniform(gen, shape, device)
    return torch.log(a).to(dtype)


def _dt_bias_init(gen, shape, dtype, device):
    # dt in [1e-3, 1e-1] through softplus
    lo, hi = np.log(1e-3), np.log(1e-1)
    dt = torch.exp(_uniform(gen, shape, device) * (hi - lo) + lo)
    return torch.log(torch.expm1(dt)).to(dtype)


def _conv_init(gen, shape, dtype, device):
    scale = 1.0 / np.sqrt(shape[0])
    return ((2.0 * _uniform(gen, shape, device) - 1.0) * scale).to(dtype)


# ---------------------------------------------------------------------------
# Chunked SSD core
# ---------------------------------------------------------------------------
def ssd_chunked(
    x: torch.Tensor,        # (B, S, H, P)
    dt: torch.Tensor,       # (B, S, H), post-softplus, positive
    A: torch.Tensor,        # (H,) negative decay rates
    B_mat: torch.Tensor,    # (B, S, N)
    C_mat: torch.Tensor,    # (B, S, N)
    *,
    chunk: int,
    h0: Optional[torch.Tensor] = None,   # (B, H, N, P) initial state
    return_final_state: bool = False,
):
    """Exact SSD recurrence evaluated chunk-parallel, in fp32.

    Returns y (B,S,H,P) [and the final state (B,H,N,P)], in x's dtype."""
    Bsz, S, H, P = x.shape
    N = B_mat.shape[-1]
    if S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    nc = S // chunk
    f32 = torch.float32

    xc = x.reshape(Bsz, nc, chunk, H, P).to(f32)
    dtc = dt.reshape(Bsz, nc, chunk, H).to(f32)
    Bc = B_mat.reshape(Bsz, nc, chunk, N).to(f32)
    Cc = C_mat.reshape(Bsz, nc, chunk, N).to(f32)

    loga = dtc * A.to(f32)[None, None, None, :]              # (B,nc,Q,H) <= 0
    cum = torch.cumsum(loga, dim=2)                          # La_i
    # intra-chunk: M_ij = (C_i . B_j) exp(La_i - La_j) dt_j, j <= i
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)             # (B,nc,Q,Q)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(mask[None, None, :, :, None], diff, -torch.inf))
    M = CB[..., None] * decay * dtc[:, :, None, :, :]        # (B,nc,Q,Q,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xc)

    # chunk-final states: S_c = sum_j exp(La_Q - La_j) dt_j B_j (x) x_j
    tail = torch.exp(cum[:, :, -1:, :] - cum) * dtc          # (B,nc,Q,H)
    chunk_state = torch.einsum("bcjh,bcjn,bcjhp->bchnp", tail, Bc, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (B,nc,H)

    # inter-chunk scan over nc (the only sequential part)
    h = torch.zeros((Bsz, H, N, P), dtype=f32, device=x.device) if h0 is None \
        else h0.to(f32)
    starts = []
    for c in range(nc):
        starts.append(h)
        h = h * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    h_starts = torch.stack(starts, dim=1)                    # (B,nc,H,N,P)

    # inter-chunk contribution: y_i += C_i . (exp(La_i) h_start)
    inter = torch.einsum("bcin,bchnp,bcih->bcihp", Cc, h_starts, torch.exp(cum))
    y = (y_intra + inter).reshape(Bsz, S, H, P)
    if return_final_state:
        return y.to(x.dtype), h.to(x.dtype)
    return y.to(x.dtype)


def ssd_sequential(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
    B_mat: torch.Tensor, C_mat: torch.Tensor,
    *, h0: Optional[torch.Tensor] = None, return_final_state: bool = False,
):
    """Step-by-step oracle recurrence (tests and decode), in fp32."""
    Bsz, S, H, P = x.shape
    N = B_mat.shape[-1]
    f32 = torch.float32
    h = torch.zeros((Bsz, H, N, P), dtype=f32, device=x.device) if h0 is None \
        else h0.to(f32)
    Af = A.to(f32)
    ys = []
    for t in range(S):
        dtt = dt[:, t].to(f32)                                # (B,H)
        a = torch.exp(dtt * Af)
        hb = torch.einsum("bh,bn,bhp->bhnp", dtt, B_mat[:, t].to(f32),
                          x[:, t].to(f32))
        h = h * a[..., None, None] + hb
        ys.append(torch.einsum("bn,bhnp->bhp", C_mat[:, t].to(f32), h))
    y = torch.stack(ys, dim=1).to(x.dtype)
    if return_final_state:
        return y, h.to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# Causal conv1d helper (width-W depthwise)
# ---------------------------------------------------------------------------
def causal_conv1d(
    u: torch.Tensor,            # (B, S, C)
    w: torch.Tensor,            # (W, C)
    bias: torch.Tensor,         # (C,)
    state: Optional[torch.Tensor] = None,   # (B, W-1, C) carried for decode
) -> Tuple[torch.Tensor, torch.Tensor]:
    W = w.shape[0]
    if state is None:
        state = torch.zeros((u.shape[0], W - 1, u.shape[-1]), dtype=u.dtype,
                            device=u.device)
    padded = torch.cat([state.to(u.dtype), u], dim=1)
    S = u.shape[1]
    out = sum(padded[:, i: i + S, :] * w[i][None, None, :] for i in range(W))
    out = out + bias[None, None, :]
    new_state = padded[:, -(W - 1):, :]
    return F.silu(out), new_state


# ---------------------------------------------------------------------------
# Full Mamba2 block
# ---------------------------------------------------------------------------
def mamba_block(
    p: dict,
    x: torch.Tensor,                    # (B, S, D)
    cfg: ModelConfig,
    *,
    state: Optional[dict] = None,       # {"ssm": (B,H,N,P), "conv": (B,W-1,Cd)}
    return_state: bool = False,
    from_zero_state: bool = False,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """One Mamba2 mixer. ``from_zero_state`` says that ``state`` is the
    zero state of ``init_mamba_state`` (a serving prefill from position
    0): a multi-token step then runs ``ops.ssd``, the chunk-scan kernel
    on the card. Otherwise a multi-token step runs ``ssd_chunked`` and a
    single token ``ssd_sequential``, as in the JAX block."""
    dtype = torch_dtype(cfg.compute_dtype)
    tp = tpl.context()
    split = _split(tp)
    dims = ssm_dims(cfg, tp)
    H, P, N = dims["nheads"], dims["head_dim"], dims["dstate"]
    di = dims["d_inner"]
    Bsz, S, _ = x.shape

    xm = tpl.to_model(x) if split else x
    z = apply_dense(p["in_z"], xm, dtype)                    # (B,S,di)
    xs = apply_dense(p["in_x"], xm, dtype)
    bs = apply_dense(p["in_b"], x, dtype)                    # (B,S,N)
    cs = apply_dense(p["in_c"], x, dtype)
    dt_raw = apply_dense(p["in_dt"], xm, dtype)              # (B,S,H)

    conv_in = torch.cat([xs, bs, cs], dim=-1)
    conv_state = None if state is None else state["conv"]
    conv_w, conv_b = p["conv_w"], p["conv_b"]
    if split:
        # the rank's x columns of the replicated conv (their gradient is
        # added over the ranks) beside the B and C columns every rank runs
        full = cfg.ssm_expand * cfg.d_model
        lo = tp.rank * di
        conv_w = torch.cat([tpl.to_model(conv_w[:, :full])[:, lo:lo + di],
                            conv_w[:, full:]], dim=-1)
        conv_b = torch.cat([tpl.to_model(conv_b[:full])[lo:lo + di], conv_b[full:]])
    conv_out, new_conv_state = causal_conv1d(
        conv_in, conv_w.to(dtype), conv_b.to(dtype), conv_state,
    )
    xs = conv_out[..., :di]
    bs = conv_out[..., di: di + N]
    cs = conv_out[..., di + N:]
    if split:
        bs, cs = tpl.to_model(bs), tpl.to_model(cs)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    xh = xs.reshape(Bsz, S, H, P)

    h0 = None if state is None else state["ssm"]
    if S == 1:
        y, h_final = ssd_sequential(xh, dt, A, bs, cs, h0=h0, return_final_state=True)
    elif from_zero_state:
        y, h_final = ops.ssd(
            xh.contiguous(), dt, A, bs.contiguous(), cs.contiguous(),
            chunk=cfg.ssm_chunk,
        )
        h_final = h_final.to(xh.dtype)
    else:
        chunk = min(cfg.ssm_chunk, S)
        while S % chunk:
            chunk //= 2
        y, h_final = ssd_chunked(
            xh, dt, A, bs, cs, chunk=chunk, h0=h0, return_final_state=True
        )
    y = y + xh * p["D"].float()[None, None, :, None].to(y.dtype)
    y = y.reshape(Bsz, S, di)
    # gated RMSNorm (mamba2): norm(y * silu(z)); fp32 statistics only
    y = (y * F.silu(z)).to(dtype)
    yf = y.float()
    if split:
        # the mean over the whole d_inner: the ranks' sums of squares added
        sq = tpl.model_sum(torch.sum(yf * yf, dim=-1, keepdim=True))
        stat = torch.rsqrt(sq / (di * tp.size) + 1e-6)
    else:
        stat = torch.rsqrt(torch.mean(yf * yf, dim=-1, keepdim=True) + 1e-6)
    y = y * stat.to(dtype) * p["norm_scale"].to(dtype)
    out = apply_dense(p["out"], y, dtype)
    if split:
        out = tpl.reduce_from_model(out)
    if return_state:
        return out, {"ssm": h_final, "conv": new_conv_state}
    return out, None


def init_mamba_state(batch: int, cfg: ModelConfig, dtype, device) -> dict:
    """A zero state: this rank's heads and conv columns under tensor
    parallel."""
    dims = ssm_dims(cfg, tpl.context())
    return {
        "ssm": torch.zeros(
            (batch, dims["nheads"], dims["dstate"], dims["head_dim"]),
            dtype=dtype, device=device,
        ),
        "conv": torch.zeros(
            (batch, dims["conv_width"] - 1, dims["conv_dim"]),
            dtype=dtype, device=device,
        ),
    }
