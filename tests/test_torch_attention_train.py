"""Training attention through the flash kernel and its backward.

On the CPU (no card needed):

* ``models.attention.flash_route``, the one rule that sends a training
  attention call to the flash kernel: taken on meta (the dry run) and
  card tensors in bf16 at head widths 64 and 128 and at latent
  attention's q / k 192 over v 128; refused for each exclusion (fp32, hd
  112 and 256, other pairs of widths, softcap, window, keys of another
  length, CPU tensors); ``attention_block`` asks it for cache-less
  self-attention only, whatever the start position (cross-attention and
  cache steps stay plain), and ``sdpa`` at an offset start computes the
  kernel's index-causal function;
* on CPU tensors training keeps ``sdpa``: the tiny model's loss and
  gradients are bit-equal to a run with the rule switched off, and a
  traced step's spans count the plain calls (none through the kernel);
* the plain backward passes (``kernels.ref``) equal autograd through the
  plain attention, also at q / k 192 over v 128; the kernels' costs count
  the two widths apart;
* the dry run of Moonlight's latent attention launches the kernels and
  no plain attention;
* the dry run of internlm2-1.8b-d10 training (one node's loss and
  gradients at the cell's 1 x 4096) launches the flash forward twice a
  layer (remat) and each backward pass once a layer, and one attention
  block's forward and backward peak GBs lower than through ``sdpa`` (the
  whole replica's peak is the head's, the same on both routes).

Marked ``cuda`` (skip without an sm_90 card; this file imports no JAX):
the backward kernels' dq, dk and dv against the float32 plain backward at
the training cell's shape and at ragged S, GQA groups 1, 2 and 8, causal
and not, hd 64 and 128, and at latent attention's q / k 192 over v 128;
two launches bit-equal; the forward's lse against a plain log-sum-exp,
and refused off the wgmma path; ``ops.attention``'s gradients through
``FlashAttention``.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_attention_train.py
"""
import dataclasses

import pytest
import torch

from repro_torch.analysis import launch_counts
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun
from repro_torch.models import attention
from repro_torch.models.transformer import Model
from repro_torch.tree import tree_leaves, tree_map


def _qk(device="meta", dtype=torch.bfloat16, hd=128, S=16, Sk=None, hd_v=None):
    q = torch.empty((2, S, 4, hd), dtype=dtype, device=device)
    k = torch.empty((2, Sk or S, 2, hd), dtype=dtype, device=device)
    v = torch.empty((2, Sk or S, 2, hd_v or hd), dtype=dtype, device=device)
    return q, k, v


ROUTE = dict(logit_softcap=0.0, window=0)


@pytest.mark.parametrize("case,qk,over,want", [
    ("meta bf16 hd 128", dict(), {}, True),
    ("meta bf16 hd 64", dict(hd=64), {}, True),
    ("fp32", dict(dtype=torch.float32), {}, False),
    ("hd 112", dict(hd=112), {}, False),
    ("hd 256", dict(hd=256), {}, False),
    ("softcap", dict(), dict(logit_softcap=50.0), False),
    ("window", dict(), dict(window=1024), False),
    ("keys of another length", dict(Sk=24), {}, False),
    ("cpu", dict(device="cpu"), {}, False),
    ("v narrower than q and k (latent attention)", dict(hd=128, hd_v=64), {}, False),
    ("meta bf16 q / k 192, v 128 (Moonlight's latent attention)", dict(hd=192, hd_v=128), {},
     True),
    ("q / k 192, v 192", dict(hd=192, hd_v=192), {}, False),
    ("q / k 192, v 64", dict(hd=192, hd_v=64), {}, False),
    ("fp32 q / k 192, v 128", dict(hd=192, hd_v=128, dtype=torch.float32), {}, False),
    ("cpu q / k 192, v 128", dict(hd=192, hd_v=128, device="cpu"), {}, False),
])
def test_flash_route_takes_and_refuses(case, qk, over, want):
    q, k, v = _qk(**qk)
    assert attention.flash_route(q, k, v, **dict(ROUTE, **over)) is want, case


@pytest.mark.parametrize("case,plain", [
    ("self-attention", False),
    ("self-attention from position 5", False),
    ("cross-attention", True),
    ("cache", True),
])
def test_attention_block_asks_the_rule_for_cache_less_self_attention(case, plain):
    """internlm2-1.8b's block on meta tensors (bf16, hd 128): cache-less
    self-attention takes the kernel from any start; cross-attention over
    keys of the same length and a multi-token cache step stay plain."""
    cfg = get_config("internlm2_1_8b")
    S, kw = 16, {}
    p = tree_map(lambda a: a[0], Model(cfg).init(0, device="meta")["blocks_0"]["mixer"])
    x = torch.empty((1, S, cfg.d_model), dtype=torch.bfloat16, device="meta")
    start = 5 if case.endswith("5") else 0
    pos = torch.arange(start, start + S, dtype=torch.int32, device="meta")[None]
    kv = torch.empty((1, S, cfg.num_kv_heads, cfg.head_dim), dtype=torch.bfloat16,
                     device="meta")
    if case == "cross-attention":
        kw = dict(cross_kv=(kv, kv))
    if case == "cache":
        spec = attention.CacheSpec(length=2 * S, ring=False)
        kw = dict(cache_spec=spec, cache=attention.init_kv_cache(
            1, spec, cfg.num_kv_heads, cfg.head_dim, torch.bfloat16, "meta"))
    before = attention.route_counts()["attention_plain"]
    attention.attention_block(p, x, cfg, positions=pos, **kw)
    assert attention.route_counts()["attention_plain"] - before == plain


def test_plain_route_at_an_offset_start_is_the_kernels_function():
    """``sdpa`` given one positions tensor for queries and keys masks by
    index whatever the start: from position 5 it equals the call from 0
    bit for bit, and the kernel's plain version (index-causal)."""
    gen = torch.Generator().manual_seed(5)
    B, S = 2, 37
    q, k, v = (torch.randn((B, S, h, 16), generator=gen) for h in (4, 2, 2))
    out = {}
    for start in (0, 5):
        pos = torch.arange(start, start + S, dtype=torch.int32)[None].expand(B, S)
        out[start] = attention.sdpa(q, k, v, q_positions=pos, k_positions=pos, causal=True)
    assert torch.equal(out[5], out[0])
    assert torch.allclose(out[5], ref.attention_ref(q, k, v, causal=True), atol=1e-6)


def _tiny_loss_and_grads(cfg, batch):
    model = Model(cfg)
    params = tree_map(lambda a: a.requires_grad_(), model.init(0, device="cpu"))
    loss, _ = model.loss(params, batch)
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(params))


def test_cpu_training_keeps_sdpa_bit_for_bit(monkeypatch):
    """The tiny internlm2 (and a bf16 variant at hd 64, the backward's
    width) on the CPU: the loss and every gradient equal a run with the
    rule switched off, bit for bit, and every attention call is plain."""
    from repro_torch.data.pipeline import DecentralizedBatches

    for cfg in (get_smoke_config("internlm2_1_8b"),
                dataclasses.replace(get_smoke_config("internlm2_1_8b"), head_dim=64)):
        batch = {k: v[0] for k, v in next(DecentralizedBatches(
            cfg, 1, 2, 16, seed=0, device="cpu")).items()}
        before = attention.route_counts()
        loss, grads = _tiny_loss_and_grads(cfg, batch)
        after = attention.route_counts()
        assert after["attention_kernel"] == before["attention_kernel"]
        # remat runs each layer again in the backward
        assert after["attention_plain"] - before["attention_plain"] == \
            cfg.num_layers * (1 + cfg.remat)
        with monkeypatch.context() as m:
            m.setattr(attention, "flash_route", lambda *a, **k: False)
            want_loss, want = _tiny_loss_and_grads(cfg, batch)
        assert torch.equal(loss, want_loss)
        assert all(torch.equal(g, w) for g, w in zip(grads, want))


def test_traced_step_counts_attention_calls_by_route():
    """A traced step on the CPU attaches the calls to its forward and
    backward spans: every one plain, each layer once in the forward and
    once more in the backward (remat)."""
    from repro_torch.core import named_graph, plan_matcha
    from repro_torch.dist import decen_train as dt
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.optim.optimizers import sgd
    from repro_torch.telemetry import StepTimer, TraceRecorder

    cfg = get_smoke_config("internlm2_1_8b")
    nodes = 3
    model, opt = Model(cfg), sgd(0.05, momentum=0.9)
    plan = plan_matcha(named_graph("ring", nodes, seed=3), 0.5, seed=0)
    params = dt.init_stacked_params(model, nodes, seed=0, device="cpu")
    state = dt.init_stacked_opt_state(opt, model, nodes, device="cpu")
    batch = next(DecentralizedBatches(cfg, nodes, 2, 16, seed=0, device="cpu"))
    step = dt.make_train_step(model, opt, plan, gossip_mode="masked",
                              timer=StepTimer(TraceRecorder()))
    bits = torch.as_tensor(plan.schedule(1, seed=0).activations[0].astype("float32"))
    step(params, state, batch, bits)
    by_span = {}
    for span in step.last_phases.spans:
        if span.name in ("forward", "backward"):
            for key, n in span.counts().items():
                by_span[(span.name, key)] = by_span.get((span.name, key), 0) + n
    L = cfg.num_layers
    assert by_span == {("forward", "attention_kernel"): 0,
                       ("forward", "attention_plain"): nodes * L,
                       ("backward", "attention_kernel"): 0,
                       ("backward", "attention_plain"): nodes * L}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (2, 2), (8, 1)])
def test_plain_backward_passes_equal_autograd(causal, Hq, Hkv):
    gen = torch.Generator().manual_seed(Hq)
    B, S, hd = 2, 37, 16
    q, k, v = (torch.randn((B, S, h, hd), generator=gen, dtype=torch.float64).requires_grad_()
               for h in (Hq, Hkv, Hkv))
    o = ref.attention_ref(q, k, v, causal=causal)
    do = torch.randn(o.shape, generator=gen, dtype=torch.float64)
    want = torch.autograd.grad(o, (q, k, v), do)
    with torch.no_grad():
        lse = ref.attention_lse_ref(q, k, causal=causal)
        dq, delta = ops.attention_dq(q, k, v, o, do, lse, causal=causal)
        dk, dv = ops.attention_dkdv(q, k, v, do, lse, delta, causal=causal)
    # the plain passes sum in fp32, as the plain attention does
    for got, w in zip((dq, dk, dv), want):
        assert torch.allclose(got, w, atol=1e-5, rtol=1e-5)
    assert torch.allclose(delta.double(), (do * o).sum(-1).transpose(1, 2), atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd,hd_v", [(192, 128), (128, 128)])
def test_plain_backward_passes_equal_autograd_at_the_kernels_widths(hd, hd_v, causal):
    """The plain passes at latent attention's q / k 192 over v 128 (and at
    one width of 128): dq, dk and dv equal autograd through
    ``attention_ref``, whose output takes v's width."""
    gen = torch.Generator().manual_seed(hd + hd_v)
    B, S, Hq, Hkv = 1, 37, 4, 2
    q, k = (torch.randn((B, S, h, hd), generator=gen, dtype=torch.float64).requires_grad_()
            for h in (Hq, Hkv))
    v = torch.randn((B, S, Hkv, hd_v), generator=gen, dtype=torch.float64).requires_grad_()
    o = ref.attention_ref(q, k, v, causal=causal)
    assert o.shape == (B, S, Hq, hd_v)
    do = torch.randn(o.shape, generator=gen, dtype=torch.float64)
    want = torch.autograd.grad(o, (q, k, v), do)
    with torch.no_grad():
        lse = ref.attention_lse_ref(q, k, causal=causal)
        dq, delta = ops.attention_dq(q, k, v, o, do, lse, causal=causal)
        dk, dv = ops.attention_dkdv(q, k, v, do, lse, delta, causal=causal)
    for got, w in zip((dq, dk, dv), want):
        assert got.shape == w.shape
        assert torch.allclose(got, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hd,hd_v", [(192, 128), (128, 128), (64, 64)])
def test_costs_count_the_two_widths_apart(hd, hd_v):
    """Per live (query, key) pair and query head: the forward 2 (hd + hd_v)
    flops, the backward's bound 2 (3 hd + 2 hd_v), the dq pass 2 (2 hd +
    hd_v) and the dk / dv pass 2 (2 hd + 2 hd_v); their bytes read each
    operand at its own width once."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    B, S, Hq, Hkv = 1, 100, 4, 2
    pairs = B * Hq * fa.live_pairs(S, S, True, 0, 0)
    assert pairs == B * Hq * S * (S + 1) // 2
    flops, nbytes = fa.cost(B, S, S, Hq, Hkv, hd, torch.bfloat16, causal=True, hd_v=hd_v)
    assert flops == 2 * (hd + hd_v) * pairs
    assert nbytes == 2 * B * S * (Hq * (hd + hd_v) + Hkv * (hd + hd_v))
    flops, _ = fab.cost(B, S, Hq, Hkv, hd, causal=True, hd_v=hd_v)
    assert flops == 2 * (3 * hd + 2 * hd_v) * pairs
    dq = fab.pass_cost("dq", B, S, Hq, Hkv, hd, causal=True, hd_v=hd_v)
    dkdv = fab.pass_cost("dkdv", B, S, Hq, Hkv, hd, causal=True, hd_v=hd_v)
    assert dq[0] == 2 * (2 * hd + hd_v) * pairs
    assert dkdv[0] == 2 * (2 * hd + 2 * hd_v) * pairs
    stats = 2 * B * Hq * S * 4
    assert dq[1] == 2 * B * S * (Hq * (2 * hd + 2 * hd_v) + Hkv * (hd + hd_v)) + stats
    assert dkdv[1] == 2 * B * S * (Hq * (hd + hd_v) + Hkv * (2 * hd + 2 * hd_v)) + stats
    if hd == hd_v:          # one width: the defaults
        assert fa.cost(B, S, S, Hq, Hkv, hd, torch.bfloat16, causal=True)[0] == 4 * hd * pairs
        assert fab.cost(B, S, Hq, Hkv, hd, causal=True)[0] == 10 * hd * pairs


def test_dry_run_of_moonlight_training_launches_the_kernels_and_no_plain_attention():
    """Moonlight-16B-A3B's replica (latent attention at q / k 192, v 128)
    at 2 layers on meta: each layer's attention launches the flash forward
    twice (remat) and each backward pass once, and no call takes
    ``sdpa``; the reported flops of the three kernels are their costs."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    from repro_torch.kernels import meta

    cfg = dryrun.config_for("moonlight_16b_a3b", layers=2, experts=8, vocab=20480)
    assert (cfg.head_dim, cfg.mla_v_dim) == (192, 128)
    S = 512
    reported = {}

    def hear(kernel, flops, nbytes, dtype):
        if kernel.startswith("flash"):
            reported[kernel] = reported.get(kernel, 0) + flops

    before = attention.route_counts()["attention_plain"]
    meta.listen(hear)
    try:
        cm = dryrun.trace(lambda: dryrun.replica_call(cfg, batch=1, seq=S))
    finally:
        meta.unlisten(hear)
    assert attention.route_counts()["attention_plain"] == before
    want = launch_counts.forward_backward(cfg, seq=S)
    assert dict(cm.launches) == {k: v for k, v in want.items() if v}
    assert {k: cm.launches[k] for k in ("flash_attention", "flash_attention_dq",
                                        "flash_attention_dkdv")} == {
        "flash_attention": 2 * 2, "flash_attention_dq": 2, "flash_attention_dkdv": 2}
    H = cfg.num_heads
    fwd = fa.cost(1, S, S, H, H, 192, torch.bfloat16, causal=True, hd_v=128)[0]
    dq = fab.pass_cost("dq", 1, S, H, H, 192, causal=True, hd_v=128)[0]
    dkdv = fab.pass_cost("dkdv", 1, S, H, H, 192, causal=True, hd_v=128)[0]
    assert reported == {"flash_attention": 4 * fwd, "flash_attention_dq": 2 * dq,
                        "flash_attention_dkdv": 2 * dkdv}


def _d10():
    return dataclasses.replace(get_config("internlm2_1_8b"), num_layers=10)


def test_dry_run_of_the_d10_cell_launches_the_kernels():
    cfg = _d10()
    cm = dryrun.trace(lambda: dryrun.replica_call(cfg, batch=1, seq=4096))
    want = launch_counts.forward_backward(cfg, seq=4096)
    assert dict(cm.launches) == {k: v for k, v in want.items() if v}
    assert dict(cm.launches) == {"flash_attention": 20, "flash_attention_dq": 10,
                                 "flash_attention_dkdv": 10}


def _block_call(cfg, S):
    """One attention block's forward and backward at 1 x S on meta."""
    def build():
        p = tree_map(lambda a: a[0], Model(cfg).init(0, device="meta")["blocks_0"]["mixer"])
        leaves = tree_leaves(p)
        for a in leaves:
            a.requires_grad_()
        x = torch.empty((1, S, cfg.d_model), dtype=torch.bfloat16, device="meta",
                        requires_grad=True)
        pos = torch.arange(S, dtype=torch.int32, device="meta")[None]

        def run():
            y, _ = attention.attention_block(p, x, cfg, positions=pos)
            return torch.autograd.grad(y, [x] + leaves, torch.empty_like(y))
        return (p, x), run
    return build


def test_dry_run_attention_peak_falls_without_the_score_tensors(monkeypatch):
    cfg = _d10()
    S = 4096
    kernel = dryrun.trace(_block_call(cfg, S))
    monkeypatch.setattr(attention, "flash_route", lambda *a, **k: False)
    plain = dryrun.trace(_block_call(cfg, S))
    assert dict(kernel.launches) == {"flash_attention": 1, "flash_attention_dq": 1,
                                     "flash_attention_dkdv": 1}
    assert dict(plain.launches) == {}
    scores = 4 * cfg.num_heads * S * S       # one fp32 (S, S) score tensor a query head
    assert plain.peak - kernel.peak > 2 * scores


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------
@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")


def _operands(B, S, Hq, Hkv, hd, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").bfloat16()
    return mk(B, S, Hq, hd), mk(B, S, Hkv, hd), mk(B, S, Hkv, hd), mk(B, S, Hq, hd)


def _kernel_backward(q, k, v, do, causal):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    B, S, Hq, _ = q.shape
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device="cuda")
    o = fa.flash_attention(q, k, v, causal=causal, lse=lse)
    dq, delta = fab.flash_attention_dq(q, k, v, o, do, lse, causal=causal)
    dk, dv = fab.flash_attention_dkdv(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    return o, lse, delta, (dq, dk, dv)


def _fp32_backward(q, k, v, do, causal):
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    of = ref.attention_ref(qf, kf, vf, causal=causal)
    return torch.autograd.grad(of, (qf, kf, vf), do.float())


def _rel(got, want):
    return float((got.float() - want).norm() / want.norm())


# dq, dk, dv against the float32 plain backward from the same bf16
# operands, as a relative norm: the kernels round P and dS to bf16 as
# operands of their products (2^-9 relative each) and the outputs to bf16,
# and the forward's output o, which enters D, is bf16 too; a wrong tile,
# mask or scale gives errors of order 1
BWD_REL_TOL = 2e-2
BWD_CASES = [
    # (B, S, Hq, Hkv, hd, causal)
    (1, 4096, 16, 8, 128, True),        # the training cell's shape
    (2, 197, 4, 4, 128, True),          # ragged S, GQA 1
    (2, 197, 4, 2, 64, False),          # ragged S, GQA 2, non-causal
    (1, 300, 16, 2, 64, True),          # GQA 8
    (1, 256, 8, 1, 128, False),         # MQA
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal", BWD_CASES)
def test_backward_kernels_match_the_fp32_plain_backward(sm90, B, S, Hq, Hkv, hd, causal):
    q, k, v, do = _operands(B, S, Hq, Hkv, hd)
    _, _, _, got = _kernel_backward(q, k, v, do, causal)
    want = _fp32_backward(q, k, v, do, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, w) < BWD_REL_TOL, (name, _rel(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_backward_launches_are_bit_equal(sm90, causal):
    q, k, v, do = _operands(1, 1000, 16, 2, 128, seed=1)
    first = _kernel_backward(q, k, v, do, causal)
    again = _kernel_backward(q, k, v, do, causal)
    for a, b in zip(first[3] + (first[2],), again[3] + (again[2],)):
        assert torch.equal(a, b)


# latent attention's widths, q / k 192 over v 128 (Moonlight): the dq pass
# on two warpgroups a block, the dk / dv pass split over two
LATENT_CASES = [
    # (B, S, Hq, Hkv, causal)
    (1, 2048, 16, 16, True),            # Moonlight's heads, a quarter of its context
    (2, 197, 4, 4, True),               # ragged S: a block's second warpgroup holds no row
    (1, 300, 8, 2, False),              # GQA 4, non-causal, ragged
]


def _latent_operands(B, S, Hq, Hkv, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").bfloat16()
    return mk(B, S, Hq, 192), mk(B, S, Hkv, 192), mk(B, S, Hkv, 128), mk(B, S, Hq, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Hkv,causal", LATENT_CASES)
def test_latent_backward_kernels_match_the_fp32_plain_backward(sm90, B, S, Hq, Hkv, causal):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    q, k, v, do = _latent_operands(B, S, Hq, Hkv)
    assert fa.kernel_path(q, k, v) == "wgmma" and fab.kernel_path(q, k, v) == "wgmma"
    o, lse, _, got = _kernel_backward(q, k, v, do, causal)
    assert o.shape == (B, S, Hq, 128)
    assert float((lse - ref.attention_lse_ref(q, k, causal=causal)).abs().max()) < LSE_TOL
    want = _fp32_backward(q, k, v, do, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, w) < BWD_REL_TOL, (name, _rel(g, w))
    again = _kernel_backward(q, k, v, do, causal)
    for a, b in zip(got, again[3]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_ops_attention_gradients_at_latent_widths_go_through_the_kernels(sm90):
    from repro_torch.kernels import flash_attention_bwd as fab

    q, k, v, do = _latent_operands(1, 256, 8, 8, seed=5)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n = (fab.flash_attention_dq.launches, fab.flash_attention_dkdv.launches)
    out = ops.attention(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, do)
    assert (fab.flash_attention_dq.launches, fab.flash_attention_dkdv.launches) == \
        (n[0] + 1, n[1] + 1)
    for g, w in zip(got, _fp32_backward(q, k, v, do, True)):
        assert _rel(g, w) < BWD_REL_TOL


# the kernel's log-sum-exp sums the fp32 exponentials of ex2.approx in
# another order than torch.logsumexp: a few fp32 ulps of a value near 8
LSE_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("hd,causal", [(64, True), (128, True), (128, False), (256, True)])
def test_forward_lse_matches_a_plain_logsumexp(sm90, hd, causal):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, _ = _operands(2, 333, 8, 4, hd, seed=2)

    lse = torch.empty((2, 8, 333), dtype=torch.float32, device="cuda")
    fa.flash_attention(q, k, v, causal=causal, lse=lse)
    want = ref.attention_lse_ref(q, k, causal=causal)
    assert float((lse - want).abs().max()) < LSE_TOL


@pytest.mark.cuda
def test_ops_attention_gradients_go_through_the_kernels(sm90):
    from repro_torch.kernels import flash_attention_bwd as fab

    q, k, v, do = _operands(2, 200, 8, 2, 128, seed=3)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    n = (fab.flash_attention_dq.launches, fab.flash_attention_dkdv.launches)
    out = ops.attention(*leaves, causal=True)
    got = torch.autograd.grad(out, leaves, do)
    assert (fab.flash_attention_dq.launches, fab.flash_attention_dkdv.launches) == \
        (n[0] + 1, n[1] + 1)
    for g, w in zip(got, _fp32_backward(q, k, v, do, True)):
        assert _rel(g, w) < BWD_REL_TOL
    with pytest.raises(ValueError):
        ops.attention(*leaves, causal=True, window=16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", [(torch.float32, 128), (torch.bfloat16, 32)])
def test_forward_refuses_lse_off_the_wgmma_path(sm90, dtype, hd):
    """Only the wgmma kernel writes the log-sum-exp: fp32 and bf16 at hd
    32 run the scalar kernel, whose launch with ``lse`` is refused."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, _ = (t.to(dtype) for t in _operands(1, 64, 4, 2, hd, seed=4))
    assert fa.kernel_path(q, k) == "scalar"
    lse = torch.empty((1, 4, 64), dtype=torch.float32, device="cuda")
    with pytest.raises(RuntimeError):
        fa.flash_attention(q, k, v, causal=True, lse=lse)
