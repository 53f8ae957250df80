"""Moonlight-16B-A3B's blocks in the port against the plain reference.

``perfbench/reference/deepseek_v3.py`` (plain float32 PyTorch; the
benchmark's reference of the Moonlight cell) is held to the port at its
smoke sizes, compute in fp32:

* ``attention.mla_block`` against the reference's latent attention: the
  output and every gradient;
* ``Model.loss`` and every gradient leaf of the smoke model (4 experts,
  the einsum branch), of a 16-expert router with 8 experts held (the
  ragged branch, both shares), and with a large RMSNorm epsilon (every
  norm takes ``cfg.rms_eps``);
* ``sdpa`` and ``sdpa_chunked`` with v narrower than q and k;
* the sigmoid router's gates and sequence-wise balance by hand;
* the held share: the ragged branch at 8 held experts, and the shares of
  a 16-expert layer added up (the shared experts counted once) against
  the uncut reference layer;
* the block spans of a traced train step, and the parameter counts.

Tolerances: the loss to 1e-5 relative, each gradient leaf and layer
output to 1e-4 relative Frobenius norm (summation order only: the port
sorts pairs by expert and adds in fp32, the reference gathers per
expert), as ``perfbench/tests/test_perfbench_reference.py`` holds the
dense reference.
"""
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import weights  # noqa: E402
from perfbench.reference import deepseek_v3 as ref  # noqa: E402
from repro_torch.configs.registry import get_config, get_smoke_config  # noqa: E402
from repro_torch.dist import decen_train as dt  # noqa: E402
from repro_torch.models import attention, ffn  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

REL = 1e-4


def _cfg(**kw):
    kw.setdefault("compute_dtype", "float32")
    return dataclasses.replace(get_smoke_config("moonlight_16b_a3b"), **kw)


def _ref_config(cfg) -> dict:
    """The reference's configuration dict of a port config."""
    c = dataclasses.asdict(cfg)
    c.update(vocab_rows=cfg.padded_vocab, moe_router_experts=cfg.router_experts)
    return c


def _nest(flat):
    out = {}
    for path, leaf in flat.items():
        node = out
        *keys, last = path.split(".")
        for key in keys:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def _rel(a, b) -> float:
    a, b = a.detach(), b.detach()
    return float((a - b).norm()) / (float(b.norm()) + 1e-12)


SHARE16 = dict(moe_num_experts=8, moe_router_experts=16, moe_top_k=4)


@pytest.mark.parametrize("case,kw,batch", [
    ("smoke: 4 experts, einsum branch", {}, 1),
    ("8 of 16 experts held: ragged branch", SHARE16, 2),
    ("the other 8 of 16", dict(SHARE16, moe_first_expert=8), 2),
    ("every norm's epsilon from the config", dict(SHARE16, rms_eps=0.5), 2),
])
def test_loss_and_every_gradient_match_the_reference(case, kw, batch):
    cfg = _cfg(**kw)
    c = _ref_config(cfg)
    model = Model(cfg)
    flat = weights.make(ref.param_specs(c), 2**31 + 11, "cpu")
    assert {k: tuple(v.shape) for k, v in flat.items()} == {
        k: tuple(s) for k, (s, _) in flatten(model.param_shapes()).items()}
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (batch, 32), generator=gen)
    labels = torch.randint(0, cfg.vocab_size, (batch, 32), generator=gen)

    ours = {k: v.clone().requires_grad_() for k, v in flat.items()}
    loss_ref = ref.loss(ours, tokens, labels, c)
    g_ref = torch.autograd.grad(loss_ref, list(ours.values()))
    theirs = {k: v.clone().requires_grad_() for k, v in flat.items()}
    loss_port, metrics = model.loss(_nest(theirs), {"tokens": tokens, "labels": labels})
    g_port = torch.autograd.grad(loss_port, list(theirs.values()))

    assert set(metrics) == {"ce", "seq_balance"}
    assert float(loss_port.detach()) == pytest.approx(float(loss_ref.detach()), rel=1e-5), case
    for k, a, b in zip(ours, g_ref, g_port):
        assert _rel(b, a) < REL, (case, k)


def _mla_weights(cfg, seed=0):
    c = _ref_config(cfg)
    flat = weights.make(ref.param_specs(c), seed, "cpu")
    return {k[len("blocks_0.mixer."):]: v[0] for k, v in flat.items()
            if k.startswith("blocks_0.mixer.")}


def test_mla_block_output_and_gradients_match_the_reference():
    cfg = _cfg()
    c = _ref_config(cfg)
    w = {k: v.requires_grad_() for k, v in _mla_weights(cfg).items()}
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(5))
    x_port, x_ref = x.clone().requires_grad_(), x.clone().requires_grad_()
    positions = torch.arange(24)[None].expand(2, 24)
    y_port, cache = attention.mla_block(_nest({k: v for k, v in w.items()}), x_port, cfg,
                                        positions=positions)
    y_ref = ref._mla(x_ref, {f"mixer.{k}": v for k, v in w.items()}, c, torch.matmul)
    assert cache is None and y_port.shape == (2, 24, cfg.d_model)
    assert _rel(y_port, y_ref) < REL
    leaves = list(w.values())
    g_port = torch.autograd.grad(y_port.square().sum(), [x_port] + leaves)
    g_ref = torch.autograd.grad(y_ref.square().sum(), [x_ref] + leaves)
    for name, a, b in zip(["x"] + list(w), g_port, g_ref):
        assert _rel(a, b) < REL, name


def test_mla_block_refuses_a_cache():
    cfg = _cfg()
    x = torch.zeros(1, 4, cfg.d_model)
    with pytest.raises(NotImplementedError, match="latent"):
        attention.mla_block(_nest(_mla_weights(cfg)), x, cfg,
                            positions=torch.arange(4)[None], cache={})


@pytest.mark.parametrize("fn", ["sdpa", "sdpa_chunked"])
def test_sdpa_takes_v_narrower_than_q_and_k(fn):
    gen = torch.Generator().manual_seed(7)
    B, S, H, hd, hv = 2, 32, 4, 24, 8
    q, k = (torch.randn(B, S, H, hd, generator=gen) for _ in range(2))
    v = torch.randn(B, S, H, hv, generator=gen)
    pos = torch.arange(S)[None].expand(B, S)
    kw = dict(q_positions=pos, k_positions=pos, causal=True)
    if fn == "sdpa_chunked":
        kw["block_q"] = 8
    out = getattr(attention, fn)(q, k, v, **kw)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    scores = scores.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -math.inf)
    want = torch.einsum("bhqk,bkhd->bqhd", scores.softmax(-1), v)
    assert out.shape == (B, S, H, hv)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)


def test_sigmoid_router_gates_and_balance_by_hand():
    cfg = _cfg(moe_num_experts=16, moe_router_experts=16, moe_top_k=4, moe_route_scale=2.446)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    w = (rng.standard_normal((cfg.d_model, 16)) / np.sqrt(cfg.d_model)).astype(np.float32)
    gates, idx, aux = ffn._router({"router": {"w": torch.from_numpy(w)}},
                                  torch.from_numpy(x), cfg)
    scores = 1.0 / (1.0 + np.exp(-(x.astype(np.float64) @ w)))
    top = np.argsort(-scores, axis=-1)[..., :4]
    np.testing.assert_array_equal(np.sort(idx.numpy(), -1), np.sort(top, -1))
    picked = np.take_along_axis(scores, idx.numpy(), -1)
    np.testing.assert_allclose(gates.numpy(), picked / picked.sum(-1, keepdims=True) * 2.446,
                               rtol=1e-5)
    np.testing.assert_allclose(gates.numpy().sum(-1), 2.446, rtol=1e-5)
    for b in range(2):
        counts = np.bincount(top[b].ravel(), minlength=16)
        share = (scores[b] / scores[b].sum(-1, keepdims=True)).mean(0)
        want = np.sum(counts * 16 / (4 * 10) * share)
        assert float(aux["seq_balance"][b]) == pytest.approx(want, rel=1e-5)


def test_a_held_share_of_eight_takes_the_ragged_branch(monkeypatch):
    cfg = _cfg(moe_num_experts=8, moe_router_experts=64, moe_top_k=6)
    model = Model(cfg)
    seen = []
    real = ffn._moe_ragged

    def spy(p, x2d, gates, idx, cfg_, experts=None):
        seen.append((p["w1"].shape[0], int(idx.max()) >= 8))
        return real(p, x2d, gates, idx, cfg_, experts)

    monkeypatch.setattr(ffn, "_moe_ragged", spy)
    monkeypatch.setattr(ffn, "_moe_einsum", lambda *a, **k: pytest.fail("einsum branch"))
    params = model.init(0, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=torch.Generator().manual_seed(1))
    loss, _ = model.loss(params, {"tokens": tokens, "labels": tokens})
    assert torch.isfinite(loss)
    # one MoE layer, 8 experts held, pairs routed past them (to experts 8..63)
    assert seen == [(8, True)]


@pytest.mark.parametrize("held", [8, 4])
def test_the_shares_add_up_to_the_uncut_reference_layer(held):
    """Every share of a 16-expert layer, the shared experts counted once,
    gives the uncut reference layer."""
    whole = _cfg(moe_num_experts=16, moe_router_experts=16, moe_top_k=4)
    c = _ref_config(whole)
    flat = weights.make(ref.param_specs(c), 2**31 + 17, "cpu")
    w = {k[len("blocks_1."):]: v[0] for k, v in flat.items() if k.startswith("blocks_1.")}
    h = torch.randn(2, 24, whole.d_model, generator=torch.Generator().manual_seed(9))
    y_ref, _ = ref._moe(h, w, c, torch.matmul)
    p = _nest({k[len("ffn."):]: v for k, v in w.items() if k.startswith("ffn.")})
    shared = ffn.ffn_block(p["shared"], h, whole)
    total = torch.zeros_like(h)
    for first in range(0, 16, held):
        cfg = dataclasses.replace(whole, moe_num_experts=held, moe_router_experts=16,
                                  moe_first_expert=first)
        part = dict(p, **{n: p[n][first:first + held] for n in ("w1", "w3", "w2")})
        y, _ = ffn.moe_block(part, h, cfg, impl="ragged")
        total = total + y - shared
    assert _rel(total + shared, y_ref) < REL
    y_whole, _ = ffn.moe_block(p, h, whole, impl="ragged")
    assert _rel(y_whole, y_ref) < REL


def test_block_spans_and_counters_in_a_traced_step():
    from repro_torch.core import named_graph, plan_matcha
    from repro_torch.optim.optimizers import sgd
    from repro_torch.telemetry.timers import StepTimer
    from repro_torch.telemetry.trace import TraceRecorder

    cfg = _cfg(**SHARE16)
    model = Model(cfg)
    plan = plan_matcha(named_graph("ring", 4, seed=3), 0.5, seed=0)
    bits = torch.ones(len(plan.permutations))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 1, 16),
                                     generator=torch.Generator().manual_seed(2))}
    batch["labels"] = batch["tokens"]
    runs = {}
    for name, timer in (("traced", StepTimer(TraceRecorder(capacity=4096))),
                        ("own", None), ("off", StepTimer(None))):
        opt = sgd(0.05, momentum=0.9)
        step = dt.make_train_step(model, opt, plan, gossip_mode="masked", timer=timer)
        params = dt.init_stacked_params(model, 4, 0, device="cpu")
        state = dt.init_stacked_opt_state(opt, model, 4, device="cpu")
        params, state, losses, _ = step(params, state, batch, bits, step=0)
        runs[name] = (step, losses, params)
    step = runs["traced"][0]
    names = [s.name for s in step.last_phases.spans]
    # per node: forward's 2 mla + 1 moe, the backward's recompute (2 mla, 1 moe)
    # and their backward spans
    for span, n in (("mla", 16), ("moe", 8), ("mla/backward", 8), ("moe/backward", 4)):
        assert names.count(span) == n, (span, names)
    by_id = {s.id: s for s in step.last_phases.spans}
    for s in step.last_phases.spans:
        if s.name.endswith("/backward"):
            assert by_id[s.parent].name == "backward"
        elif s.name in ("mla", "moe"):
            # remat recomputes a layer before its blocks' backward spans open
            assert by_id[s.parent].name in ("forward", "backward"), s.name
    counts = step.last_phases.counts()
    assert counts["moe_pairs_routed"] == 4 * 2 * 16 * 4          # nodes x passes x tokens x k
    assert 0 < counts["moe_pairs_held"] < counts["moe_pairs_routed"]
    assert runs["own"][0].last_phases.counts().get("moe_pairs_held") is None
    assert runs["off"][0].last_phases is None
    for other in ("own", "off"):
        assert torch.equal(runs[other][1], runs["traced"][1])
        for a, b in zip(flatten(runs[other][2]).values(), flatten(runs["traced"][2]).values()):
            assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [{}, dict(moe_num_experts=8, num_layers=6, vocab_size=20480)])
def test_parameter_counts_of_the_config_and_its_share(kw):
    cfg = dataclasses.replace(get_config("moonlight_16b_a3b"), **kw)
    shapes = flatten(Model(cfg).param_shapes())
    norms = sum(math.prod(s) for k, (s, _) in shapes.items() if "norm" in k)
    assert cfg.param_counts()["total"] == sum(math.prod(s) for s, _ in shapes.values()) - norms
    if not kw:
        # the published model: 16B in all (Moonlight-16B-A3B)
        assert cfg.param_counts()["total"] == pytest.approx(15.96e9, rel=1e-3)
    assert cfg.rms_eps == 1e-5 and cfg.router_experts == 64


def test_every_other_config_keeps_the_defaults():
    from repro_torch.configs.registry import ARCH_IDS, PORT_ARCH_IDS

    assert "moonlight_16b_a3b" in PORT_ARCH_IDS and "moonlight_16b_a3b" not in ARCH_IDS
    for arch in ARCH_IDS:
        for cfg in (get_config(arch), get_smoke_config(arch)):
            assert cfg.rms_eps == 1e-6 and cfg.moe_router == "softmax"
            assert not cfg.mla_kv_rank and not cfg.holds_share and not cfg.moe_router_experts
    with pytest.raises(ValueError, match="past the router"):
        _cfg(moe_num_experts=8, moe_router_experts=16, moe_first_expert=12)
