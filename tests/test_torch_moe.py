"""The port's Mixture-of-Experts layers against the JAX package.

Inputs and weights are drawn with numpy and fed to both
``repro.models.ffn`` and ``repro_torch.models.ffn`` at fp32 compute:

* ``_router``: gates, expert ids (exactly), load-balance and router-z;
* ``_moe_einsum``, ``_moe_ragged`` and ``moe_block`` (both branches, the
  shared expert, ``moe_token_chunks``);
* the port's flat dispatch (all B*S*k pairs sorted at once, one grouped
  matmul per weight) against the JAX model's per-example dispatch;
* ``Model.loss`` and every gradient for the dbrx smoke model (4 experts:
  the einsum branch), the dbrx smoke model with 16 experts and top-4
  (the ragged branch, through ``ops.grouped_matmul``), and the kimi
  smoke model (first layer dense, shared expert), from the JAX
  ``Model.init`` weights carried across.

Tolerances: 2e-5 abs and 1e-5 rel on layer outputs and aux losses
(summation order only: the combine adds each token's k terms in the JAX
order, ascending expert, in fp32); the loss to 1e-5 relative and each
gradient leaf to 1e-5 relative Frobenius norm, as
``tests/test_torch_model.py`` holds the dense models.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import ffn as jffn
from repro.models.transformer import Model as JaxModel
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import ffn
from repro_torch.models.transformer import Model
from repro_torch.tree import flatten

TOL = dict(atol=2e-5, rtol=1e-5)
B, S = 2, 16


def _cfgs(arch, **kw):
    kw.setdefault("compute_dtype", "float32")
    return (dataclasses.replace(jax_smoke_config(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _moe_params(cfg, seed=0):
    """One MoE layer's weights as nested numpy dicts (the JAX layout)."""
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff or cfg.d_ff
    n = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
    p = {"router": {"w": n(d, e)}, "w1": n(e, d, f), "w2": n(e, f, d)}
    if cfg.gated_ffn:
        p["w3"] = n(e, d, f)
    if cfg.moe_shared_expert:
        p["shared"] = {"w1": {"w": n(d, f)}, "w2": {"w": n(f, d)}}
        if cfg.gated_ffn:
            p["shared"]["w3"] = {"w": n(d, f)}
    return p


def _both(p):
    return jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")


def _x(cfg, shape, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape + (cfg.d_model,))
    return x.astype(np.float32)


@pytest.mark.parametrize("experts,top_k", [(4, 2), (16, 4)])
def test_router_matches_jax(experts, top_k):
    jcfg, cfg = _cfgs("dbrx_132b", moe_num_experts=experts, moe_top_k=top_k)
    jp, tp = _both(_moe_params(cfg))
    x = _x(cfg, (B * S,))
    jg, ji, jaux = jffn._router(jp, jnp.asarray(x), jcfg)
    tg, ti, taux = ffn._router(tp, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    for key in ("load_balance", "router_z"):
        assert taux[key].shape == ()
        np.testing.assert_allclose(taux[key].numpy(), np.asarray(jaux[key]), **TOL)


@pytest.mark.parametrize("path", ["einsum", "ragged"])
@pytest.mark.parametrize("experts,top_k", [(4, 2), (16, 4)])
def test_moe_paths_match_jax(path, experts, top_k):
    jcfg, cfg = _cfgs("dbrx_132b", moe_num_experts=experts, moe_top_k=top_k)
    jp, tp = _both(_moe_params(cfg))
    x = _x(cfg, (B * S,))
    jg, ji, _ = jffn._router(jp, jnp.asarray(x), jcfg)
    fn_j = {"einsum": jffn._moe_einsum, "ragged": jffn._moe_ragged}[path]
    fn_t = {"einsum": ffn._moe_einsum, "ragged": ffn._moe_ragged}[path]
    want = fn_j(jp, jnp.asarray(x), jg, ji, jcfg)
    got = fn_t(tp, torch.from_numpy(x), torch.from_numpy(np.array(jg)),
               torch.from_numpy(np.array(ji)).long(), cfg)
    assert got.dtype == torch.float32 and got.shape == (B * S, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch,experts,top_k,chunks", [
    ("dbrx_132b", 4, 2, 1),
    ("dbrx_132b", 16, 4, 1),
    ("dbrx_132b", 16, 4, 4),        # moe_token_chunks: a memory knob only
    ("kimi_k2_1t_a32b", 4, 2, 1),   # shared expert
    ("kimi_k2_1t_a32b", 12, 3, 2),  # shared expert on the ragged branch
])
@pytest.mark.parametrize("impl", ["einsum", "ragged"])
def test_moe_block_matches_jax(arch, experts, top_k, chunks, impl):
    kw = dict(moe_num_experts=experts, moe_top_k=top_k, moe_token_chunks=chunks)
    jcfg, cfg = _cfgs(arch, **kw)
    jp, tp = _both(_moe_params(cfg, seed=experts))
    x = _x(cfg, (B, S), seed=chunks)
    jy, jaux = jffn.moe_block(jp, jnp.asarray(x), jcfg, impl=impl)
    ty, taux = ffn.moe_block(tp, torch.from_numpy(x), cfg, impl=impl)
    assert ty.shape == (B, S, cfg.d_model)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for key in ("load_balance", "router_z"):
        assert taux[key].shape == ()
        np.testing.assert_allclose(taux[key].numpy(), np.asarray(jaux[key]), **TOL)


def test_flat_dispatch_matches_per_example_dispatch():
    """One sort over the batch's B*S*k pairs gives each token what the
    JAX model's per-example dispatch gives it."""
    _, cfg = _cfgs("dbrx_132b", moe_num_experts=16, moe_top_k=4)
    _, tp = _both(_moe_params(cfg))
    x = torch.from_numpy(_x(cfg, (4, S), seed=9))
    flat, aux = ffn.moe_block(tp, x, cfg, impl="ragged")
    per = []
    lbs, zs = [], []
    for b in range(x.shape[0]):
        g, i, a = ffn._router(tp, x[b], cfg)
        per.append(ffn._moe_ragged(tp, x[b], g, i, cfg))
        lbs.append(a["load_balance"])
        zs.append(a["router_z"])
    torch.testing.assert_close(flat, torch.stack(per), **TOL)
    torch.testing.assert_close(aux["load_balance"], torch.stack(lbs).mean(), **TOL)
    torch.testing.assert_close(aux["router_z"], torch.stack(zs).mean(), **TOL)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("arch,kw,branch", [
    ("dbrx_132b", {}, "einsum"),
    ("dbrx_132b", dict(moe_num_experts=16, moe_top_k=4), "ragged"),
    ("kimi_k2_1t_a32b", {}, "einsum"),
])
def test_loss_and_grads_match_jax(arch, kw, branch):
    jcfg, cfg = _cfgs(arch, **kw)
    assert (cfg.moe_num_experts > 8) == (branch == "ragged")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.key(0))
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}
    )
    jgrads = flatten(jax.tree.map(np.asarray, jgrads))

    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    leaves = flatten(params)
    for leaf in leaves.values():
        leaf.requires_grad_()
    loss, metrics = Model(cfg).loss(params, {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    tgrads = {k: g.numpy() for k, g in zip(leaves, grads)}
    loss = loss.detach()

    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for key in ("load_balance", "router_z"):
        got = float(metrics[key].detach())
        assert got > 0
        np.testing.assert_allclose(got, float(jmetrics[key]), rtol=1e-5)
    assert tgrads.keys() == jgrads.keys()
    assert any(".ffn.w1" in k and jgrads[k].ndim == 4 for k in jgrads)   # expert leaves
    for path, want in jgrads.items():
        assert tgrads[path].shape == want.shape, path
        assert _rel(tgrads[path], np.asarray(want, np.float32)) <= 1e-5, path
