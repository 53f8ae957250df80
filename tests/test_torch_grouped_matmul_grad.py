"""The grouped matmul's backward in the port against the JAX package.

* ``grouped_matmul_dx_ref`` and ``grouped_matmul_dw_ref`` (the plain
  versions the card's dx and dw kernels are held to) against ``jax.vjp``
  of ``repro.kernels.ref.grouped_matmul_ref`` (``lax.ragged_dot``) on the
  same numpy inputs, over the edge sizes of the card tests: ragged tails,
  empty groups, ``sum(group_sizes) < M``, no rows at all, K and N not
  multiples of 8, 16 groups. As in JAX, bf16 in gives bf16 out, rows of
  dx past the groups are exactly 0 and an empty group's dw is exactly 0;
* ``GroupedMatmul``, the autograd Function ``ops.grouped_matmul`` takes
  on the card, given CPU tensors (its backward then runs the plain
  versions): against autograd through ``grouped_matmul_ref``, with only
  the gradients ``ctx.needs_input_grad`` asks for computed, and for a
  group that overruns M;
* a 16-expert tiny MoE block (the ragged branch) and the model's loss and
  every gradient with the three expert products routed through that
  Function, against ``jax.vjp`` of the JAX block and ``jax.value_and_grad``
  of the JAX model.

Tolerances: the plain versions 1e-5 relative at fp32 (summation order
only; the absolute part scaled by the largest magnitude, as a dw
element sums hundreds of products that may cancel) and 2e-2 at bf16
(both round an fp32 sum to bf16 once, one bf16 step apart at most); the Function against autograd of the plain forward
bit-equal at fp32, 2e-2 at bf16 (autograd rounds each group's fp32
product to bf16 before it is summed into dx, the Function once after);
the model at fp32 as ``tests/test_torch_moe.py``'s
``test_loss_and_grads_match_jax`` (the loss to 1e-5 relative, each
gradient leaf to 1e-5 relative norm; the block 2e-5 abs, 1e-5 rel), at
bf16 as ``tests/test_torch_model.py``'s bf16 row (1e-3 and 0.1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.kernels.ref import grouped_matmul_ref as jax_gmm_ref
from repro.models import ffn as jffn
from repro.models.transformer import Model as JaxModel
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import grouped_matmul as gm
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (
    grouped_matmul_dw_ref,
    grouped_matmul_dx_ref,
    grouped_matmul_ref,
)
from repro_torch.models import ffn
from repro_torch.models.transformer import Model
from repro_torch.tree import flatten

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _cut(M, G, seed):
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(M, G - 1, replace=False))
    return np.diff(np.concatenate([[0], cuts, [M]])).tolist()


# the edge sizes of tests/test_torch_kernels_cuda.py's grouped-matmul sweep
SWEEP = [
    (96, 32, 48, _cut(96, 4, 100)),
    (256, 64, 128, _cut(256, 8, 264)),
    (130, 16, 40, _cut(130, 3, 133)),        # ragged tails
    (64, 128, 256, _cut(64, 16, 80)),        # 16 groups, some empty
    (64, 16, 24, [0, 40, 0, 24]),            # empty groups
    (37, 48, 72, [5, 0, 20, 12]),            # M below one tile
    (165, 48, 72, [64, 0, 0, 101]),
    (48, 24, 40, [10, 0, 7]),                # sum(group_sizes) < M
    (48, 24, 40, [0, 0, 0]),                 # no rows at all
    (32, 256, 520, [2, 3, 0, 1, 4, 2, 2, 0, 3, 1, 2, 4, 3, 0, 2, 3]),  # 16 groups
    (1000, 64, 136, [300, 0, 129, 1, 570]),
    (300, 20, 36, [100, 50, 150]),           # K, N not multiples of 8
]


def _inputs(M, K, N, G, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((G, K, N)) * 0.2).astype(np.float32)
    dy = rng.standard_normal((M, N)).astype(np.float32)
    return x, w, dy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,sizes", SWEEP)
def test_plain_backward_matches_jax_vjp_of_ragged_dot(M, K, N, sizes, dtype):
    x, w, dy = _inputs(M, K, N, len(sizes), seed=M + K + N)
    js = jnp.asarray(sizes, jnp.int32)
    jx, jw, jdy = (jnp.asarray(a).astype(dtype) for a in (x, w, dy))
    _, vjp = jax.vjp(lambda a, b: jax_gmm_ref(a, b, js), jx, jw)
    jdx, jdw = vjp(jdy)

    tdt = getattr(torch, dtype)
    tx, tw, tdy = (torch.from_numpy(a).to(tdt) for a in (x, w, dy))
    ts = torch.tensor(sizes, dtype=torch.int32)
    dx = grouped_matmul_dx_ref(tdy, tw, ts)
    dw = grouped_matmul_dw_ref(tx, tdy, ts)
    assert dx.dtype == tdt and dx.shape == (M, K)
    assert dw.dtype == tdt and dw.shape == (len(sizes), K, N)
    assert str(jdx.dtype) == dtype and str(jdw.dtype) == dtype
    for got, want in ((dx, jdx), (dw, jdw)):
        want = np.asarray(want, np.float32)
        tol = dict(TOL[dtype])
        # fp32: relative to the largest magnitude, since a dw element sums up
        # to 570 products and may cancel to far below its terms
        tol["atol"] *= max(float(np.abs(want).max(initial=0.0)), 1.0)
        np.testing.assert_allclose(got.float().numpy(), want, **tol)
    tail = sum(sizes)
    assert not dx[tail:].any() and not np.asarray(jdx, np.float32)[tail:].any()
    for g, size in enumerate(sizes):
        if size == 0:
            assert not dw[g].any() and not np.asarray(jdw, np.float32)[g].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("needs", ["x", "w", "both"])
@pytest.mark.parametrize("M,K,N,sizes", [
    (48, 24, 40, [10, 0, 7]),
    (64, 128, 256, _cut(64, 16, 80)),
    (40, 16, 24, [30, 0, 25]),               # the last group overruns M: clipped
])
def test_function_on_cpu_matches_autograd_of_plain_version(M, K, N, sizes, needs, dtype,
                                                           monkeypatch):
    calls = {"dx": 0, "dw": 0}

    def counted(name, fn):
        def run(*args):
            calls[name] += 1
            return fn(*args)
        return run

    monkeypatch.setattr(gm, "grouped_matmul_dx_ref", counted("dx", grouped_matmul_dx_ref))
    monkeypatch.setattr(gm, "grouped_matmul_dw_ref", counted("dw", grouped_matmul_dw_ref))
    x, w, dy = _inputs(M, K, N, len(sizes), seed=M)
    tdt = getattr(torch, dtype)
    ts = torch.tensor(sizes, dtype=torch.int32)
    grads = {}
    for route in ("plain", "function"):
        tx = torch.from_numpy(x).to(tdt).requires_grad_(needs in ("x", "both"))
        tw = torch.from_numpy(w).to(tdt).requires_grad_(needs in ("w", "both"))
        fn = grouped_matmul_ref if route == "plain" else gm.GroupedMatmul.apply
        out = fn(tx, tw, ts)
        assert out.dtype == tdt and out.shape == (M, N)
        leaves = [t for t in (tx, tw) if t.requires_grad]
        grads[route] = (out.detach(), torch.autograd.grad(
            out, leaves, grad_outputs=torch.from_numpy(dy).to(tdt)))
    assert calls == {"dx": int(needs != "w"), "dw": int(needs != "x")}
    assert torch.equal(grads["function"][0], grads["plain"][0])
    for got, want in zip(grads["function"][1], grads["plain"][1]):
        assert got.dtype == tdt
        if dtype == "float32":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_function_backward_clips_an_overrunning_group_as_the_forward():
    x, w, dy = _inputs(40, 16, 24, 3, seed=5)
    ts = torch.tensor([30, 0, 25], dtype=torch.int32)      # 55 rows over M = 40
    dx = grouped_matmul_dx_ref(torch.from_numpy(dy), torch.from_numpy(w), ts)
    dw = grouped_matmul_dw_ref(torch.from_numpy(x), torch.from_numpy(dy), ts)
    np.testing.assert_allclose(dx[30:].numpy(), dy[30:] @ w[2].T, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw[2].numpy(), x[30:].T @ dy[30:], rtol=1e-5, atol=1e-5)
    assert not dw[1].any()


# ---------------------------------------------------------------------------
# The MoE block and the model with the expert products through the Function
# ---------------------------------------------------------------------------
@pytest.fixture
def through_function(monkeypatch):
    """``ops.grouped_matmul`` as the card calls it, ``GroupedMatmul``, on
    CPU tensors: its backward takes the plain dx and dw. Counts calls."""
    calls = []

    def run(x, w, group_sizes, *, impl="auto"):
        calls.append(x.shape)
        return gm.GroupedMatmul.apply(x.contiguous(), w.contiguous(),
                                      group_sizes.to(torch.int32).contiguous())

    monkeypatch.setattr(ops, "grouped_matmul", run)
    return calls


def _cfgs(**kw):
    kw = dict(dict(moe_num_experts=16, moe_top_k=4, compute_dtype="float32"), **kw)
    return (dataclasses.replace(jax_smoke_config("dbrx_132b"), **kw),
            dataclasses.replace(get_smoke_config("dbrx_132b"), **kw))


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_moe_block_grads_through_function_match_jax(through_function):
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(0)
    d, e, f = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff or cfg.d_ff
    n = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
    p = {"router": {"w": n(d, e)}, "w1": n(e, d, f), "w3": n(e, d, f), "w2": n(e, f, d)}
    x = rng.standard_normal((2, 16, d)).astype(np.float32)
    ct = rng.standard_normal((2, 16, d)).astype(np.float32)

    def jblock(jp, jx):
        return jffn.moe_block(jp, jx, jcfg, impl="ragged")[0]

    jy, vjp = jax.vjp(jblock, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(ct))

    tp = params_from_numpy(p, "cpu")
    leaves = flatten(tp)
    for leaf in leaves.values():
        leaf.requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    ty, _ = ffn.moe_block(tp, tx, cfg, impl="ragged")
    grads = torch.autograd.grad(ty, [tx, *leaves.values()], grad_outputs=torch.from_numpy(ct))
    assert len(through_function) == 3
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), atol=2e-5, rtol=1e-5)
    jflat = flatten(jax.tree.map(np.asarray, jgp))
    for (path, _), g in zip(leaves.items(), grads[1:]):
        assert _rel(g.numpy(), jflat[path]) <= 1e-5, path


@pytest.mark.parametrize("compute_dtype,loss_tol,grad_tol", [
    ("float32", 1e-5, 1e-5),
    ("bfloat16", 1e-3, 1e-1),
])
def test_model_loss_and_grads_through_function_match_jax(compute_dtype, loss_tol, grad_tol,
                                                         through_function):
    jcfg, cfg = _cfgs(compute_dtype=compute_dtype)
    assert cfg.moe_num_experts > 8                     # the ragged branch
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.key(0))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = flatten(jax.tree.map(lambda a: np.asarray(a, np.float32), jgrads))

    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    leaves = flatten(params)
    for leaf in leaves.values():
        leaf.requires_grad_()
    loss, _ = Model(cfg).loss(params, {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    moe_layers = sum(map(cfg.layer_is_moe, range(cfg.num_layers)))
    # 3 expert products per MoE layer, run again in the backward under remat
    assert len(through_function) == 3 * moe_layers * (1 + cfg.remat) > 0
    assert abs(float(loss.detach()) - float(jloss)) <= loss_tol * abs(float(jloss))
    assert set(leaves) == set(jgrads)
    for path, g in zip(leaves, grads):
        assert g.shape == jgrads[path].shape, path
        assert _rel(g.float().numpy(), jgrads[path]) <= grad_tol, path
