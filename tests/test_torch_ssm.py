"""The port's Mamba2 (SSD) module and ``ops.ssd`` against the JAX package.

Inputs are drawn with numpy and fed to both. Held to JAX:
``ssd_chunked`` (with an initial state and the final state),
``ssd_sequential``, ``causal_conv1d`` (with and without a carried
state), ``mamba_block`` (prefill and one decode step, with state), the
port's ``ops.ssd`` (its plain version on the CPU) against the JAX Pallas
kernel in interpret mode and ``ssd_chunked``, including the chunk
halving of ``test_ssd_wrapper_tail_parity``; then the mamba2 smoke
model's loss and every gradient.

Tolerances: fp32 1e-5 abs and rel for the SSD cores (summation order;
the sequential and chunked forms differ by ~1e-6), 1e-4 abs / 1e-3 rel
where the JAX kernel is involved (as in ``tests/test_kernels.py``); the
model loss 1e-5 relative and each gradient 1e-4 in relative Frobenius
norm (fp32 compute; the cumulative sums and exponentials of the scan
reorder sums).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.kernels import ops as jops
from repro.models import ssm as jssm
from repro.models.transformer import Model as JaxModel
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels import ops
from repro_torch.models import ssm
from repro_torch.models.transformer import Model
from repro_torch.tree import flatten

CORE = dict(atol=1e-5, rtol=1e-5)
KERNEL = dict(atol=1e-4, rtol=1e-3)


def _ssd_inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.uniform(size=(H,)))).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    h0 = (rng.standard_normal((B, H, N, P)) * 0.2).astype(np.float32)
    return (x, dt, A, Bm, Cm), h0


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **tol)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 64, 2, 16, 8, 16), (2, 96, 3, 16, 8, 32), (2, 64, 8, 32, 32, 64),
])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_and_sequential_match_jax(B, S, H, P, N, chunk, with_h0):
    arrs, h0 = _ssd_inputs(B, S, H, P, N, seed=S + H)
    jh0 = jnp.asarray(h0) if with_h0 else None
    th0 = torch.from_numpy(h0) if with_h0 else None
    yj, hj = jssm.ssd_chunked(*_j(arrs), chunk=chunk, h0=jh0, return_final_state=True)
    yt, ht = ssm.ssd_chunked(*_t(arrs), chunk=chunk, h0=th0, return_final_state=True)
    _close(yt, yj, CORE)
    _close(ht, hj, CORE)
    ys, hs = ssm.ssd_sequential(*_t(arrs), h0=th0, return_final_state=True)
    yjs, hjs = jssm.ssd_sequential(*_j(arrs), h0=jh0, return_final_state=True)
    _close(ys, yjs, CORE)
    _close(hs, hjs, CORE)
    _close(ys, yj, CORE)
    with pytest.raises(ValueError, match="divisible"):
        ssm.ssd_chunked(*_t(arrs), chunk=S + 1)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_jax(with_state):
    rng = np.random.default_rng(0)
    u = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state else None
    oj, sj = jssm.causal_conv1d(jnp.asarray(u), jnp.asarray(w), jnp.asarray(b),
                                None if st is None else jnp.asarray(st))
    ot, s_t = ssm.causal_conv1d(torch.from_numpy(u), torch.from_numpy(w),
                                torch.from_numpy(b),
                                None if st is None else torch.from_numpy(st))
    _close(ot, oj, CORE)
    _close(s_t, sj, dict(atol=0, rtol=0))


@pytest.mark.parametrize("S", [100, 52])
def test_ssd_wrapper_tail_parity(S):
    """S does not divide the chunk: both wrappers halve it; the port's
    plain version equals the interpreted JAX kernel and ``ssd_chunked``."""
    arrs, _ = _ssd_inputs(2, S, 2, 16, 8, seed=S)
    yk, hk = jops.ssd(*_j(arrs), chunk=64, impl="interpret")
    yt, ht = ops.ssd(*_t(arrs), chunk=64)
    _close(yt, yk, KERNEL)
    _close(ht, hk, KERNEL)
    c = 64
    while S % c:
        c //= 2
    yc, hc = jssm.ssd_chunked(*_j(arrs), chunk=c, return_final_state=True)
    _close(yt, yc, CORE)
    _close(ht, hc, CORE)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 128, 128),
])
def test_ops_ssd_matches_jax_kernel_sweep(B, S, H, P, N, chunk):
    arrs, _ = _ssd_inputs(B, S, H, P, N, seed=B * S)
    yk, hk = jops.ssd(*_j(arrs), chunk=chunk, impl="interpret")
    yt, ht = ops.ssd(*_t(arrs), chunk=chunk)
    _close(yt, yk, KERNEL)
    _close(ht, hk, KERNEL)


def _jax_mamba_layer(cfg):
    params = JaxModel(cfg).init(jax.random.key(0))
    return jax.tree.map(lambda a: np.asarray(a[0]), params["blocks_0"]["mixer"])


def test_mamba_block_prefill_and_decode_match_jax():
    jcfg = dataclasses.replace(jax_smoke_config("mamba2_370m"), compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke_config("mamba2_370m"), compute_dtype="float32")
    p_np = _jax_mamba_layer(jcfg)
    p = params_from_numpy(p_np, "cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    # training form: no state
    oj, _ = jssm.mamba_block(p_np, jnp.asarray(x), jcfg)
    ot, _ = ssm.mamba_block(p, torch.from_numpy(x), cfg)
    _close(ot, oj, CORE)
    # serving: prefill from the zero state (the kernel's path), then a step
    sj = jssm.init_mamba_state(2, jcfg, jnp.float32)
    st = ssm.init_mamba_state(2, cfg, torch.float32, "cpu")
    oj, sj = jssm.mamba_block(p_np, jnp.asarray(x), jcfg, state=sj, return_state=True)
    ot, st = ssm.mamba_block(p, torch.from_numpy(x), cfg, state=st, return_state=True,
                             from_zero_state=True)
    _close(ot, oj, CORE)
    for key in ("ssm", "conv"):
        assert st[key].dtype == torch.float32
        _close(st[key], sj[key], CORE)
    oj, sj = jssm.mamba_block(p_np, jnp.asarray(x1), jcfg, state=sj, return_state=True)
    ot, st = ssm.mamba_block(p, torch.from_numpy(x1), cfg, state=st, return_state=True)
    _close(ot, oj, CORE)
    for key in ("ssm", "conv"):
        _close(st[key], sj[key], CORE)


def test_mamba2_params_load_unchanged():
    jcfg = jax_smoke_config("mamba2_370m")
    cfg = get_smoke_config("mamba2_370m")
    jparams = flatten(jax.tree.map(np.asarray, JaxModel(jcfg).init(jax.random.key(0))))
    model = Model(cfg)
    shapes = {k: tuple(s) for k, (s, _) in flatten(model.param_shapes()).items()}
    assert shapes == {k: v.shape for k, v in jparams.items()}
    assert model.num_params() == JaxModel(jcfg).num_params()
    back = flatten(params_to_numpy(params_from_numpy(jparams, "cpu")))
    for k, v in jparams.items():
        np.testing.assert_array_equal(back[k], v)
    own = flatten(model.init(0, device="cpu"))
    A = -torch.exp(own["blocks_0.mixer.A_log"])
    assert bool(((A <= -1.0) & (A >= -16.0)).all())
    dt = torch.nn.functional.softplus(own["blocks_0.mixer.dt_bias"])
    assert bool(((dt >= 1e-3 * 0.999) & (dt <= 0.1 * 1.001)).all())


def test_mamba2_loss_and_grads_match_jax():
    jcfg = dataclasses.replace(jax_smoke_config("mamba2_370m"), compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke_config("mamba2_370m"), compute_dtype="float32")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    leaves = flatten(params)
    for leaf in leaves.values():
        leaf.requires_grad_()
    loss, _ = Model(cfg).loss(params, {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    jg = flatten(jax.tree.map(np.asarray, jgrads))
    for (path, g) in zip(leaves, grads):
        want = jg[path]
        rel = np.linalg.norm(g.numpy() - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= 1e-4, (path, rel)
