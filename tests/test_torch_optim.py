"""The port's SGD against the JAX package's, update for update.

Same numpy-drawn params and grads (fp32 and bf16 params) through both
optimizers for three updates. Tolerance: 1e-6 relative (fp32
elementwise arithmetic; XLA may contract a multiply-add into an FMA).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro_torch.optim import optimizers as topt
from repro_torch.tree import flatten


def _trees(dtype_j, dtype_t, seed):
    rng = np.random.default_rng(seed)
    arrays = {"a": {"w": rng.standard_normal((7, 5))}, "b": rng.standard_normal((11,))}
    arrays = jax.tree.map(lambda a: a.astype(np.float32), arrays)
    j = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype_j), arrays)
    t = {"a": {"w": torch.from_numpy(arrays["a"]["w"]).to(dtype_t)},
         "b": torch.from_numpy(arrays["b"]).to(dtype_t)}
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("momentum,nesterov,weight_decay", [
    (0.0, False, 0.0), (0.9, False, 0.0), (0.9, True, 1e-2),
])
def test_sgd_matches_jax(dtype, momentum, nesterov, weight_decay):
    dj, dt = getattr(jnp, dtype), getattr(torch, dtype)
    jp, tp = _trees(dj, dt, 0)
    jo = jopt.sgd(0.05, momentum=momentum, nesterov=nesterov, weight_decay=weight_decay)
    to = topt.sgd(0.05, momentum=momentum, nesterov=nesterov, weight_decay=weight_decay)
    js, ts = jo.init(jp), to.init(tp)
    for k in range(3):
        jg, tg = _trees(jnp.float32, torch.float32, k + 1)
        ju, js = jo.update(jg, js, jp)
        tu, ts = to.update(tg, ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
    assert int(ts["step"]) == int(js["step"]) == 3
    want = flatten(jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp))
    for path, t in flatten(tp).items():
        assert t.dtype == dt
        np.testing.assert_allclose(t.float().numpy(), want[path], rtol=1e-6, atol=1e-7)
    if momentum:
        jv = flatten(jax.tree.map(np.asarray, js["velocity"]))
        for path, v in flatten(ts["velocity"]).items():
            assert v.dtype == torch.float32
            np.testing.assert_allclose(v.numpy(), jv[path], rtol=1e-6, atol=1e-7)


def test_clip_by_global_norm_matches_jax():
    jg, tg = _trees(jnp.float32, torch.float32, 3)
    assert float(topt.global_norm(tg)) == pytest.approx(float(jopt.global_norm(jg)), rel=1e-6)
    for max_norm in (0.5, 1e3):
        want = flatten(jax.tree.map(np.asarray, jopt.clip_by_global_norm(jg, max_norm)))
        for path, t in flatten(topt.clip_by_global_norm(tg, max_norm)).items():
            np.testing.assert_allclose(t.numpy(), want[path], rtol=1e-6)
