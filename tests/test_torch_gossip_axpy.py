"""The port's gossip-axpy against the JAX Pallas kernel (interpret mode).

The sweep is ``tests/test_kernels.py``'s (four shapes, alpha in
{0, 0.3, 1}, fp32 and bf16) plus the mixed case the masked gossip path
produces (bf16 x, fp32 target). Inputs are drawn with numpy and cast
the same way on both sides. Both compute ``x + alpha * (y - x)`` in
fp32 and cast once to x's dtype, but XLA on the CPU contracts the
multiply-add into an FMA while the port (and its CUDA kernel) round the
product first, so an fp32 result may differ by an ulp (tolerance 2e-6
absolute and relative, for values of a few units), and a bf16 result,
rounded from such an fp32 value, by one bf16 ulp (2**-7 relative).

The CUDA kernel itself runs only on the card: its tests are in
``tests/test_torch_kernels_cuda.py`` (marked ``cuda``), and
``chip_smoke.py`` holds it to the plain version on the H100 at the main
path's shapes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gossip_axpy import gossip_axpy as jax_gossip_axpy
from repro_torch.kernels import ops
from repro_torch.kernels.gossip_axpy import gossip_axpy

SHAPES = [(17,), (1003, 77), (4, 33, 9), (2048, 1024)]
ALPHAS = [0.0, 0.3, 1.0]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=2e-6, atol=2e-6), "bfloat16": dict(rtol=2.0**-7, atol=2e-6)}


def _pair(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("x_dtype,y_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"), ("bfloat16", "float32"),
])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("alpha", ALPHAS)
def test_gossip_apply_matches_pallas_kernel(shape, alpha, x_dtype, y_dtype):
    x, y = _pair(shape)
    (jx, tx), (jy, ty) = DTYPES[x_dtype], DTYPES[y_dtype]
    want = jax_gossip_axpy(_jax(x, jx), _jax(y, jy), alpha, interpret=True)
    got = ops.gossip_apply(_torch(x, tx), _torch(y, ty), alpha, impl="torch")
    assert got.dtype == tx and tuple(got.shape) == shape
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), **TOL[x_dtype]
    )


def test_resolve_mode():
    assert ops.resolve_mode("auto", "cpu") == "torch"
    assert ops.resolve_mode("auto", torch.device("cuda", 0)) == "cuda"
    for mode in ops.MODES:
        assert ops.resolve_mode(mode, "cpu") == mode
    for bad in ("fused", "", "Torch", "xla", "interpret", "pallas"):
        with pytest.raises(ValueError, match="unknown impl"):
            ops.resolve_mode(bad, "cpu")


def test_tree_update_passes_non_float_leaves_and_updates_in_place():
    steps = torch.arange(4, dtype=torch.int32)
    x = {"a": torch.ones(64, 64), "b": {"c": torch.zeros(130)}, "n": steps}
    y = {"a": torch.zeros(64, 64), "b": {"c": torch.ones(130)}, "n": steps + 7}
    out = ops.gossip_update(x, y, 0.25)
    assert out["n"] is steps
    assert float(out["a"][0, 0]) == pytest.approx(0.75)
    assert float(out["b"]["c"][0]) == pytest.approx(0.25)
    assert float(x["a"][0, 0]) == 1.0                  # not in place
    target = x["b"]["c"]
    res = ops.gossip_apply(x, y, 0.25, inplace=True)
    assert res["b"]["c"] is target and float(target[0]) == pytest.approx(0.25)


def test_cuda_request_on_cpu_tensor_raises():
    x, y = torch.zeros(8), torch.ones(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.gossip_apply(x, y, 0.5, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        gossip_axpy(x, y, 0.5)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.gossip_apply(x, y, 0.5, impl="bogus")
