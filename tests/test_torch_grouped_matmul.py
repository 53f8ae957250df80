"""The port's ``ops.grouped_matmul`` against the JAX grouped matmul.

On the CPU ``ops.grouped_matmul(impl="auto")`` is the plain version
(``repro_torch.kernels.ref.grouped_matmul_ref``); it is held to the JAX
Pallas kernel run in interpret mode
(``repro.kernels.grouped_matmul.grouped_matmul(interpret=True)``) and to
the JAX oracle ``repro.kernels.ref.grouped_matmul_ref``
(``lax.ragged_dot``), on the same numpy inputs: the block sweep of
``tests/test_kernels.py`` (ragged tails, 16 groups with some empty),
empty groups, tails of M 37 and 165, and ``sum(group_sizes) < M``, whose
rows past the groups must be exactly 0.

Tolerances: fp32 2e-5 abs and rel (summation order only); bf16 inputs
2e-2 abs and rel, as ``tests/test_kernels.py``'s ``_tol`` (the outputs
are rounded to bf16 from slightly different fp32 sums, one bf16 step
apart at most).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_matmul import grouped_matmul as jax_gmm
from repro.kernels.ref import grouped_matmul_ref as jax_gmm_ref
from repro_torch.kernels import ops

TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _cut_sizes(M, G, seed):
    """G group sizes summing to M, as ``test_grouped_matmul_sweep`` draws them."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(M, G - 1, replace=False))
    return np.diff(np.concatenate([[0], cuts, [M]])).astype(np.int32)


def _check(M, K, N, sizes, dtype, *, bm, bn, seed=0):
    rng = np.random.default_rng(seed)
    G = len(sizes)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((G, K, N)) * 0.2).astype(np.float32)
    jx, jw = jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype)
    js = jnp.asarray(sizes, jnp.int32)
    tdt = getattr(torch, dtype)
    got = ops.grouped_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                             torch.from_numpy(np.asarray(sizes, np.int32)))
    assert got.dtype == tdt and got.shape == (M, N)
    got = got.float().numpy()
    kernel = jax_gmm(jx, jw, js, block_m=bm, block_n=bn, interpret=True)
    oracle = jax_gmm_ref(jx, jw, js)
    for want in (kernel, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), **TOL[dtype])
    tail = int(np.sum(sizes))
    assert not got[tail:].any(), "rows past sum(group_sizes) must be 0"
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "M,K,N,G,bm,bn",
    [
        (96, 32, 48, 4, 32, 32),
        (256, 64, 128, 8, 128, 64),
        (130, 16, 40, 3, 32, 32),      # ragged tail blocks
        (64, 128, 256, 16, 32, 128),   # many groups, some empty
    ],
)
def test_grouped_matmul_sweep_matches_jax_kernel(M, K, N, G, bm, bn, dtype):
    sizes = _cut_sizes(M, G, seed=M + G)
    if G == 16:
        assert (sizes == 0).any() or M < 2 * G
    _check(M, K, N, sizes, dtype, bm=bm, bn=bn)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_matmul_empty_groups(dtype):
    _check(64, 16, 24, np.asarray([0, 40, 0, 24], np.int32), dtype, bm=32, bn=24, seed=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,sizes", [
    (37, [5, 0, 20, 12]),              # M below one block, tail of 5
    (165, [64, 0, 0, 101]),            # two ragged blocks, empty middle
    (165, [3, 17, 0, 60, 80, 5]),
])
def test_grouped_matmul_tails(M, sizes, dtype):
    _check(M, 48, 72, np.asarray(sizes, np.int32), dtype, bm=32, bn=32, seed=M)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sizes", [[10, 0, 7], [0, 0, 0], [30, 2, 0]])
def test_grouped_matmul_rows_past_the_groups_are_zero(sizes, dtype):
    got = _check(48, 24, 40, np.asarray(sizes, np.int32), dtype, bm=16, bn=40, seed=7)
    assert not got[sum(sizes):].any()


def test_plain_version_is_differentiable_like_ragged_dot():
    """On the CPU the plain version carries gradients (the MoE layers
    train through it); on the card ``GroupedMatmul`` does, through the
    dx and dw kernels (tests/test_torch_grouped_matmul_grad.py)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((20, 8)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((3, 8, 5)).astype(np.float32)).requires_grad_()
    sizes = torch.tensor([6, 0, 11], dtype=torch.int32)
    ops.grouped_matmul(x, w, sizes).square().sum().backward()
    gx = np.zeros((20, 8), np.float32)
    gw = np.zeros((3, 8, 5), np.float32)
    xn, wn = x.detach().numpy(), w.detach().numpy()
    for g, (s, e) in enumerate([(0, 6), (6, 6), (6, 17)]):
        y = xn[s:e] @ wn[g]
        gx[s:e] = 2 * y @ wn[g].T
        gw[g] = xn[s:e].T @ (2 * y)
    np.testing.assert_allclose(x.grad.numpy(), gx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(w.grad.numpy(), gw, rtol=1e-5, atol=1e-5)
    assert not x.grad[17:].any()


def test_unknown_impl_raises():
    x = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.grouped_matmul(x, torch.zeros(1, 2, 3), torch.tensor([4], dtype=torch.int32),
                           impl="pallas")
