"""Hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without an sm_90 card. This file
imports no JAX, so it runs on a machine with the card but without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerance: exact. The kernel rounds the same three fp32 operations as
the plain version and casts once, as it does.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.gossip_axpy import gossip_axpy
from repro_torch.kernels.ref import gossip_axpy_ref

SHAPES = [(17,), (1003, 77), (4, 33, 9), (2048, 1024), (1,), (5,), ((1 << 20) + 3,)]
ALPHAS = [0.0, 0.3, 1.0]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.fixture
def sm90():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("the kernel is built for sm_90a (Hopper)")


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,y_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"), ("bfloat16", "float32"),
])
def test_cuda_kernel_matches_plain_version(sm90, x_dtype, y_dtype):
    tx, ty = DTYPES[x_dtype], DTYPES[y_dtype]
    for shape in SHAPES:
        x, y = _pair(shape)
        for offset in (0, 1, 3):          # views at misaligned offsets
            xb = torch.from_numpy(np.concatenate([np.zeros(offset, np.float32), x.ravel()]))
            xc = xb.to("cuda", tx)[offset:]
            yc = torch.from_numpy(y).to("cuda", ty).ravel()
            for alpha in ALPHAS:
                before = gossip_axpy.launches
                got = gossip_axpy(xc, yc, alpha)
                assert gossip_axpy.launches == before + 1
                torch.testing.assert_close(
                    got, gossip_axpy_ref(xc, yc, alpha), rtol=0, atol=0
                )


@pytest.mark.cuda
def test_cuda_kernel_in_place_and_rejects_bad_operands(sm90):
    x = torch.randn(1000, device="cuda")
    y = torch.randn(1000, device="cuda")
    want = gossip_axpy_ref(x, y, 0.25)
    out = gossip_axpy(x, y, 0.25, inplace=True)
    assert out is x
    torch.testing.assert_close(x, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="shapes differ"):
        gossip_axpy(x, y[:10], 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        gossip_axpy(x.view(10, 100).T, y.view(10, 100).T, 0.25)
    with pytest.raises(ValueError, match="dtype"):
        gossip_axpy(x.half(), y, 0.25)
