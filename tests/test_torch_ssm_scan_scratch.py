"""The SSD chunk-scan wrapper's host-side pieces that run without a card:
the sizes of the tensor-core kernel's state ring and scratch, the
per-stream scratch cache, and the refusals of CPU tensors."""
import pytest
import torch

from repro_torch.kernels import ssm_scan as ss


@pytest.mark.parametrize("shape,ring,scratch", [
    # mamba2-370m's serving prefill: B 8, S 2048, H 32, P 64, N 128, chunk 128
    ((8, 2048, 32, 64, 128, 128), 2 * 8 * 32 * 128 * 64, 2 + 8 * 32 * 16),
    ((1, 64, 2, 16, 16, 64), 2 * 2 * 16 * 16, 2 + 2),          # one chunk
    ((2, 272, 3, 64, 64, 16), 2 * 2 * 3 * 64 * 64, 2 + 2 * 3 * 17),
])
def test_scratch_sizes(shape, ring, scratch):
    assert ss.scratch_sizes(*shape) == (ring, scratch)
    # the ring at the serving shapes: 16.8 MB of fp32, within the 50 MB L2
    if shape[0] == 8:
        assert ring * 4 == 16_777_216


def test_scratch_is_zeroed_once_per_stream_and_grows():
    ss._SCRATCH.clear()
    dev = torch.device("cpu")
    a = ss._scratch(dev, 7, 10)
    assert a.dtype == torch.int32 and a.numel() >= 10 and not a.any()
    assert ss._scratch(dev, 7, 20) is a                 # large enough: reused
    b = ss._scratch(dev, 8, 10)                          # another stream
    assert b is not a
    big = ss._scratch(dev, 7, a.numel() + 1)             # grows: a new zeroed one
    assert big is not a and big.numel() > a.numel() and not big.any()
    ss._SCRATCH.clear()


def test_cpu_tensors_are_refused():
    x = torch.zeros(1, 64, 2, 16, dtype=torch.bfloat16)
    Bm = torch.zeros(1, 64, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        ss.kernel_path(x, Bm, 64)
    with pytest.raises(ValueError, match="ssm_scan_ref"):
        ss.ssm_scan(x, torch.zeros(1, 64, 2), torch.zeros(2), Bm, Bm, chunk=64)
