"""Hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without an sm_90 card. This file
imports no JAX, so it runs on a machine with the card but without JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: gossip_axpy exact (it rounds the same three fp32
operations as the plain version and casts once, as it does); flash
attention, the SSD chunk scan and the grouped matmul as stated above
their tests.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gossip_axpy import gossip_axpy
from repro_torch.kernels.grouped_matmul import grouped_matmul
from repro_torch.kernels.ref import (
    attention_ref,
    gossip_axpy_ref,
    grouped_matmul_dw_ref,
    grouped_matmul_dx_ref,
    grouped_matmul_ref,
    ssm_scan_ref,
)
from repro_torch.kernels.ssm_scan import ssm_scan

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


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,y_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"), ("bfloat16", "float32"),
])
def test_cuda_kernel_bit_equal_in_place_across_tiles(sm90, x_dtype, y_dtype):
    # sizes around the kernel's tile (256 threads x 4 vectors) and past one
    # tile per resident block, at aligned and misaligned offsets, in place
    tx, ty = DTYPES[x_dtype], DTYPES[y_dtype]
    for n in (1, 7, 4095, 4096 * 4 + 3, 8192 * 4 - 1, 132 * 8 * 1024 * 4 + 13):
        x, y = _pair((n + 8,), seed=n)
        for offset in (0, 1, 8):
            xc = torch.from_numpy(x).to("cuda", tx)[offset:offset + n]
            yc = torch.from_numpy(y).to("cuda", ty)[offset:offset + n]
            want = gossip_axpy_ref(xc, yc, 0.3)
            out = gossip_axpy(xc, yc, 0.3, inplace=True)
            assert out.data_ptr() == xc.data_ptr()
            torch.testing.assert_close(xc, want, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_faulted_masked_gossip_through_the_kernel_is_bit_equal(sm90, dtype):
    # per-node effective bits at p_drop 0.35 (paper8, 6 matchings): the
    # kernel and the plain version from the same fp32 targets; and
    # all-ones gates give the unfaulted row's result bit for bit
    from repro_torch import core, faults
    from repro_torch.dist.gossip import mix_matchings_masked

    plan = core.plan_matcha(core.named_graph("paper8", 8, seed=3), 0.5,
                            budget_steps=400, seed=0)
    sched = plan.schedule(4, seed=1)
    fs = faults.make_fault_schedule(plan, 4, faults.FaultSpec(p_drop=0.35, seed=0))
    rng = np.random.default_rng(0)
    x = {"w": torch.from_numpy(rng.standard_normal((8, 333, 65)).astype(np.float32)).to(
             "cuda", dtype),
         "b": torch.from_numpy(rng.standard_normal((8, 4099)).astype(np.float32)).to(
             "cuda", dtype),
         "n": torch.arange(8, device="cuda")}
    mix = lambda bits, impl: mix_matchings_masked(x, plan.alpha, plan.permutations,
                                                  torch.as_tensor(bits, device="cuda"),
                                                  impl=impl)
    dropped = 0
    for k in range(4):
        row = sched.activations[k].astype(np.float32)
        bits = fs.node_bits(row, k)
        dropped += fs.dropped_links(row, k)
        before = gossip_axpy.launches
        got = mix(bits, "cuda")
        assert gossip_axpy.launches == before + 2
        want = mix(bits, "torch")
        ones, plain = mix(np.tile(row, (8, 1)), "cuda"), mix(row, "cuda")
        torch.cuda.synchronize()
        for key in x:
            assert torch.equal(got[key], want[key]), (k, key)
            assert torch.equal(ones[key], plain[key]), (k, key)
    assert dropped > 0


# ---------------------------------------------------------------------------
# flash attention and the SSD chunk scan
#
# Tolerances: fp32 1e-4 abs and rel (the kernel sums in another order and
# uses the fast exp); bf16 2e-2 for attention and 5e-2 for the scan (one
# bf16 rounding of the output apart, as in tests/test_kernels.py). Rows
# with no live key: the kernel writes 0 where the plain version spreads
# uniform weight over NEG_INF scores; they are checked apart.
# ---------------------------------------------------------------------------

FA_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
          torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
SSM_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-3),
           torch.bfloat16: dict(atol=5e-2, rtol=5e-2)}


def _qkv(B, Sq, Sk, Hq, Hkv, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to("cuda", dtype)
    return mk(B, Sq, Hq, hd), mk(B, Sk, Hkv, hd), mk(B, Sk, Hkv, hd)


def _live(Sq, Sk, causal, window, kv_len):
    i = torch.arange(Sq)[:, None]
    j = torch.arange(Sk)[None, :]
    m = (j < (kv_len or Sk)) & (i >= 0)
    if causal:
        m = m & (j <= i)
    if window:
        m = m & (i - j < window)
    return m


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd", [
    (1, 128, 128, 4, 4, 64),      # MHA
    (2, 256, 256, 8, 2, 64),      # GQA 4:1
    (1, 192, 192, 6, 1, 32),      # MQA
    (2, 64, 64, 4, 4, 128),       # wide heads
    (2, 100, 100, 4, 2, 32),      # odd lengths, GQA 2
    (1, 37, 130, 2, 2, 128),      # Sq != Sk, odd
    (2, 130, 37, 4, 1, 64),       # more queries than keys
    (1, 128, 128, 48, 8, 128),    # dbrx-132b's heads, GQA 6:1
])
@pytest.mark.parametrize("causal,window,kv_len", [
    (True, 0, 0), (True, 24, 0), (False, 0, 0), (False, 24, 0), (True, 0, 31), (False, 0, 31),
])
def test_flash_kernel_matches_plain_version(sm90, dtype, B, Sq, Sk, Hq, Hkv, hd,
                                            causal, window, kv_len):
    q, k, v = _qkv(B, Sq, Sk, Hq, Hkv, hd, dtype)
    kv_len = min(kv_len, Sk)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window, kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    n = kv_len or Sk
    want = attention_ref(q, k[:, :n], v[:, :n], causal=causal, window=window)
    live = _live(Sq, Sk, causal, window, kv_len).any(1).cuda()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got[:, live].float(), want[:, live].float(), **FA_TOL[dtype])
    assert bool((got[:, ~live] == 0).all())


# Every other head_dim of the model registry (kimi-k2 112, nemotron-4-340b
# 192, gemma3-4b 256): bf16 on the wgmma kernel (112 on a zero-padded
# 128-column box; 192 and 256 with two warpgroups on a 128-row q tile),
# fp32 on the scalar kernel (7, 12 and 16 output columns a thread, 14 / 28
# chunks a row at 112 that 256 threads do not divide, 208 KB of shared
# memory at 256). Heads in the models' ratios, cut down.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hd,Hq,Hkv", [(112, 8, 1), (192, 12, 1), (256, 4, 2)],
                         ids=["kimi", "nemotron", "gemma3"])
@pytest.mark.parametrize("B,Sq,Sk", [(2, 150, 150), (1, 37, 130), (2, 130, 37)])
@pytest.mark.parametrize("causal,window,kv_len", [
    (True, 0, 0), (True, 24, 0), (False, 0, 0), (False, 24, 0), (True, 0, 31), (False, 0, 31),
])
def test_flash_kernel_at_every_registry_width(sm90, dtype, hd, Hq, Hkv, B, Sq, Sk,
                                              causal, window, kv_len):
    from repro_torch.kernels.flash_attention import kernel_path

    q, k, v = _qkv(B, Sq, Sk, Hq, Hkv, hd, dtype, seed=hd + Sq)
    assert kernel_path(q, k) == ("wgmma" if dtype == torch.bfloat16 else "scalar")
    kv_len = min(kv_len, Sk)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window, kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    n = kv_len or Sk
    want = attention_ref(q, k[:, :n], v[:, :n], causal=causal, window=window)
    live = _live(Sq, Sk, causal, window, kv_len).any(1).cuda()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got[:, live].float(), want[:, live].float(), **FA_TOL[dtype])
    assert bool((got[:, ~live] == 0).all())


# The wide widths' wgmma kernel at the edges of its 128-row q tile (two
# warpgroups of 64 rows at hd 192 / 256; hd 112 has one on 64 rows):
# Sq 129 leaves the last tile's second warpgroup no row, Sq 200 a ragged
# 8; windows of 24 and 64 leave one warpgroup a k tile with no live key
# (the first window tile of warpgroup 1, the last causal tile of
# warpgroup 0); kv_len 97 ends inside warpgroup 1's rows; Sq != Sk both
# ways; kv_len 10 with a window of 4 masks every row from 13 on.
@pytest.mark.cuda
@pytest.mark.parametrize("hd,Hq,Hkv", [(112, 8, 1), (192, 12, 1), (256, 4, 2)],
                         ids=["kimi", "nemotron", "gemma3"])
@pytest.mark.parametrize("B,Sq,Sk,causal,window,kv_len", [
    (2, 129, 129, True, 0, 0),
    (2, 200, 200, True, 0, 0),
    (1, 200, 200, False, 0, 0),
    (2, 256, 256, True, 24, 0),
    (2, 320, 320, True, 64, 0),
    (1, 256, 256, False, 64, 0),
    (2, 200, 200, True, 0, 97),
    (1, 256, 256, False, 0, 97),
    (2, 70, 300, True, 0, 0),
    (2, 300, 70, True, 0, 0),
    (1, 100, 260, False, 0, 0),
    (1, 96, 96, True, 4, 10),
], ids=["Sq129", "Sq200", "Sq200-noncausal", "window24", "window64", "window64-noncausal",
        "kv_len97", "kv_len97-noncausal", "Sq<Sk", "Sq>Sk", "Sq<Sk-noncausal", "masked-rows"])
def test_flash_wgmma_kernel_128_row_tile_edges(sm90, hd, Hq, Hkv, B, Sq, Sk, causal,
                                               window, kv_len):
    from repro_torch.kernels.flash_attention import kernel_path

    q, k, v = _qkv(B, Sq, Sk, Hq, Hkv, hd, torch.bfloat16, seed=hd + Sq + Sk)
    assert kernel_path(q, k) == "wgmma"
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window, kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    n = kv_len or Sk
    want = attention_ref(q, k[:, :n], v[:, :n], causal=causal, window=window)
    live = _live(Sq, Sk, causal, window, kv_len).any(1).cuda()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got[:, live].float(), want[:, live].float(),
                               **FA_TOL[torch.bfloat16])
    assert bool((got[:, ~live] == 0).all())
    if kv_len == 10:
        assert int((~live).sum()) == Sq - 13


@pytest.mark.cuda
def test_flash_kernel_fully_masked_rows_are_zero_and_wrapper_dispatches(sm90):
    # kv_len 10 with a window of 4: queries from 13 on see no live key
    q, k, v = _qkv(1, 64, 64, 2, 2, 32, torch.float32, seed=2)
    got = flash_attention(q, k, v, causal=True, window=4, kv_len=10)
    assert bool((got[:, 13:] == 0).all()) and bool(torch.isfinite(got).all())
    before = flash_attention.launches
    out = ops.attention(q, k, v, causal=True, window=8)
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(out, ops.attention(q, k, v, causal=True, window=8,
                                                  impl="torch"), **FA_TOL[torch.float32])
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[..., :16].contiguous(), k[..., :16].contiguous(),
                        v[..., :16].contiguous())
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), k, v)


# The tensor-core kernel (bf16, hd 64 and 128): one 64 x 64 tile, lengths
# that are not multiples of the 64-key tile and cross it with B > 1 (a
# tile's tail must not read the next batch's keys), and the serving shapes.
@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv", [
    (1, 64, 64, 1, 1),            # a single tile
    (3, 150, 150, 4, 2),          # 2.3 tiles, batch edges
    (2, 70, 200, 2, 1),           # Sq < Sk, both off the tile
    (2, 200, 70, 6, 2),           # Sq > Sk
    (2, 129, 129, 2, 2),          # one key into the third tile
])
@pytest.mark.parametrize("causal,window,kv_len", [
    (True, 0, 0), (False, 0, 0), (True, 40, 0), (False, 0, 67),
])
def test_flash_wgmma_kernel_tiles_and_edges(sm90, hd, B, Sq, Sk, Hq, Hkv, causal,
                                            window, kv_len):
    from repro_torch.kernels.flash_attention import kernel_path

    q, k, v = _qkv(B, Sq, Sk, Hq, Hkv, hd, torch.bfloat16, seed=Sq + Sk)
    assert kernel_path(q, k) == "wgmma"
    kv_len = min(kv_len, Sk)
    got = flash_attention(q, k, v, causal=causal, window=window, kv_len=kv_len)
    torch.cuda.synchronize()
    n = kv_len or Sk
    want = attention_ref(q, k[:, :n], v[:, :n], causal=causal, window=window)
    live = _live(Sq, Sk, causal, window, kv_len).any(1).cuda()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got[:, live].float(), want[:, live].float(),
                               **FA_TOL[torch.bfloat16])
    assert bool((got[:, ~live] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv", [(16, 8), (48, 8)], ids=["internlm2", "dbrx"])
def test_flash_wgmma_kernel_at_the_serving_shapes(sm90, Hq, Hkv):
    q, k, v = _qkv(8, 2048, 2048, Hq, Hkv, 128, torch.bfloat16, seed=Hq)
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, causal=True)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), **FA_TOL[torch.bfloat16])


# The new families' attention on the tensor-core kernel (bf16, hd 64):
# whisper-base's non-causal encoder self-attention and its cross-attention
# (384 decoder queries over 1500 encoder keys), and internvl2-1b's GQA 7:1.
@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,causal", [
    (8, 1500, 1500, 8, 8, False),
    (8, 384, 1500, 8, 8, False),
    (2, 2048, 2048, 14, 2, True),
    (2, 300, 300, 14, 2, True),
], ids=["whisper-encoder", "whisper-cross", "internvl2", "internvl2-ragged"])
def test_flash_wgmma_kernel_at_the_new_families_shapes(sm90, B, Sq, Sk, Hq, Hkv, causal):
    from repro_torch.kernels.flash_attention import kernel_path

    q, k, v = _qkv(B, Sq, Sk, Hq, Hkv, 64, torch.bfloat16, seed=Sq + Hq)
    assert kernel_path(q, k) == "wgmma"
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, causal=causal)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), **FA_TOL[torch.bfloat16])


@pytest.mark.cuda
def test_flash_kernel_path_rule(sm90):
    from repro_torch.kernels.flash_attention import kernel_path

    # bf16 hd 64, 112, 128, 192 and 256 on the tensor cores; fp32 at every
    # width, bf16 at 32, and a k/v with no keys, scalar
    for dtype, hd, path in [(torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
                            (torch.bfloat16, 32, "scalar"), (torch.float32, 128, "scalar"),
                            (torch.float32, 64, "scalar"), (torch.bfloat16, 112, "wgmma"),
                            (torch.bfloat16, 192, "wgmma"), (torch.bfloat16, 256, "wgmma"),
                            (torch.float32, 112, "scalar"), (torch.float32, 192, "scalar"),
                            (torch.float32, 256, "scalar")]:
        q, k, _ = _qkv(1, 8, 8, 2, 1, hd, dtype)
        assert kernel_path(q, k) == path, (dtype, hd)
    # no keys: the scalar kernel writes zeros at every bf16 width
    for hd in (112, 192, 256):
        q, k, v = _qkv(1, 8, 0, 2, 1, hd, torch.bfloat16)
        assert kernel_path(q, k) == "scalar"
        out = flash_attention(q, k, v, causal=False)
        torch.cuda.synchronize()
        assert bool((out == 0).all())
    # bf16 hd 32 on the scalar kernel agrees all the same
    q, k, v = _qkv(2, 100, 100, 4, 2, 32, torch.bfloat16, seed=5)
    torch.testing.assert_close(flash_attention(q, k, v).float(),
                               attention_ref(q, k, v).float(), **FA_TOL[torch.bfloat16])


def _ssm_inputs(B, S, H, P, N, dtype, seed=0, a_scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
    x = f(rng.standard_normal((B, S, H, P)) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(f(rng.standard_normal((B, S, H))))
    A = -torch.exp(f(rng.uniform(size=(H,)))) * a_scale
    Bm = f(rng.standard_normal((B, S, N)) * 0.3).to(dtype)
    Cm = f(rng.standard_normal((B, S, N)) * 0.3).to(dtype)
    return x, dt, A, Bm, Cm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 64, 2, 16, 8, 16),
    (2, 128, 4, 32, 16, 32),
    (1, 256, 2, 64, 128, 128),    # the serving path's state dims
    (2, 96, 3, 16, 8, 32),        # 3 chunks
    (2, 64, 8, 32, 32, 64),       # the mamba2 smoke widths
])
def test_ssm_kernel_matches_plain_version(sm90, dtype, B, S, H, P, N, chunk):
    x, dt, A, Bm, Cm = _ssm_inputs(B, S, H, P, N, dtype)
    before = ssm_scan.launches
    y, h = ssm_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    y_ref, h_ref = ssm_scan_ref(x, dt, A, Bm, Cm)
    torch.testing.assert_close(y.float(), y_ref.float(), **SSM_TOL[dtype])
    torch.testing.assert_close(h, h_ref.float(), **SSM_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("S", [100, 52, 200])
def test_ssd_wrapper_halves_the_chunk_and_survives_underflow(sm90, S):
    # A * dt large: exp(La) underflows to 0 inside a chunk
    x, dt, A, Bm, Cm = _ssm_inputs(2, S, 2, 16, 8, torch.float32, seed=S, a_scale=60.0)
    before = ssm_scan.launches
    y, h = ops.ssd(x, dt, A, Bm, Cm, chunk=64)
    assert ssm_scan.launches == before + 1
    y_ref, h_ref = ops.ssd(x, dt, A, Bm, Cm, chunk=64, impl="torch")
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    torch.testing.assert_close(y, y_ref, **SSM_TOL[torch.float32])
    torch.testing.assert_close(h, h_ref, **SSM_TOL[torch.float32])
    with pytest.raises(ValueError, match="divide"):
        ssm_scan(x, dt, A, Bm, Cm, chunk=48 if S % 48 else 56)


# The tensor-core kernel (bf16, P in (16, 32, 48, 64, 128), N a multiple of
# 16 up to 128, chunk a multiple of 16): chunks in parallel, the state handed
# on through a ring under flags. 1, 2, 16 and 17 chunks; H not a multiple of
# the 2 heads a block takes (P <= 64), P 128 (one head a block), chunk 96, P
# and N 48, and decays that underflow.
@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,P,N,chunk,a_scale", [
    (1, 64, 2, 64, 128, 64, 1.0),        # 1 chunk
    (2, 128, 3, 32, 32, 64, 1.0),        # 2 chunks, H odd
    (1, 256, 4, 16, 16, 16, 1.0),        # 16 chunks
    (2, 272, 3, 64, 64, 16, 1.0),        # 17 chunks, H odd
    (1, 192, 2, 128, 64, 64, 1.0),       # P 128: one head a block
    (1, 192, 3, 128, 32, 32, 1.0),       # P 128, H odd
    (2, 256, 5, 32, 32, 128, 60.0),      # A * dt up to ~200: decays underflow
    (1, 96, 3, 32, 16, 96, 1.0),         # chunk 96
    (1, 384, 2, 48, 48, 128, 1.0),       # P, N 48
])
def test_ssm_mma_kernel_chunks_heads_and_decays(sm90, B, S, H, P, N, chunk, a_scale):
    from repro_torch.kernels.ssm_scan import kernel_path

    x, dt, A, Bm, Cm = _ssm_inputs(B, S, H, P, N, torch.bfloat16, seed=S + H, a_scale=a_scale)
    assert kernel_path(x, Bm, chunk) == "mma"
    before = ssm_scan.launches
    y, h = ssm_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    y_ref, h_ref = ssm_scan_ref(x, dt, A, Bm, Cm)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    torch.testing.assert_close(y.float(), y_ref.float(), **SSM_TOL[torch.bfloat16])
    torch.testing.assert_close(h, h_ref.float(), **SSM_TOL[torch.bfloat16])


@pytest.mark.cuda
def test_ssm_mma_kernel_at_the_serving_shapes(sm90):
    from repro_torch.kernels.ssm_scan import kernel_path

    x, dt, A, Bm, Cm = _ssm_inputs(8, 2048, 32, 64, 128, torch.bfloat16, seed=7)
    assert kernel_path(x, Bm, 128) == "mma"
    y, h = ssm_scan(x, dt, A, Bm, Cm, chunk=128)
    torch.cuda.synchronize()
    y_ref, h_ref = ssm_scan_ref(x, dt, A, Bm, Cm)
    torch.testing.assert_close(y.float(), y_ref.float(), **SSM_TOL[torch.bfloat16])
    torch.testing.assert_close(h, h_ref.float(), **SSM_TOL[torch.bfloat16])


@pytest.mark.cuda
def test_ssm_kernel_path_rule(sm90):
    from repro_torch.kernels.ssm_scan import kernel_path

    # bf16 with P in (16, 32, 48, 64, 128), N a multiple of 16 up to 128 and
    # the chunk a multiple of 16 on the tensor cores; fp32, N 8 or 144, P 24,
    # chunk 100 or 52, and a misaligned x or C on the scalar kernel
    for dtype, (S, P, N, chunk), path in [
        (torch.bfloat16, (256, 64, 128, 128), "mma"),
        (torch.bfloat16, (96, 32, 16, 96), "mma"),
        (torch.bfloat16, (256, 128, 64, 64), "mma"),
        (torch.float32, (256, 64, 128, 128), "scalar"),
        (torch.bfloat16, (64, 16, 8, 16), "scalar"),
        (torch.bfloat16, (64, 24, 16, 16), "scalar"),
        (torch.bfloat16, (64, 64, 144, 64), "scalar"),
        (torch.bfloat16, (200, 16, 16, 100), "scalar"),
        (torch.bfloat16, (52, 64, 128, 52), "scalar"),
    ]:
        x, _, _, Bm, _ = _ssm_inputs(1, S, 2, P, N, dtype)
        assert kernel_path(x, Bm, chunk) == path, (dtype, S, P, N, chunk)
    # a 2-byte-offset copy of x is contiguous but not 16-byte aligned: the
    # scalar kernel takes it, and both kernels agree with the plain version
    x, dt, A, Bm, Cm = _ssm_inputs(2, 256, 3, 32, 32, torch.bfloat16, seed=4)
    def offset_copy(t):
        out = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")[1:].view(t.shape)
        return out.copy_(t)

    x_off = offset_copy(x)
    assert kernel_path(x_off, Bm, 64) == "scalar" and kernel_path(x, Bm, 64) == "mma"
    assert kernel_path(x, Bm, 64, offset_copy(Cm)) == "scalar"
    y_ref, h_ref = ssm_scan_ref(x, dt, A, Bm, Cm)
    for xi in (x, x_off):
        y, h = ssm_scan(xi, dt, A, Bm, Cm, chunk=64)
        torch.testing.assert_close(y.float(), y_ref.float(), **SSM_TOL[torch.bfloat16])
        torch.testing.assert_close(h, h_ref.float(), **SSM_TOL[torch.bfloat16])


@pytest.mark.cuda
def test_ssm_mma_kernel_calls_in_a_row(sm90):
    # each call leaves its flags and ticket zeroed for the next: a larger
    # call after a smaller one, the smaller again, and a repeat that must
    # give the same bits (no float atomics)
    shapes = [(1, 128, 2, 32, 32, 64), (2, 512, 6, 64, 128, 64), (1, 128, 2, 32, 32, 64)]
    outs = []
    for i, (B, S, H, P, N, chunk) in enumerate(shapes):
        x, dt, A, Bm, Cm = _ssm_inputs(B, S, H, P, N, torch.bfloat16, seed=i % 2)
        y, h = ssm_scan(x, dt, A, Bm, Cm, chunk=chunk)
        torch.cuda.synchronize()
        y_ref, h_ref = ssm_scan_ref(x, dt, A, Bm, Cm)
        torch.testing.assert_close(y.float(), y_ref.float(), **SSM_TOL[torch.bfloat16])
        torch.testing.assert_close(h, h_ref.float(), **SSM_TOL[torch.bfloat16])
        outs.append((y, h))
    assert torch.equal(outs[0][0], outs[2][0]) and torch.equal(outs[0][1], outs[2][1])
    # many calls back to back on one stream, no synchronize between them
    x, dt, A, Bm, Cm = _ssm_inputs(2, 512, 6, 64, 128, torch.bfloat16, seed=1)
    for _ in range(20):
        y, h = ssm_scan(x, dt, A, Bm, Cm, chunk=64)
    torch.cuda.synchronize()
    assert torch.equal(y, outs[1][0]) and torch.equal(h, outs[1][1])


# ---------------------------------------------------------------------------
# grouped matmul
#
# Tolerances: fp32 1e-4 abs and rel (fp32 sums over K in another order);
# bf16 2e-2 abs and rel (both round an fp32 sum to bf16 once; one bf16 step
# apart at most), as tests/test_kernels.py's _tol. Rows past
# sum(group_sizes) must be exactly 0.
# ---------------------------------------------------------------------------

GMM_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _cut(M, G, seed):
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(M, G - 1, replace=False))
    return np.diff(np.concatenate([[0], cuts, [M]])).tolist()


def _gmm_inputs(M, K, N, sizes, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((len(sizes), K, N)) * 0.2).astype(np.float32))
    return (x.to("cuda", dtype), w.to("cuda", dtype),
            torch.tensor(sizes, dtype=torch.int32, device="cuda"))


GMM_SWEEP = [
    (96, 32, 48, _cut(96, 4, 100)),          # the sweep of tests/test_kernels.py
    (256, 64, 128, _cut(256, 8, 264)),
    (130, 16, 40, _cut(130, 3, 133)),        # ragged tail blocks
    (64, 128, 256, _cut(64, 16, 80)),        # 16 groups, some empty
    (64, 16, 24, [0, 40, 0, 24]),            # empty groups
    (37, 48, 72, [5, 0, 20, 12]),            # M below one tile
    (165, 48, 72, [64, 0, 0, 101]),
    (48, 24, 40, [10, 0, 7]),                # sum(group_sizes) < M
    (48, 24, 40, [0, 0, 0]),                 # no rows at all
    (32, 256, 520, [2, 3, 0, 1, 4, 2, 2, 0, 3, 1, 2, 4, 3, 0, 2, 3]),  # decode-like
    (1000, 64, 136, [300, 0, 129, 1, 570]),  # groups over several row tiles
    (300, 20, 36, [100, 50, 150]),           # K, N not multiples of 8
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("M,K,N,sizes", GMM_SWEEP)
def test_gmm_kernel_matches_plain_version(sm90, dtype, M, K, N, sizes):
    x, w, gs = _gmm_inputs(M, K, N, sizes, dtype)
    before = grouped_matmul.launches
    got = grouped_matmul(x, w, gs)
    torch.cuda.synchronize()
    assert grouped_matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (M, N)
    want = grouped_matmul_ref(x, w, gs)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), **GMM_TOL[dtype])
    assert bool((got[sum(sizes):] == 0).all())


@pytest.mark.cuda
def test_gmm_paths_wrapper_and_refusals(sm90):
    x, w, gs = _gmm_inputs(64, 32, 48, [20, 0, 44], torch.bfloat16, seed=3)
    # bf16 with K and N multiples of 8 takes the tensor cores; a bf16 N of
    # 44 and fp32 take the scalar path; all three agree on shared columns
    tc = grouped_matmul(x, w, gs).float()
    scalar_bf16 = grouped_matmul(x, w[..., :44].contiguous(), gs).float()
    scalar_fp32 = grouped_matmul(x.float(), w.float(), gs)
    torch.testing.assert_close(scalar_bf16, tc[:, :44], **GMM_TOL[torch.bfloat16])
    torch.testing.assert_close(scalar_fp32, tc, **GMM_TOL[torch.bfloat16])
    before = grouped_matmul.launches
    got = ops.grouped_matmul(x, w, gs.long())        # sizes cast to int32
    assert grouped_matmul.launches == before + 1
    torch.testing.assert_close(got.float(), ops.grouped_matmul(
        x, w, gs, impl="torch").float(), **GMM_TOL[torch.bfloat16])
    # under autograd the same call differentiates through the dx kernel
    xg = x.float().requires_grad_()
    out = ops.grouped_matmul(xg, w.float(), gs)
    (gx,) = torch.autograd.grad(out.sum(), xg)
    torch.testing.assert_close(gx, grouped_matmul_dx_ref(torch.ones_like(out), w.float(), gs),
                               **GMM_TOL[torch.float32])
    with torch.no_grad():
        ops.grouped_matmul(x.float().requires_grad_(), w.float(), gs)
    with pytest.raises(ValueError, match="int32"):
        grouped_matmul(x, w, gs.long())
    with pytest.raises(ValueError, match="dtype"):
        grouped_matmul(x, w.float(), gs)
    with pytest.raises(ValueError, match="does not fit"):
        grouped_matmul(x, w[:2], gs)
    with pytest.raises(ValueError, match="contiguous"):
        grouped_matmul(x.T.contiguous().T, w, gs)


# The tensor-core kernel (wgmma, 128 x 256 tiles, 64-deep k slices): groups
# that end mid-tile beside a non-empty group (the tile multiplies the next
# group's rows and must not store them), K not a multiple of 64, N not a
# multiple of 256, and decode-like shapes (a few rows over 16 groups).
@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,sizes", [
    (300, 128, 256, [70, 100, 130]),          # every group ends mid-tile
    (400, 64, 512, [1, 127, 129, 143]),       # 1 row, then tiles of 127 / 129
    (260, 200, 136, [130, 0, 130]),           # K 200 = 3 slices + 8, N 136
    (512, 72, 264, [256, 0, 100, 56, 100]),   # K 72, N one column tile + 8
    (32, 512, 520, [2, 3, 0, 1, 4, 2, 2, 0, 3, 1, 2, 4, 3, 0, 2, 3]),   # decode-like
    (32, 1024, 1024, [0] * 15 + [32]),        # all rows in the last group
    (96, 256, 384, [10, 20, 30]),             # rows past the groups
])
def test_gmm_wgmma_kernel_tiles_and_edges(sm90, M, K, N, sizes):
    from repro_torch.kernels.grouped_matmul import kernel_path

    x, w, gs = _gmm_inputs(M, K, N, sizes, torch.bfloat16, seed=M + K)
    assert kernel_path(x, w) == "wgmma"
    want = grouped_matmul_ref(x, w, gs)
    for _ in range(3):             # tiles land in another order each time
        got = grouped_matmul(x, w, gs)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), want.float(), **GMM_TOL[torch.bfloat16])
        assert bool((got[sum(sizes):] == 0).all())


def _gmm_backward_check(M, K, N, sizes, dtype, seed, *, poison_tail=False):
    """dx and dw kernels against their plain versions; rows of dx past
    the groups and dw of empty groups exactly 0. ``poison_tail`` fills
    the rows of x and dy past the groups with NaN, which neither kernel
    may read into a stored value."""
    from repro_torch.kernels.grouped_matmul import grouped_matmul_dw, grouped_matmul_dx

    x, w, gs = _gmm_inputs(M, K, N, sizes, dtype, seed=seed)
    dy = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (M, N)).astype(np.float32)).to("cuda", dtype)
    tail = sum(sizes)
    if poison_tail:
        x[tail:] = float("nan")
        dy[tail:] = float("nan")
    before = (grouped_matmul_dx.launches, grouped_matmul_dw.launches)
    dx = grouped_matmul_dx(dy, w, gs)
    dw = grouped_matmul_dw(x, dy, gs)
    torch.cuda.synchronize()
    assert (grouped_matmul_dx.launches, grouped_matmul_dw.launches) == (
        before[0] + (M > 0 and K > 0), before[1] + 1)
    assert dx.dtype == dtype and dx.shape == (M, K)
    assert dw.dtype == dtype and dw.shape == (len(sizes), K, N)
    assert bool(torch.isfinite(dx).all()) and bool(torch.isfinite(dw).all())
    torch.testing.assert_close(dx.float(), grouped_matmul_dx_ref(dy, w, gs).float(),
                               **GMM_TOL[dtype])
    torch.testing.assert_close(dw.float(), grouped_matmul_dw_ref(x, dy, gs).float(),
                               **GMM_TOL[dtype])
    assert bool((dx[tail:] == 0).all())
    for g, size in enumerate(sizes):
        if size == 0:
            assert bool((dw[g] == 0).all())
    return dx, dw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("M,K,N,sizes", GMM_SWEEP)
def test_gmm_backward_kernels_match_plain_versions(sm90, dtype, M, K, N, sizes):
    _gmm_backward_check(M, K, N, sizes, dtype, seed=M + N)


# The tensor-core dx and dw: groups that end mid-slice beside a non-empty
# group (dw's slice loads the next group's rows and must zero them), K and
# N not multiples of the tiles, empty groups, rows past the groups, and
# NaN in those rows, which no stored value may see.
@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,sizes,poison", [
    (300, 128, 256, [70, 100, 130], False),        # every group ends mid-slice
    (400, 64, 512, [1, 127, 129, 143], False),     # 1 row, then 127 / 129
    (260, 200, 136, [130, 0, 130], False),         # K 200, N 136, an empty group
    (512, 72, 264, [256, 0, 100, 56, 100], False),
    (32, 512, 520, [2, 3, 0, 1, 4, 2, 2, 0, 3, 1, 2, 4, 3, 0, 2, 3], False),
    (32, 1024, 1024, [0] * 15 + [32], False),      # all rows in the last group
    (96, 256, 384, [10, 20, 30], True),            # NaN rows past the groups
    (200, 64, 256, [64, 64, 0, 5], True),
    # more dw tiles than SMs: each persistent block walks several tiles,
    # across group boundaries, empty groups and slices that end mid-group
    (2100, 1024, 2048, _cut(2000, 16, 7)[:-3] + [0, 37, 0], True),
    (4096, 512, 4096, [300, 0, 1, 2000, 63, 65, 0, 1667], False),
])
def test_gmm_backward_wgmma_tiles_and_edges(sm90, M, K, N, sizes, poison):
    from repro_torch.kernels.grouped_matmul import kernel_path

    x, w, _ = _gmm_inputs(M, K, N, sizes, torch.bfloat16)
    dy = torch.zeros(M, N, dtype=torch.bfloat16, device="cuda")
    assert kernel_path(dy, w, kind="dx") == "wgmma"
    assert kernel_path(x, dy, kind="dw") == "wgmma"
    first = _gmm_backward_check(M, K, N, sizes, torch.bfloat16, seed=M + K,
                                poison_tail=poison)
    # dw sums each element in one order: the same bits on every run
    again = _gmm_backward_check(M, K, N, sizes, torch.bfloat16, seed=M + K,
                                poison_tail=poison)
    assert torch.equal(first[1], again[1]) and torch.equal(first[0], again[0])


@pytest.mark.cuda
def test_gmm_backward_kernel_path_rule(sm90):
    from repro_torch.kernels.grouped_matmul import kernel_path

    x, w, _ = _gmm_inputs(64, 32, 48, [20, 0, 44], torch.bfloat16, seed=3)
    dy = torch.zeros(64, 48, dtype=torch.bfloat16, device="cuda")
    assert kernel_path(dy, w, kind="dx") == "wgmma"
    assert kernel_path(x, dy, kind="dw") == "wgmma"
    assert kernel_path(dy[:, :44].contiguous(), w[..., :44].contiguous(),
                       kind="dx") == "scalar"                          # N % 8
    assert kernel_path(x[:, :20].contiguous(), dy, kind="dw") == "scalar"   # K % 8
    assert kernel_path(x[:0], dy[:0], kind="dw") == "scalar"           # no rows
    assert kernel_path(dy.float(), w.float(), kind="dx") == "scalar"
    assert kernel_path(x.float(), dy.float(), kind="dw") == "scalar"
    from repro_torch.kernels.grouped_matmul import grouped_matmul_dw, grouped_matmul_dx

    gs = torch.tensor([20, 0, 44], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="does not fit"):
        grouped_matmul_dx(dy[:, :40].contiguous(), w, gs)
    with pytest.raises(ValueError, match="does not fit"):
        grouped_matmul_dw(x, dy[:10].contiguous(), gs)
    with pytest.raises(ValueError, match="dtype"):
        grouped_matmul_dw(x, dy.float(), gs)
    with pytest.raises(ValueError, match="contiguous"):
        grouped_matmul_dx(dy.T.contiguous().T, w, gs)
    with pytest.raises(ValueError, match="CUDA"):
        grouped_matmul_dx(dy.cpu(), w.cpu(), gs.cpu())
    # no rows: every group's dw is 0, written by the kernel
    dw = grouped_matmul_dw(x[:0], dy[:0], gs)
    torch.cuda.synchronize()
    assert dw.shape == (3, 32, 48) and bool((dw == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("needs", ["x", "w", "both"])
def test_gmm_autograd_function_matches_plain_autograd(sm90, dtype, needs):
    """ops.grouped_matmul under autograd on the card: the forward, dx and
    dw kernels (only those the inputs need), never waiting for the host,
    against autograd through grouped_matmul_ref."""
    from repro_torch.kernels.grouped_matmul import grouped_matmul_dw, grouped_matmul_dx

    sizes = [70, 0, 100, 20]
    x, w, gs = _gmm_inputs(200, 64, 136, sizes, dtype, seed=11)
    proj = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (200, 136)).astype(np.float32)).to("cuda")
    grads = {}
    for impl in ("torch", "cuda"):
        xi = x.clone().requires_grad_(needs in ("x", "both"))
        wi = w.clone().requires_grad_(needs in ("w", "both"))
        leaves = [t for t in (xi, wi) if t.requires_grad]
        before = [fn.launches for fn in (grouped_matmul, grouped_matmul_dx, grouped_matmul_dw)]
        torch.cuda.synchronize()
        if impl == "cuda":
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = ops.grouped_matmul(xi, wi, gs, impl=impl)
            grads[impl] = torch.autograd.grad((out.float() * proj).sum(), leaves)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        after = [fn.launches for fn in (grouped_matmul, grouped_matmul_dx, grouped_matmul_dw)]
        launched = [a - b for a, b in zip(after, before)]
        if impl == "cuda":
            assert launched == [1, int(needs != "w"), int(needs != "x")]
        else:
            assert launched == [0, 0, 0]
    for got, want in zip(grads["cuda"], grads["torch"]):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), **GMM_TOL[dtype])


@pytest.mark.cuda
def test_gmm_kernel_path_rule(sm90):
    from repro_torch.kernels.grouped_matmul import kernel_path

    x, w, _ = _gmm_inputs(64, 32, 48, [20, 0, 44], torch.bfloat16, seed=3)
    assert kernel_path(x, w) == "wgmma"
    assert kernel_path(x, w[..., :44].contiguous()) == "scalar"      # N % 8
    assert kernel_path(x[:, :20].contiguous(), w[:, :20].contiguous()) == "scalar"   # K % 8
    assert kernel_path(x.float(), w.float()) == "scalar"
    off = torch.empty(64 * 32 + 4, dtype=torch.bfloat16, device="cuda")[4:].view(64, 32)
    off.copy_(x)
    assert kernel_path(off, w) == "scalar"                           # 8-byte aligned x
    torch.testing.assert_close(grouped_matmul(off, w, torch.tensor(
        [20, 0, 44], dtype=torch.int32, device="cuda")).float(),
        grouped_matmul(x, w, torch.tensor([20, 0, 44], dtype=torch.int32,
                                          device="cuda")).float(),
        **GMM_TOL[torch.bfloat16])


@pytest.mark.cuda
def test_moe_ragged_layer_never_waits_for_the_host(sm90):
    """The ragged MoE layer (router, sort, group sizes, three grouped
    matmuls, combine) runs with synchronizing CUDA calls made errors."""
    import dataclasses

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import ffn
    from repro_torch.models.transformer import Model

    cfg = dataclasses.replace(get_smoke_config("dbrx_132b"), moe_num_experts=16,
                              moe_top_k=4)
    params = Model(cfg).init(0, device="cuda")
    p = {k: v[0] for k, v in params["blocks_0"]["ffn"].items() if k != "router"}
    p["router"] = {"w": params["blocks_0"]["ffn"]["router"]["w"][0]}
    x = torch.randn(2, 24, cfg.d_model, device="cuda", dtype=torch.bfloat16)
    want, _ = ffn.moe_block({k: (v.cpu() if torch.is_tensor(v) else
                                 {kk: vv.cpu() for kk, vv in v.items()})
                             for k, v in p.items()}, x.cpu(), cfg)
    before = grouped_matmul.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            got, _ = ffn.moe_block(p, x, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert grouped_matmul.launches == before + 3
    torch.testing.assert_close(got.float().cpu(), want.float(), atol=3e-2, rtol=3e-2)
