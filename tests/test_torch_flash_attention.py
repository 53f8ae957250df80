"""The port's ``ops.attention`` against the JAX flash-attention kernel.

On the CPU ``ops.attention(impl="auto")`` is the plain version
(``repro_torch.kernels.ref.attention_ref``); it is held to the JAX Pallas
kernel run through ``repro.kernels.ops.attention(impl="interpret")`` and
to the JAX oracle ``repro.kernels.ref.attention_ref``, on the same numpy
inputs and the shapes of ``tests/test_kernels.py``: the block sweep, the
padding wrapper, pad masking under causal and window masks, and rows
that are fully masked within a tile. Every ``head_dim`` of the model
registry is one of the kernel's compiled widths, and the smoke
nemotron, kimi and gemma3 models at their published widths (192, 112,
256) prefill through ``ops.attention`` in agreement with JAX.

Tolerances: fp32 2e-5 abs and rel (summation order only, as in
``tests/test_kernels.py``); bf16 inputs 2e-2 (the outputs are rounded to
bf16 from slightly different fp32 sums, one bf16 step apart at most).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops

TOL = {"float32": dict(atol=2e-5, rtol=2e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _inputs(B, Sq, Sk, Hq, Hkv, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd))]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _check(jx, tx, dtype, *, causal, window, jax_kw):
    got = ops.attention(*tx, causal=causal, window=window)
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    got = got.float().numpy()
    kernel = jops.attention(*jx, causal=causal, window=window, impl="interpret", **jax_kw)
    oracle = jref.attention_ref(*jx, causal=causal, window=window)
    for want in (kernel, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,Hq,Hkv,hd,bq,bk",
    [
        (1, 128, 4, 4, 64, 64, 64),     # MHA
        (2, 256, 8, 2, 64, 128, 64),    # GQA 4:1
        (1, 192, 6, 1, 32, 64, 64),     # MQA, ragged grid
        (2, 64, 4, 4, 128, 32, 32),     # wide heads
        (1, 128, 8, 1, 112, 64, 64),    # kimi-k2's width, GQA 8:1
        (1, 128, 12, 1, 192, 64, 64),   # nemotron-4-340b's width, GQA 12:1
        (2, 128, 4, 2, 256, 64, 64),    # gemma3-4b's width, GQA 2:1
    ],
)
def test_attention_sweep_matches_jax_kernel(B, S, Hq, Hkv, hd, bq, bk, dtype):
    jx, tx = _inputs(B, S, S, Hq, Hkv, hd, dtype, seed=0)
    for causal, window in [(True, 0), (True, S // 4), (False, 0)]:
        _check(jx, tx, dtype, causal=causal, window=window,
               jax_kw=dict(block_q=bq, block_k=bk))


def test_attention_ragged_length_needs_no_padding():
    """S = 100 does not divide the JAX wrapper's 64-blocks: it pads and
    masks; the port's wrapper takes the ragged length as it is."""
    jx, tx = _inputs(1, 100, 100, 4, 4, 64, "float32", seed=1)
    _check(jx, tx, "float32", causal=True, window=0, jax_kw=dict(block_q=64, block_k=64))


@pytest.mark.parametrize("causal,window", [(False, 0), (False, 24), (True, 24)])
@pytest.mark.parametrize("Sq,Sk", [(100, 100), (64, 100), (37, 130)])
def test_attention_pad_masking_parity(Sq, Sk, causal, window):
    jx, tx = _inputs(2, Sq, Sk, 4, 4, 32, "float32", seed=3)
    _check(jx, tx, "float32", causal=causal, window=window,
           jax_kw=dict(block_q=64, block_k=64))


def test_attention_rows_masked_within_a_tile():
    """A window smaller than the JAX kernel's block: early rows of late
    blocks see no live key in some tiles. Finite, and equal to JAX."""
    jx, tx = _inputs(1, 128, 128, 2, 2, 32, "float32", seed=2)
    got = ops.attention(*tx, causal=True, window=8)
    assert bool(torch.isfinite(got).all())
    _check(jx, tx, "float32", causal=True, window=8, jax_kw=dict(block_q=32, block_k=32))


def test_attention_dispatch_modes():
    _, tx = _inputs(1, 16, 16, 2, 1, 32, "float32", seed=4)
    torch.testing.assert_close(ops.attention(*tx), ops.attention(*tx, impl="torch"),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(*tx, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.attention(*tx, impl="pallas")
    assert jax.default_backend() == "cpu"


def test_every_registry_head_dim_is_a_compiled_width():
    """The card's kernel is compiled for each width it may be handed: a
    registry model whose head_dim is missing would raise at its prefill."""
    from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
    from repro_torch.kernels.flash_attention import HEAD_DIMS

    widths = {get_config(a).head_dim for a in ARCH_IDS if get_config(a).num_heads}
    widths |= {get_smoke_config(a).head_dim for a in ARCH_IDS if get_smoke_config(a).num_heads}
    assert {112, 192, 256} <= widths
    assert widths <= set(HEAD_DIMS), sorted(widths - set(HEAD_DIMS))


@pytest.mark.parametrize("arch,hd", [("nemotron_4_340b", 192), ("kimi_k2_1t_a32b", 112),
                                     ("gemma3_4b", 256)])
def test_prefill_at_the_wide_registry_widths_matches_jax(monkeypatch, arch, hd):
    """The smoke model at its published head_dim, fp32: the port's
    prefill runs each layer's attention through ``ops.attention`` (the
    kernel's plain version on the CPU) and agrees with the JAX
    ``serve_forward`` (2e-5 abs, 1e-5 rel: summation order, as in
    ``tests/test_torch_serve.py``)."""
    import dataclasses

    from repro.configs.registry import get_smoke_config as jax_smoke_config
    from repro.models.transformer import Model as JaxModel
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist import serve as sv
    from repro_torch.models.transformer import Model

    over = dict(head_dim=hd, compute_dtype="float32")
    jcfg = dataclasses.replace(jax_smoke_config(arch), **over)
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    jm, model = JaxModel(jcfg), Model(cfg)
    jparams = jm.init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    B, S, max_len = 2, 24, 32
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)

    widths = []
    attention = ops.attention

    def spy(q, k, v, **kw):
        widths.append(q.shape[-1])
        return attention(q, k, v, **kw)

    monkeypatch.setattr(ops, "attention", spy)
    got, _ = sv.make_prefill_step(model, max_len=max_len)(
        params, torch.as_tensor(toks), model.init_cache(B, max_len, device="cpu"))
    assert widths == [hd] * cfg.num_layers
    want, _ = jm.serve_forward(jparams, jnp.asarray(toks), jm.init_cache(B, max_len),
                               start_position=0, max_len=max_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)
