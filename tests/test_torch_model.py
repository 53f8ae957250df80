"""The port's dense model against the JAX model: loss and every gradient;
and every registry architecture's full-size parameter tree against the
JAX ``Model.init`` tree (``jax.eval_shape``, nothing allocated).

Weights come from the JAX ``Model.init`` through
``repro_torch.convert.params_from_numpy``; tokens are drawn with numpy
and fed to both. Tolerances:

* fp32 compute: the loss to 1e-5 relative, each gradient leaf to 1e-5
  in relative Frobenius norm (measured: ~1e-7 and ~2e-6; the rest is
  summation order);
* bf16 compute: the loss to 1e-3 relative, each gradient leaf to 0.1
  relative norm (the two frameworks round bf16 products and
  accumulations at different places; measured up to ~4e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models.transformer import Model as JaxModel
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models.module import _fold_path
from repro_torch.models.transformer import (
    SCAN_THRESHOLD,
    Model,
    _stack_builder,
    segment_layers,
)
from repro_torch.tree import flatten

TOL = {
    "float32": dict(loss=1e-5, grad=1e-5),
    "bfloat16": dict(loss=1e-3, grad=1e-1),
}


def _batch(vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(2, 33)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jax_loss_and_grads(cfg, batch):
    model = JaxModel(cfg)
    params = model.init(jax.random.key(0))
    (loss, _), grads = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}
    )
    return (
        jax.tree.map(np.asarray, params),
        float(loss),
        flatten(jax.tree.map(np.asarray, grads)),
    )


def _torch_loss_and_grads(cfg, np_params, batch):
    params = params_from_numpy(np_params, "cpu")
    leaves = flatten(params)
    for leaf in leaves.values():
        leaf.requires_grad_()
    loss, _ = Model(cfg).loss(params, {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {k: g.float().numpy() for k, g in zip(leaves, grads)}


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize(
    "arch,compute_dtype,num_layers",
    [
        ("internlm2_1_8b", "float32", None),
        ("internlm2_1_8b", "bfloat16", None),
        ("internlm2_1_8b", "float32", SCAN_THRESHOLD),   # a scanned segment
        ("granite_20b", "float32", None),    # layernorm, learned positions, tied
        ("nemotron_4_340b", "float32", None),  # squared ReLU, plain MLP
        ("gemma3_4b", "float32", None),   # local/global window, qk-norm
        ("gemma3_4b", "bfloat16", None),  # embed scale promotes to fp32
    ],
)
def test_loss_and_grads_match_jax(arch, compute_dtype, num_layers):
    kw = {"compute_dtype": compute_dtype}
    if num_layers:
        kw["num_layers"] = num_layers
    jcfg = dataclasses.replace(jax_smoke_config(arch), **kw)
    cfg = dataclasses.replace(get_smoke_config(arch), **kw)
    if num_layers == SCAN_THRESHOLD:
        assert [s.scanned for s in segment_layers(cfg)] == [True]
    batch = _batch(cfg.vocab_size)
    np_params, jloss, jgrads = _jax_loss_and_grads(jcfg, batch)
    tloss, tgrads = _torch_loss_and_grads(cfg, np_params, batch)

    tol = TOL[compute_dtype]
    assert np.isfinite(tloss)
    assert abs(tloss - jloss) <= tol["loss"] * abs(jloss), (tloss, jloss)
    assert tgrads.keys() == jgrads.keys()
    for path, want in jgrads.items():
        got = tgrads[path]
        assert got.shape == want.shape, path
        assert _rel(got, np.asarray(want, np.float32)) <= tol["grad"], path


def test_param_tree_matches_jax_keys_shapes_and_round_trips():
    jcfg = jax_smoke_config("internlm2_1_8b")
    cfg = get_smoke_config("internlm2_1_8b")
    jparams = jax.tree.map(np.asarray, JaxModel(jcfg).init(jax.random.key(0)))
    model = Model(cfg)
    shapes = {k: tuple(s) for k, (s, _) in flatten(model.param_shapes()).items()}
    assert shapes == {k: v.shape for k, v in flatten(jparams).items()}
    assert model.num_params() == JaxModel(jcfg).num_params()
    own = flatten(model.init(0, device="cpu"))
    assert {k: tuple(v.shape) for k, v in own.items()} == shapes
    back = flatten(params_to_numpy(params_from_numpy(jparams, "cpu")))
    for k, v in flatten(jparams).items():
        np.testing.assert_array_equal(back[k], v)


def test_own_init_is_seeded_and_lecun_scaled():
    cfg = get_smoke_config("internlm2_1_8b")
    a = flatten(Model(cfg).init(0, device="cpu"))
    b = flatten(Model(cfg).init(0, device="cpu"))
    c = flatten(Model(cfg).init(1, device="cpu"))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["blocks_0.mixer.wq.w"], c["blocks_0.mixer.wq.w"])
    # fan-in of a stacked (layers, d, h*hd) leaf is d, not layers * d
    wq = a["blocks_0.mixer.wq.w"]
    assert abs(float(wq.std()) - 1.0 / np.sqrt(cfg.d_model)) < 0.1 / np.sqrt(cfg.d_model)
    assert not torch.equal(wq[0], wq[1])      # layers drawn independently


@pytest.mark.parametrize("arch,experts", [
    ("internlm2_1_8b", None), ("mamba2_370m", None), ("dbrx_132b", 16),
])
def test_stacked_init_matches_per_layer_builder_init(arch, experts):
    # each stacked leaf, filled layer by layer in place, holds exactly what
    # the per-layer ParamBuilder.init draws from that layer's seed
    cfg = get_smoke_config(arch)
    if experts:
        cfg = dataclasses.replace(cfg, moe_num_experts=experts, moe_top_k=4)
    model = Model(cfg)
    params = model.init(3, device="cpu")
    for s, seg in enumerate(model.segments):
        builder = _stack_builder(cfg, seg)
        seed = _fold_path(3, f"blocks_{s}")
        stacked = flatten(params[f"blocks_{s}"])
        assert all(v.shape[0] == seg.count for v in stacked.values())
        for i in range(seg.count):
            layer = flatten(builder.init(_fold_path(seed, str(i)), "cpu")["layer"])
            assert layer.keys() == stacked.keys()
            for k, v in layer.items():
                assert torch.equal(stacked[k][i], v), (s, i, k)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_param_shapes_match_jax_eval_shape(arch):
    """Every registry architecture at its published size builds, and its
    parameter tree (keys, shapes, dtypes) is the JAX ``Model.init``
    tree, with nothing allocated on either side."""
    want = jax.eval_shape(JaxModel(jax_config(arch)).init, jax.random.key(0))
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in flatten(want).items()}
    got = {k: (tuple(s), str(d).removeprefix("torch."))
           for k, (s, d) in flatten(Model(get_config(arch)).param_shapes()).items()}
    assert got == want
