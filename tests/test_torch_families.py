"""The periodic, encoder-decoder and vision-prefix families against the
JAX package: jamba (hybrid Mamba / attention / MoE) and gemma3
(local:global), each at 2, 4 and 5 layers (plain segments, one periodic
segment, a periodic segment and a tail), whisper-base (encoder and
cross-attention) and internvl2 (vision prefix), at the smoke sizes.

Weights come from the JAX ``Model.init`` through
``repro_torch.convert``; inputs are drawn with numpy and fed to both.
Tolerances, as in ``tests/test_torch_model.py`` and
``tests/test_torch_serve.py``:

* loss and every gradient against ``jax.value_and_grad``: fp32 compute,
  the loss to 1e-5 relative and each gradient leaf to 1e-5 in relative
  Frobenius norm; bf16 compute 1e-3 and 0.1. Two Mamba leaves of jamba
  are held looser (``LEAF_TOL``), each as measured over data seeds 0-3:
  the fp32 ``mixer.A_log`` to 1e-4, as in ``tests/test_torch_ssm.py``
  (the scan's cumulative sums reorder fp32 sums: 1.9e-6 to 2.7e-5 port
  vs JAX, and up to 1.4e-5 between the JAX model's own jitted and eager
  runs), and the bf16 ``mixer.D`` to 0.15 (0.038 to 0.101 port vs JAX,
  0.033 to 0.044 JAX jitted vs eager: a sum over every position and
  channel of bf16 products that cancel);
* ``serve_forward`` prefill and one decode step (whisper with the
  encoder output in both, internvl2 with a prefix): the last logits and
  every cache leaf, the nested ``pos_j`` entries of a periodic segment
  included, to 2e-5 abs and 1e-5 rel at fp32; ``pos`` exactly;
* serving against the port's own teacher-forced ``forward`` at bf16:
  2e-2, as ``tests/test_arch_smoke.py`` does it for JAX;
* the frontend stubs of ``DecentralizedBatches``: bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.data.pipeline import DecentralizedBatches as JaxBatches
from repro.dist import serve as jax_serve
from repro.dist import sharding as shd
from repro.models.transformer import Model as JaxModel
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import caches_from_numpy, caches_to_numpy, params_from_numpy
from repro_torch.data.pipeline import DecentralizedBatches, to_bfloat16
from repro_torch.dist import serve as sv
from repro_torch.models.transformer import Model, PeriodicSegment
from repro_torch.tree import flatten

# case id -> (arch, num_layers or None for the smoke depth)
CASES = {
    "jamba-2": ("jamba_v0_1_52b", 2), "jamba-4": ("jamba_v0_1_52b", 4),
    "jamba-5": ("jamba_v0_1_52b", 5), "gemma3-2": ("gemma3_4b", 2),
    "gemma3-4": ("gemma3_4b", 4), "gemma3-5": ("gemma3_4b", 5),
    "whisper": ("whisper_base", None), "internvl2": ("internvl2_1b", None),
}
# segment kinds each case must build (P: periodic, S: plain)
LAYOUT = {2: "SS", 4: "P", 5: "PS"}
TOL = {"float32": dict(loss=1e-5, grad=1e-5), "bfloat16": dict(loss=1e-3, grad=1e-1)}
LEAF_TOL = {"float32": {".mixer.A_log": 1e-4}, "bfloat16": {".mixer.D": 0.15}}
SERVE_TOL = dict(atol=2e-5, rtol=1e-5)
B, S, MAX_LEN = 2, 24, 48


def _configs(case, **kw):
    arch, layers = CASES[case]
    if layers:
        kw["num_layers"] = layers
    return (dataclasses.replace(jax_smoke_config(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


@functools.lru_cache(maxsize=None)
def _jax_params(case):
    """JAX initial weights of a case (they do not depend on the compute
    dtype) and their numpy copy."""
    jcfg, _ = _configs(case)
    jparams = jax.jit(JaxModel(jcfg).init)(jax.random.key(0))
    return jparams, jax.tree.map(np.asarray, jparams)


def _frontend(cfg, seed=1):
    """A frontend model's stub input, bf16 as the pipeline makes it:
    ``(batch key, numpy float64 draw)`` or ``(None, None)``."""
    key = {"vision": "prefix_embeddings", "audio": "encoder_frames"}.get(cfg.frontend)
    if key is None:
        return None, None
    draw = np.random.default_rng(seed).normal(
        size=(B, cfg.encoder_seq, cfg.frontend_dim))
    return key, draw


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("case,dtype,remat", [
    *[(c, "float32", True) for c in CASES],
    ("jamba-4", "bfloat16", True), ("gemma3-5", "bfloat16", True),
    ("whisper", "bfloat16", True), ("internvl2", "bfloat16", True),
    ("gemma3-4", "float32", False),       # the periodic loop without checkpoints
])
def test_loss_and_grads_match_jax(case, dtype, remat):
    jcfg, cfg = _configs(case, compute_dtype=dtype, remat=remat)
    model = Model(cfg)
    if CASES[case][1]:
        kinds = "".join("P" if isinstance(s, PeriodicSegment) else "S"
                        for s in model.segments)
        assert kinds == LAYOUT[CASES[case][1]], kinds
    jparams, np_params = _jax_params(case)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(B, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    key, draw = _frontend(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    if key:
        jbatch[key] = jnp.asarray(draw, jnp.bfloat16)
        tbatch[key] = to_bfloat16(draw)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(JaxModel(jcfg).loss, has_aux=True))(
        jparams, jbatch)
    jgrads = flatten(jax.tree.map(np.asarray, jgrads))

    params = params_from_numpy(np_params, "cpu")
    leaves = flatten(params)
    for leaf in leaves.values():
        leaf.requires_grad_()
    loss, _ = model.loss(params, tbatch)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    tol = TOL[dtype]
    jloss, loss = float(jloss), float(loss.detach())
    assert np.isfinite(loss)
    assert abs(loss - jloss) <= tol["loss"] * abs(jloss), (loss, jloss)
    assert grads.keys() == jgrads.keys()
    for path, want in jgrads.items():
        got = grads[path].float().numpy()
        assert got.shape == want.shape, path
        bound = next((b for end, b in LEAF_TOL[dtype].items() if path.endswith(end)),
                     tol["grad"])
        assert _rel(got, np.asarray(want, np.float32)) <= bound, path


def _close_caches(got, want):
    got, want = flatten(dict(enumerate(got))), flatten(dict(enumerate(want)))
    assert got.keys() == want.keys()
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        assert got[path].shape == w.shape, path
        if path.endswith(".pos"):
            np.testing.assert_array_equal(got[path], w, err_msg=path)
        else:
            np.testing.assert_allclose(got[path], w, err_msg=path, **SERVE_TOL)


def _serve_inputs(jm, model, jparams, params, cfg):
    """Per-package keyword arguments of a prefill and of a decode step
    (whisper: the encoder output of the same frames, in both; internvl2:
    a prefix in the prefill) and the prefix length."""
    key, draw = _frontend(cfg)
    if key == "encoder_frames":
        jenc = jm._encode(jparams, jnp.asarray(draw, jnp.bfloat16))
        with torch.inference_mode():
            tenc = model._encode(params, to_bfloat16(draw))
        np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), **SERVE_TOL)
        j, t = dict(encoder_out=jenc), dict(encoder_out=tenc)
        return (j, t), (j, t), 0
    if key == "prefix_embeddings":
        return ((dict(prefix_embeddings=jnp.asarray(draw, jnp.bfloat16)),
                 dict(prefix_embeddings=to_bfloat16(draw))), ({}, {}), cfg.encoder_seq)
    return ({}, {}), ({}, {}), 0


@pytest.mark.parametrize("case", list(CASES))
def test_serve_forward_matches_jax(case):
    jcfg, cfg = _configs(case, compute_dtype="float32")
    jm, model = JaxModel(jcfg), Model(cfg)
    jparams, np_params = _jax_params(case)
    params = params_from_numpy(np_params, "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    (jpre, tpre), (jdec, tdec), P = _serve_inputs(jm, model, jparams, params, cfg)

    jserve = jax.jit(jm.serve_forward, static_argnames="max_len")
    jc = jm.init_cache(B, MAX_LEN)
    caches = model.init_cache(B, MAX_LEN, device="cpu")
    _close_caches(caches_to_numpy(caches), jax.tree.map(np.asarray, jc))

    jl, jc = jserve(jparams, jnp.asarray(toks[:, :S]), jc, start_position=0,
                    max_len=MAX_LEN, **jpre)
    with torch.inference_mode():
        tl, caches = model.serve_forward(params, torch.as_tensor(toks[:, :S]), caches,
                                         start_position=0, max_len=MAX_LEN, **tpre)
    assert tl.shape == (B, 1, cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **SERVE_TOL)
    jc_prefill = jax.tree.map(np.asarray, jc)
    _close_caches(caches_to_numpy(caches), jc_prefill)

    # one decode step each, the port's from the JAX prefill's caches
    # carried across (the nested periodic entries included)
    jd, jc = jserve(jparams, jnp.asarray(toks[:, S:]), jc, start_position=P + S,
                    max_len=MAX_LEN, **jdec)
    caches = caches_from_numpy(jc_prefill, "cpu")
    with torch.inference_mode():
        td, caches = model.serve_forward(params, torch.as_tensor(toks[:, S:]), caches,
                                         start_position=P + S, max_len=MAX_LEN, **tdec)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **SERVE_TOL)
    _close_caches(caches_to_numpy(caches), jax.tree.map(np.asarray, jc))


@pytest.mark.parametrize("case", list(CASES))
def test_serve_consistency_with_forward(case):
    cfg = _configs(case)[1]
    model = Model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.as_tensor(
        np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32))
    key, draw = _frontend(cfg, seed=6)
    fwd, pre, dec, P = {}, {}, {}, 0
    with torch.no_grad():
        if key == "encoder_frames":
            fwd = dict(encoder_frames=to_bfloat16(draw))
            pre = dec = dict(encoder_out=model._encode(params, to_bfloat16(draw)))
        elif key == "prefix_embeddings":
            fwd = pre = dict(prefix_embeddings=to_bfloat16(draw))
            P = cfg.encoder_seq
        ref, _ = model.forward(params, toks, **fwd)
        caches = model.init_cache(B, 64, device="cpu")
        lp, caches = model.serve_forward(params, toks[:, :S], caches, start_position=0,
                                         max_len=64, **pre)
        ld, _ = model.serve_forward(params, toks[:, S:], caches, start_position=P + S,
                                    max_len=64, **dec)
    assert ref.shape == (B, S + 1, cfg.padded_vocab)
    torch.testing.assert_close(lp[:, 0].float(), ref[:, S - 1].float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(ld[:, 0].float(), ref[:, S].float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("case", ["whisper", "internvl2"])
def test_step_builders_match_jax(case):
    """The prefill-step builders with ``encoder_frames`` /
    ``prefix_embeddings``, then one decode step from each builder (no
    encoder output there, in either package)."""
    jcfg, cfg = _configs(case, compute_dtype="float32")
    jm, model = JaxModel(jcfg), Model(cfg)
    jparams, np_params = _jax_params(case)
    params = params_from_numpy(np_params, "cpu")
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rules = shd.serve_rules(mesh, jcfg)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    key, draw = _frontend(cfg)
    P = cfg.encoder_seq if key == "prefix_embeddings" else 0

    jl, jc = jax.jit(jax_serve.make_prefill_step(jm, rules, max_len=MAX_LEN))(
        jparams, jnp.asarray(toks[:, :S]), jm.init_cache(B, MAX_LEN),
        **{key: jnp.asarray(draw, jnp.bfloat16)})
    tl, caches = sv.make_prefill_step(model, max_len=MAX_LEN)(
        params, torch.as_tensor(toks[:, :S]), model.init_cache(B, MAX_LEN, device="cpu"),
        **{key: to_bfloat16(draw)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **SERVE_TOL)
    _close_caches(caches_to_numpy(caches), jax.tree.map(np.asarray, jc))

    jd, jc = jax.jit(jax_serve.make_decode_step(jm, rules, max_len=MAX_LEN))(
        jparams, jnp.asarray(toks[:, S:]), jc, jnp.int32(P + S))
    td, caches = sv.make_decode_step(model, max_len=MAX_LEN)(
        params, torch.as_tensor(toks[:, S:]), caches, P + S)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **SERVE_TOL)
    _close_caches(caches_to_numpy(caches), jax.tree.map(np.asarray, jc))


@pytest.mark.parametrize("arch,key", [("whisper_base", "encoder_frames"),
                                      ("internvl2_1b", "prefix_embeddings")])
@pytest.mark.parametrize("iid", [True, False], ids=["iid", "non_iid"])
def test_batches_with_frontend_stubs_are_bit_equal_to_jax(arch, key, iid):
    jdata = JaxBatches(jax_smoke_config(arch), 3, 2, 8, iid=iid, seed=4)
    data = DecentralizedBatches(get_smoke_config(arch), 3, 2, 8, iid=iid, seed=4,
                                device="cpu")
    cfg = get_smoke_config(arch)
    for _ in range(2):
        want, got = next(jdata), next(data)
        assert got.keys() == want.keys() == {"tokens", "labels", key}
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        stub = got[key]
        assert stub.dtype == torch.bfloat16
        assert stub.shape == (3, 2, cfg.encoder_seq, cfg.frontend_dim)
        np.testing.assert_array_equal(stub.view(torch.int16).numpy(),
                                      np.asarray(want[key]).view(np.int16))


def test_bf16_stub_rounding_matches_jax_at_a_double_rounding_tie():
    # 1 + 2^-8 + 2^-30 rounds up to 1 + 2^-7 straight from float64, but
    # to 1 through float32 (1 + 2^-8 is a tie, broken to even): both
    # packages take the float32 step
    x = np.array([1.0 + 2.0**-8 + 2.0**-30, -(1.0 + 2.0**-8 + 2.0**-30), 3.3, 1e-40])
    np.testing.assert_array_equal(to_bfloat16(x).view(torch.int16).numpy(),
                                  np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.int16))
    assert float(to_bfloat16(x)[0]) == 1.0


def test_positions_past_max_len_or_max_position_raise_named_errors():
    """JAX drops out-of-range cache writes and clamps learned-position
    gathers; the port refuses both, naming the cause."""
    cfg = get_smoke_config("whisper_base")          # learned table of 128
    model = Model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    caches = model.init_cache(1, 8, device="cpu")
    with pytest.raises(ValueError, match="max_len 8"):
        model.serve_forward(params, toks, caches, start_position=6, max_len=8)
    caches = model.init_cache(1, 200, device="cpu")
    with pytest.raises(ValueError, match="max_position"):
        model.serve_forward(params, toks, caches, start_position=126, max_len=200)
    with pytest.raises(ValueError, match="max_position"):
        model.forward(params, torch.zeros((1, 129), dtype=torch.int32))


def test_mamba_decodes_past_max_len_like_jax():
    """A model with no full-length KV cache (every cache a Mamba state)
    has no end: it serves past ``max_len`` as the JAX model does."""
    kw = dict(compute_dtype="float32")
    jcfg = dataclasses.replace(jax_smoke_config("mamba2_370m"), **kw)
    cfg = dataclasses.replace(get_smoke_config("mamba2_370m"), **kw)
    jm, model = JaxModel(jcfg), Model(cfg)
    jparams = jm.init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, 10)).astype(np.int32)
    jc, caches = jm.init_cache(B, 8), model.init_cache(B, 8, device="cpu")
    for start, sl in ((0, slice(0, 6)), *((i, slice(i, i + 1)) for i in range(6, 10))):
        jl, jc = jm.serve_forward(jparams, jnp.asarray(toks[:, sl]), jc,
                                  start_position=start, max_len=8)
        with torch.inference_mode():
            tl, caches = model.serve_forward(params, torch.as_tensor(toks[:, sl]), caches,
                                             start_position=start, max_len=8)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **SERVE_TOL)
    _close_caches(caches_to_numpy(caches), jax.tree.map(np.asarray, jc))


def test_sinusoidal_positions_match_jax():
    """The sinusoidal position branch (no registry model uses it): the
    forward over ``start_position + S`` rows of the table, serving over
    ``max_len`` rows."""
    kw = dict(compute_dtype="float32", pos_embed="sinusoidal")
    jcfg = dataclasses.replace(jax_smoke_config("internlm2_1_8b"), **kw)
    cfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), **kw)
    jm, model = JaxModel(jcfg), Model(cfg)
    jparams = jm.init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    jl, _ = jm.forward(jparams, jnp.asarray(toks[:, :S]), start_position=5)
    with torch.inference_mode():
        tl, _ = model.forward(params, torch.as_tensor(toks[:, :S]), start_position=5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **SERVE_TOL)
    jc, caches = jm.init_cache(B, MAX_LEN), model.init_cache(B, MAX_LEN, device="cpu")
    for start, sl in ((0, slice(0, S)), (S, slice(S, S + 1))):
        jl, jc = jm.serve_forward(jparams, jnp.asarray(toks[:, sl]), jc,
                                  start_position=start, max_len=MAX_LEN)
        with torch.inference_mode():
            tl, caches = model.serve_forward(params, torch.as_tensor(toks[:, sl]), caches,
                                             start_position=start, max_len=MAX_LEN)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **SERVE_TOL)
    _close_caches(caches_to_numpy(caches), jax.tree.map(np.asarray, jc))


def test_periodic_init_folds_each_position_seed_like_jax():
    """A periodic segment's ``pos_j`` sub-trees are each stacked over
    the repeats and drawn from the seed folded from ``blocks_{s}_pos_{j}``."""
    from repro_torch.models.module import _fold_path
    from repro_torch.models.transformer import _stack_builder

    cfg = dataclasses.replace(get_smoke_config("jamba_v0_1_52b"), num_layers=5)
    model = Model(cfg)
    params = model.init(7, device="cpu")
    seg = model.segments[0]
    assert isinstance(seg, PeriodicSegment) and (seg.period, seg.reps) == (2, 2)
    assert set(params["blocks_0"]) == {"pos_0", "pos_1"}
    for j, sub in enumerate(seg.pattern):
        seed = _fold_path(7, f"blocks_0_pos_{j}")
        stacked = flatten(params["blocks_0"][f"pos_{j}"])
        for r in range(seg.reps):
            layer = flatten(_stack_builder(cfg, sub).init(_fold_path(seed, str(r)), "cpu")["layer"])
            assert layer.keys() == stacked.keys()
            for k, v in layer.items():
                assert torch.equal(stacked[k][r], v), (j, r, k)
    assert flatten(model.param_shapes()).keys() == flatten(params).keys()
