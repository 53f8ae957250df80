"""Tensor parallel in the port: the logical-axis rules, the converter and
gloo worlds over the ``model`` axis, against the JAX package.

In process:

* the rules: for all ten registry configs at T 2, 4 and 16, the dim the
  port splits in each parameter leaf is the one JAX's
  ``logical_to_pspec(model.logical_axes())`` maps to ``model``, and the
  port's cache specs are JAX's ``cache_shardings`` (both JAX functions
  called with a duck-typed mesh: they read only ``axis_names`` and
  ``shape``);
* ``convert.shard_params`` / ``gather_params`` and ``shard_caches`` /
  ``gather_caches`` are each other's inverse.

Over gloo, each world spawned once by ``tests/torch_dist_worker.py``
under its own timeout, from the JAX package's weights (written by this
process, which computes the JAX results while the world runs):

* ``m2`` (T 2), per model kind (dense GQA internlm2, dbrx with 4 experts
  and with 16 experts top-4, mamba2, jamba and gemma3 at 4 layers,
  whisper, internvl2): the loss and every gradient leaf, joined from the
  ranks' slices, against ``jax.value_and_grad`` of ``Model.loss``; a
  prefill, one decode step and every joined cache against the JAX
  ``serve_forward`` (no rules); 3 masked steps against the port's
  single-process step;
* ``m4`` (T 4): tiny internlm2, whose 2 kv heads do not divide 4 (the
  ``kv_in`` branch), loss and gradients against JAX;
* ``d2m2``: nodes over two data ranks at T 2 (masked, static, overlap)
  against the single-process step, and serving with the batch split
  over the data ranks against JAX;
* ``s2m2``: the streamed FSDP step at S 2 x T 2 against the
  single-process step.

Tolerances, fp32, with what a CPU run measured: the JAX package and the
port sum in other orders, and T changes the order of the row-parallel
sums. Against JAX: the loss within 1e-6 relative (measured 7.7e-8 at
most), every gradient leaf within 5e-6 relative norm (measured 3.0e-6
at most) and Mamba's ``A_log`` within 2e-5 (measured 5.4e-6; 1e-4 in
the one-device ``tests/test_torch_families.py``), serving within 2e-5
abs / 1e-5 rel as one device (measured 9e-7 on the logits). Against
the port's single-process step after 3 steps: params within 1e-6
(measured 1.2e-7), loss within 2e-6 (measured 9.5e-7: two fp32 ulps of
a loss near 6.3), consensus within 1e-6 (measured 3e-8).
"""
import dataclasses
import os
import sys
import threading
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jax_config
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.dist import serve as jax_serve
from repro.dist import sharding as jshd
from repro.models.transformer import Model as JaxModel
from repro_torch.configs.registry import get_config
from repro_torch.convert import (
    gather_caches,
    gather_params,
    params_from_numpy,
    shard_caches,
    shard_params,
)
from repro_torch.dist import serve as sv
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import Mesh
from repro_torch.models.module import split_of
from repro_torch.models.transformer import Model
from repro_torch.tree import flatten, tree_items

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_worker as w  # noqa: E402

LOSS_RTOL, GRAD_RTOL = 1e-6, 5e-6
LEAF_TOL = {".mixer.A_log": 2e-5}
SERVE_TOL = dict(atol=2e-5, rtol=1e-5)
STEP_TOL = {"params": 1e-6, "loss": 2e-6, "consensus": 1e-6}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _duck_mesh(T: int):
    return types.SimpleNamespace(axis_names=("data", "model"), shape={"data": 1, "model": T})


def _jax_specs(tree, is_spec):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_spec)[0]}


# ---------------------------------------------------------------------------
# In process: rules and the converter
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_split_dims_and_cache_specs_follow_the_jax_rules(arch):
    jm, model = JaxModel(jax_config(arch)), Model(get_config(arch))
    with shd.no_rules():
        shapes = dict(tree_items(model.param_shapes()))
    axes = dict(tree_items(model.logical_axes()))
    jaxes = _jax_specs(jm.logical_axes(), lambda v: isinstance(v, tuple))
    assert axes == {k: tuple(v) for k, v in jaxes.items()}
    jcaches = jax_serve.abstract_caches(jm, 1, 2)
    is_spec = lambda v: isinstance(v, jax.sharding.PartitionSpec)
    for T in (2, 4, 16):
        mesh = _duck_mesh(T)
        jr, tr = jshd.serve_rules(mesh, jax_config(arch)), shd.serve_rules(mesh, get_config(arch))
        assert tr.mapping == jr.mapping
        want = _jax_specs(jshd.param_pspecs(jm.logical_axes(), jr), is_spec)
        for path, a in axes.items():
            spec = tuple(want[path]) + (None,) * (len(a) - len(want[path]))
            d = split_of(a, shapes[path][0], tr)
            assert d == (spec.index("model") if "model" in spec else None), (T, path)
            assert shd.param_pspecs({"x": a}, tr)["x"] == spec, (T, path)
        got = flatten({str(i): c for i, c in enumerate(sv.cache_shardings(model, tr))})
        jspecs = _jax_specs(jax_serve.cache_shardings(jm, jr, jcaches), is_spec)
        assert got.keys() == jspecs.keys()
        for path, spec in jspecs.items():
            assert got[path] == spec + (None,) * (len(got[path]) - len(spec)), (T, path)


def test_sequence_parallel_and_the_pod_axis_map_as_jax():
    cfg, jcfg = get_config("internlm2_1_8b"), jax_config("internlm2_1_8b")
    got = shd.train_rules(_duck_mesh(2), cfg, sequence_parallel=True).mapping
    assert got == jshd.train_rules(_duck_mesh(2), jcfg, sequence_parallel=True).mapping
    assert got["seq_res"] == "model" and got["kv_seq"] is None
    pod = types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                shape={"pod": 2, "data": 1, "model": 2})
    got = shd.serve_rules(pod, cfg, multi_pod=True, kv_seq_sharded=True).mapping
    assert got == jshd.serve_rules(pod, jcfg, multi_pod=True, kv_seq_sharded=True).mapping
    assert got["batch"] == ("pod", "data") and got["kv_seq"] == "model"


@pytest.mark.parametrize("routed", ["spread", "elsewhere"])
def test_expert_parallel_dispatch_adds_up_to_the_whole(routed, monkeypatch):
    """The ragged dispatch over each half of the experts (a rank's expert
    weights; only the pairs routed there, the buffers sized to them) adds
    up to the whole dispatch, in values and in the gradients of a linear
    loss; a half no pair reaches gives zeros and zero gradients."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import ffn

    cfg = dataclasses.replace(get_smoke_config("dbrx_132b"), moe_num_experts=16,
                              moe_top_k=4, compute_dtype="float32")
    E, D, F, T = 16, cfg.d_model, cfg.moe_d_ff or cfg.d_ff, 12
    gen = torch.Generator().manual_seed(0)
    p = {k: (torch.randn(s, generator=gen) / s[1] ** 0.5).requires_grad_()
         for k, s in (("w1", (E, D, F)), ("w3", (E, D, F)), ("w2", (E, F, D)))}
    x = torch.randn(T, D, generator=gen).requires_grad_()
    c = torch.randn(T, D, generator=gen)
    gates = torch.softmax(torch.randn(T, 4, generator=gen), -1)
    first = 0 if routed == "spread" else 8        # "elsewhere": every pair in the upper half
    idx = torch.stack([torch.randperm(E - first, generator=gen)[:4] + first
                       for _ in range(T)])

    rows = []
    gmm = ffn.ops.grouped_matmul
    monkeypatch.setattr(ffn.ops, "grouped_matmul",
                        lambda a, *r, **k: rows.append(a.shape[0]) or gmm(a, *r, **k))

    def run(lo, hi):
        experts = (lo, hi) if hi - lo < E else None
        rows.clear()
        y = ffn._moe_ragged({k: v[lo:hi] for k, v in p.items()}, x, gates, idx, cfg, experts)
        pairs = int(((idx >= lo) & (idx < hi)).sum())
        assert rows == [max(pairs, 1)] * 3, (lo, hi, rows)      # w1, w3, w2
        return [y.detach()] + list(torch.autograd.grad((y * c).sum(), [x, *p.values()]))

    whole, lo, hi = run(0, E), run(0, 8), run(8, E)
    for a, b, want in zip(lo, hi, whole):
        assert torch.allclose(a + b, want, atol=1e-5, rtol=1e-5)
    for a, b in zip(lo[2:], hi[2:]):                # each half's experts only
        assert torch.count_nonzero(a[8:]) == 0 and torch.count_nonzero(b[:8]) == 0
    if routed == "elsewhere":
        assert all(torch.count_nonzero(t) == 0 for t in lo)


@pytest.mark.parametrize("case", list(w.TP_CASES))
def test_shard_then_gather_is_the_identity(case):
    cfg = w.tp_config(case)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    caches = model.init_cache(2, 8, device="cpu")
    for c in caches:
        for path, a in tree_items(c):
            if a.is_floating_point():
                a.copy_(torch.randn(a.shape))
    for T in (2, 4):
        mesh = Mesh(1, 1, model=T)
        rules = shd.train_rules(mesh, cfg)
        parts = [shard_params(params, model, rules, r) for r in range(T)]
        whole = gather_params(parts, model, rules)
        for path, a in flatten(params).items():
            assert torch.equal(flatten(whole)[path], a), (T, path)
        # each rank's slices have the shapes the rank's own init gives
        for r in range(T):
            with shd.use_rules(shd.ShardingRules(Mesh(1, 1, rank=r, model=T), rules.mapping)):
                local = Model(cfg).param_shapes()
            assert {k: tuple(v.shape) for k, v in flatten(parts[r]).items()} == {
                k: tuple(s) for k, (s, _) in flatten(local).items()}
        cparts = [shard_caches(caches, model, rules, r) for r in range(T)]
        back = gather_caches(cparts, model, rules)
        for g, c in zip(back, caches):
            for path, a in flatten(c).items():
                assert torch.equal(flatten(g)[path], a), (T, path)
        r_rules = shd.ShardingRules(Mesh(1, 1, rank=1, model=T), rules.mapping)
        with shd.use_rules(r_rules):
            local = model.init_cache(2, 8, device="cpu")
        for g, c in zip(cparts[1], local):
            assert {k: tuple(v.shape) for k, v in flatten(g).items()} == {
                k: tuple(v.shape) for k, v in flatten(c).items()}


# ---------------------------------------------------------------------------
# The JAX side of the worlds
# ---------------------------------------------------------------------------
def _jax_case(case):
    arch, over = w.TP_CASES[case]
    return dataclasses.replace(jax_smoke_config(arch), compute_dtype="float32", **over)


def _cases_in_threads(fn) -> dict:
    """``fn(case)`` for every case, in threads: XLA compiles outside the GIL."""
    with ThreadPoolExecutor(4) as pool:
        return dict(zip(w.TP_CASES, pool.map(fn, w.TP_CASES)))


def _write_inputs(data: str) -> dict:
    """Per case: the JAX weights, the batch, the serving tokens and the
    frontend stub, written for the ranks; kept here for the JAX runs."""
    return _cases_in_threads(lambda case: _write_case(data, case))


def _write_case(data: str, case: str):
    """One case's inputs, written; returned for the JAX run."""
    jcfg = _jax_case(case)
    jparams = jax.jit(JaxModel(jcfg).init)(jax.random.key(0))
    np_params = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (w.TP_B, w.TP_S + 1)).astype(np.int32)
    stoks = rng.integers(0, jcfg.vocab_size, (w.TP_B, w.TP_SERVE + 1)).astype(np.int32)
    flat = {f"p/{k}": v for k, v in flatten(np_params).items()}
    flat.update({"b/tokens": toks[:, :-1], "b/labels": toks[:, 1:], "s/tokens": stoks})
    key = {"vision": "prefix_embeddings", "audio": "encoder_frames"}.get(jcfg.frontend)
    draw = None
    if key:
        draw = np.random.default_rng(1).normal(
            size=(w.TP_B, jcfg.encoder_seq, jcfg.frontend_dim))
        flat.update({"f/key": np.array(key), "f/draw": draw})
    np.savez(os.path.join(data, f"{case}.in.npz"), **flat)
    return jcfg, jparams, toks, stoks, key, draw


def _jax_results(inputs) -> dict:
    """Per case: JAX's loss and gradients, and its prefill and decode
    logits and caches."""
    return _cases_in_threads(lambda case: _jax_case_results(*inputs[case]))


def _jax_case_results(jcfg, jparams, toks, stoks, key, draw) -> dict:
    """One case's JAX loss, gradients, logits and caches."""
    jm = JaxModel(jcfg)
    batch = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    front = {} if key is None else {key: jnp.asarray(draw, jnp.bfloat16)}
    (loss, _), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jparams, {**batch, **front})
    serve = jax.jit(jm.serve_forward, static_argnames="max_len")
    pre = {}
    if key == "encoder_frames":
        pre = {"encoder_out": jm._encode(jparams, front[key])}
    elif key == "prefix_embeddings":
        pre = dict(front)
    lp, jc = serve(jparams, jnp.asarray(stoks[:, :w.TP_SERVE]),
                   jm.init_cache(w.TP_B, w.TP_MAX_LEN), start_position=0,
                   max_len=w.TP_MAX_LEN, **pre)
    c_pre = jax.tree.map(np.asarray, jc)
    start = w.TP_SERVE + (jcfg.encoder_seq if key == "prefix_embeddings" else 0)
    ld, jc = serve(jparams, jnp.asarray(stoks[:, w.TP_SERVE:]), jc, start_position=start,
                   max_len=w.TP_MAX_LEN)
    return dict(loss=float(loss), grads=flatten(jax.tree.map(np.asarray, grads)),
                prefill=np.asarray(lp), decode=np.asarray(ld), c_pre=c_pre,
                c_dec=jax.tree.map(np.asarray, jc))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world of this file, each spawned once, beside the JAX runs."""
    data = str(tmp_path_factory.mktemp("tp"))
    results, errors = {}, []

    def spawn(cases):
        for case, world in cases:
            try:
                results[case] = w.run_world(case, world, timeout=150, data=data)
            except BaseException as err:       # reported by the tests that read it
                errors.append((case, err))

    # s2m2 needs no inputs: it runs while the JAX weights are written
    first = threading.Thread(target=spawn, args=([("s2m2", 4)],))
    first.start()
    inputs = _write_inputs(data)
    first.join()
    rest = [threading.Thread(target=spawn, args=(cases,))
            for cases in ([("m2", 2)], [("m4", 4), ("d2m2", 4)])]
    for t in rest:
        t.start()
    jres = _jax_results(inputs)
    for t in rest:
        t.join()
    return types.SimpleNamespace(data=data, jax=jres, res=results, errors=errors)


def _world(worlds, case):
    if case not in worlds.res:
        raise AssertionError(f"world {case} failed: {worlds.errors}")
    return worlds.res[case]


def _rank_files(worlds, stem, ranks):
    out = []
    for r in range(ranks):
        with np.load(os.path.join(worlds.data, f"{stem}.r{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _check_loss_and_grads(files, model, rules, want):
    loss = float(files[0]["loss/loss"])
    assert abs(loss - want["loss"]) <= LOSS_RTOL * abs(want["loss"]), (loss, want["loss"])
    grads = flatten(gather_params([w._unflat(f, "grads/") for f in files], model, rules))
    assert grads.keys() == want["grads"].keys()
    for path, g in want["grads"].items():
        assert grads[path].shape == g.shape, path
        bound = next((b for end, b in LEAF_TOL.items() if path.endswith(end)), GRAD_RTOL)
        assert _rel(grads[path], np.asarray(g, np.float32)) <= bound, path


def _close_caches(got, want):
    got, want = flatten(dict(enumerate(got))), flatten(dict(enumerate(want)))
    assert got.keys() == want.keys()
    for path, v in want.items():
        v = np.asarray(v, np.float32)
        assert got[path].shape == v.shape, path
        if path.endswith(".pos"):
            np.testing.assert_array_equal(got[path], v, err_msg=path)
        else:
            np.testing.assert_allclose(got[path], v, err_msg=path, **SERVE_TOL)


def _rules(case, T):
    cfg = w.tp_config(case)
    return Model(cfg), shd.train_rules(Mesh(1, 1, model=T), cfg)


# ---------------------------------------------------------------------------
# m2: every model kind at T 2
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", list(w.TP_CASES))
def test_m2_loss_and_every_gradient_leaf_match_jax(worlds, case):
    _world(worlds, "m2")
    model, rules = _rules(case, 2)
    _check_loss_and_grads(_rank_files(worlds, case, 2), model, rules, worlds.jax[case])


@pytest.mark.parametrize("case", list(w.TP_CASES))
def test_m2_prefill_decode_and_caches_match_jax(worlds, case):
    _world(worlds, "m2")
    model, rules = _rules(case, 2)
    files, want = _rank_files(worlds, case, 2), worlds.jax[case]
    for f in files:       # every rank returns the whole logits
        np.testing.assert_allclose(f["logits/prefill"], want["prefill"], **SERVE_TOL)
        np.testing.assert_allclose(f["logits/decode"], want["decode"], **SERVE_TOL)
    for stage, key in (("prefill/", "c_pre"), ("decode/", "c_dec")):
        got = gather_caches([w._caches_unflat(f, stage) for f in files], model, rules)
        _close_caches(got, want[key])


@pytest.mark.parametrize("case", list(w.TP_CASES))
def test_m2_three_masked_steps_match_one_process(worlds, case):
    r = _world(worlds, "m2")[case]
    for key, tol in STEP_TOL.items():
        assert r[key] <= tol, (case, r)


# ---------------------------------------------------------------------------
# m4, d2m2, s2m2
# ---------------------------------------------------------------------------
def test_m4_kv_in_branch_matches_jax(worlds):
    res = _world(worlds, "m4")
    assert res == {"kv_in": "model", "heads": "model"}
    model, rules = _rules("internlm2", 4)
    _check_loss_and_grads(_rank_files(worlds, "m4", 4), model, rules, worlds.jax["internlm2"])


@pytest.mark.parametrize("mode", ["masked", "static", "overlap"])
def test_d2m2_nodes_over_data_ranks_match_one_process(worlds, mode):
    r = _world(worlds, "d2m2")[mode]
    for key, tol in STEP_TOL.items():
        assert r[key] <= tol, (mode, r)


def test_d2m2_serving_splits_the_batch_over_the_data_ranks(worlds):
    _world(worlds, "d2m2")
    want = worlds.jax["internlm2"]
    for d in range(2):
        with np.load(os.path.join(worlds.data, f"d2m2.d{d}.npz")) as z:
            rows = slice(d, d + 1)
            np.testing.assert_allclose(z["logits/prefill"], want["prefill"][rows], **SERVE_TOL)
            np.testing.assert_allclose(z["logits/decode"], want["decode"][rows], **SERVE_TOL)


def test_s2m2_streamed_fsdp_matches_one_process(worlds):
    r = _world(worlds, "s2m2")
    # S 2 sums the sub-batch means in another order (tests/test_torch_mesh.py)
    assert r["params"] <= 5e-5 and r["loss"] <= 5e-5, r
    assert r["consensus"] <= 1e-6, r
