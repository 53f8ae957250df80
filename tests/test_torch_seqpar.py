"""Sequence parallel and kv-seq-sharded serving in the port, against the
JAX package, and the collective inventory of a gloo world against its
meta view.

One gloo world of T 2 (``sp2`` in ``tests/torch_dist_worker.py``),
spawned once under its own timeout, from the JAX package's weights
(written by this process, which computes the JAX results while the
world runs); fp32 tiny presets:

* ``train_rules(sequence_parallel=True)`` for internlm2, dbrx (4
  experts), mamba2 and jamba at 4 layers: the loss and every gradient
  leaf, joined from the ranks' slices, against ``jax.value_and_grad`` of
  ``Model.loss`` (JAX's model on one device: its multi-device tests do
  not run under the installed jax, ROADMAP queue 3), at the tolerances
  of ``tests/test_torch_tp.py``; 3 masked steps of the sequence-parallel
  trainer against the port's single-process step;
* ``serve_rules(kv_seq_sharded=True)`` for internlm2, gemma3 at 4 layers
  (ring caches) and jamba at 4 layers (Mamba states beside the split KV
  caches): a prefill and 3 decode steps, every logit and every cache
  joined from the ranks against JAX's ``serve_forward``, within 2e-5 abs
  / 1e-5 rel;
* the collectives of a tensor-parallel and a sequence-parallel loss and
  backward and of a kv-seq-sharded decode step equal, op for op, those of
  the rank's meta view (``launch.mesh.virtual_mesh``), and every c10d op
  the backend received came through ``repro_torch.dist.comm``.
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

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models.transformer import Model as JaxModel
from repro_torch.convert import gather_caches, gather_params
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import Mesh
from repro_torch.models.transformer import Model
from repro_torch.tree import flatten

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_worker as w  # noqa: E402

LOSS_RTOL, GRAD_RTOL = 1e-6, 5e-6
LEAF_TOL = {".mixer.A_log": 2e-5}
SERVE_TOL = dict(atol=2e-5, rtol=1e-5)
STEP_TOL = {"params": 1e-6, "loss": 2e-6, "consensus": 1e-6}


def _jax_cfg(case):
    arch, over = w.TP_CASES[case]
    return dataclasses.replace(jax_smoke_config(arch), compute_dtype="float32", **over)


def _write(data: str, case: str, stem: str, serve_len: int):
    """One case's JAX weights, training batch and serving tokens, written
    for the ranks as ``{stem}.in.npz``; returned for the JAX run."""
    jcfg = _jax_cfg(case)
    jparams = jax.jit(JaxModel(jcfg).init)(jax.random.key(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (w.TP_B, w.TP_S + 1)).astype(np.int32)
    stoks = rng.integers(0, jcfg.vocab_size, (w.TP_B, serve_len)).astype(np.int32)
    flat = {f"p/{k}": v for k, v in flatten(jax.tree.map(np.asarray, jparams)).items()}
    flat.update({"b/tokens": toks[:, :-1], "b/labels": toks[:, 1:], "s/tokens": stoks})
    np.savez(os.path.join(data, f"{stem}.in.npz"), **flat)
    return jcfg, jparams, toks, stoks


def _jax_loss(jcfg, jparams, toks, stoks) -> dict:
    jm = JaxModel(jcfg)
    batch = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    (loss, _), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jparams, batch)
    return dict(loss=float(loss), grads=flatten(jax.tree.map(np.asarray, grads)))


def _jax_serve(jcfg, jparams, toks, stoks) -> dict:
    """A prefill of ``TP_SERVE`` tokens and ``KV_DECODES`` decode steps:
    the logits of each and the caches after the prefill and the last."""
    jm = JaxModel(jcfg)
    serve = jax.jit(jm.serve_forward, static_argnames="max_len")
    lp, jc = serve(jparams, jnp.asarray(stoks[:, :w.TP_SERVE]), jm.init_cache(
        w.TP_B, w.TP_MAX_LEN), start_position=0, max_len=w.TP_MAX_LEN)
    logits, c_pre = [np.asarray(lp)], jax.tree.map(np.asarray, jc)
    for i in range(w.KV_DECODES):
        p = w.TP_SERVE + i
        ld, jc = serve(jparams, jnp.asarray(stoks[:, p:p + 1]), jc, start_position=p,
                       max_len=w.TP_MAX_LEN)
        logits.append(np.asarray(ld))
    return dict(logits=np.concatenate(logits, 1), c_pre=c_pre,
                c_dec=jax.tree.map(np.asarray, jc))


@pytest.fixture(scope="module")
def sp2(tmp_path_factory):
    data = str(tmp_path_factory.mktemp("sp"))
    jobs = [(c, c, w.TP_SERVE + 1, _jax_loss) for c in w.SP_CASES]
    jobs += [(c, f"kv.{c}", w.TP_SERVE + w.KV_DECODES, _jax_serve) for c in w.KV_CASES]
    with ThreadPoolExecutor(4) as pool:
        inputs = list(pool.map(lambda j: _write(data, j[0], j[1], j[2]), jobs))
    out, errors = {}, []

    def spawn():
        try:
            out["res"] = w.run_world("sp2", 2, timeout=180, data=data)
        except BaseException as err:      # reported by the tests that read it
            errors.append(err)

    world = threading.Thread(target=spawn)
    world.start()
    with ThreadPoolExecutor(4) as pool:
        jres = list(pool.map(lambda ji: ji[0][3](*ji[1]), zip(jobs, inputs)))
    world.join()
    if "res" not in out:
        raise AssertionError(f"world sp2 failed: {errors}")
    return types.SimpleNamespace(data=data, res=out["res"],
                                 jax={j[1]: r for j, r in zip(jobs, jres)})


def _files(sp2, stem):
    out = []
    for r in range(2):
        with np.load(os.path.join(sp2.data, f"{stem}.r{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("case", w.SP_CASES)
def test_sequence_parallel_loss_and_every_gradient_leaf_match_jax(sp2, case):
    cfg = w.tp_config(case)
    model = Model(cfg)
    rules = shd.train_rules(Mesh(1, 1, model=2), cfg, sequence_parallel=True)
    files, want = _files(sp2, f"sp.{case}"), sp2.jax[case]
    loss = float(files[0]["loss/loss"])
    assert abs(loss - want["loss"]) <= LOSS_RTOL * abs(want["loss"]), (loss, want["loss"])
    assert float(files[1]["loss/loss"]) == loss
    grads = flatten(gather_params([w._unflat(f, "grads/") for f in files], model, rules))
    assert grads.keys() == want["grads"].keys()
    for path, g in want["grads"].items():
        bound = next((b for end, b in LEAF_TOL.items() if path.endswith(end)), GRAD_RTOL)
        assert _rel(grads[path], np.asarray(g, np.float32)) <= bound, path


@pytest.mark.parametrize("case", w.SP_CASES)
def test_sequence_parallel_steps_match_one_process(sp2, case):
    r = sp2.res["steps"][case]
    for key, tol in STEP_TOL.items():
        assert r[key] <= tol, (case, r)


@pytest.mark.parametrize("case", w.KV_CASES)
def test_kv_seq_sharded_serving_matches_jax(sp2, case):
    cfg = w.tp_config(case)
    model = Model(cfg)
    rules = shd.serve_rules(Mesh(1, 1, model=2), cfg, kv_seq_sharded=True)
    files, want = _files(sp2, f"kv.{case}"), sp2.jax[f"kv.{case}"]
    for f in files:          # every rank returns the whole logits
        np.testing.assert_allclose(f["logits/all"], want["logits"], **SERVE_TOL)
    for stage, key in (("prefill/", "c_pre"), ("decode/", "c_dec")):
        got = gather_caches([w._caches_unflat(f, stage) for f in files], model, rules)
        got, exp = flatten(dict(enumerate(got))), flatten(dict(enumerate(want[key])))
        assert got.keys() == exp.keys()
        for path, v in exp.items():
            v = np.asarray(v, np.float32)
            assert got[path].shape == v.shape, path
            if path.endswith(".pos"):
                np.testing.assert_array_equal(got[path], v, err_msg=path)
            else:
                np.testing.assert_allclose(got[path], v, err_msg=path, **SERVE_TOL)


def test_kv_seq_sharded_caches_split_positions_and_keep_every_kv_head():
    cfg = w.tp_config("internlm2")
    rules = shd.serve_rules(Mesh(1, 1, rank=1, model=2), cfg, kv_seq_sharded=True)
    with shd.use_rules(rules):
        caches = Model(cfg).init_cache(2, w.TP_MAX_LEN, device="meta")
    k = caches[0]["k"]
    assert tuple(k.shape) == (cfg.num_layers, 2, w.TP_MAX_LEN // 2, cfg.num_kv_heads,
                              cfg.head_dim)
    assert tuple(caches[0]["pos"].shape) == (cfg.num_layers, 2, w.TP_MAX_LEN)


@pytest.mark.parametrize("name", ["tp", "sp", "kvseq"])
def test_tp_sp_and_kvseq_inventories_equal_their_meta_views(sp2, name):
    inv = sp2.res["inventory"][name]
    assert inv["equal"] and inv["count"] > 0, inv
    want = {"tp": ["psum"], "sp": ["all_gather", "psum", "psum_scatter"],
            "kvseq": ["all_gather", "psum"]}[name]
    assert inv["kinds"] == want, inv


def test_sequence_parallel_off_is_tensor_parallel_bit_for_bit():
    """A model axis of 1 runs the one-device code, bit for bit, with or
    without ``sequence_parallel`` in its rules."""
    cfg = dataclasses.replace(w.tp_config("internlm2"), num_layers=1)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks, "labels": toks}
    ref, _ = model.loss(params, batch)
    for sp in (False, True):
        rules = shd.rules_for_config(Mesh(1, 1), cfg, batch_axes=None, nodes="data",
                                     sequence_parallel=sp)
        with shd.use_rules(rules):
            got, _ = model.loss(params, batch)
        assert torch.equal(got, ref)
