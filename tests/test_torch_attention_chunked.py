"""The port's query-chunked attention (``sdpa_chunked``) against the JAX
package and against its own unchunked ``sdpa``.

* ``sdpa_chunked`` against ``repro.models.attention.sdpa_chunked`` on the
  same numpy inputs: query lengths that ``block_q`` does not divide (the
  block halves until it does), causal, sliding window, softcap, GQA;
* its output and the gradients of q, k and v against the port's
  unchunked ``sdpa``;
* the model at the threshold: ``CHUNKED_SDPA_THRESHOLD`` set low in both
  packages' attention modules for the test (an attribute set at run time;
  no file of the JAX package changes), so a short sequence takes the
  chunked path in both; the loss and every gradient against JAX;
* ``_dispatch_sdpa`` at ``CHUNKED_SDPA_THRESHOLD`` queries runs the
  chunked path.

Tolerances: 1e-5 abs and rel against JAX at fp32 (summation order);
against the unchunked ``sdpa`` 1e-6 (each query row is the same
computation over the same keys); the model as
``tests/test_torch_model.py``'s fp32 row (the loss to 1e-5 relative,
each gradient leaf to 1e-5 relative norm).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models.transformer import Model as JaxModel
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models.transformer import Model
from repro_torch.tree import flatten

TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(B, Sq, Sk, Hq, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    return mk(B, Sq, Hq, hd), mk(B, Sk, Hkv, hd), mk(B, Sk, Hkv, hd)


def _positions(B, S, offset=0):
    return np.broadcast_to(np.arange(offset, offset + S, dtype=np.int32), (B, S)).copy()


CASES = [
    # (label, B, Sq, Sk, Hq, Hkv, hd, causal, window, softcap, block_q)
    ("causal, block divides", 2, 64, 64, 4, 2, 16, True, 0, 0.0, 16),
    ("causal, block halves 32 -> 8", 2, 40, 40, 4, 2, 16, True, 0, 0.0, 32),
    ("window 7, block halves", 1, 48, 48, 2, 1, 8, True, 7, 0.0, 32),
    ("softcap 5, non-causal, Sq != Sk", 2, 24, 56, 4, 4, 8, False, 0, 5.0, 16),
    ("GQA 4:1, window and softcap", 1, 96, 96, 8, 2, 16, True, 12, 30.0, 64),
    ("one block (block_q > Sq)", 1, 20, 20, 2, 2, 8, True, 0, 0.0, 512),
]


@pytest.mark.parametrize("label,B,Sq,Sk,Hq,Hkv,hd,causal,window,softcap,block_q", CASES)
def test_sdpa_chunked_matches_jax(label, B, Sq, Sk, Hq, Hkv, hd, causal, window, softcap,
                                  block_q):
    q, k, v = _qkv(B, Sq, Sk, Hq, Hkv, hd, seed=Sq + Sk)
    # queries at the end of the keys' range, as in a cached step
    qp, kp = _positions(B, Sq, Sk - Sq if Sk >= Sq else 0), _positions(B, Sk)
    kw = dict(causal=causal, window=window, logit_softcap=softcap, block_q=block_q)
    want = jattn.sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_positions=jnp.asarray(qp), k_positions=jnp.asarray(kp), **kw)
    got = tattn.sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             q_positions=torch.from_numpy(qp),
                             k_positions=torch.from_numpy(kp), **kw)
    assert got.shape == (B, Sq, Hq, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("label,B,Sq,Sk,Hq,Hkv,hd,causal,window,softcap,block_q", CASES)
def test_sdpa_chunked_output_and_grads_match_unchunked(label, B, Sq, Sk, Hq, Hkv, hd, causal,
                                                       window, softcap, block_q):
    arrays = _qkv(B, Sq, Sk, Hq, Hkv, hd, seed=Sq * 3 + Sk)
    ct = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (B, Sq, Hq, hd)).astype(np.float32))
    pos = dict(q_positions=torch.from_numpy(_positions(B, Sq, Sk - Sq if Sk >= Sq else 0)),
               k_positions=torch.from_numpy(_positions(B, Sk)))
    res = {}
    for name in ("chunked", "plain"):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
        if name == "chunked":
            out = tattn.sdpa_chunked(q, k, v, causal=causal, window=window,
                                     logit_softcap=softcap, block_q=block_q, **pos)
        else:
            out = tattn.sdpa(q, k, v, causal=causal, window=window,
                             logit_softcap=softcap, **pos)
        res[name] = (out.detach(), torch.autograd.grad(out, (q, k, v), grad_outputs=ct))
    torch.testing.assert_close(res["chunked"][0], res["plain"][0], atol=1e-6, rtol=1e-6)
    for got, want in zip(res["chunked"][1], res["plain"][1]):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_dispatch_sdpa_takes_the_chunked_path_at_the_threshold(monkeypatch):
    """At ``CHUNKED_SDPA_THRESHOLD`` queries ``_dispatch_sdpa`` runs
    ``sdpa_chunked`` (it used to raise), which gives each block of queries
    what ``sdpa`` gives it."""
    S = tattn.CHUNKED_SDPA_THRESHOLD
    calls = []
    chunked = tattn.sdpa_chunked
    monkeypatch.setattr(tattn, "sdpa_chunked",
                        lambda *a, **kw: calls.append(a[0].shape) or chunked(*a, **kw))
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, S, S, 1, 1, 4, seed=3))
    pos = torch.arange(S, dtype=torch.int32)[None]
    out = tattn._dispatch_sdpa(q, k, v, q_positions=pos, k_positions=pos, causal=True)
    assert calls == [(1, S, 1, 4)]
    assert out.shape == (1, S, 1, 4) and bool(torch.isfinite(out).all())
    last = slice(S - 512, S)
    want = tattn.sdpa(q[:, last], k, v, q_positions=pos[:, last], k_positions=pos,
                      causal=True)
    torch.testing.assert_close(out[:, last], want, atol=1e-6, rtol=1e-6)
    # one below the threshold stays on the unchunked path
    tattn._dispatch_sdpa(q[:, 1:], k[:, 1:], v[:, 1:], q_positions=pos[:, 1:],
                         k_positions=pos[:, 1:], causal=True)
    assert len(calls) == 1


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "gemma3_4b"])
def test_model_at_the_threshold_matches_jax(arch, monkeypatch):
    """A sequence of 768 with the threshold set to 256 in both packages:
    every attention layer takes the chunked path, in blocks of 256 (512
    halved), in both; gemma3 adds its sliding window and qk-norm."""
    S, threshold = 768, 256
    monkeypatch.setattr(jattn, "CHUNKED_SDPA_THRESHOLD", threshold)
    monkeypatch.setattr(tattn, "CHUNKED_SDPA_THRESHOLD", threshold)
    calls = []
    chunked = tattn.sdpa_chunked
    monkeypatch.setattr(tattn, "sdpa_chunked",
                        lambda *a, **kw: calls.append(a[0].shape[1]) or chunked(*a, **kw))
    kw = dict(compute_dtype="float32")
    jcfg = dataclasses.replace(jax_smoke_config(arch), **kw)
    cfg = dataclasses.replace(get_smoke_config(arch), **kw)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, size=(1, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    jm = JaxModel(jcfg)
    jparams = jm.init(jax.random.key(0))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = flatten(jax.tree.map(np.asarray, jgrads))

    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    leaves = flatten(params)
    for leaf in leaves.values():
        leaf.requires_grad_()
    loss, _ = Model(cfg).loss(params, {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert calls and set(calls) == {S}                  # every layer, chunked
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for path, g in zip(leaves, grads):
        want = np.asarray(jgrads[path], np.float32)
        rel = np.linalg.norm(g.numpy() - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= 1e-5, path
