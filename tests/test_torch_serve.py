"""The port's serving path against the JAX package, and its CLI.

* ``Model.serve_forward``: a prefill from position 0 and one decode
  step, from the JAX ``Model.init`` weights carried across, at fp32
  compute, against the JAX ``serve_forward``: the last position's logits
  and every cache leaf (``k``, ``v``, ``pos``; ``ssm``, ``conv``).
  Tolerance 2e-5 abs and 1e-5 rel (summation order; measured ~1e-6 on
  logits and ~3e-6 on cache values of magnitude ~5); ``pos`` exactly.
  internlm2 and mamba2 are the serving path's models; granite (learned
  positions) and gemma3 (ring caches under a sliding window, shorter
  than the prompt) cover the other cache branches; dbrx (4 experts: the
  einsum branch; 16 experts, top-4: the ragged branch and its grouped
  matmuls, in prefill and decode) and kimi (a dense first layer, then
  MoE with a shared expert) the MoE layers; jamba (Mamba, attention and
  MoE layers in one stack), whisper and internvl2 their decoders
  without the frontend, as the serving CLI's decode runs them
  (``tests/test_torch_families.py`` adds the encoder output, the
  prefix and the periodic stacks).
* Serve consistency against the port's own teacher-forced ``forward``
  at the default bf16 compute, as ``tests/test_arch_smoke.py`` does it
  for JAX (tolerance 2e-2, as there).
* ``python -m repro_torch.launch.serve --device cpu --preset tiny`` for
  internlm2, mamba2, dbrx, gemma3, jamba, whisper (zero frames through
  the encoder) and internvl2; without ``--device cpu`` and without a card it exits with
  a message; unported flags exit naming their ROADMAP item, and ``--trace``
  writes spans the JAX package's readers load.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models.transformer import Model as JaxModel
from repro.telemetry.trace import read_chrome_trace, read_jsonl
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import caches_from_numpy, caches_to_numpy, params_from_numpy
from repro_torch.dist import serve as sv
from repro_torch.launch import serve
from repro_torch.models.transformer import Model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["internlm2_1_8b", "mamba2_370m", "granite_20b", "gemma3_4b",
         "dbrx_132b", "dbrx_132b_16x4", "kimi_k2_1t_a32b", "jamba_v0_1_52b",
         "whisper_base", "internvl2_1b"]
# smoke configs with overrides, by the name ARCHS gives them
VARIANTS = {"dbrx_132b_16x4": ("dbrx_132b", dict(moe_num_experts=16, moe_top_k=4))}
B, S, MAX_LEN = 2, 24, 40
TOL = dict(atol=2e-5, rtol=1e-5)


def _smoke(arch, **kw):
    """(JAX config, port config) of an ARCHS entry, with overrides."""
    name, over = VARIANTS.get(arch, (arch, {}))
    return (dataclasses.replace(jax_smoke_config(name), **over, **kw),
            dataclasses.replace(get_smoke_config(name), **over, **kw))


def _tokens(vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S + 1)).astype(np.int32)


def _close_caches(got, want, tol):
    assert len(got) == len(want)
    for g_seg, w_seg in zip(got, want):
        assert g_seg.keys() == w_seg.keys()
        for key in w_seg:
            w = np.asarray(w_seg[key], np.float32)
            assert g_seg[key].shape == w.shape, key
            if key == "pos":
                np.testing.assert_array_equal(g_seg[key], w)
            else:
                np.testing.assert_allclose(g_seg[key], w, **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_forward_matches_jax(arch):
    jcfg, cfg = _smoke(arch, compute_dtype="float32")
    jm, model = JaxModel(jcfg), Model(cfg)
    jparams = jm.init(jax.random.key(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    toks = _tokens(cfg.vocab_size)

    jc = jm.init_cache(B, MAX_LEN)
    caches = model.init_cache(B, MAX_LEN, device="cpu")
    _close_caches(caches_to_numpy(caches), jax.tree.map(np.asarray, jc), TOL)

    jl, jc = jm.serve_forward(jparams, jnp.asarray(toks[:, :S]), jc,
                              start_position=0, max_len=MAX_LEN)
    prefill = sv.make_prefill_step(model, max_len=MAX_LEN)
    tl, caches = prefill(params, torch.as_tensor(toks[:, :S]), caches)
    assert tl.shape == (B, 1, cfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_caches(caches_to_numpy(caches), jax.tree.map(np.asarray, jc), TOL)

    # decode from the JAX prefill's caches carried across: one step each
    jd, jc = jm.serve_forward(jparams, jnp.asarray(toks[:, S:]), jc,
                              start_position=S, max_len=MAX_LEN)
    caches = caches_from_numpy(jax.tree.map(np.asarray, jm.serve_forward(
        jparams, jnp.asarray(toks[:, :S]), jm.init_cache(B, MAX_LEN),
        start_position=0, max_len=MAX_LEN)[1]), "cpu")
    decode = sv.make_decode_step(model, max_len=MAX_LEN)
    td, caches = decode(params, torch.as_tensor(toks[:, S:]), caches, S)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    _close_caches(caches_to_numpy(caches), jax.tree.map(np.asarray, jc), TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_consistency_with_forward(arch):
    cfg = _smoke(arch)[1]
    model = Model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.as_tensor(_tokens(cfg.vocab_size, seed=5))
    with torch.no_grad():
        ref, _ = model.forward(params, toks)
    caches = model.init_cache(B, 64, device="cpu")
    lp, caches = sv.make_prefill_step(model, max_len=64)(params, toks[:, :S], caches)
    ld, _ = sv.make_decode_step(model, max_len=64)(params, toks[:, S:], caches, S)
    torch.testing.assert_close(lp[:, 0].float(), ref[:, S - 1].float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(ld[:, 0].float(), ref[:, S].float(), atol=2e-2, rtol=2e-2)


def _run(args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        env[var] = "1"
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO,
    )


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mamba2_370m", "dbrx_132b",
                                  "gemma3_4b", "jamba_v0_1_52b", "whisper_base",
                                  "internvl2_1b"])
def test_cli_serves_on_cpu(arch):
    res = _run(["--device", "cpu", "--preset", "tiny", "--arch", arch,
                "--batch", "2", "--prompt-len", "24", "--gen", "4"])
    assert res.returncode == 0, res.stderr[-4000:]
    out = res.stdout
    assert "prefill:" in out and "ms/token" in out
    assert "kernel launches: flash_attention prefill 0 decode 0" in out
    assert "kernel launches: ssm_scan prefill 0 decode 0" in out
    assert "kernel launches: grouped_matmul prefill 0 decode 0" in out
    assert "kernel launches: gossip_axpy prefill 0 decode 0" in out
    ids = out.split("generated token ids (first request):")[1]
    assert len(ids.split("[")[1].split("]")[0].split()) == 4


def test_cli_without_a_card_needs_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is usable here")
    res = _run(["--preset", "tiny", "--gen", "2"])
    assert res.returncode != 0
    assert "--device cpu" in res.stderr
    assert "prefill:" not in res.stdout


@pytest.mark.parametrize("flags,item", [
    (["--trace", "{tmp}/tr"], "ported"),
    (["--data-par", "2"], "item 15"),
    (["--model-par", "2"], "item 15"),
])
def test_unported_flags_exit_naming_the_roadmap_item(flags, item, tmp_path):
    """Unported flags exit naming their ROADMAP item; ``--trace`` is
    ported: one fenced prefill span and one decode span per
    step, in files the JAX package's readers load."""
    flags = [f.replace("{tmp}", str(tmp_path)) for f in flags]
    if item != "ported":
        with pytest.raises(SystemExit, match=item):
            serve.main(["--device", "cpu", *flags])
        return
    serve.main(["--device", "cpu", "--preset", "tiny", "--batch", "2",
                "--prompt-len", "8", "--gen", "4", *flags])
    header, events = read_jsonl(str(tmp_path / "tr" / "events.jsonl"))
    assert header["schema"] == "repro.telemetry/1" and header["meta"]["gen"] == 4
    assert events == read_chrome_trace(str(tmp_path / "tr" / "trace.json"))
    assert [(e.name, e.cat, e.step) for e in events] == (
        [("prefill", "serve", -1)] + [("decode", "serve", i) for i in range(3)])
    assert events[0].args == {"tokens": 16} and all(e.dur_us > 0 for e in events)


def test_run_reports_generated_ids_and_times():
    res = serve.run(get_smoke_config("mamba2_370m"), batch=2, prompt_len=9, gen=3,
                    device="cpu")
    assert res["generated"].shape == (2, 3)
    assert res["prefill_ms"] > 0 and res["decode_ms_per_token"] > 0
    assert res["peak_bytes"] is None
    assert res["prefill_launches"] == {"flash_attention": 0, "ssm_scan": 0,
                                       "grouped_matmul": 0, "gossip_axpy": 0}
    assert bool(torch.isfinite(res["logits"]).all())
