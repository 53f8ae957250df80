"""The dry run (``repro_torch.launch.dryrun``) against the JAX package
and against what it counts: meta inputs, meta parameter trees, resident
bytes, kernel launches, FLOPs and the record's keys.

* ``input_specs`` gives the JAX ``input_specs``'s names, shapes and
  dtypes for every arch and workload shape, and the meta model the JAX
  ``Model.init`` tree (``jax.eval_shape``) at full width;
* at the tiny size the traced resident bytes equal the storages of the
  same state built on the CPU, as the allocator books them;
* the meta branches' launches equal ``analysis.launch_counts`` for a
  dense, a MoE (remat on and off), a Mamba, a hybrid and an audio
  model, in training and serving, and leave the wrappers' own counters
  (the card's launches) alone;
* the tiny model's loss and gradients (no remat) make exactly the
  analytic number of matmul flops, and the total stays within
  ``XLA_FLOP_TOL`` of XLA's ``cost_analysis()`` of the same JAX
  ``value_and_grad`` (XLA counts reductions the mode leaves out);
* the record has every key of the JAX ``analyze`` record, a kernel's
  refusal fails the run, and the flags of the multi-GPU port exit naming
  ROADMAP item 15.
"""
import ast
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import INPUT_SHAPES as JAX_SHAPES
from repro.configs.registry import get_config as jax_config
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.data.pipeline import input_specs as jax_input_specs
from repro.models.transformer import Model as JaxModel
from repro_torch.analysis import launch_counts
from repro_torch.analysis.cost import CostMode, rounded
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.pipeline import input_specs
from repro_torch.launch import dryrun
from repro_torch.models.transformer import Model
from repro_torch.tree import flatten, tree_leaves

REPO = Path(__file__).resolve().parents[1]
# XLA's total over the tracer's on the tiny internlm2 without remat,
# measured 1.079: the matmuls agree, XLA also counts reductions and the
# tracer does not
XLA_FLOP_TOL = 0.25


def _dt(d) -> str:
    return str(d).removeprefix("torch.")


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax(arch, shape):
    nodes = 8 if INPUT_SHAPES[shape].kind == "train" else 0
    want = jax_input_specs(jax_config(arch), JAX_SHAPES[shape], num_nodes=nodes)
    got = input_specs(get_config(arch), INPUT_SHAPES[shape], num_nodes=nodes)
    assert {k: (tuple(v.shape), _dt(v.dtype), v.device.type) for k, v in got.items()} == {
        k: (tuple(v.shape), str(v.dtype), "meta") for k, v in want.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_params_match_jax_eval_shape(arch):
    want = jax.eval_shape(JaxModel(jax_config(arch)).init, jax.random.key(0))
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in flatten(want).items()}
    params = Model(get_config(arch)).init(0, device="meta")
    got = {k: (tuple(v.shape), _dt(v.dtype)) for k, v in flatten(params).items()}
    assert all(v.device.type == "meta" for v in flatten(params).values())
    assert got == want


def _storage_bytes(*tensors) -> int:
    """Each distinct storage once, as the allocator books it."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = rounded(st.nbytes())
    return sum(seen.values())


@pytest.mark.parametrize("mode", ["masked", "overlap"])
@pytest.mark.parametrize("arch", ["internlm2_1_8b", "dbrx_132b", "jamba_v0_1_52b"])
def test_resident_bytes_equal_the_state_built_on_the_cpu(arch, mode):
    cfg = get_smoke_config(arch)
    kw = dict(nodes=8, batch=2, seq=16, gossip_mode=mode)
    cm = dryrun.trace(lambda: (lambda st: (st, st.run))(dryrun.train_state(cfg, **kw)))
    st = dryrun.train_state(cfg, device="cpu", **kw)
    # the CPU batch views the numpy token array; a copy to a device holds
    # just the tokens, as the meta batch does
    batch = [v.clone(memory_format=torch.contiguous_format) for v in st.batch.values()]
    state = tree_leaves(st.params) + tree_leaves(st.opt_state)
    assert cm.argument_bytes == _storage_bytes(
        *state, *batch, *(st.gstate.delta if st.gstate else ()))


def _nonzero(d):
    return {k: v for k, v in d.items() if v}


LAUNCH_CASES = {
    "dense": ("internlm2_1_8b", {}),
    "moe_remat": ("dbrx_132b", dict(moe_num_experts=16, moe_top_k=4, remat=True)),
    "moe_no_remat": ("dbrx_132b", dict(moe_num_experts=16, moe_top_k=4, remat=False)),
    "mamba": ("mamba2_370m", {}),
    "hybrid": ("jamba_v0_1_52b", dict(num_layers=4, moe_num_experts=16)),
    "audio": ("whisper_base", {}),
}


@pytest.mark.parametrize("case", list(LAUNCH_CASES))
def test_meta_launches_equal_launch_counts(case):
    arch, over = LAUNCH_CASES[case]
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    cm = dryrun.trace(lambda: (lambda st: (st, st.run))(dryrun.train_state(
        cfg, nodes=8, batch=2, seq=16)))
    assert dict(cm.launches) == _nonzero(launch_counts.train_step(cfg, nodes=8, seq=16))
    for kind, want in (("prefill", launch_counts.prefill(
            cfg, seq=32, encoder=cfg.frontend == "audio")), ("decode", launch_counts.decode(cfg))):
        cm = dryrun.trace(lambda: dryrun.serve_call(cfg, kind=kind, batch=2, seq=32))
        assert dict(cm.launches) == _nonzero(want), kind
    if cfg.moe_num_experts > 8:
        cm = dryrun.trace(lambda: dryrun.replica_call(cfg, batch=2, seq=16))
        assert dict(cm.launches) == _nonzero(launch_counts.forward_backward(cfg, seq=16))
        assert cm.launches["grouped_matmul"] == 3 * 2 * (1 + cfg.remat)


def test_meta_calls_leave_the_card_counters_alone():
    """A meta launch is reported to the CostMode only: each wrapper's
    ``launches`` counts the card's launches, which chip_smoke.py reads."""
    from repro_torch.kernels import flash_attention, gossip_axpy, grouped_matmul, ssm_scan

    counters = [gossip_axpy.gossip_axpy, flash_attention.flash_attention, ssm_scan.ssm_scan,
                grouped_matmul.grouped_matmul, grouped_matmul.grouped_matmul_dx,
                grouped_matmul.grouped_matmul_dw]
    before = [fn.launches for fn in counters]
    arch, over = LAUNCH_CASES["hybrid"]
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    traced = set()
    for build in (lambda: (lambda st: (st, st.run))(dryrun.train_state(cfg, nodes=8, batch=2,
                                                                       seq=16)),
                  lambda: dryrun.serve_call(cfg, kind="prefill", batch=2, seq=32),
                  lambda: dryrun.replica_call(cfg, batch=2, seq=16)):
        traced |= set(dryrun.trace(build).launches)
    assert traced == {fn.__name__ for fn in counters}
    assert [fn.launches for fn in counters] == before


def test_a_kernel_refusal_fails_the_dry_run(monkeypatch, tmp_path, capsys):
    """Only positions past a model's table give a ``refused`` record; a
    shape a kernel rejects (here a head width flash is not compiled for)
    fails the run."""
    real = dryrun.config_for
    monkeypatch.setattr(dryrun, "config_for",
                        lambda *a, **k: dataclasses.replace(real(*a, **k), head_dim=48))
    assert dryrun.main(["--arch", "internlm2_1_8b", "--shape", "prefill_32k", "--preset",
                        "tiny", "--seq", "64", "--out", str(tmp_path)]) == 1
    captured = capsys.readouterr()
    assert "REFUSED" not in captured.out
    assert "FAIL internlm2_1_8b prefill_32k" in captured.err and "head_dim 48" in captured.err


def _analytic_matmul_flops(cfg, B, S):
    """Loss and gradients of the dense tiny model without remat: every
    projection and the unembedding (2 flops a multiply-add), the full
    (S, S) scores and their product with v; the backward twice the
    forward."""
    d, h, kv, hd, ff, V = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                           cfg.d_ff, cfg.padded_vocab)
    T = B * S
    layer = 2 * T * (d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * ff)
    layer += 2 * 2 * B * h * S * S * hd
    head = 2 * T * d * V
    return 3 * (cfg.num_layers * layer + head)


def test_tiny_loss_and_grad_flops_analytic_and_against_xla(capsys):
    cfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), remat=False)
    B, S = 2, 32
    cm = dryrun.trace(lambda: dryrun.replica_call(cfg, batch=B, seq=S))
    assert cm.matmul_flops == _analytic_matmul_flops(cfg, B, S)
    # remat recomputes each layer's forward in the backward, up to its
    # last saved tensor (the recompute stops early): more, at most a
    # whole forward of the layers more
    rm = dryrun.trace(lambda: dryrun.replica_call(
        dataclasses.replace(cfg, remat=True), batch=B, seq=S))
    assert cm.matmul_flops < rm.matmul_flops < cm.matmul_flops * 4 / 3

    jcfg = dataclasses.replace(jax_smoke_config("internlm2_1_8b"), remat=False)
    model = JaxModel(jcfg)
    params = jax.eval_shape(model.init, jax.random.key(0))
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "labels": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    fn = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b)[0]))
    cost = fn.lower(params, batch).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    xla = float(cost["flops"])
    total = float(sum(cm.flops.values()))
    with capsys.disabled():
        print(f"\ntiny internlm2 loss+grad B {B} x S {S}: tracer {total:.4g} flops "
              f"({cm.matmul_flops:.4g} in matmuls), XLA cost_analysis {xla:.4g} "
              f"(ratio {xla / total:.3f})")
    assert abs(xla / total - 1) <= XLA_FLOP_TOL


def _jax_analyze_keys():
    """The top-level and ``memory`` keys of the JAX ``analyze`` record,
    read from its source (importing the JAX dry run would set XLA's
    device count for the whole process)."""
    tree = ast.parse((REPO / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "analyze")
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return)][-1].value
    top = {k.value for k in ret.keys if isinstance(k, ast.Constant)}
    mem = next(v for k, v in zip(ret.keys, ret.values)
               if isinstance(k, ast.Constant) and k.value == "memory")
    return top, {k.value for k in mem.keys}


def test_record_has_every_jax_analyze_key(tmp_path):
    top, mem = _jax_analyze_keys()
    assert {"flops_per_chip", "roofline_seconds", "useful_flops_ratio"} <= top
    rec = dryrun.run_one("internlm2_1_8b", "train_4k", preset="tiny", out_dir=str(tmp_path))
    assert top <= set(rec)
    # the generated code's size is XLA's; the port's kernels are built apart
    assert mem - {"code_bytes"} <= set(rec["memory"])
    assert {"peak_bytes", "fits", "kernel_launches"} <= set(rec)
    assert rec["mode"] == "meta" and rec["n_chips"] == 1 and rec["collectives"] == {}
    assert rec["memory"]["total_per_chip"] == rec["peak_bytes"]
    assert rec["kernel_launches"] == {"gossip_axpy": len(flatten(Model(
        get_smoke_config("internlm2_1_8b")).param_shapes()))}
    saved = json.loads((tmp_path / "internlm2_1_8b_train_4k.json").read_text())
    assert saved["peak_bytes"] == rec["peak_bytes"]


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_cli_all_archs_tiny(shape, tmp_path, capsys):
    assert dryrun.main(["--arch", "all", "--shape", shape, "--preset", "tiny",
                        "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.count("OK ") + out.count("REFUSED ") == len(ARCH_IDS)
    for arch in ARCH_IDS:
        rec = json.loads((tmp_path / f"{arch}_{shape}.json").read_text())
        if "refused" in rec:
            # only the learned position tables (whisper, granite: 128 at the
            # smoke size) refuse, past their end
            assert "position table" in rec["refused"] and rec["seq"] > 128, rec["refused"]
            continue
        assert rec["fits"] and rec["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0


def test_cli_full_width_train_fits_as_the_card_measured(tmp_path):
    """internlm2-1.8b at 2 layers, 8 nodes, 4 x 128: the card measured
    32.31 GB resident and 44.48 GB at the peak (NVIDIA H100 80GB HBM3,
    700 W; PERF.md §6)."""
    assert dryrun.main(["--arch", "internlm2_1_8b", "--shape", "train_4k", "--layers", "2",
                        "--batch", "4", "--seq", "128", "--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "internlm2_1_8b_train_4k.json").read_text())
    assert rec["memory"]["argument_bytes"] == 32313606656
    assert rec["peak_bytes"] == pytest.approx(44.48e9, rel=0.01)
    assert rec["fits"]


@pytest.mark.parametrize("flag", ["--multi-pod", "--kv-seq-shard"])
def test_multi_gpu_flags_exit_naming_item_15(flag):
    with pytest.raises(SystemExit, match="item 15"):
        dryrun.main(["--arch", "internlm2_1_8b", "--shape", "train_4k", flag])
