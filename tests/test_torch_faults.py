"""The port's fault injection against the JAX package's.

* ``repro_torch.faults.model`` is a copy of ``repro.faults.model``: over
  a grid of specs and two plans, its schedules (link masks, straggler
  delays), per-node bits, dropped-link counts, straggler delays, dense
  mixing matrices and Theorem 2 re-checks equal the original's exactly
  (the same numpy code on the same seeds: no tolerance).
* Faulted gossip (per-node effective bits, masked and static) equals the
  dense oracle ``effective_mixing_matrix @ x`` within 1e-6 relative
  (fp32; only the summation order differs) at p_drop 0.35, and with
  all-ones gates three faulted masked steps are bit-equal to three plain
  ones (static: within fp32 rounding, 2e-5).
* The CLI: a faulted run crashed after step 4 and resumed with
  ``--resume auto`` from its step-3 checkpoint ends where the
  uninterrupted run ends (rtol 1e-5, atol 1e-7, as
  ``tests/test_faults.py`` holds the JAX CLI), and the checkpoints it
  leaves restore in the JAX package.
* A checkpoint resumes exactly: the port's step from a restored state
  (written by the port, or by the JAX package) is bit-equal to its step
  from the JAX state converted in memory.
"""
import csv
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import faults as jfaults
from repro.checkpoint import ckpt as jckpt
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models.transformer import Model as JaxModel
from repro_torch import core, faults
from repro_torch.checkpoint import ckpt
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.dist import decen_train as dt
from repro_torch.dist.gossip import mix_dense, mix_matchings, mix_matchings_masked
from repro_torch.launch import train
from repro_torch.models.transformer import Model
from repro_torch.optim.optimizers import sgd
from repro_torch.tree import flatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 12


def _plans(kind):
    """(JAX plan, port plan) from the same graph: MATCHA on paper8 or
    vanilla on a 6-ring."""
    if kind == "paper8":
        return (jcore.plan_matcha(jcore.named_graph("paper8", 8, seed=3), 0.5,
                                  budget_steps=400, seed=0),
                core.plan_matcha(core.named_graph("paper8", 8, seed=3), 0.5,
                                 budget_steps=400, seed=0))
    return (jcore.plan_vanilla(jcore.named_graph("ring", 6, seed=3)),
            core.plan_vanilla(core.named_graph("ring", 6, seed=3)))


SPECS = [
    dict(p_drop=0.35, seed=0),
    dict(p_drop=0.1, straggler_prob=0.2, straggler_units=2.5, seed=3),
    dict(downtime=((1, 2, 5), (3, 0, 1)), seed=1),
    dict(p_drop=1.0, seed=2),
    dict(p_drop=0.5, straggler_prob=1.0, crash_at_step=3, downtime=((0, 1, 40),), seed=7),
]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: "-".join(f"{k}{v}" for k, v in s.items()))
@pytest.mark.parametrize("kind", ["paper8", "ring6"])
def test_fault_schedule_equals_jax_bit_for_bit(kind, spec):
    jplan, plan = _plans(kind)
    jspec, tspec = jfaults.FaultSpec(**spec), faults.FaultSpec(**spec)
    assert (tspec.empty, tspec.has_link_faults) == (jspec.empty, jspec.has_link_faults)
    js = jfaults.make_fault_schedule(jplan, STEPS, jspec)
    ts = faults.make_fault_schedule(plan, STEPS, tspec)
    for name in ("permutations", "link_masks", "delays"):
        a, b = getattr(ts, name), getattr(js, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ts.empty == js.empty
    sched = jplan.schedule(STEPS, seed=4).activations
    for k in range(STEPS):
        bits = ts.node_bits(sched[k], k)
        np.testing.assert_array_equal(bits, js.node_bits(sched[k], k))
        assert ts.dropped_links(sched[k], k) == js.dropped_links(sched[k], k)
        assert ts.max_delay(k) == js.max_delay(k)
        np.testing.assert_array_equal(
            faults.effective_mixing_matrix(plan.permutations, plan.alpha, bits),
            jfaults.effective_mixing_matrix(jplan.permutations, jplan.alpha, bits),
        )
    assert faults.verify_degraded_plan(plan, tspec) == jfaults.verify_degraded_plan(jplan, jspec)


def test_fault_spec_validates_like_jax():
    for bad in (dict(p_drop=float("nan")), dict(straggler_units=-1.0),
                dict(crash_at_step=-2), dict(downtime=((0, 3, 1),))):
        with pytest.raises(ValueError):
            jfaults.FaultSpec(**bad)
        with pytest.raises(ValueError):
            faults.FaultSpec(**bad)
    with pytest.raises(faults.SimulatedCrash, match="after step 4"):
        raise faults.SimulatedCrash(4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("kind", ["paper8", "ring6"])
def test_faulted_gossip_equals_dense_oracle(kind, dtype, tol):
    _, plan = _plans(kind)
    m = plan.permutations.shape[1]
    sched = plan.schedule(8, seed=2)
    fs = faults.make_fault_schedule(plan, 8, faults.FaultSpec(p_drop=0.35, seed=0))
    rng = np.random.default_rng(0)
    x = {"w": torch.from_numpy(rng.standard_normal((m, 16, 8)).astype(np.float32)).to(dtype),
         "b": torch.from_numpy(rng.standard_normal((m, 129)).astype(np.float32)).to(dtype),
         "n": torch.arange(m)}
    dropped = 0
    for k in range(8):
        row = sched.activations[k]
        bits = fs.node_bits(row, k)
        dropped += fs.dropped_links(row, k)
        W = faults.effective_mixing_matrix(plan.permutations, plan.alpha, bits)
        np.testing.assert_allclose(W, W.T)
        np.testing.assert_allclose(W.sum(1), 1.0, atol=1e-12)
        want = flatten(mix_dense(x, W))
        for got in (mix_matchings_masked(x, plan.alpha, plan.permutations, bits),
                    mix_matchings(x, plan.alpha, plan.permutations,
                                  sched.active_indices(k), gate_bits=bits)):
            got = flatten(got)
            assert torch.equal(got["n"], x["n"])
            for path in ("w", "b"):
                g, w = got[path].double(), want[path].double()
                assert got[path].dtype == dtype
                assert float((g - w).norm() / w.norm()) <= tol, (k, path)
    assert dropped > 0, "no exchange dropped at p_drop 0.35"


def _tiny():
    """The smoke internlm2 at fp32 compute: (config, model)."""
    cfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), compute_dtype="float32")
    return cfg, Model(cfg)


@pytest.mark.parametrize("gossip_mode", ["masked", "static"])
def test_all_ones_gates_are_bit_equal_to_the_plain_step(gossip_mode):
    """Masked: bit-equal. Static, as in the JAX package, sums gated
    deltas where its plain path sums partners: fp32 rounding apart, which
    the momentum carries (2e-5 relative Frobenius norm per leaf, the
    state tolerance of ``tests/test_torch_decen_step.py``; measured 1e-6)."""
    _, plan = _plans("paper8")
    cfg, model = _tiny()
    from repro_torch.data.pipeline import DecentralizedBatches

    data = DecentralizedBatches(cfg, 8, 2, 16, seed=0, device="cpu")
    batches = [next(data) for _ in range(3)]
    sched = plan.schedule(3, seed=0)
    opt = sgd(0.05, momentum=0.9)
    out = {}
    for faulted in (False, True):
        params = dt.init_stacked_params(model, 8, seed=0, device="cpu")
        state = dt.init_stacked_opt_state(opt, model, 8, device="cpu")
        steps = {}
        losses = []
        for k in range(3):
            row = sched.activations[k].astype(np.float32)
            active = tuple(sched.active_indices(k)) if gossip_mode == "static" else ()
            if active not in steps:
                steps[active] = dt.make_train_step(model, opt, plan, gossip_mode=gossip_mode,
                                                   active=active, faulted=faulted)
            bits = np.tile(row, (8, 1)) if faulted else row
            params, state, loss, _ = steps[active](params, state, batches[k],
                                                   torch.as_tensor(bits))
            losses.append(loss)
        out[faulted] = (flatten(params), flatten(state), torch.stack(losses))
    for a, b in zip(out[False][:2], out[True][:2]):
        for path in a:
            if gossip_mode == "masked":
                assert torch.equal(a[path], b[path]), path
            else:
                gap = (b[path].double() - a[path].double()).norm() / a[path].double().norm()
                assert float(gap) <= 2e-5, (path, float(gap))
    if gossip_mode == "masked":
        assert torch.equal(out[False][2], out[True][2])
    step = dt.make_train_step(model, opt, plan, faulted=True)
    with pytest.raises(ValueError, match=r"\(nodes, M\)"):
        step(params, state, batches[0], torch.ones(plan.num_matchings))


def _train(*extra, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        env[var] = "1"
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--preset", "tiny", "--nodes", "4", "--graph", "ring", "--steps", "8",
         "--batch-per-node", "2", "--seq", "32", "--seed", "1",
         "--p-drop", "0.25", "--fault-seed", "5", *extra],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO,
    )


def _csv_rows(path):
    with open(path, newline="") as f:
        return {int(r["step"]): r for r in csv.DictReader(f)}


def test_cli_crash_and_resume_matches_the_uninterrupted_run(tmp_path):
    ck = str(tmp_path / "ckpt")
    csv_a, csv_b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    run_a = _train("--csv", csv_a)
    assert run_a.returncode == 0, run_a.stderr[-3000:]
    assert "faults: p_drop=0.25 keeps the plan contractive" in run_a.stdout
    run_b = _train("--ckpt-dir", ck, "--ckpt-every", "3", "--crash-at-step", "4")
    assert run_b.returncode == 1 and "SimulatedCrash" in run_b.stderr
    assert "simulated crash after completing step 4" in run_b.stdout
    assert sorted(os.listdir(ck)) == ["step_00000003"]
    line = lambda out: [ln for ln in out.splitlines() if ln.startswith("step    0")]
    assert line(run_a.stdout) == line(run_b.stdout) and line(run_a.stdout)
    run_r = _train("--ckpt-dir", ck, "--ckpt-every", "3", "--resume", "auto", "--csv", csv_b)
    assert run_r.returncode == 0, run_r.stderr[-3000:]
    assert f"resumed from {os.path.join(ck, 'step_00000003')} at step 3" in run_r.stdout
    rows_a, rows_b = _csv_rows(csv_a), _csv_rows(csv_b)
    final = max(rows_a)
    assert final == 7 and final in rows_b
    for col in ("loss", "consensus"):
        np.testing.assert_allclose(float(rows_b[final][col]), float(rows_a[final][col]),
                                   rtol=1e-5, atol=1e-7, err_msg=col)
    resolved = ckpt.find_resumable(ck)
    assert resolved is not None and resolved.endswith("step_00000008")
    # the port's checkpoints restore in the JAX package, with --shard 1's extra
    _, jopt, step = jckpt.restore_run(resolved)
    assert step == 8 and np.asarray(jopt["step"]).tolist() == [8] * 4
    import json

    with open(os.path.join(resolved, "ckpt.json")) as f:
        info = json.load(f)
    assert info == {"step": 8, "per_node_files": False, "num_nodes": 4, "shard": 1,
                    "stream_layers": False, "stream_scan": True}


@pytest.mark.parametrize("strict", [True, False])
def test_theorem2_recheck_warns_or_fails_under_strict_faults(capsys, strict):
    argv = ["--device", "cpu", "--preset", "tiny", "--steps", "1", "--p-drop", "1.0"]
    if strict:
        with pytest.raises(SystemExit, match="--strict-faults"):
            train.main(argv + ["--strict-faults"])
        return
    rows = train.main(argv)
    assert "faults: WARNING" in capsys.readouterr().out and len(rows) == 1


def test_restored_checkpoint_steps_like_the_converted_jax_state(tmp_path):
    nodes = 4
    plan = core.plan_vanilla(core.named_graph("ring", nodes, seed=3))
    jcfg = dataclasses.replace(jax_smoke_config("internlm2_1_8b"), compute_dtype="float32")
    cfg, model = _tiny()
    init = JaxModel(jcfg).init(jax.random.key(0))
    jparams = jax.tree.map(
        lambda a: jnp.stack([a + 0.01 * i for i in range(nodes)]), init)
    rng = np.random.default_rng(3)
    jopt = {"step": jnp.full((nodes,), 5, jnp.int32),
            "velocity": jax.tree.map(
                lambda a: jnp.asarray(0.01 * rng.standard_normal(a.shape), jnp.float32),
                jparams)}
    jckpt.save_run_step(str(tmp_path / "jax"), jparams, jopt, step=5)

    from repro_torch.data.pipeline import DecentralizedBatches

    batch = next(DecentralizedBatches(cfg, nodes, 2, 16, seed=0, device="cpu"))
    row = plan.schedule(1, seed=0).activations[0]
    bits = faults.make_fault_schedule(plan, 1, faults.FaultSpec(p_drop=0.35, seed=1)) \
        .node_bits(row, 0)
    opt = sgd(0.05, momentum=0.9)
    step = dt.make_train_step(model, opt, plan, faulted=True)

    def run(params, state):
        params, state, losses, _ = step(params, state, batch, torch.as_tensor(bits))
        return flatten(params), flatten(state), losses

    convert = lambda t: params_from_numpy(jax.tree.map(np.asarray, t), "cpu")
    want = run(convert(jparams), convert(jopt))
    ckpt.save_run_step(str(tmp_path / "port"), convert(jparams), convert(jopt), step=5)
    for root in ("jax", "port"):
        params, state, k = ckpt.restore_run(str(tmp_path / root), device="cpu")
        assert k == 5
        got = run(params, state)
        for a, b in zip(got[:2], want[:2]):
            assert a.keys() == b.keys()
            for path in b:
                assert torch.equal(a[path], b[path]), (root, path)
        assert torch.equal(got[2], want[2])


def test_cli_clock_with_stragglers_follows_the_reference_formula(tmp_path):
    """The CSV's simulated clock, built from the JAX package's own plan,
    schedule and fault schedule: one unit per activated matching, one for
    compute, and the slowest node's straggler units, summed in step order
    (exact: the same float additions)."""
    out = str(tmp_path / "run.csv")
    rows = train.main(["--device", "cpu", "--preset", "tiny", "--steps", "11",
                       "--straggler-prob", "0.5", "--straggler-units", "2.5",
                       "--fault-seed", "3", "--csv", out])
    jplan = jcore.plan_matcha(jcore.named_graph("paper8", 8, seed=3), 0.5, seed=0)
    sched = jplan.schedule(11, seed=0)
    fs = jfaults.make_fault_schedule(
        jplan, 11, jfaults.FaultSpec(straggler_prob=0.5, straggler_units=2.5, seed=3))
    want, clock = {}, 0.0
    for k in range(11):
        clock += sched.comm_units(k) + 1.0
        clock += fs.max_delay(k)
        want[k] = (clock, sched.comm_units(k))
    assert [r["step"] for r in rows] == [0, 10]
    assert sum(fs.max_delay(k) for k in range(11)) > 0
    for r in _csv_rows(out).values():
        assert (float(r["sim_time"]), int(r["comm_units"])) == want[int(r["step"])]
