"""The port's mesh over ``torch.distributed`` and its multi-rank runs.

In process: the ``(data, shard)`` mesh (ranks, groups' members, the
mismatch errors), ``sharding.num_nodes`` / ``num_shards`` /
``make_spec`` and the node-axis exchange plan's pair order.

Over gloo, each run in ranks of ``tests/torch_dist_worker.py`` with a
timeout of its own (every rank killed when it runs out):

* nodes over 2 data ranks (each matching whose partners sit apart a
  paired send/recv): bit-equal to the single-process step in masked,
  static and overlap modes;
* S 2 (2 shard ranks): the monolithic and streamed sharded steps, the
  overlap step and flush, and the faulted step with all-ones gates,
  within 5e-5 of the replicated step (tests/test_fsdp_parity.py's limit);
* a 2 x 2 world: the streamed step within the same;

and the training CLI: ``--shard 2`` starts its two ranks and prints the
JAX CLI's ``fsdp:`` lines (their numbers from the JAX package's own
layouts); a ``--shard 2`` streamed checkpoint resumes under
``--no-stream-layers``, under ``--shard 1`` and in the JAX package's
``restore_run`` with the next step's loss of the unbroken run.
``--model-par`` below 1 exits (``tests/test_torch_tp.py`` holds the
model axis's worlds).
"""
import csv
import os
import signal
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.data.pipeline import DecentralizedBatches as JaxBatches
from repro.dist import fsdp as jf
from repro.models.transformer import Model as JaxModel
from repro_torch.checkpoint import ckpt
from repro_torch.dist import decen_train as dt
from repro_torch.dist import sharding as shd
from repro_torch.dist.gossip import NodeAxis, Partners
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train
from repro_torch.tree import flatten

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_dist_worker import run_world  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
MULTI_TOL = 5e-5                                    # tests/test_fsdp_parity.py:209-211


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny models run as fast on one torch thread, and the suite runs
    several test processes at once: more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# In process
# ---------------------------------------------------------------------------
def test_mesh_ranks_and_the_count_authorities():
    m = mesh_lib.Mesh(2, 2, rank=3)
    assert (m.axis_names, m.shape, m.size) == (
        ("data", "shard", "model"), {"data": 2, "shard": 2, "model": 1}, 4)
    assert (m.data_rank, m.shard_rank) == (1, 1)
    assert [m.global_rank(d) for d in range(2)] == [1, 3]
    assert m.global_rank(0, 0) == 0
    with pytest.raises(ValueError, match="outside a mesh of 4"):
        mesh_lib.Mesh(2, 2, rank=4)
    with pytest.raises(ValueError, match=">= 1"):
        mesh_lib.Mesh(0, 1)
    one = mesh_lib.make_test_mesh()
    assert (one.size, one.shard_group, one.data_group) == (1, None, None)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        mesh_lib.make_test_mesh(data=2, shard=2)
    with pytest.raises(ValueError, match="needs a world of ranks"):
        mesh_lib.make_mesh(shard=2)
    assert shd.num_shards(m) == 2 and shd.num_nodes(m, 8) == 8
    assert shd.node_range(m, 8) == (4, 8)
    with pytest.raises(ValueError, match="do not split evenly over 2 data ranks"):
        shd.num_nodes(m, 5)
    with pytest.raises(ValueError, match="'pod' axis"):
        shd.num_nodes(m, 8, multi_pod=True)
    spec = dt.make_spec(m, 8)
    assert (spec.node_lo, spec.node_hi, spec.local_nodes, spec.num_shards) == (4, 8, 4, 2)
    assert spec.node_axis == NodeAxis(8, 4, 8, (1, 3))
    assert dt.make_spec(one, 8).node_axis is None
    assert train.main.__module__ == "repro_torch.launch.train"
    assert mesh_lib.backend_for("cpu") == "gloo" and mesh_lib.backend_for("cuda") == "nccl"


def test_exchange_plans_pair_rows_in_the_same_order_on_both_ranks():
    """A matching whose pairs cross data ranks in opposite orders (node 0
    with 3, node 1 with 2): both sides pack the rows by the pair's lower
    node, so the k-th row sent is the k-th row the peer expects."""
    perms = np.array([[3, 2, 1, 0], [1, 0, 3, 2]])
    plans = [Partners(perms, NodeAxis(4, lo, lo + 2, (0, 1)), "cpu").plans
             for lo in (0, 2)]
    (dst0, src0, peers0), (dst1, src1, peers1) = plans[0][0], plans[1][0]
    assert dst0.numel() == dst1.numel() == 0
    (p0, rows0), = peers0
    (p1, rows1), = peers1
    assert (p0, p1) == (1, 0)
    # rank 0 sends node 0 (pair 0-3) then node 1 (pair 1-2); rank 1 receives
    # into node 3 (pair 0-3) then node 2 (pair 1-2)
    assert rows0.tolist() == [0, 1] and rows1.tolist() == [1, 0]
    (dst, src, peers) = plans[0][1]
    assert dst.tolist() == [0, 1] and src.tolist() == [1, 0] and not peers
    x = torch.arange(8.0).reshape(4, 2)
    whole = Partners(perms, None, "cpu")
    assert torch.equal(whole(x, 0), x[[3, 2, 1, 0]])


# ---------------------------------------------------------------------------
# Gloo worlds (each with its own timeout)
# ---------------------------------------------------------------------------
def test_nodes_over_two_data_ranks_are_bit_equal_to_one_process():
    res = run_world("r2", 2, timeout=120)
    for mode in ("masked", "static", "overlap"):
        assert res[mode]["params"] == 0.0 and res[mode]["loss"] == 0.0, (mode, res[mode])
        assert res[mode]["consensus"] <= 1e-6, (mode, res[mode])


def test_two_shard_ranks_match_the_replicated_step():
    res = run_world("s2", 2, timeout=120)
    assert set(res) == {"masked_mono", "masked_stream", "masked_stream_faulted",
                        "overlap_mono", "overlap_stream"}
    for name, r in res.items():
        assert r["params"] <= MULTI_TOL and r["loss"] <= MULTI_TOL, (name, r)
        assert r["consensus"] <= 1e-6, (name, r)
    assert res["masked_mono"]["buckets"] == 1 and res["masked_stream"]["buckets"] == 4


def test_a_two_by_two_world_matches_the_replicated_step():
    res = run_world("w22", 4, timeout=120)
    assert res["params"] <= MULTI_TOL and res["loss"] <= MULTI_TOL, res
    assert res["consensus"] <= 1e-6, res


# ---------------------------------------------------------------------------
# The training CLI
# ---------------------------------------------------------------------------
CLI = ["--device", "cpu", "--preset", "tiny", "--graph", "ring", "--nodes", "4"]


def _cli(*flags, timeout=120):
    """The CLI in a process group of its own (``--shard 2`` starts two
    more ranks); the whole group is killed when ``timeout`` runs out."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *CLI, *flags],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=REPO, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"the CLI did not finish in {timeout} s") from None
    assert proc.returncode == 0, err[-4000:]
    return out


def _csv(path):
    with open(path, newline="") as f:
        return {int(r["step"]): float(r["loss"]) for r in csv.DictReader(f)}


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    """``--shard 2`` (streamed) for 3 steps, checkpointing every 2."""
    tmp = tmp_path_factory.mktemp("shard2")
    out = _cli("--shard", "2", "--steps", "3", "--ckpt-dir", str(tmp / "ck"),
               "--ckpt-every", "2", "--csv", str(tmp / "a.csv"))
    return types.SimpleNamespace(out=out, ck=tmp / "ck", tmp=tmp, rows=_csv(tmp / "a.csv"))


def test_cli_shard_2_prints_the_jax_clis_fsdp_lines(sharded_run):
    """The lines' numbers come from the JAX package's own layout of the
    tiny internlm2 at S 2 (no JAX mesh needed for a layout)."""
    jmodel = JaxModel(jax_smoke_config("internlm2_1_8b"))
    layout = jf.make_stream_layout(jmodel, types.SimpleNamespace(num_nodes=4, num_shards=2))
    want = [
        f"fsdp: shard=2, {layout.per_device_elements * 4 / 1e6:.2f} MB params/device "
        f"(of {layout.plan.total_elements * 4 / 1e6:.2f} MB/replica)",
        f"fsdp: streaming {layout.plan.num_buckets} layer groups "
        f"({', '.join(layout.group_names)}); per-iteration peak gathered view "
        f"{layout.plan.max_group_elements * 4 / 1e6:.2f} MB vs "
        f"{layout.plan.total_elements * 4 / 1e6:.2f} MB monolithic",
    ]
    got = [ln for ln in sharded_run.out.splitlines() if ln.startswith("fsdp:")]
    assert got == want
    assert "mesh data 1 x shard 2 (4 nodes a data rank)" in sharded_run.out
    assert sorted(sharded_run.rows) == [0, 2]
    assert sorted(os.listdir(sharded_run.ck)) == ["step_00000002", "step_00000003"]
    with pytest.raises(SystemExit, match="--model-par must be >= 1"):
        train.main([*CLI, "--model-par", "0"])
    with pytest.raises(SystemExit, match="must divide by --shard 2"):
        train.main([*CLI, "--shard", "2", "--batch-per-node", "3"])


def test_shard_2_streamed_checkpoint_resumes_across_layouts_shards_and_packages(
        sharded_run, capsys):
    """From the step-2 checkpoint of the streamed S 2 run: the
    monolithic S 2 run, the S 1 run and the JAX package's model on the
    JAX package's restore give the unbroken run's step-2 loss."""
    step2 = str(sharded_run.ck / "step_00000002")
    want = sharded_run.rows[2]
    _cli("--shard", "2", "--no-stream-layers", "--steps", "3", "--resume", step2,
         "--csv", str(sharded_run.tmp / "b.csv"))
    assert _csv(sharded_run.tmp / "b.csv")[2] == want
    rows = train.main([*CLI, "--steps", "3", "--resume", step2])
    assert f"resumed from {step2} at step 2" in capsys.readouterr().out
    np.testing.assert_allclose(rows[-1]["loss"], want, rtol=1e-6)
    # the JAX package restores the same bits and computes the same loss
    jparams, _, jstep = jckpt.restore_run(step2)
    params, _, _ = ckpt.restore_run(step2, device="cpu")
    assert jstep == 2
    got = {".".join(k.key for k in p): np.asarray(v)
           for p, v in jax.tree_util.tree_leaves_with_path(jparams)}
    for k, v in flatten(params).items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    cfg = jax_smoke_config("internlm2_1_8b")
    it = iter(JaxBatches(cfg, 4, 4, 128, seed=0))
    for _ in range(2):
        next(it)
    batch = next(it)
    loss = jax.jit(lambda p, b: JaxModel(cfg).loss(p, b)[0])
    node = lambda t, i: jax.tree.map(lambda a: a[i], t)
    jloss = float(np.mean([loss(node(jparams, i), node(batch, i)) for i in range(4)]))
    # bf16 compute in both packages, rounded at other places
    np.testing.assert_allclose(jloss, want, rtol=2e-3)
    info = ckpt.verify_run(step2)
    assert (info["shard"], info["stream_layers"], info["num_nodes"]) == (2, True, 4)


# ---------------------------------------------------------------------------
# --model-par: the CLIs and checkpoints across model factors and packages
# ---------------------------------------------------------------------------
SHORT = ["--steps", "3", "--seq", "32"]


def _start(*args, module="repro_torch.launch.train"):
    """The CLI in a process group of its own, started (``_finish`` waits)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    extra = CLI if module.endswith("train") else []
    return subprocess.Popen([sys.executable, "-m", module, *extra, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=REPO, start_new_session=True)


def _finish(proc, timeout=150):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"the CLI did not finish in {timeout} s") from None
    assert proc.returncode == 0, err[-4000:]
    return out


SERVE = ["--device", "cpu", "--batch", "4", "--prompt-len", "16", "--gen", "6"]


@pytest.fixture(scope="module")
def model_par_runs(tmp_path_factory):
    """Side by side: 3 steps at ``--model-par 2`` and at ``--shard 2
    --model-par 2``, each checkpointing every 2, the serving CLI at
    ``--data-par 2 --model-par 2``; then the training run at
    ``--model-par 1`` in process."""
    tmp = tmp_path_factory.mktemp("model_par")
    procs = {name: _start(*flags, *SHORT, "--ckpt-dir", str(tmp / name), "--ckpt-every", "2",
                          "--csv", str(tmp / f"{name}.csv"))
             for name, flags in (("t2", ["--model-par", "2"]),
                                 ("s2t2", ["--shard", "2", "--model-par", "2"]))}
    serve = _start(*SERVE, "--data-par", "2", "--model-par", "2",
                   module="repro_torch.launch.serve")
    runs = {name: types.SimpleNamespace(out=_finish(p), ck=tmp / name,
                                        rows=_csv(tmp / f"{name}.csv"))
            for name, p in procs.items()}
    runs["serve"] = _finish(serve)
    runs["t1"] = types.SimpleNamespace(rows={r["step"]: r["loss"] for r in train.main(
        [*CLI, *SHORT])})
    return types.SimpleNamespace(tmp=tmp, **runs)


def test_cli_model_par_2_trains_like_model_par_1(model_par_runs):
    """The header names the mesh and the whole model's parameter count;
    the losses are the world of one's within bf16 compute rounding (T
    changes the order of the row-parallel sums)."""
    t2, s2t2, t1 = model_par_runs.t2, model_par_runs.s2t2, model_par_runs.t1
    n = JaxModel(jax_smoke_config("internlm2_1_8b")).num_params()
    assert f"({n} params/node)" in t2.out
    assert "mesh data 1 x shard 1 x model 2 (4 nodes a data rank)" in t2.out
    assert "mesh data 1 x shard 2 x model 2 (4 nodes a data rank)" in s2t2.out
    assert [ln for ln in s2t2.out.splitlines() if ln.startswith("fsdp:")]
    for run in (t2, s2t2):
        assert sorted(run.rows) == [0, 2]
        for k in (0, 2):
            np.testing.assert_allclose(run.rows[k], t1.rows[k], rtol=1e-3)
        assert sorted(os.listdir(run.ck)) == ["step_00000002", "step_00000003"]


def test_model_par_checkpoints_resume_across_model_factors_and_packages(model_par_runs,
                                                                        capsys):
    """A ``--model-par 2`` checkpoint (and one of ``--shard 2 --model-par
    2``) holds the whole tree in the JAX format: the JAX package restores
    the same bytes; resumed at ``--model-par 2`` it gives the unbroken
    run's next loss within bf16 compute rounding, and the JAX model's
    loss on it (bf16 compute in both packages). A save by the JAX package
    of the same bytes resumes at ``--model-par 2`` with the unbroken
    run's next loss exactly."""
    runs = model_par_runs
    step2 = str(runs.t2.ck / "step_00000002")
    jparams, jstate, jstep = jckpt.restore_run(step2)
    params, _, _ = ckpt.restore_run(step2, device="cpu")
    got = {".".join(k.key for k in p): np.asarray(v)
           for p, v in jax.tree_util.tree_leaves_with_path(jparams)}
    for k, v in flatten(params).items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    for name in ("t2", "s2t2"):
        ck = str(getattr(runs, name).ck / "step_00000002")
        rows = train.main([*CLI, *SHORT, "--resume", ck])
        assert f"resumed from {ck} at step 2" in capsys.readouterr().out
        np.testing.assert_allclose(rows[-1]["loss"], getattr(runs, name).rows[2], rtol=1e-3)
    cfg = jax_smoke_config("internlm2_1_8b")
    it = iter(JaxBatches(cfg, 4, 4, 32, seed=0))
    for _ in range(2):
        next(it)
    batch = next(it)
    loss = jax.jit(lambda p, b: JaxModel(cfg).loss(p, b)[0])
    node = lambda t, i: jax.tree.map(lambda a: a[i], t)
    jloss = float(np.mean([loss(node(jparams, i), node(batch, i)) for i in range(4)]))
    np.testing.assert_allclose(jloss, rows[-1]["loss"], rtol=2e-3)
    # the JAX package's own save of the same state: its bytes restore into
    # the unbroken run's next step exactly
    jroot = str(runs.tmp / "jax")
    jdir = jckpt.save_run_step(jroot, jparams, jstate, step=jstep,
                               extra={"shard": 1, "stream_layers": False,
                                      "stream_scan": True})
    _cli("--model-par", "2", *SHORT, "--resume", jdir, "--csv", str(runs.tmp / "rj.csv"))
    assert _csv(runs.tmp / "rj.csv")[2] == runs.t2.rows[2]


def test_serve_cli_model_par_2_gives_the_world_of_ones_tokens(model_par_runs, capsys):
    """``--data-par 2 --model-par 2`` over gloo (four ranks, each data
    rank serving 2 of the 4 requests): the JAX CLI's lines, and the
    greedy tokens of the world of one."""
    from repro_torch.launch import serve

    one = serve.main(SERVE)
    want, got = capsys.readouterr().out, model_par_runs.serve
    assert "mesh data 2 x model 2" in got
    ids = [[ln for ln in out.splitlines() if ln.startswith("generated token ids")]
           for out in (want, got)]
    assert ids[0] and ids[1] == ids[0]
    assert one["generated"].shape == (4, 6)
    for out in (want, got):
        assert "arch=internlm2-smoke batch=4 prompt=16 gen=6" in out
        assert "prefill:" in out and "ms/token" in out
