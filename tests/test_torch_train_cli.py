"""The port's training CLI, run as a user runs it.

``python -m repro_torch.launch.train --device cpu --preset tiny --steps 3``
must train, for the dense internlm2, the Mamba2, the dbrx (MoE),
gemma3, jamba, whisper (with its encoder frames) and internvl2 (with
its vision prefix) smoke models alike, print the JAX CLI's step lines and write its CSV
columns; its step-0 loss must sit near the JAX CLI's ~6.26 (about ln
512 for the smoke vocab; not bit-equal, since the port initializes from
its own generator; tolerance 0.1). Without a card and without ``--device cpu``
it must refuse to run, every flag it has not ported must exit with
the ROADMAP item that ports it, and ``--resume auto`` without
``--ckpt-dir`` must exit (the fault and checkpoint flags themselves run
in ``tests/test_torch_faults.py``). ``--gossip-mode overlap`` and
``--trace`` are ported: overlap trains (with and without link drops) and
ends with the flush line, ``--trace`` writes the three files the JAX
package's readers load, also when the run resumes, and an overlap run
that crashes after step 4 and resumes from its step-3 checkpoint ends
bit-equal to the unbroken run, as does a gemma3 run with a periodic
parameter tree.
"""
import csv
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro.telemetry.trace import read_chrome_trace, read_jsonl
from repro_torch import core
from repro_torch.checkpoint import ckpt
from repro_torch.faults import SimulatedCrash
from repro_torch.launch import train
from repro_torch.tree import flatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several test workers at once,
    and oversubscribed OpenMP threads slow these training loops tenfold
    (one thread is as fast here when the file runs alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    # one BLAS/OpenMP thread: the suite runs beside other test workers,
    # and spinning BLAS threads on shared cores slow the planner tenfold
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        env[var] = "1"
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO,
    )


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mamba2_370m", "dbrx_132b",
                                  "gemma3_4b", "jamba_v0_1_52b", "whisper_base",
                                  "internvl2_1b"])
def test_cli_trains_on_cpu_and_writes_csv(tmp_path, arch):
    out = tmp_path / "run.csv"
    res = _run(["--device", "cpu", "--arch", arch, "--preset", "tiny", "--steps", "3",
                "--csv", str(out)])
    assert res.returncode == 0, res.stderr[-4000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("step ")]
    assert [ln.split()[1] for ln in lines] == ["0", "2"]
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == ["step", "loss", "consensus", "sim_time", "comm_units", "wall"]
    assert [int(r["step"]) for r in rows] == [0, 2]
    for r in rows:
        assert math.isfinite(float(r["loss"])) and math.isfinite(float(r["consensus"]))
    assert abs(float(rows[0]["loss"]) - 6.26) < 0.1
    assert float(rows[0]["consensus"]) > 0
    # the paper's clock: one unit per activated matching plus one compute
    assert float(rows[0]["sim_time"]) == int(rows[0]["comm_units"]) + 1


def test_cli_without_a_card_needs_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is usable here")
    res = _run(["--preset", "tiny", "--steps", "1"])
    assert res.returncode != 0
    assert "--device cpu" in res.stderr
    assert "step " not in res.stdout


@pytest.mark.parametrize("entry", ["Model.init", "init_stacked_params",
                                   "init_stacked_opt_state", "DecentralizedBatches",
                                   "Model.init_cache", "init_gossip_state",
                                   "measure_matchings"])
def test_library_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is usable here")
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.dist import decen_train as dt
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd
    from repro_torch.telemetry.probes import measure_matchings

    cfg = get_smoke_config("internlm2_1_8b")
    plan = core.plan_vanilla(core.named_graph("ring", 4))
    calls = {
        "Model.init": lambda: Model(cfg).init(0),
        "init_stacked_params": lambda: dt.init_stacked_params(Model(cfg), 2),
        "init_stacked_opt_state": lambda: dt.init_stacked_opt_state(sgd(0.1, 0.9), Model(cfg), 2),
        "DecentralizedBatches": lambda: DecentralizedBatches(cfg, 2, 1, 4),
        "Model.init_cache": lambda: Model(cfg).init_cache(2, 8),
        "init_gossip_state": lambda: dt.init_gossip_state(
            plan, dt.param_bucket_plan(Model(cfg))),
        "measure_matchings": lambda: measure_matchings(plan, per_node_elements=8),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def _quick(steps):
    return ["--device", "cpu", "--preset", "tiny", "--steps", str(steps),
            "--batch-per-node", "2", "--seq", "32"]


def _check_ported(flags, tmp_path, capsys):
    """A flag ported since it was refused: it runs, as the JAX CLI's does."""
    flags = [f.replace("{tmp}", str(tmp_path)) for f in flags]
    if "--resume" in flags:       # a checkpoint to resume from
        train.main(_quick(2) + ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"])
        capsys.readouterr()
    rows = train.main(_quick(3) + flags)
    out = capsys.readouterr().out
    assert rows and all(math.isfinite(r["loss"]) for r in rows)
    if "overlap" in flags:
        assert "gossip overlap" in out
        assert "flushed in-flight gossip: consensus" in out
    if "--trace" in flags:
        tr = str(tmp_path / "tr")
        header, events = read_jsonl(os.path.join(tr, "events.jsonl"))
        assert header["schema"] == "repro.telemetry/1"
        assert events == read_chrome_trace(os.path.join(tr, "trace.json"))
        with open(os.path.join(tr, "metrics.jsonl")) as f:
            metrics = [json.loads(ln) for ln in f]
        first = 2 if "--resume" in flags else 0
        assert [m["step"] for m in metrics] == list(range(first, 3))
        assert [e.step for e in events if e.name == "step"] == list(range(first, 3))
        assert {f"gossip/matching{j}" for j in range(6)} <= {e.name for e in events}
        assert {"fwd_bwd", "optimizer", "gossip"} <= {e.name for e in events}
        if first:
            assert f"resumed from {tmp_path / 'ck' / 'step_00000002'} at step 2" in out


@pytest.mark.parametrize("flags,item", [
    (["--shard", "2", "--gossip-mode", "static"], "not static"),
    (["--model-par", "2"], "item 15"),
    (["--stream-layers"], "requires --shard > 1"),
    (["--no-stream-scan"], "ported"),
    (["--gossip-mode", "overlap"], "ported"),
    (["--gossip-mode", "overlap", "--p-drop", "0.1"], "ported"),
    (["--trace", "{tmp}/tr"], "ported"),
    (["--trace", "{tmp}/tr", "--ckpt-dir", "{tmp}/ck", "--resume", "auto"], "ported"),
])
def test_unported_flags_exit_naming_the_roadmap_item(flags, item, tmp_path, capsys):
    """Every flag the port has not implemented exits naming the ROADMAP
    item that ports it (``--model-par``); those ported since (overlap,
    ``--trace``, the FSDP flags) run instead, and the FSDP flags keep the
    JAX CLI's checks (``--stream-layers`` needs ``--shard > 1``, static
    gossip is refused with ``--shard > 1``)."""
    if item == "ported":
        _check_ported(flags, tmp_path, capsys)
        return
    with pytest.raises(SystemExit, match=item):
        train.main(["--device", "cpu", *flags])


def test_overlap_crash_and_resume_ends_bit_equal(tmp_path, capsys):
    """--gossip-mode overlap --ckpt-every 3, crashed after step 4, then
    --resume auto: the checkpoint holds the flushed params and the
    resumed run starts from a zero GossipState, so its final state equals
    the unbroken run's bit for bit."""
    base = _quick(8) + ["--gossip-mode", "overlap"]
    whole = train.main(base + ["--ckpt-dir", str(tmp_path / "a")])
    ck = str(tmp_path / "b")
    with pytest.raises(SimulatedCrash):
        train.main(base + ["--ckpt-dir", ck, "--ckpt-every", "3", "--crash-at-step", "4"])
    assert sorted(os.listdir(ck)) == ["step_00000003"]
    resumed = train.main(base + ["--ckpt-dir", ck, "--ckpt-every", "3", "--resume", "auto"])
    assert f"resumed from {os.path.join(ck, 'step_00000003')} at step 3" in capsys.readouterr().out
    # the simulated clock restarts at 0 on resume, as in the JAX CLI
    for key in ("step", "loss", "consensus"):
        assert resumed[-1][key] == whole[-1][key], key
    a = ckpt.restore_run(ckpt.find_resumable(str(tmp_path / "a")), device="cpu")
    b = ckpt.restore_run(ckpt.find_resumable(ck), device="cpu")
    assert a[2] == b[2] == 8
    fa, fb = flatten({"p": a[0], "s": a[1]}), flatten({"p": b[0], "s": b[1]})
    assert fa.keys() == fb.keys()
    for path, t in fa.items():
        assert torch.equal(fb[path], t), path


def test_periodic_gemma3_crash_and_resume_ends_bit_equal(tmp_path, capsys, monkeypatch):
    """gemma3 at 4 layers (one periodic segment: its params nest as
    ``blocks_0.pos_{j}``, each stacked over the repeats) checkpoints
    every 3 steps, crashes after step 4 and resumes with --resume auto;
    the final checkpoint equals the unbroken run's bit for bit."""
    from repro_torch.configs import gemma3_4b
    from repro_torch.models.transformer import Model, PeriodicSegment

    smoke = gemma3_4b.smoke_config
    monkeypatch.setattr(gemma3_4b, "smoke_config",
                        lambda: dataclasses.replace(smoke(), num_layers=4))
    assert isinstance(Model(gemma3_4b.smoke_config()).segments[0], PeriodicSegment)
    base = _quick(6) + ["--arch", "gemma3_4b", "--nodes", "4", "--graph", "ring"]
    whole = train.main(base + ["--ckpt-dir", str(tmp_path / "a")])
    ck = str(tmp_path / "b")
    with pytest.raises(SimulatedCrash):
        train.main(base + ["--ckpt-dir", ck, "--ckpt-every", "3", "--crash-at-step", "4"])
    resumed = train.main(base + ["--ckpt-dir", ck, "--ckpt-every", "3", "--resume", "auto"])
    assert f"resumed from {os.path.join(ck, 'step_00000003')} at step 3" in capsys.readouterr().out
    for key in ("step", "loss", "consensus"):
        assert resumed[-1][key] == whole[-1][key], key
    a = ckpt.restore_run(ckpt.find_resumable(str(tmp_path / "a")), device="cpu")
    b = ckpt.restore_run(ckpt.find_resumable(ck), device="cpu")
    fa, fb = flatten({"p": a[0], "s": a[1]}), flatten({"p": b[0], "s": b[1]})
    assert "p.blocks_0.pos_1.mixer.wq.w" in fa and fa.keys() == fb.keys()
    for path, t in fa.items():
        assert torch.equal(fb[path], t), path


@pytest.mark.parametrize("flags", [
    ["--resume", "auto"],
    ["--resume", "auto", "--p-drop", "0.35", "--ckpt-every", "3"],
])
def test_resume_auto_without_ckpt_dir_exits(flags):
    with pytest.raises(SystemExit, match="--resume auto requires --ckpt-dir"):
        train.main(["--device", "cpu", *flags])
