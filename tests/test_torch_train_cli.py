"""The port's training CLI, run as a user runs it.

``python -m repro_torch.launch.train --device cpu --preset tiny --steps 3``
must train, for the dense internlm2, the Mamba2 and the dbrx (MoE)
smoke models alike, print the JAX CLI's step lines and write its CSV
columns; its step-0 loss must sit near the JAX CLI's ~6.26 (about ln
512 for the smoke vocab; not bit-equal, since the port initializes from
its own generator; tolerance 0.1). Without a card and without ``--device cpu``
it must refuse to run, and every flag it has not ported must exit with
the ROADMAP item that ports it.
"""
import csv
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mamba2_370m", "dbrx_132b"])
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
                                   "Model.init_cache"])
def test_library_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is usable here")
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.dist import decen_train as dt
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd

    cfg = get_smoke_config("internlm2_1_8b")
    calls = {
        "Model.init": lambda: Model(cfg).init(0),
        "init_stacked_params": lambda: dt.init_stacked_params(Model(cfg), 2),
        "init_stacked_opt_state": lambda: dt.init_stacked_opt_state(sgd(0.1, 0.9), Model(cfg), 2),
        "DecentralizedBatches": lambda: DecentralizedBatches(cfg, 2, 1, 4),
        "Model.init_cache": lambda: Model(cfg).init_cache(2, 8),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


@pytest.mark.parametrize("flags,item", [
    (["--shard", "2"], "item 15"),
    (["--model-par", "2"], "item 15"),
    (["--gossip-mode", "overlap"], "item 11"),
    (["--p-drop", "0.1"], "item 10"),
    (["--crash-at-step", "3"], "item 10"),
    (["--ckpt-dir", "ck"], "item 9"),
    (["--resume", "auto"], "item 9"),
    (["--trace", "tr"], "item 14"),
])
def test_unported_flags_exit_naming_the_roadmap_item(flags, item):
    with pytest.raises(SystemExit, match=item):
        train.main(["--device", "cpu", *flags])
