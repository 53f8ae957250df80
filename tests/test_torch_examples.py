"""The port's examples (``python -m repro_torch.examples.<name>``) on the
CPU with ``--device cpu``, at small step counts, in-process and once as
a module; and without a card, the default device exits."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.examples import quickstart, serve_batched, topology_explorer
from repro_torch.examples import train_decentralized

REPO = Path(__file__).resolve().parents[1]


def test_quickstart_matcha_against_vanilla(capsys):
    res = quickstart.main(["--device", "cpu", "--steps", "4"])
    out = capsys.readouterr().out
    assert "CB" in out and "rho(MATCHA)" in out and "MATCHA reaches loss" in out
    (v_loss, v_time), (m_loss, m_time) = res["vanilla"], res["matcha"]
    # MATCHA at budget 0.5 pays about half of vanilla's simulated time
    assert m_time < v_time and abs(m_loss - v_loss) < 0.1


def test_topology_explorer_checks_rho_on_the_device(capsys):
    rows = topology_explorer.main(["--device", "cpu"])
    assert len(rows) == 5
    # a denser graph: more matchings, vanilla's delay grows, MATCHA's stays below it
    assert rows[-1][2] > rows[0][2]
    assert all(delay_m < delay_v for *_, delay_v, delay_m in rows)
    assert "vanilla rho checked on cpu" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["internlm2_1_8b", "mamba2_370m"])
def test_serve_batched(arch):
    res = serve_batched.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                              "--prompt-len", "16", "--gen", "4"])
    assert res["generated"].shape == (2, 4)
    assert bool(torch.isfinite(res["logits"]).all())


@pytest.mark.parametrize("mode", ["masked", "overlap"])
def test_train_decentralized_loss_decreases(mode, tmp_path):
    res = train_decentralized.main(["--device", "cpu", "--steps", "4", "--gossip-mode", mode,
                                    "--ckpt-dir", str(tmp_path / "ck")])
    assert res["losses"][-1] < res["losses"][0]
    assert (tmp_path / "ck" / "ckpt.json").exists()


def test_train_decentralized_fsdp_exits_naming_item_15(monkeypatch):
    """The FSDP half of ROADMAP item 15 is ported: ``--shard 2`` starts
    two ranks, one card each, and a host with fewer cards exits naming
    both counts (the run itself is in tests/test_torch_mesh.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="2 ranks need one CUDA card each, but this host "
                                         "has 1 card"):
        train_decentralized.main(["--shard", "2"])


@pytest.mark.parametrize("name", ["quickstart", "topology_explorer", "serve_batched",
                                  "train_decentralized"])
def test_examples_need_a_card_unless_told_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device would run")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}"],
                         capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert res.returncode != 0
    assert "no CUDA device is visible" in res.stderr
