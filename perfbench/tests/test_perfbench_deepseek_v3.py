"""The Moonlight cell (``moonlight-ep8.matcha50.seq8192``, reference
family ``deepseek_v3``) cut to a CPU test's size: the float32 reference
against the port, whole runs of the harness (plain with the control,
traced, one run a planted fault), the readers of ``mla_ms`` and
``moe_ms``, the configuration file, and the flop count by hand.

``smoke.py``'s tables are keyed by family and hold the dense decoder's
cut; this file holds the deepseek_v3 family's (``SMOKE``,
``SMOKE_LIMITS``) and, run as a script, drives its runs in a fresh
process as ``smoke.py`` does:

    python perfbench/tests/test_perfbench_deepseek_v3.py --runs clean,traced,half_batch
"""
import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import pytest  # noqa: E402

from perfbench import manifest, weights  # noqa: E402
from perfbench.faults import PLANTS  # noqa: E402
from perfbench.tests.smoke import child_env  # noqa: E402

CELL = "moonlight-ep8.matcha50.seq8192"

# The cell at the smoke size: every width cut, the structure kept (one
# dense layer and one MoE layer, 8 of a 16-expert router held, top-4).
SMOKE = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, head_dim=48, d_ff=256,
             vocab_size=512, vocab_rows=512, moe_num_experts=8, moe_router_experts=16,
             moe_top_k=4, moe_d_ff=64, moe_shared_d_ff=128, mla_kv_rank=32, mla_rope_dim=16,
             mla_v_dim=32)

# The limits at this size, set as the cell's are (PERF.md section 2):
# each lower + 0.6 x (upper - lower). Readings over 11 seeds (2**31 + 5
# .. 2**31 + 15) on the CPU: the program's largest loss / grad / change
# gaps 0.00755 / 0.0258 / 0.01638; the control's smallest 0.01218 /
# 0.04905 / 0.02915, 1.6x / 1.9x / 1.8x the program's. loss and grad lie
# between the program's and the control's readings, so the control fails
# both; change, the widest gap of a leaf, takes the smallest fault at 10x
# the program's or more (half_batch's 0.396).
SMOKE_LIMITS = {"loss_gap": 0.0103, "grad_gap": 0.0398, "change_gap": 0.244}


def smoke_cell(root: Path = ROOT):
    cell = manifest.cell(CELL, root)
    cell.config = dict(cell.config, **SMOKE)
    cell.limits = dict(SMOKE_LIMITS)
    cell.traffic = dict(cell.traffic, seq=min(cell.traffic["seq"], 64), batches=12,
                        trace_steps=2)
    return cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=2**31 + 5)
    ap.add_argument("--runs", default="clean")
    args = ap.parse_args(argv)
    import torch

    from perfbench.drivers import matcha_train as mt
    from perfbench.reference import decen

    torch.set_num_threads(1)
    cell = smoke_cell()
    for run in args.runs.split(","):
        plant = None if run in ("clean", "traced") else run
        out = mt.run_cell(cell, args.seed, 0.2, run == "traced", time.time(), device="cpu",
                          plant=plant)
        row = {"run": run, "result": out["result"], "gaps": out["gaps"],
               "loaded": mt.forbidden_modules()}
        if run == "clean":
            cpu = torch.device("cpu")
            ref = mt.reference(cell.config, cell.traffic, cell.family(), args.seed, cpu)
            ctl = mt.reference(cell.config, cell.traffic, cell.family(), args.seed, cpu, "fp8")
            row["control"] = decen.compare(ctl, ref)
        print(json.dumps(row), flush=True)
    return 0


@pytest.fixture(scope="module")
def runs():
    """One fresh process: a clean run with the control, a traced run, one
    run a fault."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--runs",
                           ",".join(("clean", "traced") + PLANTS)],
                          capture_output=True, text=True, timeout=600, cwd=ROOT,
                          env=child_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    return {row["run"]: row for row in rows}


def test_clean_run_is_correct_and_the_control_is_not(runs):
    row = runs["clean"]
    res = row["result"]
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"tokens_per_s", "mfu", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert set(res["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    assert all(r["loaded"] == [] for r in runs.values())
    assert any(row["control"][k] > c["limit"] for k, c in res["checks"].items())


def test_traced_line_has_the_shape_of_the_dense_cells(runs):
    res = runs["traced"]["result"]
    assert res["correct"] is True and list(res)[-1] == "checks"
    # the cell's per-layer metrics split the card's time: none reads on the CPU
    assert res["metrics"] == {}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])


@pytest.mark.parametrize("plant", PLANTS)
def test_each_planted_fault_makes_correct_false(runs, plant):
    assert runs[plant]["result"]["correct"] is False, runs[plant]["result"]["checks"]


def test_reference_loss_and_gradients_match_the_port_in_fp32():
    import torch

    from perfbench.drivers.matcha_train import _nest, program_config
    from repro_torch.models.transformer import Model
    from repro_torch.tree import flatten

    c = smoke_cell().config
    ref = manifest.load_module(ROOT / "perfbench" / "reference" / "deepseek_v3.py")
    cfg = dataclasses.replace(program_config(c), compute_dtype="float32")
    assert (cfg.moe_num_experts, cfg.router_experts, cfg.mla_kv_rank) == (8, 16, 32)
    model = Model(cfg)
    flat = weights.make(ref.param_specs(c), 2**31 + 3, "cpu")
    assert {k: tuple(v.shape) for k, v in flat.items()} == {
        k: tuple(s) for k, (s, _) in flatten(model.param_shapes()).items()}
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, c["vocab_size"], (2, 64), generator=gen, dtype=torch.int32)
    labels = torch.randint(0, c["vocab_size"], (2, 64), generator=gen, dtype=torch.int32)
    ours = {k: v.clone().requires_grad_() for k, v in flat.items()}
    loss_ref = ref.loss(ours, tokens, labels, c)
    g_ref = torch.autograd.grad(loss_ref, list(ours.values()))
    theirs = {k: v.clone().requires_grad_() for k, v in flat.items()}
    loss_port, _ = model.loss(_nest(theirs), {"tokens": tokens, "labels": labels})
    g_port = torch.autograd.grad(loss_port, list(theirs.values()))
    assert float(loss_ref.detach()) == pytest.approx(float(loss_port.detach()), rel=1e-5)
    for k, a, b in zip(ours, g_ref, g_port):
        assert float((a - b).norm()) / (float(b.norm()) + 1e-12) < 1e-4, k


def test_fp8_control_differs_from_fp32():
    import torch

    c = smoke_cell().config
    ref = manifest.load_module(ROOT / "perfbench" / "reference" / "deepseek_v3.py")
    flat = weights.make(ref.param_specs(c), 5, "cpu")
    tokens = torch.randint(0, c["vocab_size"], (1, 32), generator=torch.Generator().manual_seed(2))
    a = float(ref.loss(flat, tokens, tokens, c, "fp32"))
    b = float(ref.loss(flat, tokens, tokens, c, "fp8"))
    assert a != b and abs(a - b) < 0.1 * a


def test_flop_count_against_a_hand_count():
    ref = manifest.load_module(ROOT / "perfbench" / "reference" / "deepseek_v3.py")
    conf = manifest.cell(CELL).config
    # per layer, MLA: wq 2048 x 16 x 192 + wkv_a 2048 x 576 + wkv_b 512 x 16 x 256
    # + wo 16 x 128 x 2048; the dense layer's SwiGLU 3 x 2048 x 11264; a MoE
    # layer's router 2048 x 64, shared 3 x 2048 x 2816 and 0.75 held pairs of
    # 3 x 2048 x 1408; the head 2048 x 20480
    mla = 2048 * 3072 + 2048 * 576 + 512 * 4096 + 2048 * 2048
    moe = 2048 * 64 + 3 * 2048 * 2816 + 0.75 * 3 * 2048 * 1408
    layers = conf["num_layers"]
    matmul = layers * mla + 3 * 2048 * 11264 + (layers - 1) * moe + 2048 * 20480
    assert mla == 13_762_560 and moe == 23_920_640
    per_token = ref.flops_per_token(conf, 8192)
    assert per_token == pytest.approx(6 * matmul + 3 * layers * 2 * (192 + 128) * 16 * 8193 / 2,
                                      rel=1e-12)


def test_configuration_file_states_the_cut_and_the_deployment():
    conf = manifest.cell(CELL).config
    bench = manifest.load()
    entry, = [c for c in bench["configs"] if c["file"].endswith("moonlight-16b-a3b-ep8.json")]
    assert sorted(conf["reduced"]) == sorted(entry["reduced"])
    assert conf["published"] == {"num_layers": 27, "moe_num_experts": 64,
                                 "vocab_size": 163840, "vocab_rows": 163840}
    assert conf["moe_num_experts"] == 8 and conf["moe_router_experts"] == 64
    assert conf["vocab_size"] * 8 == conf["published"]["vocab_size"]
    assert conf["num_layers"] - conf["moe_first_dense"] >= 4
    # the widths as published (the catalog's keys beside the port's)
    assert (conf["d_model"], conf["hidden_size"]) == (2048, 2048)
    assert (conf["head_dim"], conf["qk_nope_head_dim"] + conf["qk_rope_head_dim"]) == (192, 192)
    assert (conf["mla_kv_rank"], conf["mla_v_dim"], conf["moe_d_ff"]) == (512, 128, 1408)
    assert conf["moe_shared_d_ff"] == conf["n_shared_experts"] * conf["moe_intermediate_size"]
    assert conf["moe_top_k"] == conf["num_experts_per_tok"] == 6
    assert conf["rms_eps"] == conf["rms_norm_eps"] == 1e-5
    assert "8 H100s" in conf["deployment"]


def _window(**phases):
    return {"steps": 2, "window_s": 0.2, "step_ms": [100.0] * 2, "start_wall": 0.0,
            "phases": [dict(phases, step=99.0, forward=30.0),
                       {k: v + 2 for k, v in dict(phases, step=99.0).items()}],
            "profile": {"steps": 1, "window_s": 0.1, "busy_s": 0.07}}


@pytest.mark.parametrize("name,span", [("mla_ms", "mla"), ("moe_ms", "moe")])
def test_block_span_readers(name, span):
    reader = manifest.load_module(ROOT / "perfbench" / "metrics" / f"{name}.py")
    read = lambda *w: reader.read(SimpleNamespace(windows=list(w)))  # noqa: E731
    win = _window(**{span: 10.0, f"{span}/backward": 20.0})
    assert read(win) == pytest.approx(32.0)          # (30 + 34) / 2
    assert read(win, _window(**{span: 14.0, f"{span}/backward": 20.0})) == pytest.approx(34.0)
    # on the CPU (no device activity), and from a program without the spans
    assert read(dict(win, profile={"busy_s": 0.0})) is None
    assert read(_window(fwd_bwd=5.0)) is None
    entry, = [m for m in manifest.load(ROOT)["per_layer"] if m["name"] == name]
    assert entry["source"] == "program_span" and entry["moves"] == "tokens_per_s"
    assert entry["workloads"] == [CELL]


if __name__ == "__main__":
    sys.exit(main())
