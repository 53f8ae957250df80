"""Whole runs of the harness on the CPU at the smoke size (the look for
a card skipped), all in one fresh process: the shape of the last line,
plain and traced, the import check, and the control and the planted
faults that ``correct`` has to catch; and the refusal without a card."""
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.faults import PLANTS
from perfbench.tests.smoke import C1, child_env, run_all

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def runs():
    """One process: a clean run with the control, a traced run, one run a fault."""
    rows = run_all("--workload", C1, "--control", "--runs", ",".join(("clean", "traced") + PLANTS))
    return {row["run"]: row for row in rows}


def test_last_line_shape_and_no_jax(runs):
    row = runs["clean"]
    res = row["result"]
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"tokens_per_s", "mfu", "setup_s"}
    assert all(set(m) == {"value", "unit"} and m["value"] > 0 for m in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["checks"]) == {"loss_gap", "grad_gap", "change_gap"}
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    assert all(r["loaded"] == [] for r in runs.values())
    # the control (float8 matmuls) fails at least one number
    assert any(row["control"][k] > c["limit"] for k, c in res["checks"].items())


def test_traced_line_has_the_per_layer_metrics_and_a_breakdown(runs):
    res = runs["traced"]["result"]
    assert res["correct"] is True and list(res)[-1] == "checks"
    # on the CPU no device metric reads: the spans and the step's share do
    assert set(res["metrics"]) == {"fwd_bwd_ms", "optimizer_ms", "gossip_ms", "step_mfu"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])


@pytest.mark.parametrize("plant", PLANTS)
def test_a_planted_fault_makes_correct_false(runs, plant):
    res = runs[plant]["result"]
    assert res["correct"] is False, res["checks"]


def test_run_refuses_without_a_card():
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", C1, "--seed", "1",
                           "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                          timeout=120, cwd=ROOT, env=child_env())
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr
