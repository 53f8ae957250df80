"""A cell of the benchmark cut to a CPU test's size, and runs of it.

``smoke_cell`` keeps a cell's traffic and structure and gives its
configuration the port's smoke widths (2 layers, d_model 128, vocab 512),
with short sequences and few batches. Run as a script, it drives the
rest of a benchmark run on the CPU (the look for a card skipped), once
for each entry of ``--runs``: ``clean``, ``traced`` (``--trace 1``) or
the name of a fault planted under the timed path. It prints one JSON
line a run: the result, the gaps, the JAX modules loaded, and for a
clean run with ``--control`` the control's gaps.

    python perfbench/tests/smoke.py --workload <cell> --runs clean,traced,half_batch [--control]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
C1 = "internlm2-d10.matcha50.seq4096"

SMOKE = {
    "dense_decoder": dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
                          d_ff=256, vocab_size=512, vocab_rows=512),
}


# The limits at this size, set as the cells' are (perfbench/limits, PERF.md):
# above the largest reading of the program over 11 seeds on the CPU, below
# the control's smallest where that is 3x the program's or more, else below
# the smallest planted fault that reads 10x the program's or more.
SMOKE_LIMITS = {
    "dense_decoder": {"loss_gap": 0.0049, "grad_gap": 0.0165, "change_gap": 0.0073},
}


def smoke_cell(name: str, root: Path = ROOT):
    from perfbench import manifest

    cell = manifest.cell(name, root)
    family = cell.config["reference"]
    cell.config = dict(cell.config, **SMOKE[family])
    cell.limits = dict(SMOKE_LIMITS[family])
    cell.traffic = dict(cell.traffic, seq=min(cell.traffic["seq"], 64), batches=12,
                        trace_steps=2)
    return cell


def child_env() -> dict:
    """A child's environment: one thread a process, no inherited PYTHONPATH."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return env


def run_all(*args, timeout: float = 300) -> list:
    """This script in a fresh process; its JSON lines, one a run."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), *args],
                          capture_output=True, text=True, timeout=timeout, cwd=ROOT,
                          env=child_env())
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr[-3000:])
    return [json.loads(line) for line in proc.stdout.strip().splitlines()
            if line.startswith("{")]


def main(argv=None) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 5)
    ap.add_argument("--seconds", type=float, default=0.2)
    ap.add_argument("--runs", default="clean",
                    help="comma-separated: clean, traced, or a fault to plant; a run each")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from perfbench.drivers import matcha_train as mt
    from perfbench.reference import decen

    torch.set_num_threads(1)
    cell = smoke_cell(args.workload)
    for run in args.runs.split(","):
        plant = None if run in ("clean", "traced") else run
        out = mt.run_cell(cell, args.seed, args.seconds, run == "traced", time.time(),
                          device="cpu", plant=plant)
        row = {"run": run, "result": out["result"], "gaps": out["gaps"],
               "loaded": mt.forbidden_modules()}
        if args.control and run == "clean":
            cpu = torch.device("cpu")
            ref = mt.reference(cell.config, cell.traffic, cell.family(), args.seed, cpu)
            ctl = mt.reference(cell.config, cell.traffic, cell.family(), args.seed, cpu,
                               "fp8")
            row["control"] = decen.compare(ctl, ref)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
