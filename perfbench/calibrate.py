"""Readings that the limits of ``correct`` are set from, on the chip.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control] [--faults half_batch,no_exchange] [--out FILE]

For every seed: the program's readings after the cell's check steps
(set-up only, no window) and their gaps against the float32 reference;
with ``--control`` the control's gaps (the reference itself in float8
e4m3 matmuls, the precision below the configuration's bfloat16); with
``--faults`` the gaps of the program with each fault of
``perfbench.faults`` planted. One JSON line a seed, on standard output
and appended to ``--out``. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def calibrate(cell, seeds, *, control: bool = False, faults=(), device: str = "cuda"):
    """Yield one row a seed: the program's gaps, each planted fault's and,
    with ``control``, the control's, all against the float32 reference."""
    import torch

    from perfbench.drivers import matcha_train as mt
    from perfbench.reference import decen

    plants = [None] + list(faults)
    job = mt.Job(config=cell.config, traffic=cell.traffic,
                 family_path=str(cell.path("reference", f"{cell.config['reference']}.py")),
                 tasks=[(s, p) for s in seeds for p in plants], device=device)
    t0 = time.time()
    run = mt.run_job(job)
    program_s = time.time() - t0
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    family = cell.family()
    for si, seed in enumerate(seeds):
        t1 = time.time()
        ref = mt.reference(cell.config, cell.traffic, family, seed, dev)
        row = {"cell": cell.name, "seed": seed, "reference_s": time.time() - t1}
        for pi, plant in enumerate(plants):
            gaps = decen.compare(run["tasks"][si * len(plants) + pi]["readings"], ref)
            row["program" if plant is None else plant] = gaps
        if control:
            ctl = mt.reference(cell.config, cell.traffic, family, seed, dev, "fp8")
            row["control"] = decen.compare(ctl, ref)
        row["program_s_all_seeds"] = program_s
        yield row


def main(argv=None) -> int:
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    from perfbench import manifest

    cell = manifest.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [f for f in args.faults.split(",") if f]
    for row in calibrate(cell, seeds, control=args.control, faults=faults, device=args.device):
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
