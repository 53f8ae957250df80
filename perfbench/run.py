"""Run one cell of the port's benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's entry in ``BENCHMARK.json``
names its configuration and traffic files; the traffic's driver
(``perfbench/drivers/<kind>.py``) makes the inputs from the seed, sets
up, warms up, measures for ``--seconds`` and checks what the timed steps
produced against the plain reference. The last line of standard output
is one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``; last, ``checks``: each
compared number beside its limit), and the line before it names the
card, its power limit and the window's peak memory. The run exits with
an error and prints no result without the CUDA cards the cell asks for,
or if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def process_age() -> float:
    """Seconds since this process started (its start time in
    ``/proc/self/stat`` against ``/proc/uptime``; 0 where unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def power_limits() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "power limit not read"
    return "; ".join(line.strip() for line in out.strip().splitlines())


def main(argv=None) -> int:
    start_wall = time.time() - process_age()
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path.pop(0)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # caches inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import manifest

    cell = manifest.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA card(s); found {found}",
              file=sys.stderr)
        return 2
    out = cell.driver().run_cell(cell, args.seed, args.seconds, bool(args.trace), start_wall)
    from perfbench.drivers.matcha_train import forbidden_modules

    loaded = forbidden_modules()
    if loaded:
        print(f"perfbench: modules of JAX or the JAX package were loaded: {loaded}",
              file=sys.stderr)
        return 3
    result = out["result"]
    print(f"card: {result['device']['kind']} x{cell.chips}; {power_limits()}; "
          f"window peak {out['peak'] / 1e9:.3f} GB")
    print("set-up: " + ", ".join(f"{n} {t:.2f} s" for n, t in out["stages"]),
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
