"""Topology explorer: how MATCHA's gains scale with base-graph density.

The port of ``examples/topology_explorer.py``. For geometric graphs of
increasing radius, vanilla DecenSGD's delay per iteration grows with the
maximum degree, while MATCHA holds the expected delay about flat at
equal error (spectral norm): the paper's Section 5 and Fig. 5. The
planner is numpy; each vanilla plan's rho is recomputed on the device
from its mixing matrix (``||W^T W - J||_2``, W = I - alpha L) as a cross
check of the planner.

Usage: PYTHONPATH=src python -m repro_torch.examples.topology_explorer [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import (
    matching_decomposition,
    plan_matcha,
    plan_vanilla,
    random_geometric_graph,
)


def find_budget_matching_vanilla_rho(g, *, tol=0.02):
    """Smallest CB whose rho is within tol of vanilla's (bisection)."""
    v = plan_vanilla(g)
    lo, hi = 0.05, 1.0
    best = (1.0, v.rho)
    for _ in range(12):
        mid = 0.5 * (lo + hi)
        m = plan_matcha(g, mid, budget_steps=600)
        if m.rho <= v.rho + tol:
            best = (mid, m.rho)
            hi = mid
        else:
            lo = mid
    return best, v


def vanilla_rho_on(device, g, alpha: float) -> float:
    """``||W^T W - J||_2`` of vanilla's every-matching mixing matrix,
    computed in fp64 on ``device``."""
    L = torch.as_tensor(g.laplacian(), dtype=torch.float64, device=device)
    n = L.shape[0]
    W = torch.eye(n, dtype=torch.float64, device=device) - alpha * L
    J = torch.full((n, n), 1.0 / n, dtype=torch.float64, device=device)
    return float(torch.linalg.matrix_norm(W.T @ W - J, ord=2))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.topology_explorer")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def main(argv=None):
    from repro_torch.device import resolve_device

    args = build_parser().parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(str(err)) from None
    print(f"{'radius':>7} {'maxdeg':>7} {'M':>3} {'vanilla rho':>12} "
          f"{'CB*':>6} {'rho@CB*':>8} {'delay(van)':>10} {'delay(MATCHA)':>13}")
    rows = []
    for radius in (0.36, 0.45, 0.55, 0.65, 0.8):
        g = random_geometric_graph(16, radius, seed=5)
        ms = matching_decomposition(g)
        (cb, rho), v = find_budget_matching_vanilla_rho(g)
        rho_dev = vanilla_rho_on(device, g, v.alpha)
        if abs(rho_dev - v.rho) > 1e-6:
            raise SystemExit(f"radius {radius}: vanilla rho {v.rho} from the planner, "
                             f"{rho_dev} on {device}")
        delay_v = len(ms)                        # all matchings, every iteration
        delay_m = cb * len(ms)                   # expected units an iteration
        rows.append((radius, g.max_degree(), len(ms), v.rho, cb, rho, delay_v, delay_m))
        print(f"{radius:7.2f} {g.max_degree():7d} {len(ms):3d} "
              f"{v.rho:12.4f} {cb:6.2f} {rho:8.4f} {delay_v:10d} "
              f"{delay_m:13.2f}")
    print("\nDenser base graph -> vanilla delay grows ~linearly with max "
          "degree;\nMATCHA holds delay ~flat at matched error (paper Fig. 5); "
          f"vanilla rho checked on {device}.")
    return rows


if __name__ == "__main__":
    main()
