"""Quickstart: the MATCHA pipeline end to end on the paper's 8-node graph.

The port of ``examples/quickstart.py``:

  1. decompose the Fig. 1 topology into matchings (Misra-Gries),
  2. optimize activation probabilities at several communication budgets,
  3. solve for the mixing weight alpha and the spectral norm rho,
  4. print the error-vs-communication table (paper Fig. 3a),
  5. train the tiny internlm2 decentralized on 8 nodes (node-stacked
     replicas on one device, masked gossip), MATCHA at budget 0.5
     against vanilla DecenSGD, and compare the loss each reaches in the
     same number of steps and the simulated time (one unit per activated
     matching plus one for compute) each step count costs.

Usage: PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu] [--steps 60]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (
    matching_decomposition,
    paper_figure1_graph,
    plan_matcha,
    plan_periodic,
    plan_vanilla,
)


def spectral_table():
    g = paper_figure1_graph()
    ms = matching_decomposition(g)
    print(f"base graph: m={g.m} |E|={len(g.edges)} maxdeg={g.max_degree()}")
    print(f"matchings (Misra-Gries): M={len(ms)} sizes={[len(x.edges) for x in ms]}")
    vanilla = plan_vanilla(g)
    print(f"\nvanilla DecenSGD: rho={vanilla.rho:.4f} "
          f"comm={vanilla.vanilla_comm_units} units/iter")
    print(f"\n{'CB':>5} {'rho(MATCHA)':>12} {'rho(P-Decen)':>13} "
          f"{'E[comm]':>8} {'saving':>7}")
    for cb in (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.75, 0.9, 1.0):
        m = plan_matcha(g, cb, budget_steps=800)
        p, _ = plan_periodic(g, cb)
        print(f"{cb:5.2f} {m.rho:12.4f} {p.rho:13.4f} "
              f"{m.expected_comm_units:8.2f} "
              f"{vanilla.vanilla_comm_units / max(m.expected_comm_units, 1e-9):6.1f}x")


def training_comparison(device, steps: int):
    """MATCHA CB 0.5 against vanilla over ``steps`` steps each; returns
    ``{mode: (final mean loss, simulated time units)}``."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.dist import decen_train as dt
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd

    g = paper_figure1_graph()
    cfg = get_smoke_config("internlm2_1_8b")
    model = Model(cfg)
    opt = sgd(0.2, momentum=0.9)
    results = {}
    for mode, cb in (("vanilla", 1.0), ("matcha", 0.5)):
        plan = plan_vanilla(g) if mode == "vanilla" else plan_matcha(g, cb)
        sched = plan.schedule(steps, seed=1)
        params = dt.init_stacked_params(model, 8, seed=0, device=device)
        opt_state = dt.init_stacked_opt_state(opt, model, 8, device=device)
        it = iter(DecentralizedBatches(cfg, 8, 4, 64, seed=0, device=device))
        step = dt.make_train_step(model, opt, plan, gossip_mode="masked")
        sim_time = 0.0
        for k in range(steps):
            bits = sched.activations[k].astype(np.float32)
            params, opt_state, losses, _ = step(params, opt_state, next(it), bits)
            sim_time += sched.comm_units(k) + 1
        results[mode] = (float(losses.mean()), sim_time)
        print(f"{mode:8s}: final loss {results[mode][0]:.4f} "
              f"simulated time {sim_time:.0f} units")
    v, m = results["vanilla"], results["matcha"]
    print(f"\nMATCHA reaches loss {m[0]:.3f} (vanilla {v[0]:.3f}) using "
          f"{m[1] / v[1]:.0%} of vanilla's simulated time.")
    return results


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def main(argv=None):
    from repro_torch.device import resolve_device

    args = build_parser().parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(str(err)) from None
    print("=" * 64)
    print("MATCHA quickstart: paper Fig. 1 topology")
    print("=" * 64)
    spectral_table()
    print("\n" + "=" * 64)
    print(f"{args.steps}-step decentralized training (8 nodes on {device})")
    print("=" * 64)
    return training_comparison(device, args.steps)


if __name__ == "__main__":
    torch.backends.cuda.matmul.allow_tf32 = False
    main()
