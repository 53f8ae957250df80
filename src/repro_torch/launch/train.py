"""End-to-end decentralized training CLI (PyTorch port).

The port of ``repro.launch.train``: MATCHA / vanilla DecenSGD /
P-DecenSGD / local SGD over a chosen topology, with the pre-generated
a-priori schedule, the paper's simulated clock (one unit per activated
matching plus one for compute) and CSV metrics. It takes the JAX
CLI's flags, plus ``--device``: the run is on ``cuda`` unless
``--device cpu`` is given, and without a card and without that flag it
exits with an error instead of carrying on on the CPU.

Flags of the JAX CLI that the port does not implement yet exit with
a message naming the ROADMAP item; none is silently ignored.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2_1_8b \
      --preset tiny --graph paper8 --nodes 8 --budget 0.5 --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --preset tiny --steps 3 --csv out/run.csv
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    """The JAX training CLI, flag for flag, plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--preset", default="tiny", choices=("tiny", "small", "full"))
    ap.add_argument("--graph", default="paper8")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--budget", type=float, default=0.5)
    ap.add_argument("--mode", default="matcha",
                    choices=("matcha", "vanilla", "periodic", "local"))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-per-node", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gossip-mode", "--gossip-impl", dest="gossip_mode",
                    default="masked",
                    choices=("masked", "sequential", "static", "overlap"))
    ap.add_argument("--shard", type=int, default=1,
                    help="FSDP shard factor (not ported: only 1)")
    ap.add_argument("--stream-layers", dest="stream_layers",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="FSDP layer streaming (not ported)")
    ap.add_argument("--stream-scan", dest="stream_scan",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="FSDP scan streaming (not ported)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--keep-last", type=int, default=3)
    ap.add_argument("--resume", default="")
    ap.add_argument("--p-drop", type=float, default=0.0)
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--straggler-prob", type=float, default=0.0)
    ap.add_argument("--straggler-units", type=float, default=1.0)
    ap.add_argument("--crash-at-step", type=int, default=-1)
    ap.add_argument("--strict-faults", action="store_true")
    ap.add_argument("--csv", default="")
    ap.add_argument("--non-iid", action="store_true")
    ap.add_argument("--trace", default="", metavar="DIR")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the run goes; the default needs a CUDA card")
    return ap


# Flags the port has not implemented yet, with the ROADMAP item that
# ports them. Any value other than the default exits.
_UNPORTED = {
    "model_par": "queue 1, item 15 (multi-GPU, FSDP and tensor parallel)",
    "shard": "queue 1, item 15 (multi-GPU, FSDP and tensor parallel)",
    "stream_layers": "queue 1, item 15 (multi-GPU, FSDP and tensor parallel)",
    "stream_scan": "queue 1, item 15 (multi-GPU, FSDP and tensor parallel)",
    "ckpt_dir": "queue 1, item 9 (checkpoints)",
    "ckpt_every": "queue 1, item 9 (checkpoints)",
    "keep_last": "queue 1, item 9 (checkpoints)",
    "resume": "queue 1, item 9 (checkpoints)",
    "p_drop": "queue 1, item 10 (faults)",
    "fault_seed": "queue 1, item 10 (faults)",
    "straggler_prob": "queue 1, item 10 (faults)",
    "straggler_units": "queue 1, item 10 (faults)",
    "crash_at_step": "queue 1, item 10 (faults)",
    "strict_faults": "queue 1, item 10 (faults)",
    "trace": "queue 1, item 14 (telemetry)",
}


def _reject_unported(ap: argparse.ArgumentParser, args) -> None:
    for dest, item in _UNPORTED.items():
        if getattr(args, dest) != ap.get_default(dest):
            flag = "--" + dest.replace("_", "-")
            raise SystemExit(
                f"{flag} is not ported to repro_torch yet (ROADMAP {item})"
            )
    if args.gossip_mode == "overlap":
        raise SystemExit(
            "--gossip-mode overlap is not ported to repro_torch yet "
            "(ROADMAP queue 1, item 11)"
        )


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    _reject_unported(ap, args)

    import torch

    from repro_torch.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(str(err)) from None

    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.core import (
        named_graph, periodic_schedule, plan_matcha, plan_periodic,
        plan_vanilla, vanilla_schedule,
    )
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.dist import decen_train as dt
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd

    cfg = (
        get_smoke_config(args.arch) if args.preset == "tiny"
        else get_config(args.arch)
    )
    if args.preset == "small":
        cfg = dataclasses.replace(
            get_config(args.arch),
            num_layers=min(get_config(args.arch).num_layers, 8),
        )

    graph = named_graph(args.graph, args.nodes, seed=3)
    if graph.m != args.nodes:
        raise SystemExit(f"graph has {graph.m} nodes, --nodes {args.nodes}")

    if args.mode == "vanilla":
        plan = plan_vanilla(graph)
        schedule = vanilla_schedule(plan.matchings, args.steps)
    elif args.mode == "periodic":
        plan, _ = plan_periodic(graph, args.budget)
        schedule = periodic_schedule(plan.matchings, args.budget, args.steps)
    else:
        plan = plan_matcha(graph, args.budget, seed=args.seed)
        schedule = plan.schedule(args.steps, seed=args.seed)

    model = Model(cfg)
    opt = sgd(args.lr, momentum=args.momentum)
    params = dt.init_stacked_params(model, args.nodes, seed=args.seed, device=device)
    opt_state = dt.init_stacked_opt_state(opt, model, args.nodes, device=device)
    gossip_mode = "none" if args.mode == "local" else args.gossip_mode
    print(f"repro_torch: {cfg.name} ({model.num_params()} params/node) on "
          f"{device}, {args.nodes} nodes, mode {args.mode}, gossip {gossip_mode}")

    step_cache = {}

    def get_step(active):
        """static mode: one step per distinct activated subset."""
        key = tuple(active) if gossip_mode == "static" else gossip_mode
        if key not in step_cache:
            step_cache[key] = dt.make_train_step(
                model, opt, plan, gossip_mode=gossip_mode,
                active=tuple(active) if gossip_mode == "static" else (),
            )
        return step_cache[key]

    data = DecentralizedBatches(
        cfg, args.nodes, args.batch_per_node, args.seq,
        iid=not args.non_iid, seed=args.seed, device=device,
    )
    it = iter(data)
    rows = []
    sim_time = 0.0
    t0 = time.time()
    for k in range(args.steps):
        batch = next(it)
        active = schedule.active_indices(k)
        bits = torch.as_tensor(
            schedule.activations[k].astype(np.float32), device=device
        )
        params, opt_state, losses, _ = get_step(active)(
            params, opt_state, batch, bits
        )
        # paper's delay model: one unit per activated matching, +1 compute
        sim_time += schedule.comm_units(k) + 1.0
        if k % 10 == 0 or k == args.steps - 1:
            loss_mean = float(torch.mean(losses))
            cons = float(dt.consensus_distance(params))
            rows.append(
                dict(step=k, loss=loss_mean, consensus=cons,
                     sim_time=sim_time, comm_units=schedule.comm_units(k),
                     wall=time.time() - t0)
            )
            print(
                f"step {k:4d} loss {loss_mean:.4f} consensus {cons:.3e} "
                f"sim_time {sim_time:.0f}u active {len(active)}/{plan.num_matchings}"
            )

    if args.csv:
        os.makedirs(os.path.dirname(args.csv) or ".", exist_ok=True)
        import csv as csvmod

        with open(args.csv, "w", newline="") as f:
            w = csvmod.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        print("wrote", args.csv)
    return rows


if __name__ == "__main__":
    main()
