"""End-to-end decentralized training CLI (PyTorch port).

The port of ``repro.launch.train``: MATCHA / vanilla DecenSGD /
P-DecenSGD / local SGD over a chosen topology, with the pre-generated
a-priori schedule, the paper's simulated clock (one unit per activated
matching plus one for compute) and CSV metrics. It takes the JAX
CLI's flags, plus ``--device``: the run is on ``cuda`` unless
``--device cpu`` is given, and without a card and without that flag it
exits with an error instead of carrying on on the CPU.

Fault injection and crash safety are the JAX CLI's: ``--p-drop`` drops
each activated edge's exchange with that probability (seeded by
``--fault-seed``) and the step degrades to self-weight renormalization,
after Theorem 2 is re-checked under the faulted probabilities (a
warning, or an error under ``--strict-faults``); ``--straggler-prob`` /
``--straggler-units`` stretch the simulated clock; ``--crash-at-step K``
raises ``SimulatedCrash`` after step K and any checkpoint due at it.
``--ckpt-dir D --ckpt-every N`` writes ``D/step_XXXXXXXX/`` every N
steps and at the end (``--keep-last`` of them kept), in the JAX
package's format, and ``--resume auto`` (or ``--resume DIR``) restarts
from the newest complete one, replaying the batches already consumed.

Flags of the JAX CLI that the port does not implement yet exit with
a message naming the ROADMAP item; none is silently ignored.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2_1_8b \
      --preset tiny --graph paper8 --nodes 8 --budget 0.5 --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --preset tiny --steps 3 --csv out/run.csv
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --preset tiny --steps 8 --p-drop 0.35 --ckpt-dir ck --ckpt-every 3 \
      --crash-at-step 4        # then the same with --resume auto
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
    if args.resume == "auto" and not args.ckpt_dir:
        raise SystemExit("--resume auto requires --ckpt-dir")

    import torch

    from repro_torch.device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(str(err)) from None

    from repro_torch.checkpoint import ckpt as ckpt_lib
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.core import (
        named_graph, periodic_schedule, plan_matcha, plan_periodic,
        plan_vanilla, vanilla_schedule,
    )
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.dist import decen_train as dt
    from repro_torch.faults import (
        FaultSpec, SimulatedCrash, make_fault_schedule, retry_with_backoff,
        verify_degraded_plan,
    )
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd
    from repro_torch.tree import flatten

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

    # --- fault injection (repro_torch.faults) --------------------------
    fault_spec = FaultSpec(
        p_drop=args.p_drop,
        straggler_prob=args.straggler_prob,
        straggler_units=args.straggler_units,
        crash_at_step=args.crash_at_step,
        seed=args.fault_seed,
    )
    fault_sched = None
    faulted = fault_spec.has_link_faults
    if not fault_spec.empty:
        fault_sched = make_fault_schedule(plan, args.steps, fault_spec)
    if faulted and args.mode in ("matcha", "vanilla"):
        # Theorem 2 under faults: link drops rescale the activation
        # Bernoullis to p_eff = p * (1 - p_drop) exactly, so the
        # contraction gate re-runs on the degraded probabilities
        rho_f, problems = verify_degraded_plan(plan, fault_spec)
        if problems and args.strict_faults:
            raise SystemExit("faults: --strict-faults: " + "; ".join(problems))
        if problems:
            for msg in problems:
                print(f"faults: WARNING {msg}")
        else:
            print(f"faults: p_drop={args.p_drop:g} keeps the plan "
                  f"contractive (faulted rho {rho_f:.4f} < 1)")
    elif faulted:
        print(f"faults: mode {args.mode} has no independent-Bernoulli "
              "spectral gate; injecting drops without a rho-under-"
              "faults guarantee")

    model = Model(cfg)
    opt = sgd(args.lr, momentum=args.momentum)
    start_step = 0
    resume_dir = args.resume
    if resume_dir == "auto":
        # newest complete, checksum-valid checkpoint under --ckpt-dir
        # (torn entries from a crash mid-checkpoint are skipped)
        resume_dir = ckpt_lib.find_resumable(args.ckpt_dir) or ""
        if not resume_dir:
            print("resume auto: no restorable checkpoint under "
                  f"{args.ckpt_dir}; starting fresh")
    if resume_dir:
        # transient read failures retry with bounded backoff
        params, opt_state, start_step = retry_with_backoff(
            lambda: ckpt_lib.restore_run(resume_dir, device=device)
        )
        want = {path: (args.nodes,) + tuple(shape)
                for path, (shape, _) in flatten(model.param_shapes()).items()}
        if {path: tuple(a.shape) for path, a in flatten(params).items()} != want:
            raise SystemExit(f"checkpoint {resume_dir} does not hold {cfg.name} "
                             f"params for {args.nodes} nodes")
        print(f"resumed from {resume_dir} at step {start_step}")
    else:
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
                faulted=faulted,
            )
        return step_cache[key]

    def save(step):
        # crash-safe history layout: each checkpoint lands in its own
        # step_XXXXXXXX/ dir, ckpt.json written last; "extra" is what a
        # --shard 1 run of the JAX CLI records, so that it resumes here
        retry_with_backoff(lambda: ckpt_lib.save_run_step(
            args.ckpt_dir, params, opt_state, step=step,
            extra={"shard": args.shard,
                   "stream_layers": bool(args.stream_layers),
                   "stream_scan": bool(args.stream_scan)},
            keep_last=args.keep_last,
        ))

    data = DecentralizedBatches(
        cfg, args.nodes, args.batch_per_node, args.seq,
        iid=not args.non_iid, seed=args.seed, device=device,
    )
    it = iter(data)
    # resume: replay the consumed prefix so step k sees the batch it
    # would in an uninterrupted run (the pipeline is a seeded stream)
    for _ in range(start_step):
        next(it)
    rows = []
    sim_time = 0.0
    t0 = time.time()
    for k in range(start_step, args.steps):
        batch = next(it)
        active = schedule.active_indices(k)
        if faulted:
            # per-node effective rows: activation bit x link-survival
            # gate, symmetric across every matching edge (a dropped
            # exchange zeroes the delta at both endpoints)
            bits = fault_sched.node_bits(schedule.activations[k], k)
        else:
            bits = schedule.activations[k].astype(np.float32)
        params, opt_state, losses, _ = get_step(active)(
            params, opt_state, batch, torch.as_tensor(bits, device=device)
        )
        # paper's delay model: one unit per activated matching, +1 compute
        sim_time += schedule.comm_units(k) + 1.0
        if fault_sched is not None:
            # stragglers stretch the synchronous round: the step costs
            # the slowest node's extra units
            sim_time += fault_sched.max_delay(k)
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
        if args.ckpt_every and args.ckpt_dir and (k + 1) % args.ckpt_every == 0:
            save(k + 1)
        if fault_spec.crash_at_step == k:
            print(f"fault: simulated crash after completing step {k}")
            raise SimulatedCrash(k)

    if args.ckpt_dir:
        save(args.steps)
    if args.csv and rows:
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
