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

``--gossip-mode overlap`` runs the one-step-delayed bucketed exchange
(``repro_torch.dist.decen_train.OverlapStep``): the simulated clock
charges a step ``max(comm_units, 1)``, checkpoints hold the params with
the pending exchange landed while the run keeps it pending (so a resumed
run, starting from a zero ``GossipState``, ends bit-equal to an
unbroken one), and the run ends by landing the last exchange.

``--trace DIR`` measures the run: the step records its spans
(``repro_torch.telemetry.timers``), unfenced: ``step``, each node's
``fwd_bwd`` (``forward``, ``backward``) and ``optimizer``, the
``gossip`` with each leaf's ``gossip/target`` and ``gossip/apply``, or
overlap's ``gossip_apply`` and its side-stream ``gossip_launch``. Every
step prints a metrics line (the ``step`` span's ms; comm ms, the
``gossip`` span in the sequential modes and the ``gossip_launch`` span
in overlap; overlap ratio; modeled bytes), reading the spans after the
step returns, and DIR receives ``events.jsonl``, ``trace.json`` and
``metrics.jsonl`` (schema ``repro.telemetry/1``, which the JAX
package's readers load). Nothing inside a step is fenced, so the step
times are the card's, not a fenced upper bound; the host waits for each
step before the next is issued, as it does for the loss.

``--model-par T`` trains tensor-parallel over a ``model`` axis of T
ranks (``repro_torch.dist.sharding``'s rules, ``repro_torch.models.tp``),
with ``--shard S`` too: S·T ranks a data rank, which this CLI starts
itself without torchrun, or torchrun's world. Checkpoints hold the
whole tree in the JAX format at any T and resume at any other.
``--backend`` names the process group's backend: NCCL on the card and
gloo on the CPU by default; ``--backend gloo`` on the card lets the
ranks share a card (gloo's all-reduce takes CUDA tensors).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2_1_8b \
      --preset tiny --graph paper8 --nodes 8 --budget 0.5 --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --preset tiny --steps 3 --csv out/run.csv
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --preset tiny --steps 8 --p-drop 0.35 --ckpt-dir ck --ckpt-every 3 \
      --crash-at-step 4        # then the same with --resume auto
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --preset tiny --steps 4 --gossip-mode overlap --trace out/trace
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --preset tiny --model-par 2 --steps 3
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
                    help="FSDP shard factor: each node's replica is split over this "
                         "many ranks (torchrun's world, or ranks this CLI starts)")
    ap.add_argument("--stream-layers", dest="stream_layers",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="FSDP: gather one layer group at a time (default with "
                         "--shard > 1); --no-stream-layers gathers the whole model")
    ap.add_argument("--stream-scan", dest="stream_scan",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="streamed FSDP: gather a scanned segment one layer row at a time")
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
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the process group's backend (default: nccl on the card, gloo "
                         "on the CPU); gloo lets several ranks share one card")
    return ap


def _check_args(args) -> None:
    """The JAX CLI's checks of the FSDP flags, and the mesh factors'."""
    if args.resume == "auto" and not args.ckpt_dir:
        raise SystemExit("--resume auto requires --ckpt-dir")
    if args.shard < 1:
        raise SystemExit(f"--shard must be >= 1, got {args.shard}")
    if args.model_par < 1:
        raise SystemExit(f"--model-par must be >= 1, got {args.model_par}")
    use_fsdp = args.shard > 1
    if args.stream_layers is None:
        args.stream_layers = use_fsdp
    if args.stream_layers and not use_fsdp:
        raise SystemExit("--stream-layers streams the sharded-replica "
                         "runtime; it requires --shard > 1")
    if use_fsdp and args.gossip_mode == "static":
        raise SystemExit("--shard > 1 supports --gossip-mode "
                         "sequential/masked or overlap, not static")
    if use_fsdp and args.batch_per_node % args.shard:
        raise SystemExit(
            f"--batch-per-node {args.batch_per_node} must divide by "
            f"--shard {args.shard} (the node's batch splits over the "
            "shard axis)")


def main(argv=None):
    """Run the CLI. Under ``torchrun`` the world comes from the
    environment (``--shard S --model-par T``: ``W / (S T)`` data ranks);
    without it ``S * T > 1`` local ranks start here
    (``launch.mesh.spawn``), one card each on the card unless
    ``--backend gloo`` lets them share."""
    import sys

    from repro_torch.launch import mesh as mesh_lib

    ap = build_parser()
    args = ap.parse_args(argv)
    _check_args(args)
    world = mesh_lib.torchrun_world()
    if world > 1:
        return _run(args, rank=None, world=world)
    ranks = args.shard * args.model_par
    if ranks > 1:
        argv = sys.argv[1:] if argv is None else list(argv)
        return mesh_lib.spawn(_spawned, ranks, args.device, args=(argv,),
                              share=args.backend == "gloo")
    return _run(args, rank=0, world=1)


def _spawned(rank: int, world: int, init_method: str, argv) -> None:
    args = build_parser().parse_args(argv)
    _check_args(args)
    _run(args, rank=rank, world=world, init_method=init_method)


def _run(args, *, rank, world: int, init_method=None):
    from repro_torch.device import resolve_device
    from repro_torch.dist import decen_train as dt
    from repro_torch.launch import mesh as mesh_lib

    try:
        if world > 1:
            device = mesh_lib.init_world(args.device, rank=rank, world_size=world,
                                         init_method=init_method, backend=args.backend)
        else:
            device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(str(err)) from None
    try:
        mesh = mesh_lib.make_mesh(shard=args.shard, model=args.model_par, device=device)
        spec = dt.make_spec(mesh, args.nodes, cfg=_config(args))
    except ValueError as err:
        raise SystemExit(str(err)) from None
    try:
        from repro_torch.dist.sharding import use_rules

        with use_rules(spec.rules):
            return _train(args, device, spec)
    finally:
        if world > 1:
            import torch.distributed as dist

            dist.destroy_process_group()


def _config(args):
    """The run's model config (``--arch`` at ``--preset``)."""
    from repro_torch.configs.registry import get_config, get_smoke_config

    cfg = (
        get_smoke_config(args.arch) if args.preset == "tiny"
        else get_config(args.arch)
    )
    if args.preset == "small":
        cfg = dataclasses.replace(
            get_config(args.arch),
            num_layers=min(get_config(args.arch).num_layers, 8),
        )
    return cfg


def _train(args, device, spec):
    """The run on this rank, under the spec's tensor-parallel rules."""
    import torch

    from repro_torch.checkpoint import ckpt as ckpt_lib
    from repro_torch.core import (
        named_graph, periodic_schedule, plan_matcha, plan_periodic,
        plan_vanilla, vanilla_schedule,
    )
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.dist import decen_train as dt
    from repro_torch.dist import fsdp
    from repro_torch.dist.sharding import no_rules
    from repro_torch.faults import (
        FaultSpec, SimulatedCrash, make_fault_schedule, retry_with_backoff,
        verify_degraded_plan,
    )
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd
    from repro_torch.tree import flatten

    lead = spec.mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    use_fsdp = args.shard > 1
    spread = spec.mesh.size > 1
    cfg = _config(args)

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
                say(f"faults: WARNING {msg}")
        else:
            say(f"faults: p_drop={args.p_drop:g} keeps the plan "
                f"contractive (faulted rho {rho_f:.4f} < 1)")
    elif faulted:
        say(f"faults: mode {args.mode} has no independent-Bernoulli "
            "spectral gate; injecting drops without a rho-under-"
            "faults guarantee")

    model = Model(cfg)
    opt = sgd(args.lr, momentum=args.momentum)
    layout = None
    if use_fsdp:
        layout = (
            fsdp.make_stream_layout(model, spec, scan_aware=args.stream_scan)
            if args.stream_layers else fsdp.make_layout(model, spec)
        )
        say(f"fsdp: shard={args.shard}, "
            f"{layout.per_device_elements * 4 / 1e6:.2f} MB params/device "
            f"(of {layout.plan.total_elements * 4 / 1e6:.2f} MB/replica)")
        if args.stream_layers:
            # the true per-iteration peak: a scan-aware group streams one
            # layer row per iteration, not its whole stack
            peak = layout.plan.max_group_elements
            total = layout.plan.total_elements
            scanned = [(n, r) for n, r in zip(layout.plan.names, layout.plan.repeats)
                       if r > 1]
            say(f"fsdp: streaming {layout.plan.num_buckets} layer groups "
                f"({', '.join(layout.group_names)}); per-iteration peak "
                f"gathered view {peak * 4 / 1e6:.2f} MB vs "
                f"{total * 4 / 1e6:.2f} MB monolithic")
            if scanned:
                say("fsdp: scan-streaming "
                    + ", ".join(f"{n} ({r} iterations/row gathers)" for n, r in scanned)
                    + " — double-buffered prefetch, <= 2 layer rows live")
            if not args.stream_scan and peak > 0.5 * total:
                say("fsdp: WARNING largest layer group is "
                    f"{100 * peak / total:.0f}% of the model — "
                    "--no-stream-scan keeps each scanned segment as "
                    "one stack-at-once gather; drop the flag to "
                    "stream per scan iteration")
    start_step = 0
    resume_dir = args.resume
    if resume_dir == "auto":
        # newest complete, checksum-valid checkpoint under --ckpt-dir
        # (torn entries from a crash mid-checkpoint are skipped)
        resume_dir = ckpt_lib.find_resumable(args.ckpt_dir) or ""
        if not resume_dir:
            say("resume auto: no restorable checkpoint under "
                f"{args.ckpt_dir}; starting fresh")
    if resume_dir:
        # checkpoints hold the gathered node-stacked whole tree at any
        # shard and model factor; transient read failures retry with
        # bounded backoff
        params, opt_state, start_step = retry_with_backoff(
            lambda: ckpt_lib.restore_run(resume_dir, device=device)
        )
        with no_rules():
            whole = model.param_shapes()
        want = {path: (args.nodes,) + tuple(shape)
                for path, (shape, _) in flatten(whole).items()}
        if {path: tuple(a.shape) for path, a in flatten(params).items()} != want:
            raise SystemExit(f"checkpoint {resume_dir} does not hold {cfg.name} "
                             f"params for {args.nodes} nodes")
        params, opt_state = spec.slice_model(params), spec.slice_model(opt_state)
        if use_fsdp:
            params, opt_state = (fsdp.scatter_params(layout, params, spec),
                                 fsdp.scatter_opt_state(layout, opt, opt_state, spec))
        elif spread:
            params, opt_state = _clone(spec.local(params)), _clone(spec.local(opt_state))
        say(f"resumed from {resume_dir} at step {start_step}")
    elif use_fsdp:
        params = fsdp.init_fsdp_params(model, layout, spec, seed=args.seed, device=device)
        opt_state = fsdp.init_fsdp_opt_state(opt, layout, spec, device=device)
    else:
        params = dt.init_stacked_params(model, args.nodes, seed=args.seed, device=device)
        opt_state = dt.init_stacked_opt_state(opt, model, args.nodes, device=device)
        if spread:
            params, opt_state = _clone(spec.local(params)), _clone(spec.local(opt_state))
    gossip_mode = "none" if args.mode == "local" else args.gossip_mode
    say(f"repro_torch: {cfg.name} ({model.num_params()} params/node) on "
        f"{device}, {args.nodes} nodes, mode {args.mode}, gossip {gossip_mode}"
        + (f"; mesh data {spec.mesh.data} x shard {spec.mesh.shard}"
           + (f" x model {spec.mesh.model}" if spec.mesh.model > 1 else "")
           + f" ({spec.local_nodes} nodes a data rank)" if spread else ""))

    # --- telemetry (--trace DIR) -----------------------------------------
    # An untraced step gets a disabled timer and records nothing.
    from repro_torch.telemetry import StepTimer, TraceRecorder

    traced = bool(args.trace)
    recorder = None
    if traced:
        recorder = TraceRecorder(meta=dict(
            arch=args.arch, preset=args.preset, graph=args.graph,
            nodes=args.nodes, shard=args.shard, mode=args.mode,
            gossip_mode=gossip_mode, budget=args.budget,
            steps=args.steps, batch_per_node=args.batch_per_node,
            seq=args.seq, p_drop=args.p_drop, fault_seed=args.fault_seed,
            device=str(device),
        ))
    timer = StepTimer(recorder)
    gstate = flush = bplan = None
    if gossip_mode == "overlap":
        if use_fsdp:
            gstate = fsdp.init_fsdp_gossip_state(layout, spec, device=device)
            flush = fsdp.make_fsdp_gossip_flush(plan, layout)
        else:
            bplan = dt.param_bucket_plan(model)
            gstate = dt.init_gossip_state(plan, bplan, device=device, spec=spec)
            flush = dt.make_gossip_flush(plan, bplan)
    step_cache = {}

    def get_step(active):
        """static mode: one step per distinct activated subset."""
        key = tuple(active) if gossip_mode == "static" else gossip_mode
        if key not in step_cache:
            active = tuple(active) if gossip_mode == "static" else ()
            if use_fsdp:
                step_cache[key] = fsdp.make_fsdp_train_step(
                    model, opt, plan, spec, layout, gossip_mode=gossip_mode,
                    faulted=faulted, timer=timer)
            else:
                step_cache[key] = dt.make_train_step(
                    model, opt, plan, gossip_mode=gossip_mode, active=active,
                    bucket_plan=bplan, faulted=faulted, timer=timer, spec=spec,
                )
        return step_cache[key]

    def gathered(p, s):
        """The node-stacked whole tree of every node (a collective on a
        mesh): the checkpoint format at any shard and model factor and
        layout."""
        if use_fsdp:
            p, s = fsdp.gather_params(layout, p, spec), fsdp.gather_opt_state(layout, s, spec)
        else:
            p, s = spec.gather_nodes(p), spec.gather_nodes(s)
        return spec.gather_model(p), spec.gather_model(s)

    def consensus(p) -> float:
        if use_fsdp:
            return float(fsdp.consensus_distance_sharded(p, spec, layout))
        return float(dt.consensus_distance(p, spec if spread else None))

    def save(step, p):
        # crash-safe history layout: each checkpoint lands in its own
        # step_XXXXXXXX/ dir, ckpt.json written last; "extra" is what the
        # JAX CLI records, so that each package resumes the other's.
        # Every rank gathers; rank 0 writes.
        tree, state = gathered(p, opt_state)
        if lead:
            retry_with_backoff(lambda: ckpt_lib.save_run_step(
                args.ckpt_dir, tree, state, step=step,
                extra={"shard": args.shard,
                       "stream_layers": bool(args.stream_layers),
                       "stream_scan": bool(args.stream_scan)},
                keep_last=args.keep_last,
            ))
        if spread:
            import torch.distributed as dist

            dist.barrier()

    data = DecentralizedBatches(
        cfg, args.nodes, args.batch_per_node, args.seq,
        iid=not args.non_iid, seed=args.seed, device=device,
    )
    it = iter(data)
    # resume: replay the consumed prefix so step k sees the batch it
    # would in an uninterrupted run (the pipeline is a seeded stream)
    for _ in range(start_step):
        next(it)

    # the modeled per-matching bytes of each step's metrics line
    # (analysis.bytes_model)
    per_matching_bytes = 0
    if traced:
        from repro_torch.analysis import bytes_model
        from repro_torch.telemetry import probes as tprobes

        if use_fsdp:
            per_matching_bytes = int(bytes_model.bucket_plan_bytes(
                layout.plan, args.shard)["per_matching_comm_bytes"])
        else:
            per_matching_bytes = bytes_model.tree_storage_bytes(model.param_shapes())

    rows = []
    trace_rows = []
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
        bits = torch.as_tensor(bits, device=device)
        stepf = get_step(active)
        if gossip_mode == "overlap":
            params, opt_state, gstate, losses, _ = stepf(
                params, opt_state, gstate, batch, bits, step=k
            )
            # delayed gossip hides behind compute: the step costs the
            # slower of the two, not their sum
            sim_time += max(schedule.comm_units(k), 1.0)
        else:
            params, opt_state, losses, _ = stepf(
                params, opt_state, batch, bits, step=k
            )
            # paper's delay model: one unit per activated matching,
            # +1 compute
            sim_time += schedule.comm_units(k) + 1.0
        if fault_sched is not None:
            # stragglers stretch the synchronous round: the step costs
            # the slowest node's extra units
            delay = fault_sched.max_delay(k)
            sim_time += delay
            if traced:
                dropped = fault_sched.dropped_links(schedule.activations[k], k)
                if dropped:
                    tprobes.fault_event(recorder, step=k, kind="link_drop",
                                        dropped_exchanges=dropped)
                if delay:
                    tprobes.fault_event(recorder, step=k, kind="straggler",
                                        delay_units=delay)
        if traced:
            # reading the spans waits for the step's end on the card
            phase_ms = stepf.last_phase_ms
            step_ms = phase_ms.pop("step")
            comm_ms = phase_ms.get("gossip_launch" if gossip_mode == "overlap" else "gossip",
                                   0.0)
            timer.read()
            mrec = tprobes.step_metrics(
                step=k, step_ms=step_ms, comm_ms=comm_ms,
                gossip_mode=gossip_mode,
                comm_bytes=per_matching_bytes * len(active),
                phase_ms=phase_ms,
            )
            trace_rows.append(mrec)
            say(tprobes.format_metrics_line(mrec))
        if k % 10 == 0 or k == args.steps - 1:
            loss_mean = spec.node_mean(losses)
            cons = consensus(params)
            rows.append(
                dict(step=k, loss=loss_mean, consensus=cons,
                     sim_time=sim_time, comm_units=schedule.comm_units(k),
                     wall=time.time() - t0)
            )
            say(
                f"step {k:4d} loss {loss_mean:.4f} consensus {cons:.3e} "
                f"sim_time {sim_time:.0f}u active {len(active)}/{plan.num_matchings}"
            )
        if args.ckpt_every and args.ckpt_dir and (k + 1) % args.ckpt_every == 0:
            # overlap: the checkpoint lands the in-flight exchange (the
            # live run keeps it pending; resuming from a zero GossipState
            # then replays the unbroken trajectory)
            save(k + 1, flush(params, gstate) if gossip_mode == "overlap" else params)
        if fault_spec.crash_at_step == k:
            if traced:
                tprobes.fault_event(recorder, step=k, kind="crash")
            say(f"fault: simulated crash after completing step {k}")
            raise SimulatedCrash(k)

    if gossip_mode == "overlap":
        # land the exchange still in flight from the last step
        params = flush(params, gstate, inplace=True)
        say(f"flushed in-flight gossip: consensus {consensus(params):.3e}")
    if args.ckpt_dir:
        save(args.steps, params)
    if args.csv and rows and lead:
        os.makedirs(os.path.dirname(args.csv) or ".", exist_ok=True)
        import csv as csvmod

        with open(args.csv, "w", newline="") as f:
            w = csvmod.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        say("wrote", args.csv)
    if traced and lead:
        import json

        jsonl_path, chrome_path = recorder.flush(args.trace)
        metrics_path = os.path.join(args.trace, "metrics.jsonl")
        with open(metrics_path, "w") as f:
            for r in trace_rows:
                f.write(json.dumps(r) + "\n")
        say(f"wrote trace: {jsonl_path} + {chrome_path} "
            f"({len(recorder.events())} events, "
            f"{recorder.num_dropped} dropped) and {metrics_path}")
    return rows


def _clone(tree):
    """A tree of views as tensors of their own (a rank keeps its nodes)."""
    from repro_torch.tree import tree_map

    return tree_map(lambda a: a.clone(), tree)


if __name__ == "__main__":
    main()
