"""End-to-end decentralized training of an internlm2-family decoder.

The port of ``examples/train_decentralized.py``: the trainer of
``repro_torch.launch.train`` driven by hand, 8 nodes on the paper's
Fig. 1 topology, MATCHA at budget 0.5 (or vanilla / periodic), masked
or overlap gossip, gradient clipping at 1.0. ``--scale tiny`` (default,
~3M parameters, 100 steps) runs the pipeline at smoke scale; ``--scale
full`` the ~100M x 300-step configuration. The run asserts that the
loss decreased and, with ``--ckpt-dir``, saves the final replicas in
the JAX package's checkpoint format. ``--shard S`` runs the FSDP
sharded-replica variant (``repro_torch.dist.fsdp``, monolithic layout):
each node's replica split over S ranks, started here (or taken from
``torchrun``), one card each; rank 0 prints.

Usage:
  PYTHONPATH=src python -m repro_torch.examples.train_decentralized [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.train_decentralized --scale full
  PYTHONPATH=src python -m repro_torch.examples.train_decentralized --device cpu --shard 2
"""
from __future__ import annotations

import argparse

import numpy as np

NODES = 8           # the paper's Fig. 1 topology


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_decentralized")
    ap.add_argument("--scale", default="tiny", choices=("tiny", "full"))
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--budget", type=float, default=0.5)
    ap.add_argument("--mode", default="matcha", choices=("matcha", "vanilla", "periodic"))
    ap.add_argument("--gossip-mode", default="masked",
                    choices=("masked", "sequential", "overlap"),
                    help="masked/sequential: in-step exchange; overlap: one-step-delayed "
                         "bucketed gossip on a side CUDA stream")
    ap.add_argument("--shard", type=int, default=1,
                    help="FSDP shard factor: each node keeps 1/N of its replica")
    ap.add_argument("--ckpt-dir", default="", help="save the final replicas here")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.shard < 1:
        raise SystemExit(f"--shard must be >= 1, got {args.shard}")
    from repro_torch.launch import mesh as mesh_lib

    world = mesh_lib.torchrun_world()
    if world > 1:
        return run(args, rank=None, world=world)
    if args.shard > 1:
        return mesh_lib.spawn(_spawned, args.shard, args.device,
                              args=(list(argv) if argv is not None else None,))
    return run(args, rank=0, world=1)


def _spawned(rank: int, world: int, init_method: str, argv) -> None:
    run(build_parser().parse_args(argv), rank=rank, world=world, init_method=init_method)


def run(args, *, rank, world: int, init_method=None) -> dict:
    """One rank of the example (the whole of it in a world of one)."""
    from repro_torch.device import resolve_device
    from repro_torch.dist import decen_train as dt
    from repro_torch.launch import mesh as mesh_lib

    try:
        device = (mesh_lib.init_world(args.device, rank=rank, world_size=world,
                                      init_method=init_method)
                  if world > 1 else resolve_device(args.device))
    except RuntimeError as err:
        raise SystemExit(str(err)) from None
    try:
        return _train(args, device, dt.make_spec(
            mesh_lib.make_mesh(shard=args.shard, device=device), NODES))
    finally:
        if world > 1:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(args, device, spec) -> dict:
    from repro_torch.checkpoint import ckpt as ckpt_lib
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import paper_figure1_graph, plan_matcha, plan_periodic, plan_vanilla
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.dist import decen_train as dt
    from repro_torch.dist import fsdp
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd

    gossip_mode = "masked" if args.gossip_mode == "sequential" else args.gossip_mode
    say = print if spec.mesh.rank == 0 else (lambda *a, **k: None)
    sharded = args.shard > 1
    if args.scale == "full":
        # ~100M decoder (GQA, SwiGLU)
        cfg = ModelConfig(
            name="decen-100m", family="dense", num_layers=12, d_model=768,
            num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32768,
            ffn_activation="silu", gated_ffn=True, pos_embed="rope",
            tie_embeddings=True, source="example",
        )
        steps, batch_per_node, seq = args.steps or 300, 8, 256
    else:
        cfg = ModelConfig(
            name="decen-3m", family="dense", num_layers=4, d_model=256,
            num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=2048,
            ffn_activation="silu", gated_ffn=True, pos_embed="rope",
            tie_embeddings=True, source="example",
        )
        steps, batch_per_node, seq = args.steps or 100, 4, 128
    if sharded and batch_per_node % args.shard:
        raise SystemExit(f"batch_per_node {batch_per_node} must divide by --shard {args.shard}")
    model = Model(cfg)
    say(f"model: {cfg.name}  params ~{model.num_params() / 1e6:.1f}M  steps={steps} "
        f"device={device}")

    g = paper_figure1_graph()
    if args.mode == "vanilla":
        plan = plan_vanilla(g)
    elif args.mode == "periodic":
        plan, _ = plan_periodic(g, args.budget)
    else:
        plan = plan_matcha(g, args.budget)
    sched = plan.schedule(steps, seed=0)
    say(f"{args.mode}: M={plan.num_matchings} alpha={plan.alpha:.3f} "
        f"rho={plan.rho:.4f} E[comm]={plan.expected_comm_units:.2f}u/iter")

    opt = sgd(0.15 if args.scale == "tiny" else 0.05, momentum=0.9)
    if sharded:
        layout = fsdp.make_layout(model, spec)
        params = fsdp.init_fsdp_params(model, layout, spec, seed=0, device=device)
        opt_state = fsdp.init_fsdp_opt_state(opt, layout, spec, device=device)
        step = fsdp.make_fsdp_train_step(model, opt, plan, spec, layout,
                                         gossip_mode=gossip_mode, grad_clip=1.0)
        bplan = layout.plan
        say(f"fsdp shard={args.shard}: "
            f"{layout.per_device_elements * 4 / 1e6:.2f} MB params/device "
            f"(replica: {layout.plan.total_elements * 4 / 1e6:.2f} MB)")
    else:
        params = dt.init_stacked_params(model, NODES, seed=0, device=device)
        opt_state = dt.init_stacked_opt_state(opt, model, NODES, device=device)
        step = dt.make_train_step(model, opt, plan, gossip_mode=gossip_mode, grad_clip=1.0)
        bplan = step.bplan if gossip_mode == "overlap" else None
    consensus = (lambda p: float(fsdp.consensus_distance_sharded(p, spec))) if sharded \
        else (lambda p: float(dt.consensus_distance(p)))
    it = iter(DecentralizedBatches(cfg, NODES, batch_per_node, seq, seed=0, device=device))
    gstate = None
    if gossip_mode == "overlap":
        gstate = (fsdp.init_fsdp_gossip_state(layout, spec, device=device) if sharded
                  else dt.init_gossip_state(plan, bplan, device=device))
        say(f"overlap gossip: {bplan.num_buckets} bucket(s), "
            f"{bplan.total_elements / 1e6:.2f}M fp32 elements in flight")

    losses_hist, sim_time = [], 0.0
    for k in range(steps):
        bits = sched.activations[k].astype(np.float32)
        if gstate is not None:
            params, opt_state, gstate, losses, _ = step(params, opt_state, gstate,
                                                        next(it), bits)
            sim_time += max(sched.comm_units(k), 1)     # the exchange hides behind compute
        else:
            params, opt_state, losses, _ = step(params, opt_state, next(it), bits)
            sim_time += sched.comm_units(k) + 1
        if k % 20 == 0 or k == steps - 1:
            losses_hist.append(spec.node_mean(losses))
            say(f"step {k:4d} loss {losses_hist[-1]:.4f} "
                f"consensus {consensus(params):.2e} sim_time {sim_time:.0f}u")
    if gstate is not None:
        flush = (fsdp.make_fsdp_gossip_flush(plan, layout) if sharded
                 else dt.make_gossip_flush(plan, bplan))
        params = flush(params, gstate)
        say(f"flushed in-flight gossip: consensus {consensus(params):.2e}")

    assert losses_hist[-1] < losses_hist[0], "loss must decrease"
    if args.ckpt_dir:
        if sharded:     # every rank gathers, rank 0 writes
            params = fsdp.gather_params(layout, params, spec)
            opt_state = fsdp.gather_opt_state(layout, opt_state, spec)
        if spec.mesh.rank == 0:
            ckpt_lib.save_run(args.ckpt_dir, params, opt_state, step=steps,
                              extra={"shard": args.shard})
    say(f"final loss {losses_hist[-1]:.4f} (from {losses_hist[0]:.4f})"
        + (f"; checkpoint -> {args.ckpt_dir}" if args.ckpt_dir else ""))
    return dict(losses=losses_hist, sim_time=sim_time)


if __name__ == "__main__":
    main()
