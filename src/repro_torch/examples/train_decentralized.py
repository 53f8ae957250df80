"""End-to-end decentralized training of an internlm2-family decoder.

The port of ``examples/train_decentralized.py``: the trainer of
``repro_torch.launch.train`` driven by hand, 8 nodes on the paper's
Fig. 1 topology, MATCHA at budget 0.5 (or vanilla / periodic), masked
or overlap gossip, gradient clipping at 1.0. ``--scale tiny`` (default,
~3M parameters, 100 steps) runs the pipeline at smoke scale; ``--scale
full`` the ~100M x 300-step configuration. The run asserts that the
loss decreased and, with ``--ckpt-dir``, saves the final replicas in
the JAX package's checkpoint format. The JAX example's FSDP variant
(``--shard``) waits for the multi-GPU port (ROADMAP queue 1, item 15)
and exits.

Usage:
  PYTHONPATH=src python -m repro_torch.examples.train_decentralized [--device cpu]
  PYTHONPATH=src python -m repro_torch.examples.train_decentralized --scale full
"""
from __future__ import annotations

import argparse

import numpy as np

ITEM_15 = "ROADMAP queue 1, item 15: multi-GPU, FSDP and tensor parallel"


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
    ap.add_argument("--shard", type=int, default=1, help=f"FSDP: not ported ({ITEM_15})")
    ap.add_argument("--ckpt-dir", default="", help="save the final replicas here")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.shard != 1:
        raise SystemExit(f"--shard is not ported to repro_torch yet ({ITEM_15})")
    gossip_mode = "masked" if args.gossip_mode == "sequential" else args.gossip_mode

    from repro_torch.checkpoint import ckpt as ckpt_lib
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import paper_figure1_graph, plan_matcha, plan_periodic, plan_vanilla
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.device import resolve_device
    from repro_torch.dist import decen_train as dt
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(str(err)) from None
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
    model = Model(cfg)
    print(f"model: {cfg.name}  params ~{model.num_params() / 1e6:.1f}M  steps={steps} "
          f"device={device}")

    g = paper_figure1_graph()
    if args.mode == "vanilla":
        plan = plan_vanilla(g)
    elif args.mode == "periodic":
        plan, _ = plan_periodic(g, args.budget)
    else:
        plan = plan_matcha(g, args.budget)
    sched = plan.schedule(steps, seed=0)
    print(f"{args.mode}: M={plan.num_matchings} alpha={plan.alpha:.3f} "
          f"rho={plan.rho:.4f} E[comm]={plan.expected_comm_units:.2f}u/iter")

    opt = sgd(0.15 if args.scale == "tiny" else 0.05, momentum=0.9)
    params = dt.init_stacked_params(model, 8, seed=0, device=device)
    opt_state = dt.init_stacked_opt_state(opt, model, 8, device=device)
    it = iter(DecentralizedBatches(cfg, 8, batch_per_node, seq, seed=0, device=device))
    step = dt.make_train_step(model, opt, plan, gossip_mode=gossip_mode, grad_clip=1.0)
    gstate = None
    if gossip_mode == "overlap":
        gstate = dt.init_gossip_state(plan, step.bplan, device=device)
        print(f"overlap gossip: {step.bplan.num_buckets} bucket(s), "
              f"{step.bplan.total_elements / 1e6:.2f}M fp32 elements in flight")

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
            losses_hist.append(float(losses.mean()))
            print(f"step {k:4d} loss {losses_hist[-1]:.4f} "
                  f"consensus {float(dt.consensus_distance(params)):.2e} "
                  f"sim_time {sim_time:.0f}u")
    if gstate is not None:
        params = dt.make_gossip_flush(plan, step.bplan)(params, gstate)
        print(f"flushed in-flight gossip: consensus "
              f"{float(dt.consensus_distance(params)):.2e}")

    assert losses_hist[-1] < losses_hist[0], "loss must decrease"
    if args.ckpt_dir:
        ckpt_lib.save_run(args.ckpt_dir, params, opt_state, step=steps)
    print(f"final loss {losses_hist[-1]:.4f} (from {losses_hist[0]:.4f})"
          + (f"; checkpoint -> {args.ckpt_dir}" if args.ckpt_dir else ""))
    return dict(losses=losses_hist, sim_time=sim_time)


if __name__ == "__main__":
    main()
