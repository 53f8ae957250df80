"""Dry run on one card: memory, FLOPs and kernel launches from meta tensors.

The port of ``repro.launch.dryrun`` for one card. Where the JAX dry run
lowers and compiles each (arch x shape) on a production mesh and reads
XLA's ``memory_analysis()`` / ``cost_analysis()``, this one builds the
port's real steps on the meta device (shapes and dtypes, no data, no
card) and runs them once inside ``repro_torch.analysis.cost.CostMode``:

  * training (``train_4k``): the m node-stacked replicas, their SGD
    velocities and a batch, then one ``TrainStep`` (masked, static or
    overlap gossip, with the in-flight ``GossipState``): every node's
    loss and gradients, the update and the gossip gathers;
  * serving: ``prefill_32k`` runs a prefill from position 0 and
    ``decode_32k`` one decode step against a full cache, both through
    ``dist/serve.py``'s step builders with the caches they allocate (full
    KV, ring caches for windows, Mamba states); ``long_500k`` decodes
    against the ``long_context_variant`` of the config.

Each kernel wrapper's meta branch runs the wrapper's checks, allocates
its CUDA kernel's outputs and reports the launch and its ``cost(...)``
to the ``CostMode``. Full depth costs no compilation here, so the JAX
dry run's shallow-stack extrapolation is not needed. Positions a model
has no room for (past a learned position table) give a ``refused``
record; any other refusal, a kernel's among them, fails the run.

The record has every key of the JAX ``analyze`` record (one chip, no
collectives) plus ``peak_bytes``, ``fits`` (the peak within the card's
80 GB), ``kernel_launches`` and ``mode: "meta"``. The roofline divides by
the H100 SXM5 80GB's spec-sheet figures (NVIDIA's data sheet, dense, at
its 700 W limit), not by measurements.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2_1_8b \\
      --shape train_4k --layers 2 --batch 4 --seq 128 --gossip-mode overlap

``--multi-pod`` and ``--kv-seq-shard`` exit: the dry run's mesh and
sharded lowering wait for the last item of the multi-GPU port (ROADMAP
queue 1, item 15).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.dist.sharding import NEXT_ITEM as ITEM_15

# NVIDIA's data sheet for the H100 SXM5 80GB, dense rates at a 700 W limit:
# the spec sheet's figures, not measurements of this port.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
CARD = "NVIDIA H100 SXM5 80GB (spec sheet, 700 W)"


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TrainState:
    """One decentralized step and everything it runs over."""

    step: Any
    params: Any
    opt_state: Any
    gstate: Any
    batch: Dict[str, torch.Tensor]
    bits: np.ndarray

    def run(self):
        """One step, whose params, velocities and in-flight exchange the
        next ``run()`` starts from; returns the per-node losses."""
        if self.gstate is not None:
            self.params, self.opt_state, self.gstate, losses, _ = self.step(
                self.params, self.opt_state, self.gstate, self.batch, self.bits)
        else:
            self.params, self.opt_state, losses, _ = self.step(
                self.params, self.opt_state, self.batch, self.bits)
        return losses


def train_state(cfg, *, nodes: int, batch: int, seq: int, gossip_mode: str = "masked",
                graph: str = "paper8", budget: float = 0.5, seed: int = 0,
                device="meta") -> TrainState:
    """The state of one decentralized step: ``nodes`` replicas of
    ``cfg`` from ``seed`` with zero SGD velocities (lr 0.05, momentum
    0.9), MATCHA at ``budget`` on ``graph``, ``batch`` x ``seq`` tokens a
    node (on the meta device shapes only, elsewhere from the synthetic
    corpus), the first schedule row, and with overlap gossip the
    in-flight ``GossipState``. The same builder makes the state on the
    card that the dry run predicts."""
    from repro_torch.configs.base import InputShape
    from repro_torch.core import named_graph, plan_matcha
    from repro_torch.data.pipeline import DecentralizedBatches, input_specs
    from repro_torch.dist import decen_train as dt
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd

    model = Model(cfg)
    opt = sgd(0.05, momentum=0.9)
    plan = plan_matcha(named_graph(graph, nodes, seed=3), budget, seed=0)
    row = plan.schedule(1, seed=0)
    bits = row.activations[0].astype(np.float32)
    kw = {}
    if gossip_mode == "static":
        kw["active"] = row.active_indices(0)
    step = dt.make_train_step(model, opt, plan, gossip_mode=gossip_mode, **kw)
    params = dt.init_stacked_params(model, nodes, seed, device=device)
    opt_state = dt.init_stacked_opt_state(opt, model, nodes, device=device)
    gstate = None
    if gossip_mode == "overlap":
        gstate = dt.init_gossip_state(plan, step.bplan, device=device)
    if torch.device(device).type == "meta":
        data = input_specs(cfg, InputShape("dry", seq, nodes * batch, "train"),
                           num_nodes=nodes, device=device)
    else:
        data = next(iter(DecentralizedBatches(cfg, nodes, batch, seq, seed=seed,
                                              device=device)))
    return TrainState(step, params, opt_state, gstate, data, bits)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def serve_call(cfg, *, kind: str, batch: int, seq: int, seed: int = 0, device="meta"):
    """``(state, run)`` of one serving step: ``kind`` ``"prefill"`` is a
    prefill of ``batch`` x ``seq`` tokens from position 0 (behind a
    vision prefix, with encoder frames for audio); ``"decode"`` one token
    at position ``seq - 1`` against caches of ``seq`` (+ prefix)
    positions. ``state`` holds the weights, caches and inputs; ``run()``
    takes the step."""
    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import input_specs
    from repro_torch.dist import serve as sv
    from repro_torch.models.transformer import Model

    model = Model(cfg)
    prefix = cfg.encoder_seq if cfg.frontend == "vision" else 0
    max_len = seq + prefix
    params = model.init(seed, device=device)
    caches = model.init_cache(batch, max_len, device=device)
    inputs = input_specs(cfg, InputShape("dry", seq, batch, kind), device=device)
    state = dict(params=params, caches=caches, inputs=inputs)
    if kind == "prefill":
        prefill = sv.make_prefill_step(model, max_len=max_len)
        frontend = {k: v for k, v in inputs.items() if k != "tokens"}
        return state, lambda: prefill(params, inputs["tokens"], caches, **frontend)
    decode = sv.make_decode_step(model, max_len=max_len)
    return state, lambda: decode(params, inputs["tokens"], caches, seq - 1 + prefix)


def replica_call(cfg, *, batch: int, seq: int, seed: int = 0, device="meta"):
    """``(state, run)`` of one replica's loss and gradients over one
    node's ``batch`` x ``seq`` tokens (every parameter a leaf that needs a
    gradient); ``run()`` returns the gradients."""
    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import DecentralizedBatches, input_specs
    from repro_torch.models.transformer import Model
    from repro_torch.tree import flatten

    model = Model(cfg)
    params = model.init(seed, device=device)
    leaves = list(flatten(params).values())
    for leaf in leaves:
        leaf.requires_grad_()
    if torch.device(device).type == "meta":
        data = input_specs(cfg, InputShape("dry", seq, batch, "train"), num_nodes=1)
    else:
        data = next(iter(DecentralizedBatches(cfg, 1, batch, seq, seed=seed, device=device)))
    data = {k: v[0] for k, v in data.items()}

    def run():
        loss, _ = model.loss(params, data)
        return torch.autograd.grad(loss, leaves)

    return dict(params=params, data=data), run


def moe_block_call(cfg, *, batch: int, seq: int, seed: int = 0, device="meta"):
    """``(state, run)`` of one MoE block alone, forward and backward, over
    ``batch`` x ``seq`` bf16 tokens: an fp32 router and bf16 expert
    weights, every leaf and the input needing gradients; ``run()``
    returns the gradients."""
    from repro_torch.models import ffn

    D, F, E = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.moe_num_experts
    gen = None if torch.device(device).type == "meta" else \
        torch.Generator(device=device).manual_seed(seed)

    def rand(*shape, scale=1.0, dtype=torch.bfloat16):
        if gen is None:
            return torch.empty(shape, dtype=dtype, device=device)
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    p = {"router": {"w": rand(D, E, scale=D ** -0.5, dtype=torch.float32)},
         "w1": rand(E, D, F, scale=D ** -0.5), "w3": rand(E, D, F, scale=D ** -0.5),
         "w2": rand(E, F, D, scale=F ** -0.5)}
    x, ct = rand(batch, seq, D), rand(batch, seq, D)
    leaves = [x, p["router"]["w"], p["w1"], p["w3"], p["w2"]]
    for leaf in leaves:
        leaf.requires_grad_()

    def run():
        y, _ = ffn.moe_block(p, x, cfg)
        return torch.autograd.grad(y, leaves, grad_outputs=ct)

    return dict(p=p, x=x, ct=ct), run


# ---------------------------------------------------------------------------
# Tracing and the record
# ---------------------------------------------------------------------------
def trace(build, *, steps: int = 1, warmup: int = 0):
    """Run ``build()`` (which makes the state on meta and returns ``(state,
    run)``) and then ``run()`` ``steps`` times inside a ``CostMode``; the
    state built, after ``warmup`` more runs (a steady training step
    starts from a step's state), counts as resident, and only the last
    ``steps`` runs' ops and launches count. Returns the mode."""
    from repro_torch.analysis.cost import CostMode

    with CostMode() as cm:
        state, run = build()
        for _ in range(warmup):
            run()
        if warmup:
            cm.clear_counts()
        cm.mark_resident()
        for _ in range(steps):
            out = run()
        cm.output_bytes = cm.live - cm.argument_bytes
        del out, state, run
    return cm


def analyze(cm, cfg, shape_name: str, kind: str, tokens: int,
            extras: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The JAX ``analyze`` record of one traced call, for one card."""
    flops = float(sum(v for k, v in cm.flops.items() if k in PEAK_FLOPS))
    t_compute = sum(v / PEAK_FLOPS[k] for k, v in cm.flops.items() if k in PEAK_FLOPS)
    t_memory = cm.bytes_accessed / HBM_BYTES_PER_S
    terms = {"compute": t_compute, "memory": t_memory, "collective": 0.0}
    counts = cfg.param_counts()
    model_flops = (6 if kind == "train" else 2) * counts["active"] * tokens
    peak = int(cm.peak)
    return {
        "arch": cfg.name,
        "shape": shape_name,
        "n_chips": 1,
        "memory": {
            "argument_bytes": int(cm.argument_bytes),
            "output_bytes": int(max(cm.output_bytes, 0)),
            "temp_bytes": peak - int(cm.argument_bytes),
            "total_per_chip": peak,
        },
        "flops_per_chip": flops,
        "flops_by_dtype": {k: float(v) for k, v in cm.flops.items()},
        "bytes_accessed_per_chip": float(cm.bytes_accessed),
        "collectives": {},
        "collective_link_bytes_per_chip": 0.0,
        "roofline_seconds": terms,
        "dominant": max(terms, key=terms.get),
        "model_flops": float(model_flops),
        "params_total": counts["total"],
        "params_active": counts["active"],
        "useful_flops_ratio": model_flops / max(flops, 1.0),
        "peak_bytes": peak,
        "fits": peak <= HBM_BYTES,
        "kernel_launches": dict(cm.launches),
        "float64_ops": len(cm.float64_ops),
        "mode": "meta",
        "card": CARD,
        **(extras or {}),
    }


def refused(cfg, shape_name: str, reason: str, extras: Dict[str, Any]) -> Dict[str, Any]:
    """The record of a configuration the port refuses to run: every key of
    the JAX ``analyze`` record, the measures null, ``fits`` false and the
    port's reason in ``refused``."""
    counts = cfg.param_counts()
    return {
        "arch": cfg.name, "shape": shape_name, "n_chips": 1,
        "memory": dict.fromkeys(("argument_bytes", "output_bytes", "temp_bytes",
                                 "total_per_chip")),
        "flops_per_chip": None, "flops_by_dtype": {}, "bytes_accessed_per_chip": None,
        "collectives": {}, "collective_link_bytes_per_chip": 0.0,
        "roofline_seconds": {"compute": None, "memory": None, "collective": 0.0},
        "dominant": None, "model_flops": None, "params_total": counts["total"],
        "params_active": counts["active"], "useful_flops_ratio": None,
        "peak_bytes": None, "fits": False, "kernel_launches": {}, "float64_ops": None,
        "mode": "meta", "card": CARD, "refused": reason, **extras,
    }


def config_for(arch: str, *, preset: str = "full", layers: int = 0,
               bf16_params: bool = False):
    from repro_torch.configs.registry import get_config, get_smoke_config

    cfg = get_smoke_config(arch) if preset == "tiny" else get_config(arch)
    over = {}
    if layers:
        over["num_layers"] = layers
    if bf16_params:
        over["param_dtype"] = "bfloat16"
    return dataclasses.replace(cfg, **over) if over else cfg


def run_one(arch: str, shape_name: str, *, nodes: int = 8, layers: int = 0,
            batch: int = 0, seq: int = 0, gossip_mode: str = "masked",
            graph: str = "paper8", bf16_params: bool = False, preset: str = "full",
            out_dir: str = "") -> Dict[str, Any]:
    """The dry run of one (arch, shape): the record, also written to
    ``out_dir/<arch>_<shape>.json`` when ``out_dir`` is given. ``batch``
    and ``seq`` override the shape's (for training ``batch`` is a node's);
    ``layers`` cuts the depth."""
    from repro_torch.configs.base import INPUT_SHAPES, long_context_variant
    from repro_torch.models.transformer import PositionRangeError

    cfg = config_for(arch, preset=preset, layers=layers, bf16_params=bf16_params)
    shape = INPUT_SHAPES[shape_name]
    t0 = time.perf_counter()
    if shape.kind == "train":
        if shape.global_batch % nodes and not batch:
            raise ValueError(f"global batch {shape.global_batch} does not split over "
                             f"{nodes} nodes")
        b = batch or shape.global_batch // nodes
        s = seq or shape.seq_len
        tokens = nodes * b * s
        extras = {"num_nodes": nodes, "batch_per_node": b, "seq": s,
                  "gossip": gossip_mode, "graph": graph}
        build = lambda: (lambda st: (st, st.run))(train_state(   # noqa: E731
            cfg, nodes=nodes, batch=b, seq=s, gossip_mode=gossip_mode, graph=graph))
    else:
        note = "native"
        if shape_name == "long_500k":
            cfg, note = long_context_variant(cfg)
        b, s = batch or shape.global_batch, seq or shape.seq_len
        tokens = b * (s if shape.kind == "prefill" else 1)
        extras = {"batch": b, "seq": s, "long_context": note}
        build = lambda: serve_call(cfg, kind=shape.kind, batch=b, seq=s)  # noqa: E731
    extras.update(layers=cfg.num_layers, param_dtype=str(cfg.param_dtype))
    try:
        cm = trace(build)
    except PositionRangeError as err:
        # positions the model has no room for (past a learned position
        # table; the JAX model clamps them): the record says so. Every
        # other refusal, a kernel's among them, fails the run.
        rec = refused(cfg, shape_name, str(err), dict(extras, seconds=round(
            time.perf_counter() - t0, 2)))
    else:
        extras["seconds"] = round(time.perf_counter() - t0, 2)
        rec = analyze(cm, cfg, shape_name, shape.kind, tokens, extras)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}_{shape_name}.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.configs.registry import ARCH_IDS

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS) + ["all"])
    ap.add_argument("--shape", required=True, choices=list(INPUT_SHAPES) + ["all"])
    ap.add_argument("--preset", default="full", choices=("tiny", "full"))
    ap.add_argument("--nodes", type=int, default=8, help="training nodes (paper8: 8)")
    ap.add_argument("--graph", default="paper8")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (0: the config's)")
    ap.add_argument("--batch", type=int, default=0,
                    help="a node's batch (training) or the batch (serving); 0: the shape's")
    ap.add_argument("--seq", type=int, default=0, help="sequence length; 0: the shape's")
    ap.add_argument("--gossip-mode", default="masked", choices=("masked", "static", "overlap"))
    ap.add_argument("--bf16-params", action="store_true", help="bf16 parameters")
    ap.add_argument("--multi-pod", action="store_true", help=f"not ported ({ITEM_15})")
    ap.add_argument("--kv-seq-shard", action="store_true", help=f"not ported ({ITEM_15})")
    ap.add_argument("--out", default=os.path.join("build", "dryrun"),
                    help="directory for one JSON record per (arch, shape)")
    return ap


def main(argv=None) -> int:
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.configs.registry import ARCH_IDS

    args = build_parser().parse_args(argv)
    for flag, on in (("--multi-pod", args.multi_pod), ("--kv-seq-shard", args.kv_seq_shard)):
        if on:
            raise SystemExit(f"{flag} is not ported to repro_torch yet ({ITEM_15})")
    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    failures = []
    for a in archs:
        for s in shapes:
            try:
                rec = run_one(a, s, nodes=args.nodes, layers=args.layers, batch=args.batch,
                              seq=args.seq, gossip_mode=args.gossip_mode, graph=args.graph,
                              bf16_params=args.bf16_params, preset=args.preset,
                              out_dir=args.out)
            except Exception as e:  # noqa: BLE001 - report and go on
                failures.append((a, s))
                print(f"FAIL {a} {s}: {e!r}", file=sys.stderr)
                continue
            if "refused" in rec:
                print(f"REFUSED {a} {s}: {rec['refused']} ({rec['seconds']} s)", flush=True)
                continue
            r, m = rec["roofline_seconds"], rec["memory"]
            print(f"OK {a} {s}: resident {m['argument_bytes'] / 1e9:.2f} GB, peak "
                  f"{rec['peak_bytes'] / 1e9:.2f} GB (fits 80 GB: {rec['fits']}), "
                  f"{rec['flops_per_chip']:.3e} flop, compute {r['compute']:.3e} s, "
                  f"memory {r['memory']:.3e} s, dominant={rec['dominant']}, "
                  f"launches {rec['kernel_launches']} ({rec['seconds']} s)", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
