"""Serving driver (PyTorch port): prefill a batch of prompts, decode
greedily.

The port of ``repro.launch.serve``. It takes the JAX CLI's flags, plus
``--device``: the run is on ``cuda`` unless ``--device cpu`` is given,
and without a card and without that flag it exits with an error
instead of carrying on on the CPU. On the card the prefill runs the
hand-written flash-attention kernel (attention layers) and SSD
chunk-scan kernel (Mamba layers; both also in hybrid and local:global
stacks), and MoE layers of more than 8 experts
run their expert products on the grouped-matmul kernel in prefill and
decode alike. Audio models (whisper) encode zero frames first, and
their prefill runs the kernel for the encoder's self-attention and the
decoder's cross-attention too; their decode skips cross-attention, as
the JAX runtime's does. Vision models serve without a prefix, as the
JAX CLI does. The command prints each of the port's four kernels'
launches in the prefill and in the decode (``gossip_axpy``, the
training step's, stays at 0).

``--trace DIR`` records one fenced span per prefill and per decode
step (``repro_torch.telemetry``) and writes the JSONL event log and a
Perfetto-loadable Chrome trace into DIR, as the JAX CLI does.

``--data-par D --model-par T`` serve on a ``(data, model)`` mesh of
D·T ranks, as the JAX CLI's mesh: the batch splits over the D data
ranks (it must divide, as there), and each rank runs its
tensor-parallel slice of the model (``repro_torch.dist.sharding``'s
serving rules, ``repro_torch.models.tp``); the ranks start here without
torchrun, or come from torchrun's world. Rank 0 prints the lines, for
its rows. ``--backend`` names the process group's backend, as in the
training CLI (``gloo`` lets the ranks share a card).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2_1_8b \\
      --preset full --batch 8 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch mamba2_370m --preset tiny
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch dbrx_132b --preset tiny
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch whisper_base --preset tiny
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    """The JAX serving CLI, flag for flag, plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--preset", default="tiny", choices=("tiny", "full"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default="", metavar="DIR",
                    help="record a fenced span per prefill / decoded "
                         "token; write events.jsonl + trace.json "
                         "(chrome://tracing / Perfetto) into DIR")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the run goes; the default needs a CUDA card")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the process group's backend (default: nccl on the card, gloo "
                         "on the CPU); gloo lets several ranks share one card")
    return ap


def _check_args(args) -> None:
    """The mesh factors, and the JAX CLI's check of the batch split."""
    for flag, value in (("--data-par", args.data_par), ("--model-par", args.model_par)):
        if value < 1:
            raise SystemExit(f"{flag} must be >= 1, got {value}")
    if args.batch % args.data_par:
        raise SystemExit("batch must divide data_par")


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg, *, batch: int, prompt_len: int, gen: int, seed: int = 0,
        device="cuda", timer=None, cost=None, rules=None, data_rank: int = 0,
        data_par: int = 1) -> dict:
    """Serve ``batch`` prompts of ``prompt_len`` tokens from the synthetic
    corpus and decode ``gen`` tokens greedily, with random weights from
    ``seed``. With ``rules`` (``sharding.serve_rules``) this rank serves
    its tensor-parallel slice of the model, and with ``data_par`` > 1
    the ``batch / data_par`` prompts of ``data_rank``. Returns the prefill and per-token decode times (host clock
    around synchronized work), each kernel's launches in the prefill and
    in the decode, the generated ids (B, gen), the last logits and, on
    the card, the bytes allocated once the weights, prompts and caches
    are in place and the peak memory allocated. An enabled ``timer``
    (``repro_torch.telemetry.StepTimer``) records one fenced span per
    prefill and per decode step.

    On the meta device (the dry run, ``repro_torch.launch.dryrun``) the
    same calls run on shapes alone: ``cost``, the ``CostMode`` the call
    runs in, takes the state as resident where the card resets its peak
    statistics, and no ids come back."""
    import torch

    from repro_torch.telemetry import StepTimer

    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.device import resolve_device
    from repro_torch.dist import serve as sv
    from repro_torch.dist.sharding import use_rules
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gossip_axpy import gossip_axpy
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.models.transformer import Model

    device = resolve_device(device)
    kernels = {"flash_attention": flash_attention, "ssm_scan": ssm_scan,
               "grouped_matmul": grouped_matmul, "gossip_axpy": gossip_axpy}
    model = Model(cfg)
    max_len = prompt_len + gen
    with use_rules(rules):
        params = model.init(seed, device=device)
        caches = model.init_cache(batch // data_par, max_len, device=device)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=seed)
    rng = np.random.default_rng(seed)
    prompts = np.stack([corpus.sample(rng, prompt_len) for _ in range(batch)])
    batch //= data_par
    prompts = prompts[data_rank * batch:(data_rank + 1) * batch]
    tokens = torch.as_tensor(prompts.astype(np.int32), device=device)
    prefill = sv.make_prefill_step(model, rules, max_len=max_len)
    decode = sv.make_decode_step(model, rules, max_len=max_len)
    frontend = {}
    if cfg.frontend == "audio":
        # zero frames, as the JAX CLI feeds them; vision models serve
        # without a prefix, as there
        frontend["encoder_frames"] = torch.zeros(
            (batch, cfg.encoder_seq, cfg.frontend_dim or cfg.d_model),
            dtype=torch.bfloat16, device=device,
        )
    resident = None
    if device.type == "cuda":
        resident = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    if cost is not None:
        resident = cost.mark_resident()

    def launches():
        return {name: fn.launches for name, fn in kernels.items()}

    timer = timer or StepTimer()
    before = launches()
    _sync(device)
    t0 = time.perf_counter()
    with timer.phase("prefill", cat="serve", tokens=batch * prompt_len) as sp:
        logits, caches = prefill(params, tokens, caches, **frontend)
        sp.fence(logits)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    after_prefill = launches()

    out = [torch.argmax(logits[:, -1, :], dim=-1)]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        with timer.phase("decode", cat="serve", step=i) as sp:
            logits, caches = decode(params, out[-1][:, None].to(torch.int32), caches,
                                    prompt_len + i)
            out.append(torch.argmax(logits[:, -1, :], dim=-1))
            sp.fence(out[-1])
    _sync(device)
    t_decode = time.perf_counter() - t0
    after_decode = launches()

    return dict(
        prefill_ms=t_prefill * 1e3,
        decode_ms_per_token=t_decode / max(gen - 1, 1) * 1e3,
        prefill_launches={k: after_prefill[k] - before[k] for k in kernels},
        decode_launches={k: after_decode[k] - after_prefill[k] for k in kernels},
        generated=(None if device.type == "meta"
                   else torch.stack(out, dim=1).cpu().numpy()),
        logits=logits,
        resident_bytes=resident,
        peak_bytes=(torch.cuda.max_memory_allocated(device)
                    if device.type == "cuda" else None),
    )


def main(argv=None) -> dict:
    """Run the CLI: one process, or ``--data-par D --model-par T`` ranks
    (torchrun's world, or D·T local ranks started here). Returns the
    result of ``run`` on this process (rank 0 of a world it started
    returns None)."""
    import sys

    from repro_torch.launch import mesh as mesh_lib

    args = build_parser().parse_args(argv)
    _check_args(args)
    world = mesh_lib.torchrun_world()
    if world > 1:
        return _serve(args, rank=None, world=world)
    ranks = args.data_par * args.model_par
    if ranks > 1:
        argv = sys.argv[1:] if argv is None else list(argv)
        return mesh_lib.spawn(_spawned, ranks, args.device, args=(argv,),
                              share=args.backend == "gloo")
    return _serve(args, rank=0, world=1)


def _spawned(rank: int, world: int, init_method: str, argv) -> None:
    args = build_parser().parse_args(argv)
    _check_args(args)
    _serve(args, rank=rank, world=world, init_method=init_method)


def _serve(args, *, rank, world: int, init_method=None) -> dict:
    import torch

    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.telemetry import StepTimer, TraceRecorder

    try:
        if world > 1:
            device = mesh_lib.init_world(args.device, rank=rank, world_size=world,
                                         init_method=init_method, backend=args.backend)
        else:
            device = resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(str(err)) from None
    try:
        cfg = (
            get_smoke_config(args.arch) if args.preset == "tiny"
            else get_config(args.arch)
        )
        mesh = mesh_lib.make_mesh(model=args.model_par, device=device)
        if mesh.data != args.data_par:
            raise SystemExit(f"a world of {mesh.size} ranks at --model-par {args.model_par} "
                             f"has {mesh.data} data ranks, not --data-par {args.data_par}")
        rules = shd.serve_rules(mesh, cfg) if args.model_par > 1 else None
        lead = mesh.rank == 0
        recorder = None
        if args.trace and lead:
            recorder = TraceRecorder(meta=dict(
                arch=args.arch, preset=args.preset, batch=args.batch,
                prompt_len=args.prompt_len, gen=args.gen,
                data_par=args.data_par, model_par=args.model_par,
                device=str(device),
            ))
        res = run(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
                  seed=args.seed, device=device, timer=StepTimer(recorder), rules=rules,
                  data_rank=mesh.data_rank, data_par=mesh.data)
        if not bool(torch.isfinite(res["logits"]).all()):
            raise SystemExit("non-finite logits")
        if lead:
            _report(args, cfg, device, mesh, res, recorder)
        return res
    finally:
        if world > 1:
            import torch.distributed as dist

            dist.destroy_process_group()


def _report(args, cfg, device, mesh, res, recorder) -> None:
    """Rank 0's lines: the JAX CLI's, then each kernel's launches."""
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen} device={device}"
          + (f" mesh data {mesh.data} x model {mesh.model}" if mesh.size > 1 else ""))
    print(f"prefill: {res['prefill_ms']:.1f} ms   decode: "
          f"{res['decode_ms_per_token']:.1f} ms/token")
    for name in res["prefill_launches"]:
        print(f"kernel launches: {name} prefill {res['prefill_launches'][name]} "
              f"decode {res['decode_launches'][name]}")
    if res["peak_bytes"] is not None:
        print(f"peak memory allocated: {res['peak_bytes'] / 1e9:.2f} GB")
    print("generated token ids (first request):", res["generated"][0][:16], "...")
    if recorder is not None:
        jsonl_path, chrome_path = recorder.flush(args.trace)
        print(f"wrote trace: {jsonl_path} + {chrome_path} "
              f"({len(recorder.events())} events)")


if __name__ == "__main__":
    main()
