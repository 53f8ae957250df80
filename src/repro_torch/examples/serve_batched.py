"""Batched serving example: prefill + greedy decode on a 2 x 2 mesh.

The port of ``examples/serve_batched.py``: serves a model of the
registry at its smoke size with a batch of requests through
``repro_torch.launch.serve`` (the prefill and decode step builders of
``repro_torch.dist.serve``) on the JAX example's ``(data 2, model 2)``
mesh: four ranks started here, the batch split over the two data ranks
and the model tensor-parallel over the two model ranks. The run is on
the card unless ``--device cpu``; ``--backend gloo`` lets the four ranks
share fewer cards (NCCL, the card's default, needs one card a rank).
Returns the whole batch's generated ids and last logits, joined from
the data ranks.

Usage: PYTHONPATH=src python -m repro_torch.examples.serve_batched --arch mamba2_370m [--device cpu]
"""
from __future__ import annotations

import argparse
import os

DATA_PAR, MODEL_PAR = 2, 2


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_batched")
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    return ap


def _rank(rank: int, world: int, init_method: str, argv, out: str) -> None:
    """One rank of the mesh; each data rank's model rank 0 saves its rows."""
    import torch

    from repro_torch.launch import serve

    args = serve.build_parser().parse_args(argv)
    res = serve._serve(args, rank=rank, world=world, init_method=init_method)
    if rank % MODEL_PAR == 0:
        torch.save({"generated": torch.as_tensor(res["generated"]),
                    "logits": res["logits"].cpu()}, f"{out}.d{rank // MODEL_PAR}.pt")


def main(argv=None) -> dict:
    import tempfile

    import numpy as np
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.launch import mesh as mesh_lib

    args = build_parser().parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as err:
        raise SystemExit(str(err)) from None
    serve_argv = [
        "--arch", args.arch, "--preset", "tiny", "--batch", str(args.batch),
        "--prompt-len", str(args.prompt_len), "--gen", str(args.gen),
        "--device", args.device, "--data-par", str(DATA_PAR),
        "--model-par", str(MODEL_PAR),
    ] + (["--backend", args.backend] if args.backend else [])
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rows")
        mesh_lib.spawn(_rank, DATA_PAR * MODEL_PAR, args.device, args=(serve_argv, out),
                       share=args.backend == "gloo")
        rows = [torch.load(f"{out}.d{d}.pt") for d in range(DATA_PAR)]
    return {"generated": np.concatenate([r["generated"].numpy() for r in rows]),
            "logits": torch.cat([r["logits"] for r in rows])}


if __name__ == "__main__":
    main()
