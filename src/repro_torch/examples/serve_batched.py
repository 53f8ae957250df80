"""Batched serving example: prefill + greedy decode.

The port of ``examples/serve_batched.py``: serves a model of the
registry at its smoke size with a batch of requests through
``repro_torch.launch.serve`` (the prefill and decode step builders of
``repro_torch.dist.serve``), on the card unless ``--device cpu``. The
JAX example's 2 x 2 data x model mesh waits for the multi-GPU port
(ROADMAP queue 1, item 15): one device serves the whole batch.

Usage: PYTHONPATH=src python -m repro_torch.examples.serve_batched --arch mamba2_370m [--device cpu]
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_batched")
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def main(argv=None) -> dict:
    from repro_torch.launch import serve

    args = build_parser().parse_args(argv)
    return serve.main([
        "--arch", args.arch, "--preset", "tiny", "--batch", str(args.batch),
        "--prompt-len", str(args.prompt_len), "--gen", str(args.gen),
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
