#!/usr/bin/env python3
"""Time designs of the fp32 gossip update against torch.lerp on one card.

    python3 tools/gossip_axpy_designs.py

Builds ``tools/gossip_axpy_designs.cu`` (the designs the shipped kernel
was measured against) with the port's nvcc flags into ``build/``, checks
that every design is bit-equal to ``gossip_axpy_ref`` on the training
path's largest leaf (embed.table of 8 internlm2-1.8b replicas, 8 x 92544 x
2048 fp32), then times each design, the shipped kernel (in place, as the
training step calls it, and out of place through the wrapper) and
``torch.lerp`` once in a forward pass over them and once in a backward
pass (so that a drift of the card's clocks during the run shows as a
difference between a design's two times), with the byte bound (12 bytes
an element at 3.35 TB/s) beside each. Prints the card's name and power
limit first. Needs a CUDA card; exits non-zero without one.
"""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

DESIGNS = {
    0: "first design: 1 vector a thread, grid-stride over 8 resident blocks an SM",
    1: "4 vectors a thread, streaming hints, grid of resident blocks",
    2: "4 vectors a thread, grid of resident blocks",
    7: "8 vectors a thread, streaming hints, grid of resident blocks",
    8: "TMA bulk copies, 4 stages of 16 KB a operand",
    9: "TMA bulk copies, 3 stages of 32 KB a operand",
    10: "TMA bulk copies, 6 stages of 8 KB a operand",
    11: "1 vector a thread, one tile a block",
    5: "2 vectors a thread, one tile a block",
    3: "4 vectors a thread, one tile a block",
    4: "4 vectors a thread, streaming hints, one tile a block (shipped)",
    6: "8 vectors a thread, one tile a block",
}
HBM_BYTES_PER_S = 3.35e12


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("gossip_axpy_designs: needs a CUDA card")
    from repro_torch.kernels import build
    from repro_torch.kernels.gossip_axpy import gossip_axpy
    from repro_torch.kernels.ref import gossip_axpy_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = build.BUILD_DIR / "gossip_axpy_designs.so"
    res = subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib_path),
         os.path.join(ROOT, "tools", "gossip_axpy_designs.cu")],
        capture_output=True, text=True)
    if res.returncode:
        sys.exit(f"nvcc failed:\n{res.stdout}{res.stderr}")
    fn = ctypes.CDLL(str(lib_path)).exp_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (8, 92544, 2048)
    x = torch.randn(shape, generator=gen, device="cuda")
    y = torch.randn(shape, generator=gen, device="cuda")
    o = torch.empty_like(x)
    xi = x.clone()
    alpha = 0.3
    stream = torch.cuda.current_stream().cuda_stream
    want = gossip_axpy_ref(x, y, alpha)

    def design(d):
        def run():
            err = fn(d, x.data_ptr(), y.data_ptr(), o.data_ptr(), x.numel(), alpha, stream)
            if err:
                sys.exit(f"design {d}: cudaError {err}")
        return run

    for d in DESIGNS:
        o.zero_()
        design(d)()
        torch.cuda.synchronize()
        if not torch.equal(o, want):
            sys.exit(f"design {d} ({DESIGNS[d]}) is not bit-equal to gossip_axpy_ref")
    print("every design is bit-equal to gossip_axpy_ref", flush=True)
    del want

    def ms(fn_, iters=10):
        for _ in range(2):
            fn_()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn_()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    runs = [("torch.lerp", lambda: torch.lerp(x, y, alpha, out=o)),
            ("shipped gossip_axpy, in place", lambda: gossip_axpy(xi, y, alpha, inplace=True)),
            ("shipped gossip_axpy, out of place (allocates)", lambda: gossip_axpy(x, y, alpha)),
            ("torch.lerp, out of place (allocates)", lambda: torch.lerp(x, y, alpha))]
    runs += [(f"design {d}: {name}", design(d)) for d, name in DESIGNS.items()]
    times = {label: [] for label, _ in runs}
    for order in (runs, runs[::-1]):            # forwards, then backwards
        for label, fn_ in order:
            times[label].append(ms(fn_))
    bound = 12 * x.numel() / HBM_BYTES_PER_S * 1e3
    for label, ts in times.items():
        mean = sum(ts) / len(ts)
        print(f"{label}: {' / '.join(f'{t:.3f}' for t in ts)} ms "
              f"({bound / mean:.1%} of the {bound:.3f} ms byte bound)", flush=True)


if __name__ == "__main__":
    main()
