#!/usr/bin/env python3
"""Where the time of the tensor-core SSD kernel goes, phase by phase.

    python3 tools/ssm_scan_phases.py

Builds a copy of ``src/repro_torch/csrc/ssm_scan.cu`` with clock64 marks
inserted at the block barriers between its phases (into ``build/``), runs
it once at mamba2-370m's serving shapes (B 8, S 2048, H 32, P 64, N 128,
chunk 128, bf16), and prints the cycles a block spends in each phase
(the clock of the first thread of the block, or of a head's group of
warps, at the barrier that closes the phase, so a phase includes the
wait for its slowest warp), the block's duration on the global timer and
when the blocks start. The two heads' groups run side by side, so their
phases overlap in time and their shares do not add up. The marks are
inserted by matching lines of the kernel's source: when the source
changes, the script stops at the first line it no longer finds. Needs a
CUDA card.
"""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

NT = 16   # marks a block: 0-2 and 15 by thread 0, 3 + 6 k .. by head k's group
BLOCK_PHASES = [("ticket, loads of B, C and dt", 0, 1),
                ("cumsum, w, G = C B^T, x landed", 1, 2)]
GROUP_PHASES = [("M built", 0, 1), ("y = M x, s_c", 1, 2), ("wait for chunk c - 1", 2, 3),
                ("H update, flag", 3, 4), ("y += C H_{c-1}, y stored", 4, 5)]


def instrumented_source() -> str:
    src = open(os.path.join(ROOT, "src", "repro_torch", "csrc", "ssm_scan.cu")).read()

    def mark(anchor: str, text: str, before: bool = False) -> None:
        nonlocal src
        if src.count(anchor) != 1:
            sys.exit(f"ssm_scan_phases: the kernel source changed; not found once: {anchor!r}")
        src = src.replace(anchor, text + anchor if before else anchor + text)

    mark("namespace tc {\n",
         f"__device__ unsigned long long phase_t[8192 * {NT}];\n"
         "__device__ unsigned long long phase_g[8192 * 2];\n"
         f"#define T(k) if (tid == 0) phase_t[blockIdx.x * {NT} + (k)] = clock64();\n"
         f"#define GM(i) if (gtid == 0) phase_t[blockIdx.x * {NT} + 3 + 6 * k + (i)] = clock64();\n")
    mark("  const int t = shared_int[0];\n",
         "  T(0) if (tid == 0) phase_g[blockIdx.x * 2] = hopper::global_timer_ns();\n")
    mark("  cp_async_wait<1>();   // B, C and dt have landed\n  __syncthreads();\n", "  T(1)\n")
    mark("  __syncthreads();      // G and w are written\n", "  T(2)\n")
    mark("    const int nblk = nS * (nS + 1) / 2;\n", "    GM(0)\n")
    mark("    float yacc[kTasks][kNB][4];\n", "    GM(1)\n", before=True)
    mark("    if (c > 0 && gtid == 0) wait_flag(",
         "    group_sync(1 + k, kGroupThreads);\n    GM(2)\n", before=True)
    mark("flags + bh * nc + c - 1);\n    group_sync(1 + k, kGroupThreads);\n", "    GM(3)\n")
    mark("    if (c < nc - 1 && gtid == 0) st_release(", "    GM(4)\n", before=True)
    mark("hopper::pack_bf16(yacc[tk][nb][2], yacc[tk][nb][3]);\n        }\n      }\n    }\n",
         "    group_sync(1 + k, kGroupThreads);\n    GM(5)\n")
    mark("  // ---- the last block to finish",
         "  __syncthreads();\n  T(15) if (tid == 0) phase_g[blockIdx.x * 2 + 1] = "
         "hopper::global_timer_ns();\n", before=True)
    return src + '''
extern "C" int phase_read(void* t, void* g) {
  cudaError_t e = cudaMemcpyFromSymbol(t, tc::phase_t, sizeof(tc::phase_t));
  if (e != cudaSuccess) return e;
  return cudaMemcpyFromSymbol(g, tc::phase_g, sizeof(tc::phase_g));
}
'''


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("ssm_scan_phases: needs a CUDA card")
    from repro_torch.kernels import build
    from repro_torch.kernels.ssm_scan import scratch_sizes

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / "ssm_scan_phases.cu"
    so = build.BUILD_DIR / "ssm_scan_phases.so"
    cu.write_text(instrumented_source())
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                          "-o", str(so), str(cu)], capture_output=True, text=True)
    if res.returncode:
        sys.exit(f"nvcc failed:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = lib.ssm_scan_launch
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.phase_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]

    B, S, H, P, N, Q = 8, 2048, 32, 64, 128, 128
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(B, S, H, P, generator=gen, device="cuda") * 0.5).bfloat16()
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=gen, device="cuda"))
    A = -torch.exp(torch.rand(H, generator=gen, device="cuda"))
    Bm = (torch.randn(B, S, N, generator=gen, device="cuda") * 0.3).bfloat16()
    Cm = (torch.randn(B, S, N, generator=gen, device="cuda") * 0.3).bfloat16()
    y = torch.empty_like(x)
    h = torch.empty(B, H, N, P, device="cuda")
    n_ring, n_scratch = scratch_sizes(B, S, H, P, N, Q)
    ring = torch.empty(n_ring, device="cuda")
    scratch = torch.zeros(n_scratch, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(1, x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 y.data_ptr(), h.data_ptr(), ring.data_ptr(), scratch.data_ptr(),
                 B, S, H, P, N, Q, stream)
        if err:
            sys.exit(f"launch failed: cudaError {err}")

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    call()
    end.record()
    end.synchronize()
    blocks = (S // Q) * B * (H // 2)          # P 64: two heads a block
    t = np.zeros(8192 * NT, dtype=np.uint64)
    g = np.zeros(8192 * 2, dtype=np.uint64)
    if lib.phase_read(t.ctypes.data, g.ctypes.data):
        sys.exit("reading the marks failed")
    t = t[: blocks * NT].reshape(blocks, NT).astype(np.int64)
    g = g[: blocks * 2].reshape(blocks, 2).astype(np.int64)
    total = t[:, 15] - t[:, 0]
    print(f"instrumented call {start.elapsed_time(end):.4f} ms; {blocks} blocks of 512 threads; "
          f"cycles a block: mean {total.mean():.0f}, median {np.median(total):.0f}")

    def row(label, d):
        print(f"  {label:34s} mean {d.mean():7.0f}  median {np.median(d):7.0f}  "
              f"p90 {np.percentile(d, 90):7.0f} cycles ({d.mean() / total.mean():.1%})")

    for label, a, b in BLOCK_PHASES:
        row(label, t[:, b] - t[:, a])
    for k in range(2):
        for label, a, b in GROUP_PHASES:
            row(f"head {k}: {label}", t[:, 3 + 6 * k + b] - t[:, 3 + 6 * k + a])
    row("both heads done, clean-up", t[:, 15] - np.maximum(t[:, 8], t[:, 14]))
    g0, g1 = g[:, 0] - g[:, 0].min(), g[:, 1] - g[:, 0].min()
    print(f"global timer: last block ends {g1.max() / 1e3:.1f} us after the first starts; "
          f"a block lasts {(g1 - g0).mean() / 1e3:.2f} us on average; blocks start at "
          + ", ".join(f"q{int(q * 100)} {np.quantile(g0, q) / 1e3:.1f} us"
                      for q in (0.1, 0.5, 0.9, 1.0)))


if __name__ == "__main__":
    main()
