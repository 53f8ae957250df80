#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports the port (``src/repro_torch``) and nothing of JAX or of the
JAX package. Phases, in order; each passes or ends the run with a
non-zero exit:

1. build   every CUDA source under ``src/repro_torch/csrc`` (one nvcc per
           source, in parallel) and print the build time and ptxas report;
2. kernels each hand-written kernel against its plain PyTorch version on
           the card, at the shapes its main path gives it and on edge
           cases; times of the kernel, the plain version and the
           one-call PyTorch yardstick (where there is one) beside the
           bound: gossip_axpy (odd sizes, misaligned views, in place; at
           the training step's leaves in turns with torch.lerp),
           flash_attention (odd and unequal lengths, kv_len, windows,
           GQA groups 1 and 2, fully masked rows, fp32 and bf16; the
           registry's other head widths at B 2, S 2048, causal, in bf16
           and fp32, in turns with sdpa: nemotron-4-340b 96/8 heads of
           192, kimi-k2 64/8 of 112, gemma3-4b 8/4 of 256, also with a
           1024 window),
           ssm_scan (chunk halving, fp32 and bf16, decays that underflow,
           the path each case takes; at mamba2-370m's serving shapes the
           tensor-core kernel in turns with the scalar kernel, which takes
           a 2-byte-offset copy of x)
           and grouped_matmul (the sweep of tests/test_kernels.py, empty
           groups, ragged tails, rows past the groups, in fp32 and bf16;
           dbrx-132b's prefill shapes, 65,536 sorted rows x 6144 x 10752
           and the transposed w2 shape, and its decode shape of 32 rows,
           with group sizes from a router pass), with torch._grouped_mm
           as the one-call yardstick;
3. main    the decentralized trainer at full published width:
           internlm2-1.8b (d 2048, 16 heads, 8 kv heads, head_dim 128,
           d_ff 8192, vocab 92544), depth cut 24 -> 2 layers, 8 nodes on
           paper8, MATCHA budget 0.5, masked gossip, SGD lr 0.05 momentum
           0.9, 4 x 128 tokens per node, 5 steps, then 2 faulted steps
           (link drops at p_drop 0.35, per-node bits); launch counts,
           per-step and per-phase times, dropped exchanges, peak memory,
           loss and consensus; then one more step whose gossip runs
           through the kernel and through the plain version from the same
           state, with the schedule row and with faulted bits, which must
           agree bit for bit, as must all-ones gates and the unfaulted
           gossip; then the first two nodes' params and velocities (8.1
           GB) through save_run_step and restore_run to the card, bit for
           bit, with the save and restore rates;
4. serve   the serving path (``repro_torch.launch.serve``) at full
           published width: internlm2-1.8b (24 layers), mamba2-370m (48
           layers, d 1024, 32 SSM heads of 64, state 128, vocab 50280) and
           dbrx-132b (d 6144, 48 heads, 8 kv heads, head_dim 128, 16
           experts, top-4, expert d_ff 10752, vocab 100352; depth cut
           40 -> 3 layers to fit one card), batch 8, prompt 2048, 32
           generated tokens, random weights from seed 0; prefill and decode
           times, peak memory, and all four kernels' launches, counted from
           0 for each model (gossip_axpy none): internlm2 24 flash_attention per prefill,
           mamba2 48 ssm_scan per prefill, none in decode; dbrx 3
           flash_attention and 9 grouped_matmul per prefill and 9
           grouped_matmul per decode step; then a profile of one prefill
           and four decode steps of each model: device busy share, kernel
           launches per step, the costliest kernels;
5. check   small inputs (the tiny presets, fp32) run on the card and on
           the CPU from the same weights must agree: two masked training
           steps, and for internlm2, mamba2 and dbrx with 16 experts and
           top-4 (the ragged MoE branch) a prefill, one decode step and
           every cache; then the training CLI ``repro_torch.launch.train``
           must train on the card, and with link drops (--p-drop 0.35) a
           run that checkpoints every 3 steps and crashes after step 4
           must, resumed with --resume auto, end where an uninterrupted
           run ends;
6. tests   the card-only tests (``pytest -m cuda
           tests/test_torch_kernels_cuda.py``) in a child process.

Then it prints the card's name and power limit, one JSON line with every
ported kernel's numbers, and, last, the device JSON line.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet, at the 700 W limit
BF16_FLOP_PER_S = 989e12        # dense bf16 tensor cores, same source
FP32_FLOP_PER_S = 67e12         # fp32 on the CUDA cores, same source
NODES, BATCH, SEQ, STEPS = 8, 4, 128, 5
FAULTED_STEPS, P_DROP = 2, 0.35  # faulted steps after the masked ones, drop rate
CKPT_NODES = 2                  # nodes whose full-width state is checkpointed
SMALL_TOL = 1e-4                # card vs CPU, fp32 tiny preset, 2 steps
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 2048, 32
# kernel vs plain version on the card: the kernels sum in another order
# (and attention uses the fast exp); bf16 outputs may sit one bf16
# rounding apart
FA_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SSM_TOL = {"float32": (1e-4, 1e-3), "bfloat16": (5e-2, 5e-2)}   # (abs, rel)
SERVE_TOL = 1e-4                # card (kernels) vs CPU (plain), fp32 tiny serving
# grouped matmul vs its plain version: fp32 sums over K in another order;
# in bf16 both round an fp32 sum once, one bf16 step apart at most
GMM_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DBRX_LAYERS = 3                 # dbrx-132b depth on one card (40 published)
# the registry's other head widths, on the scalar flash kernel: (model,
# query heads, kv heads, head_dim, window)
FLASH_WIDE = [
    ("nemotron-4-340b", 96, 8, 192, 0),
    ("kimi-k2", 64, 8, 112, 0),
    ("gemma3-4b", 8, 4, 256, 0),
    ("gemma3-4b local", 8, 4, 256, 1024),
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bf16_ulp_agree(torch, got, want) -> bool:
    """Within one bf16 rounding of the plain version."""
    diff = (got.float() - want.float()).abs()
    return bool((diff <= want.float().abs() * 2.0**-7 + 1e-30).all())


def ptxas_report(text: str):
    """(kernel, registers, spill store bytes, spill load bytes) for each
    entry function in one source's ``nvcc -Xptxas -v`` output."""
    import re

    rows, label, spills = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled, base, i = m.group(1), None, 0
            while base is None and i < len(mangled):   # length-prefixed names
                n = re.match(r"\d+", mangled[i:])
                if n is None:
                    i += 1
                    continue
                start = i + len(n.group())
                name = mangled[start:start + int(n.group())]
                base = name if name.endswith("_kernel") else None
                i = start + int(n.group())
            args = ["bf16" if "__nv_bfloat16" in mangled else "fp32" if
                    re.search(r"kernelIf", mangled) else ""]
            args += re.findall(r"Li(\d+)E", mangled)
            args = [a for a in args if a]
            label = (base or mangled) + (f"<{', '.join(args)}>" if args else "")
            spills = (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and label:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and label:
            rows.append((label, int(m.group(1)), *spills))
            label = None
    return rows


def phase_build():
    """Builds every kernel; returns {kernel: (registers, spill stores,
    spill loads)} from ptxas's report of this build."""
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build()
    secs = time.perf_counter() - t0
    for name in build.sources():
        log(f"build: {name} -> {os.path.relpath(build.library_path(name), ROOT)}")
    for name, text in logs.items():
        for line in text.strip().splitlines():
            log(f"build: [{name}] {line}")
    log(f"build: {len(logs)} source(s) compiled in {secs:.2f} s")
    report = {}
    for name, text in logs.items():
        for kernel, regs, st, ld in ptxas_report(text):
            report[kernel] = (regs, st, ld)
            log(f"build: ptxas {kernel}: {regs} registers, {st} bytes spill stores, "
                f"{ld} bytes spill loads")
    return report


def ptxas_note(report, prefix: str) -> str:
    """ptxas's registers and spills of the kernels named ``prefix*``."""
    rows = [f"{k} {r} registers, {st}/{ld} bytes spilled (stores/loads)"
            for k, (r, st, ld) in sorted(report.items()) if k.startswith(prefix)]
    return "; ".join(rows) if rows else "ptxas report not available (library cached)"


def in_turns(torch, kernel, library, iters: int, warmup: int = 2):
    """Times of ``kernel`` and ``library`` measured in turns: kernel,
    library, library, kernel. Returns ((k1, k2), (l1, l2)) in ms."""
    k1 = cuda_ms(torch, kernel, iters, warmup)
    l1 = cuda_ms(torch, library, iters, warmup)
    l2 = cuda_ms(torch, library, iters, warmup)
    k2 = cuda_ms(torch, kernel, iters, warmup)
    return (k1, k2), (l1, l2)


def phase_kernels(torch, leaf_shapes, alpha: float):
    """gossip_axpy against gossip_axpy_ref; returns the JSON row's times."""
    from repro_torch.kernels.gossip_axpy import gossip_axpy
    from repro_torch.kernels.ref import gossip_axpy_ref

    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(n, dtype, offset=0):
        base = torch.randn(n + offset, generator=gen, device="cuda")
        return base.to(dtype)[offset:]

    max_err = 0.0
    cases = [
        # (label, x dtype, y dtype, elements, x offset, y offset)
        ("fp32/fp32 odd", f32, f32, 1003 * 77 + 5, 0, 0),
        ("bf16/bf16 odd", bf16, bf16, (1 << 20) + 7, 0, 0),
        ("bf16/fp32 odd", bf16, f32, 3 * 5 * 7 * 11 * 13 + 1, 0, 0),
        ("fp32/fp32 n=1", f32, f32, 1, 0, 0),
        ("bf16/fp32 n=9", bf16, f32, 9, 0, 0),
        ("fp32 views +1/+1 (vector path after a head)", f32, f32, 4099, 1, 1),
        ("fp32 views +1/+2 (scalar path)", f32, f32, 4099, 1, 2),
        ("bf16 views +3/+3", bf16, bf16, 70001, 3, 3),
        ("bf16/fp32 views +1/+1", bf16, f32, 70001, 1, 1),
    ]
    for label, tx, ty, n, ox, oy in cases:
        x, y = rand(n, tx, ox), rand(n, ty, oy)
        for a in (0.0, alpha, 1.0):
            for inplace in (False, True):
                want = gossip_axpy_ref(x, y, a)
                xin = x.clone() if inplace else x
                got = gossip_axpy(xin, y, a, inplace=inplace)
                torch.cuda.synchronize()
                if inplace and got.data_ptr() != xin.data_ptr():
                    fail(f"kernel {label}: in-place result is not x")
                exact = torch.equal(got, want)
                err = float((got.float() - want.float()).abs().max())
                max_err = max(max_err, err)
                if tx == f32 and not exact:
                    fail(f"kernel {label} alpha={a}: fp32 not bit-equal (max err {err})")
                if not exact and not bf16_ulp_agree(torch, got, want):
                    fail(f"kernel {label} alpha={a}: off by more than a bf16 ulp")
        log(f"kernels: gossip_axpy {label}: n={n} agrees with the plain version "
            f"(bit-equal in fp32; max abs err {max_err:g})")

    # the main path's largest leaf, embed.table of 8 replicas, fp32
    big = leaf_shapes["embed.table"]
    n = math.prod(big)
    x = torch.randn(big, generator=gen, device="cuda")
    y = torch.randn(big, generator=gen, device="cuda")
    got = gossip_axpy(x, y, alpha)
    if not torch.equal(got, gossip_axpy_ref(x, y, alpha)):
        fail(f"kernel on {big}: not bit-equal to the plain version")
    del got
    leaf_bound = 12 * n / HBM_BYTES_PER_S * 1e3
    (k1, k2), (l1, l2) = in_turns(torch, lambda: gossip_axpy(x, y, alpha),
                                  lambda: torch.lerp(x, y, alpha), 10)
    k_ms, l_ms = (k1 + k2) / 2, (l1 + l2) / 2
    p_ms = cuda_ms(torch, lambda: gossip_axpy_ref(x, y, alpha), 5)
    log(f"kernels: gossip_axpy largest leaf {big} fp32: in turns kernel {k1:.3f} ms, "
        f"torch.lerp {l1:.3f} ms, torch.lerp {l2:.3f} ms, kernel {k2:.3f} ms "
        f"({k_ms / l_ms:.3f}x lerp), plain {p_ms:.3f} ms, bound {leaf_bound:.3f} ms "
        f"({leaf_bound / k_ms:.1%} of the HBM roofline; lerp {leaf_bound / l_ms:.1%})")
    del x, y
    torch.cuda.empty_cache()

    # one step's worth: the 12 float leaves of 8 replicas, fp32 x and target
    xs = [torch.randn(s, generator=gen, device="cuda") for s in leaf_shapes.values()]
    ys = [torch.randn(s, generator=gen, device="cuda") for s in leaf_shapes.values()]
    elems = sum(t.numel() for t in xs)
    for xi, yi in zip(xs, ys):
        if not torch.equal(gossip_axpy(xi, yi, alpha), gossip_axpy_ref(xi, yi, alpha)):
            fail(f"kernel on leaf {tuple(xi.shape)}: not bit-equal")

    def all_leaves(fn):
        def run():
            for xi, yi in zip(xs, ys):
                fn(xi, yi)
        return run

    step_bound = 12 * elems / HBM_BYTES_PER_S * 1e3
    (k1, k2), (l1, l2) = in_turns(torch, all_leaves(lambda a, b: gossip_axpy(a, b, alpha)),
                                  all_leaves(lambda a, b: torch.lerp(a, b, alpha)), 10)
    k_ms, l_ms = (k1 + k2) / 2, (l1 + l2) / 2
    p_ms = cuda_ms(torch, all_leaves(lambda a, b: gossip_axpy_ref(a, b, alpha)), 5)
    log(f"kernels: gossip_axpy one step ({len(xs)} leaves, {elems} elements, "
        f"{12 * elems / 1e9:.1f} GB): in turns kernel {k1:.3f} ms, torch.lerp "
        f"{l1:.3f} ms, torch.lerp {l2:.3f} ms, kernel {k2:.3f} ms ({k_ms / l_ms:.3f}x "
        f"lerp), plain {p_ms:.3f} ms, bound {step_bound:.3f} ms "
        f"({step_bound / k_ms:.1%} of the HBM roofline; lerp {step_bound / l_ms:.1%})")
    del xs, ys
    torch.cuda.empty_cache()
    return dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms,
                bound_ms=step_bound, library_ms=l_ms)


def close(torch, got, want, atol: float, rtol: float) -> float:
    """Max abs error; fails unless |got - want| <= atol + rtol |want|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if not bool(torch.isfinite(got).all()):
        return math.inf
    if not bool((diff <= atol + rtol * want.abs()).all()):
        return math.inf
    return float(diff.max()) if diff.numel() else 0.0


def flash_pairs(Sq: int, Sk: int, causal: bool, window: int, kv_len: int) -> int:
    """Live (query, key) pairs: the work this input needs."""
    n = kv_len or Sk
    total = 0
    for i in range(Sq):
        hi = min(n, i + 1) if causal else n
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def phase_flash(torch, ptxas):
    """flash_attention against attention_ref; returns the JSON row."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, kernel_path
    from repro_torch.kernels.ref import attention_ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def qkv(B, Sq, Sk, Hq, Hkv, hd, dtype):
        mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)
        return mk(B, Sq, Hq, hd), mk(B, Sk, Hkv, hd), mk(B, Sk, Hkv, hd)

    max_err = 0.0
    cases = [
        # (label, B, Sq, Sk, Hq, Hkv, hd, causal, window, kv_len)
        ("odd Sq = Sk, GQA 2", 2, 100, 100, 4, 2, 32, True, 0, 0),
        ("Sq != Sk, GQA 1, non-causal", 1, 37, 130, 2, 2, 128, False, 0, 0),
        ("Sq > Sk, MQA, causal", 2, 130, 37, 4, 1, 64, True, 0, 0),
        ("kv_len 61, causal", 2, 192, 192, 8, 4, 128, True, 0, 61),
        ("kv_len 61, non-causal, window 24", 1, 100, 128, 4, 4, 64, False, 24, 61),
        ("window 24 causal (rows masked per tile)", 2, 256, 256, 8, 2, 64, True, 24, 0),
        ("fully masked rows: kv_len 10, window 4", 1, 96, 96, 2, 1, 32, True, 4, 10),
        ("smoke widths (4 heads, 2 kv, hd 32)", 2, 64, 64, 4, 2, 32, True, 0, 0),
    ]
    for label, B, Sq, Sk, Hq, Hkv, hd, causal, window, kv_len in cases:
        for dname, dtype in dtypes.items():
            q, k, v = qkv(B, Sq, Sk, Hq, Hkv, hd, dtype)
            got = flash_attention(q, k, v, causal=causal, window=window, kv_len=kv_len)
            torch.cuda.synchronize()
            n = kv_len or Sk
            want = attention_ref(q, k[:, :n], v[:, :n], causal=causal, window=window)
            i = torch.arange(Sq, device="cuda")[:, None]
            j = torch.arange(n, device="cuda")[None, :]
            live = (j >= 0) & (i >= 0)
            if causal:
                live = live & (j <= i)
            if window:
                live = live & (i - j < window)
            rows = live.any(1)
            if not bool((got[:, ~rows] == 0).all()):
                fail(f"flash {label} {dname}: a row with no live key is not 0")
            err = close(torch, got[:, rows], want[:, rows], FA_TOL[dname], FA_TOL[dname])
            if not math.isfinite(err):
                fail(f"flash {label} {dname}: disagrees with attention_ref")
            max_err = max(max_err, err)
            log(f"kernels: flash_attention {label} {dname} ({kernel_path(q, k)}): agrees "
                f"(max abs err {err:.3g}; {int((~rows).sum())} rows with no live key are 0)")

    # the serving path's prefills, bf16, causal: internlm2-1.8b (16/8 heads;
    # the JSON row) and dbrx-132b (48/8 heads)
    row = None
    for model, Hq, Hkv in (("internlm2-1.8b", 16, 8), ("dbrx-132b", 48, 8)):
        B, S, hd = SERVE_BATCH, SERVE_PROMPT, 128
        q, k, v = qkv(B, S, S, Hq, Hkv, hd, torch.bfloat16)
        got = flash_attention(q, k, v, causal=True)
        want = attention_ref(q, k, v, causal=True)
        err = close(torch, got, want, FA_TOL["bfloat16"], FA_TOL["bfloat16"])
        if not math.isfinite(err):
            fail(f"flash at {model}'s serving shapes: disagrees with attention_ref")
        max_err = max(max_err, err)
        del got, want
        torch.cuda.empty_cache()
        flops = 4 * hd * B * Hq * flash_pairs(S, S, True, 0, 0)
        nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel())
        bound = max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        bound_by = ("operations" if flops / BF16_FLOP_PER_S >= nbytes / HBM_BYTES_PER_S
                    else "bytes")
        if kernel_path(q, k) != "wgmma":
            fail(f"flash at {model}'s serving shapes does not take the wgmma kernel")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        (k1, k2), (l1, l2) = in_turns(
            torch, lambda: flash_attention(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                   enable_gqa=True), 10)
        k_ms, l_ms = (k1 + k2) / 2, (l1 + l2) / 2
        p_ms = cuda_ms(torch, lambda: attention_ref(q, k, v, causal=True), 3)
        log(f"kernels: flash_attention {model} serving shapes (B {B}, S {S}, heads "
            f"{Hq}/{Hkv}, hd {hd}, bf16, causal; {flops / 1e9:.1f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB): path wgmma; in turns kernel "
            f"{k1:.3f} ms, sdpa {l1:.3f} ms, sdpa {l2:.3f} ms, kernel {k2:.3f} ms "
            f"({flops / k_ms / 1e9:.0f} TFLOP/s; {k_ms / l_ms:.2f}x sdpa); plain "
            f"{p_ms:.3f} ms; bound {bound:.3f} ms by {bound_by} ({bound / k_ms:.1%} of "
            f"it; fp32 CUDA-core floor {flops / FP32_FLOP_PER_S * 1e3:.3f} ms); max "
            f"abs err {err:.3g}")
        if row is None:
            row = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=bound_by,
                       library_ms=l_ms)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    max_err = max(max_err, flash_wide(torch, qkv))
    log(f"kernels: flash_attention ptxas: {ptxas_note(ptxas, 'flash_')}")
    row["max_abs_err"] = max_err
    return row


def flash_wide(torch, qkv) -> float:
    """flash_attention at the registry's other head widths (the scalar
    kernel): B 2, S 2048, causal, in bf16 and fp32, against attention_ref,
    timed in turns with sdpa; returns the max abs error."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, kernel_path
    from repro_torch.kernels.ref import attention_ref

    B, S = 2, SERVE_PROMPT
    max_err = 0.0
    for model, Hq, Hkv, hd, window in FLASH_WIDE:
        i = torch.arange(S, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
        for dname, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            q, k, v = qkv(B, S, S, Hq, Hkv, hd, dtype)
            run = lambda: flash_attention(q, k, v, causal=True, window=window)
            got = run()
            want = attention_ref(q, k, v, causal=True, window=window)
            err = close(torch, got, want, FA_TOL[dname], FA_TOL[dname])
            if not math.isfinite(err):
                fail(f"flash at {model}'s widths ({hd}) {dname}: disagrees with attention_ref")
            max_err = max(max_err, err)
            del got, want
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            mask_kw = dict(attn_mask=mask) if window else dict(is_causal=True)
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                                          **mask_kw)
            (k1, k2), (l1, l2) = in_turns(torch, run, sdpa, 5, warmup=1)
            p_ms = cuda_ms(torch, lambda: attention_ref(q, k, v, causal=True, window=window),
                           2, warmup=1)
            flops = 4 * hd * B * Hq * flash_pairs(S, S, True, window, 0)
            nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
            rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
            t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_PER_S
            bound = max(t_ops, t_bytes) * 1e3
            k_ms, l_ms = (k1 + k2) / 2, (l1 + l2) / 2
            log(f"kernels: flash_attention {model} widths (B {B}, S {S}, heads {Hq}/{Hkv}, "
                f"hd {hd}, {dname}, causal{f', window {window}' if window else ''}; "
                f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB): path {kernel_path(q, k)}; "
                f"in turns kernel {k1:.3f} ms, sdpa {l1:.3f} ms, sdpa {l2:.3f} ms, kernel "
                f"{k2:.3f} ms ({k_ms / l_ms:.2f}x sdpa; {flops / k_ms / 1e9:.1f} TFLOP/s); "
                f"plain {p_ms:.3f} ms; bound {bound:.4f} ms by "
                f"{'operations' if t_ops >= t_bytes else 'bytes'} ({bound / k_ms:.1%} of it); "
                f"max abs err {err:.3g}")
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()
    return max_err


def phase_ssm(torch, ptxas):
    """ssm_scan against ssm_scan_ref; returns the JSON row."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssm_scan_ref
    from repro_torch.kernels.ssm_scan import kernel_path, ssm_scan

    gen = torch.Generator(device="cuda").manual_seed(2)

    def inputs(B, S, H, P, N, dtype, a_scale=1.0):
        rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
        x = (rn(B, S, H, P) * 0.5).to(dtype)
        dt = F.softplus(rn(B, S, H))
        A = -torch.exp(torch.rand(H, generator=gen, device="cuda")) * a_scale
        return x, dt, A, (rn(B, S, N) * 0.3).to(dtype), (rn(B, S, N) * 0.3).to(dtype)

    def check(label, dname, got, want):
        atol, rtol = SSM_TOL[dname]
        errs = [close(torch, g, w, atol, rtol) for g, w in zip(got, want)]
        if not all(math.isfinite(e) for e in errs):
            fail(f"ssm_scan {label} {dname}: disagrees with ssm_scan_ref (y, h)")
        log(f"kernels: ssm_scan {label} {dname}: agrees (max abs err y "
            f"{errs[0]:.3g}, h {errs[1]:.3g})")
        return max(errs)

    max_err = 0.0
    cases = [
        # (label, B, S, H, P, N, a_scale): ops.ssd halves the chunk from 128
        ("S 200 -> chunk 100", 2, 200, 3, 16, 8, 1.0),
        ("S 96 -> chunk 96", 2, 96, 4, 32, 16, 1.0),
        ("S 52 -> chunk 52", 1, 52, 2, 64, 128, 1.0),
        ("S 384 -> chunk 128 (3 chunks)", 1, 384, 2, 64, 128, 1.0),
        ("smoke widths, S 100 -> chunk 100", 2, 100, 8, 32, 32, 1.0),
        ("A * dt up to ~200: decays underflow", 2, 256, 4, 32, 32, 60.0),
    ]
    for label, B, S, H, P, N, a_scale in cases:
        for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            x, dt, A, Bm, Cm = inputs(B, S, H, P, N, dtype, a_scale)
            got = ops.ssd(x, dt, A, Bm, Cm, chunk=128)
            torch.cuda.synchronize()
            chunk = min(128, S)
            while S % chunk:
                chunk //= 2
            path = kernel_path(x, Bm, chunk, Cm)
            max_err = max(max_err, check(f"{label} ({path})", dname, got,
                                         ssm_scan_ref(x, dt, A, Bm, Cm)))

    # the serving path's shapes: mamba2-370m prefill, bf16 x/B/C, fp32 dt/A
    B, S, H, P, N, Q = SERVE_BATCH, SERVE_PROMPT, 32, 64, 128, 128
    x, dt, A, Bm, Cm = inputs(B, S, H, P, N, torch.bfloat16)
    path = kernel_path(x, Bm, Q, Cm)
    if path != "mma":
        fail(f"ssm_scan at the serving shapes takes the {path} kernel, not mma")
    # the same x at a 2-byte offset is contiguous but not 16-byte aligned,
    # so the scalar kernel takes it: both are timed at the serving shapes
    x_off = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")[1:].view(x.shape)
    x_off.copy_(x)
    if kernel_path(x_off, Bm, Q, Cm) != "scalar":
        fail("ssm_scan: a 2-byte-offset x does not take the scalar kernel")
    want = ssm_scan_ref(x, dt, A, Bm, Cm)
    max_err = max(max_err, check("serving shapes (mma)", "bfloat16",
                                 ssm_scan(x, dt, A, Bm, Cm, chunk=Q), want))
    max_err = max(max_err, check("serving shapes (scalar)", "bfloat16",
                                 ssm_scan(x_off, dt, A, Bm, Cm, chunk=Q), want))
    del want
    tri = Q * (Q + 1) // 2
    flops = B * H * (S // Q) * (2 * tri * N + 2 * tri * P + 4 * Q * N * P)
    nbytes = (2 * x.numel() * 2 + dt.numel() * 4 + A.numel() * 4
              + 2 * Bm.numel() * 2 + B * H * N * P * 4)
    bound = max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / BF16_FLOP_PER_S >= nbytes / HBM_BYTES_PER_S else "bytes"
    (k1, k2), (s1, s2) = in_turns(torch, lambda: ssm_scan(x, dt, A, Bm, Cm, chunk=Q),
                                  lambda: ssm_scan(x_off, dt, A, Bm, Cm, chunk=Q), 5)
    k_ms, sc_ms = (k1 + k2) / 2, (s1 + s2) / 2
    p_ms = cuda_ms(torch, lambda: ssm_scan_ref(x, dt, A, Bm, Cm), 2, warmup=1)
    log(f"kernels: ssm_scan serving shapes (B {B}, S {S}, H {H}, P {P}, N {N}, "
        f"chunk {Q}, bf16; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB): path mma; "
        f"in turns mma {k1:.4f} ms, scalar {s1:.4f} ms, scalar {s2:.4f} ms, mma "
        f"{k2:.4f} ms ({sc_ms / k_ms:.1f}x faster than the scalar kernel); plain "
        f"{p_ms:.3f} ms; no single PyTorch call computes the SSD; bound {bound:.4f} ms "
        f"by {bound_by} ({bound / k_ms:.1%} of it; fp32 CUDA-core floor "
        f"{flops / FP32_FLOP_PER_S * 1e3:.3f} ms)")
    log(f"kernels: ssm_scan ptxas: {ptxas_note(ptxas, 'ssd_')}")
    del x, x_off, dt, A, Bm, Cm
    torch.cuda.empty_cache()
    return dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=None)


def phase_tests():
    """The card-only tests (``-m cuda``), in a child process."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-m", "cuda",
         os.path.join("tests", "test_torch_kernels_cuda.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )
    lines = res.stdout.strip().splitlines()
    for line in lines[-15:] if res.returncode else lines[-1:]:
        log(f"tests: {line}")
    log(f"tests: card tests took {time.perf_counter() - t0:.1f} s")
    if res.returncode != 0:
        fail(f"card tests failed (pytest exit code {res.returncode})")


def dbrx_serving_config():
    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config("dbrx_132b"), num_layers=DBRX_LAYERS)


def router_group_sizes(torch, cfg, tokens: int, seed: int):
    """Group sizes of a router pass: the port's ``_router`` at the model's
    router init over ``tokens`` N(0, 1) hidden states."""
    from repro_torch.models import ffn
    from repro_torch.models.module import lecun_normal

    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = lecun_normal(gen, (cfg.d_model, cfg.moe_num_experts), torch.float32, "cuda")
    x = torch.randn(tokens, cfg.d_model, generator=gen, device="cuda")
    _, idx, _ = ffn._router({"router": {"w": w}}, x, cfg)
    return torch.bincount(idx.reshape(-1), minlength=cfg.moe_num_experts).int()


def phase_gmm(torch, ptxas):
    """grouped_matmul against grouped_matmul_ref; returns the JSON row
    (dbrx's prefill w1/w3 shape, bf16)."""
    from repro_torch.kernels.grouped_matmul import grouped_matmul, kernel_path
    from repro_torch.kernels.ref import grouped_matmul_ref

    gen = torch.Generator(device="cuda").manual_seed(4)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def inputs(M, K, N, G, dtype, w_std):
        x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(G, K, N, generator=gen, device="cuda") * w_std).to(dtype)
        return x, w

    def cut(M, G, seed):
        import numpy as np

        rng = np.random.default_rng(seed)
        cuts = np.sort(rng.choice(M, G - 1, replace=False))
        return np.diff(np.concatenate([[0], cuts, [M]])).tolist()

    def check(label, dname, x, w, sizes):
        got = grouped_matmul(x, w, sizes)
        torch.cuda.synchronize()
        want = grouped_matmul_ref(x, w, sizes)
        tail = int(sizes.sum())
        if not bool((got[tail:] == 0).all()):
            fail(f"grouped_matmul {label} {dname}: rows past the groups are not 0")
        err = close(torch, got, want, GMM_TOL[dname], GMM_TOL[dname])
        if not math.isfinite(err):
            fail(f"grouped_matmul {label} {dname}: disagrees with grouped_matmul_ref")
        return err

    def bound(x, w, sizes, elem):
        M, K = x.shape
        N = w.shape[2]
        rows = int(sizes.sum())
        flops = 2 * rows * K * N
        live = int((sizes > 0).sum())
        nbytes = (M * K + live * K * N + M * N) * elem + 4 * sizes.numel()
        rate = BF16_FLOP_PER_S if elem == 2 else FP32_FLOP_PER_S
        t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
                flops, nbytes)

    def library(x, w, sizes):
        """torch._grouped_mm on the same inputs as a callable, or None, and
        what it gives (or why it cannot take them)."""
        if x.dtype != torch.bfloat16:
            return None, "torch._grouped_mm takes bf16 only"
        if not hasattr(torch, "_grouped_mm"):
            return None, f"torch {torch.__version__} has no torch._grouped_mm"
        offs = torch.cumsum(sizes, 0, dtype=torch.int32)
        try:
            lib = torch._grouped_mm(x, w, offs=offs)
            torch.cuda.synchronize()
        except RuntimeError as err:                # report, do not stop
            return None, f"torch._grouped_mm refused: {str(err).splitlines()[0][:160]}"
        tail = int(sizes.sum())
        lib_err = float((lib[:tail].float() - grouped_matmul_ref(x, w, sizes)[:tail].float())
                        .abs().max()) if tail else 0.0
        del lib
        return (lambda: torch._grouped_mm(x, w, offs=offs)), f"max abs diff {lib_err:.3g}"

    max_err = 0.0
    cases = [
        # (label, M, K, N, group sizes): the sweep of tests/test_kernels.py,
        # then empty groups, tails, and rows past the groups
        ("sweep 96x32x48, 4 groups", 96, 32, 48, cut(96, 4, 100)),
        ("sweep 256x64x128, 8 groups", 256, 64, 128, cut(256, 8, 264)),
        ("sweep 130x16x40, 3 groups (ragged tails)", 130, 16, 40, cut(130, 3, 133)),
        ("sweep 64x128x256, 16 groups (some empty)", 64, 128, 256, cut(64, 16, 80)),
        ("empty groups 0/40/0/24", 64, 16, 24, [0, 40, 0, 24]),
        ("M 37 below one tile", 37, 48, 72, [5, 0, 20, 12]),
        ("M 165, groups over tiles", 165, 48, 72, [64, 0, 0, 101]),
        ("sum(sizes) 17 < M 48", 48, 24, 40, [10, 0, 7]),
        ("no rows in any group", 48, 24, 40, [0, 0, 0]),
        ("K 20, N 36 (scalar path in bf16)", 300, 20, 36, [100, 50, 150]),
    ]
    for label, M, K, N, sizes in cases:
        for dname, dtype in dtypes.items():
            x, w = inputs(M, K, N, len(sizes), dtype, 0.2)
            gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
            err = check(label, dname, x, w, gs)
            max_err = max(max_err, err)
            b_ms, b_by, _, _ = bound(x, w, gs, x.element_size())
            k_ms = cuda_ms(torch, lambda: grouped_matmul(x, w, gs), 5)
            p_ms = cuda_ms(torch, lambda: grouped_matmul_ref(x, w, gs), 3)
            lib_fn, lib_note = library(x, w, gs)
            if lib_fn is not None:
                lib_note = (f"torch._grouped_mm {cuda_ms(torch, lib_fn, 3, warmup=1):.4f} "
                            f"ms ({lib_note})")
            log(f"kernels: grouped_matmul {label} {dname} ({kernel_path(x, w)}): agrees "
                f"(max abs err {err:.3g}; rows past the groups are 0); kernel {k_ms:.4f} "
                f"ms, plain {p_ms:.4f} ms, {lib_note}; bound {b_ms:.5f} ms by {b_by}")

    # dbrx-132b's shapes, group sizes from a router pass
    cfg = dbrx_serving_config()
    D, F, E = cfg.d_model, cfg.moe_d_ff, cfg.moe_num_experts
    prefill_sizes = router_group_sizes(torch, cfg, SERVE_BATCH * SERVE_PROMPT, seed=5)
    decode_sizes = router_group_sizes(torch, cfg, SERVE_BATCH, seed=6)
    log(f"kernels: grouped_matmul router group sizes, prefill "
        f"{prefill_sizes.tolist()}, decode {decode_sizes.tolist()}")
    row = None
    P_pre, P_dec = SERVE_BATCH * SERVE_PROMPT * cfg.moe_top_k, SERVE_BATCH * cfg.moe_top_k
    shapes = [
        # (label, M, K, N, sizes, dtypes)
        ("dbrx prefill w1/w3", P_pre, D, F, prefill_sizes, ("bfloat16", "float32")),
        ("dbrx prefill w2", P_pre, F, D, prefill_sizes, ("bfloat16",)),
        ("dbrx decode w1/w3", P_dec, D, F, decode_sizes, ("bfloat16", "float32")),
        ("dbrx decode w2", P_dec, F, D, decode_sizes, ("bfloat16",)),
    ]
    for label, M, K, N, gs, dnames in shapes:
        for dname in dnames:
            dtype = dtypes[dname]
            x, w = inputs(M, K, N, E, dtype, 1.0 / math.sqrt(K))
            path = kernel_path(x, w)
            if path != ("wgmma" if dname == "bfloat16" else "scalar"):
                fail(f"grouped_matmul {label} {dname} takes the {path} kernel")
            err = check(label, dname, x, w, gs)
            max_err = max(max_err, err)
            b_ms, b_by, flops, nbytes = bound(x, w, gs, x.element_size())
            iters = 3 if M > P_dec else 10
            run = lambda: grouped_matmul(x, w, gs)
            lib_fn, lib_note = library(x, w, gs)
            l_ms = None
            if lib_fn is not None:       # kernel, library, library, kernel
                (k1, k2), (l1, l2) = in_turns(torch, run, lib_fn, iters, warmup=1)
                k_ms, l_ms = (k1 + k2) / 2, (l1 + l2) / 2
                times = (f"in turns kernel {k1:.3f} ms, torch._grouped_mm {l1:.3f} ms, "
                         f"torch._grouped_mm {l2:.3f} ms, kernel {k2:.3f} ms "
                         f"({k_ms / l_ms:.2f}x the library; library {lib_note})")
            else:
                k_ms = cuda_ms(torch, run, iters if dname == "bfloat16" else 2, warmup=1)
                times = f"kernel {k_ms:.3f} ms; {lib_note}"
            p_ms = cuda_ms(torch, lambda: grouped_matmul_ref(x, w, gs), 2, warmup=1)
            floor = ("" if dname == "float32" else
                     f"; fp32 CUDA-core floor {flops / FP32_FLOP_PER_S * 1e3:.3f} ms")
            log(f"kernels: grouped_matmul {label} ({M} x {K} -> {N}, {E} groups) {dname} "
                f"(path {path}; {flops / 1e12:.3f} TFLOP, "
                f"{nbytes / 1e9:.3f} GB): agrees (max abs err {err:.3g}); {times}; "
                f"{flops / k_ms / 1e9:.1f} TFLOP/s; plain {p_ms:.3f} ms; bound {b_ms:.3f} "
                f"ms by {b_by} ({b_ms / k_ms:.1%} of it{floor})")
            if row is None:                         # the first: prefill w1/w3, bf16
                row = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                           library_ms=l_ms)
            del x, w
            torch.cuda.empty_cache()
    log(f"kernels: grouped_matmul ptxas: {ptxas_note(ptxas, 'gmm_')}")
    row["max_abs_err"] = max_err
    return row


def serving_configs():
    """(config, expected launches per prefill, per decode step) of each
    model the serving phases drive."""
    from repro_torch.configs.registry import get_config

    dense, mamba, dbrx = (get_config("internlm2_1_8b"), get_config("mamba2_370m"),
                          dbrx_serving_config())
    moe = 3 * dbrx.num_layers                   # w1, w3, w2 in every layer
    return [
        (dense, {"flash_attention": dense.num_layers}, {}),
        (mamba, {"ssm_scan": mamba.num_layers}, {}),
        (dbrx, {"flash_attention": dbrx.num_layers, "grouped_matmul": moe},
         {"grouped_matmul": moe}),
    ]


def phase_serve(torch):
    """The serving path at full width; returns each kernel's launches,
    summed over the models' runs (each counted from 0)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gossip_axpy import gossip_axpy
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.launch import serve

    kernels = {"flash_attention": flash_attention, "ssm_scan": ssm_scan,
               "grouped_matmul": grouped_matmul, "gossip_axpy": gossip_axpy}
    launches = dict.fromkeys(kernels, 0)
    for cfg, per_prefill, per_decode in serving_configs():
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = serve.run(cfg, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                        gen=SERVE_GEN, seed=0, device="cuda")
        total = time.perf_counter() - t0
        counts = {name: fn.launches for name, fn in kernels.items()}
        for name, n in counts.items():
            launches[name] += n
        log(f"serve: {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}, "
            f"vocab {cfg.vocab_size}) batch {SERVE_BATCH} prompt {SERVE_PROMPT} gen "
            f"{SERVE_GEN}: prefill {res['prefill_ms']:.1f} ms, decode "
            f"{res['decode_ms_per_token']:.2f} ms/token, peak memory allocated "
            f"{res['peak_bytes'] / 1e9:.2f} GB; launches in the prefill "
            f"{res['prefill_launches']}, in the decode {res['decode_launches']}; "
            f"whole run with set-up {total:.1f} s")
        log(f"serve: {cfg.name} generated ids (first request): "
            f"{res['generated'][0].tolist()}")
        steps = SERVE_GEN - 1
        want_prefill = {k: per_prefill.get(k, 0) for k in kernels}
        want_decode = {k: per_decode.get(k, 0) * steps for k in kernels}
        if res["prefill_launches"] != want_prefill:
            fail(f"{cfg.name}: launches in the prefill {res['prefill_launches']}, "
                 f"expected {want_prefill}")
        if res["decode_launches"] != want_decode:
            fail(f"{cfg.name}: launches in the decode {res['decode_launches']}, "
                 f"expected {want_decode}")
        if counts != {k: want_prefill[k] + want_decode[k] for k in kernels}:
            fail(f"{cfg.name}: kernel launches outside the prefill and decode: {counts}")
        if not bool(torch.isfinite(res["logits"]).all()):
            fail(f"{cfg.name}: non-finite logits")
        if res["generated"].shape != (SERVE_BATCH, SERVE_GEN):
            fail(f"{cfg.name}: generated ids of shape {res['generated'].shape}")
        del res
        torch.cuda.empty_cache()
    return launches


def phase_profile(torch):
    """Where a serving step's time goes: torch.profiler over one prefill
    and four decode steps of each full model (random prompt ids): the
    device's busy time (the sum of kernel times) against the host clock,
    kernel launches per step, and the kernels that take the most time.
    Prints "not measured" where the profiler reports no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.dist import serve as sv
    from repro_torch.models.transformer import Model

    def summary(prof, wall_ms, steps, label):
        # device activity: kernels, copies and sets on the card; busy time
        # is the union of their intervals (one stream: no overlap)
        spans = sorted(
            (e.time_range.start, e.time_range.end, e.name)
            for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.name.startswith("Command Buffer")
        )
        busy_us, reach, by_name = 0.0, -math.inf, {}
        for start, end, name in spans:
            busy_us += max(0.0, end - max(start, reach))
            reach = max(reach, end)
            t, n = by_name.get(name, (0.0, 0))
            by_name[name] = (t + end - start, n + 1)
        launches = sum(e.count for e in prof.key_averages() if "LaunchKernel" in e.key)
        if not spans:
            log(f"profile: {label}: device time not measured (the profiler saw none); "
                f"host clock {wall_ms / steps:.2f} ms per step")
            return
        busy_ms = busy_us / 1e3
        log(f"profile: {label}: host clock {wall_ms / steps:.2f} ms per step, device "
            f"busy {busy_ms / steps:.2f} ms per step ({busy_ms / wall_ms:.1%}; idle "
            f"{1 - busy_ms / wall_ms:.1%}), {launches / steps:.0f} kernel launches per "
            f"step, {len(spans) / steps:.0f} device activities per step")
        top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:6]
        for name, (t_us, n) in top:
            log(f"profile: {label}:   {t_us / 1e3 / steps:9.3f} ms/step x{n // steps:<5d} "
                f"{name[:90]}")

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    gen = torch.Generator(device="cuda").manual_seed(3)
    for cfg, _, _ in serving_configs():
        model = Model(cfg)
        params = model.init(0, device="cuda")
        max_len = SERVE_PROMPT + 8
        tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                               generator=gen, device="cuda", dtype=torch.int32)
        caches = model.init_cache(SERVE_BATCH, max_len, device="cuda")
        prefill = sv.make_prefill_step(model, max_len=max_len)
        decode = sv.make_decode_step(model, max_len=max_len)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, caches = prefill(params, tokens, caches)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        summary(prof, wall, 1, f"{cfg.name} prefill")
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        logits, caches = decode(params, tok, caches, SERVE_PROMPT)     # warm-up
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(4):
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
                logits, caches = decode(params, tok, caches, SERVE_PROMPT + 1 + i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        summary(prof, wall, 4, f"{cfg.name} decode")
        del params, caches, logits
        torch.cuda.empty_cache()


def phase_serve_check(torch):
    """Tiny fp32 serving on the card (kernels) against the CPU (plain
    versions), from the same weights and prompts."""
    import numpy as np

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.models.transformer import Model
    from repro_torch.tree import tree_map

    kernels = {"flash_attention": flash_attention, "ssm_scan": ssm_scan,
               "grouped_matmul": grouped_matmul}
    B, S, max_len = 2, 100, 128
    checks = [
        # (arch, overrides, launches expected on the card per layer of the
        # prefill plus one decode step)
        ("internlm2_1_8b", {}, {"flash_attention": 1}),
        ("mamba2_370m", {}, {"ssm_scan": 1}),
        # the stock dbrx smoke model has 4 experts (the einsum branch):
        # 16 experts, top-4 take the ragged branch and its grouped matmuls
        ("dbrx_132b", dict(moe_num_experts=16, moe_top_k=4),
         {"flash_attention": 1, "grouped_matmul": 6}),
    ]
    for arch, over, per_layer in checks:
        cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32", **over)
        model = Model(cfg)
        params = model.init(0, device="cpu")
        toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 1))
        out = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda a: a.to(dev), params)
            tokens = torch.as_tensor(toks, dtype=torch.int32, device=dev)
            caches = model.init_cache(B, max_len, device=dev)
            before = {name: fn.launches for name, fn in kernels.items()}
            with torch.inference_mode():
                lp, caches = model.serve_forward(p, tokens[:, :S], caches,
                                                 start_position=0, max_len=max_len)
                prefill_caches = [{k: v.cpu().clone() for k, v in c.items()} for c in caches]
                ld, caches = model.serve_forward(p, tokens[:, S:], caches,
                                                 start_position=S, max_len=max_len)
            launched = {name: fn.launches - before[name] for name, fn in kernels.items()}
            out[dev] = (lp.cpu(), ld.cpu(), prefill_caches,
                        [{k: v.cpu() for k, v in c.items()} for c in caches], launched)
        expected = {k: per_layer.get(k, 0) * cfg.num_layers for k in kernels}
        if out["cuda"][4] != expected or any(out["cpu"][4].values()):
            fail(f"{cfg.name}: the card ran {out['cuda'][4]} kernel launches, the CPU "
                 f"{out['cpu'][4]}; expected {expected} and none")
        worst = 0.0
        for got, want in zip(out["cuda"][:2], out["cpu"][:2]):
            worst = max(worst, float((got - want).abs().max() / want.abs().max()))
        for c_got, c_want in zip(out["cuda"][2] + out["cuda"][3],
                                 out["cpu"][2] + out["cpu"][3]):
            for key in c_want:
                g, w = c_got[key].float(), c_want[key].float()
                worst = max(worst, float((g - w).abs().max() / max(w.abs().max(), 1e-30)))
        log(f"check: {cfg.name} {over or ''} fp32 serving, card (kernels: "
            f"{out['cuda'][4]}) vs CPU (plain): prefill logits, one decode step and "
            f"every cache leaf within {worst:.2e} of the largest magnitude (tolerance "
            f"{SERVE_TOL:g})")
        if not worst <= SERVE_TOL:
            fail(f"{cfg.name}: the card's serving disagrees with the CPU's")


def phase_main(torch, cfg, plan):
    """The full-width decentralized trainer: masked steps, then faulted
    steps; returns the kernel launches of both."""
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.dist import decen_train as dt
    from repro_torch.faults import FaultSpec, make_fault_schedule
    from repro_torch.kernels.gossip_axpy import gossip_axpy
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd
    from repro_torch.tree import flatten

    model = Model(cfg)
    log(f"main: {cfg.name} d_model {cfg.d_model} heads {cfg.num_heads} kv_heads "
        f"{cfg.num_kv_heads} head_dim {cfg.head_dim} d_ff {cfg.d_ff} vocab "
        f"{cfg.vocab_size}; reduced: num_layers 24 -> {cfg.num_layers} "
        f"(dataclasses.replace); {model.num_params()} params per replica")
    total = STEPS + FAULTED_STEPS + 1
    schedule = plan.schedule(total, seed=0)
    t0 = time.perf_counter()
    params = dt.init_stacked_params(model, NODES, seed=0, device="cuda")
    opt = sgd(0.05, momentum=0.9)
    opt_state = dt.init_stacked_opt_state(opt, model, NODES, device="cuda")
    data = DecentralizedBatches(cfg, NODES, BATCH, SEQ, seed=0, device="cuda")
    batches = [next(data) for _ in range(total)]
    torch.cuda.synchronize()
    log(f"main: set-up (init {NODES} replicas + optimizer state, draw "
        f"{total} batches of {NODES}x{BATCH}x{SEQ} tokens) "
        f"{time.perf_counter() - t0:.1f} s")

    fault_sched = make_fault_schedule(plan, total, FaultSpec(p_drop=P_DROP, seed=0))
    steps = {False: dt.make_train_step(model, opt, plan, gossip_mode="masked"),
             True: dt.make_train_step(model, opt, plan, gossip_mode="masked", faulted=True)}
    n_leaves = len(flatten(params))
    torch.cuda.reset_peak_memory_stats()
    gossip_axpy.launches = 0
    step_ms, phase_ms = [], []
    for k in range(STEPS + FAULTED_STEPS):
        faulted = k >= STEPS
        row = schedule.activations[k].astype("float32")
        bits = torch.as_tensor(fault_sched.node_bits(row, k) if faulted else row,
                               device="cuda")
        step = steps[faulted]
        before = gossip_axpy.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, losses, _ = step(params, opt_state, batches[k], bits)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launched = gossip_axpy.launches - before
        phases = step.last_phases.ms()
        phase_ms.append(phases)
        loss = float(losses.mean())
        cons = float(dt.consensus_distance(params))
        faults_note = (f" faulted (p_drop {P_DROP}): {fault_sched.dropped_links(row, k)} "
                       f"node-exchanges dropped, straggler delay "
                       f"{fault_sched.max_delay(k):g} units" if faulted else "")
        log(f"main: step {k} {step_ms[-1]:.1f} ms (fwd_bwd {phases['fwd_bwd']:.1f}, "
            f"optimizer {phases['optimizer']:.1f}, gossip {phases['gossip']:.1f} ms) "
            f"gossip_axpy launches {launched} loss {loss:.4f} consensus {cons:.4e} "
            f"active {len(schedule.active_indices(k))}/{plan.num_matchings}{faults_note}")
        if launched != n_leaves:
            fail(f"step {k}: {launched} gossip_axpy launches, expected {n_leaves}")
        if not (math.isfinite(loss) and math.isfinite(cons)):
            fail(f"step {k}: loss {loss} / consensus {cons} not finite")
    launches = gossip_axpy.launches
    peak = torch.cuda.max_memory_allocated()
    # step 0 pays the first-call set-up of the GEMM libraries
    steady = sorted(range(1, STEPS), key=lambda k: step_ms[k])
    mid = steady[len(steady) // 2]
    log(f"main: median masked step over steps 1..{STEPS - 1}: {step_ms[mid]:.1f} ms "
        + ", ".join(f"{name} {ms:.1f}" for name, ms in phase_ms[mid].items())
        + f" ms; step 0 {step_ms[0]:.1f} ms; faulted steps "
        + ", ".join(f"{step_ms[k]:.1f} (gossip {phase_ms[k]['gossip']:.1f})"
                    for k in range(STEPS, STEPS + FAULTED_STEPS)) + " ms")
    log(f"main: gossip_axpy launches {launches} over {STEPS} masked and "
        f"{FAULTED_STEPS} faulted steps; peak memory allocated {peak / 1e9:.2f} GB")
    if launches != n_leaves * (STEPS + FAULTED_STEPS):
        fail(f"{launches} launches on the main path, expected "
             f"{n_leaves * (STEPS + FAULTED_STEPS)}")

    # one more step: local SGD, then its gossip from the same state
    # through the kernel and through the plain version, plain and faulted
    k = STEPS + FAULTED_STEPS
    local = dt.make_train_step(model, opt, plan, gossip_mode="none")
    row = schedule.activations[k].astype("float32")
    params, opt_state, _, _ = local(params, opt_state, batches[k], None)
    check_gossip(torch, plan, params, row, fault_sched.node_bits(row, k))
    check_checkpoint(torch, params, opt_state)
    return launches


def check_gossip(torch, plan, params, row, node_bits):
    """Gossip of every leaf, one at a time: kernel against plain version,
    bit for bit, for the schedule row and for the faulted per-node bits;
    and all-ones gates against the row, bit for bit."""
    import numpy as np

    from repro_torch.dist.gossip import mix_matchings_masked
    from repro_torch.tree import flatten

    dev = lambda b: torch.as_tensor(b, device="cuda")
    ones = np.tile(row, (NODES, 1))
    for path, leaf in flatten(params).items():
        mix = lambda bits, impl: mix_matchings_masked({path: leaf}, plan.alpha,
                                                      plan.permutations, dev(bits),
                                                      impl=impl)[path]
        for label, bits in (("plain", row), ("faulted", node_bits)):
            got, want = mix(bits, "cuda"), mix(bits, "torch")
            if not torch.equal(got, want):
                fail(f"extra step: {path} differs between kernel and plain {label} gossip")
            del got, want
        got, want = mix(ones, "cuda"), mix(row, "cuda")
        if not torch.equal(got, want):
            fail(f"extra step: {path} with all-ones gates differs from unfaulted gossip")
        del got, want
    log("main: extra step: gossip through the kernel and through the plain version "
        "from the same state agree bit for bit on every leaf, for the schedule row and "
        f"for the faulted per-node bits ({int((node_bits == 0).sum())} of "
        f"{node_bits.size} gates 0); all-ones gates equal the unfaulted gossip bit for bit")


def check_checkpoint(torch, params, opt_state):
    """The first two nodes' full-width state through save_run_step and
    restore_run(device="cuda") in a temp directory, every leaf compared
    with torch.equal; the directory is deleted afterwards."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import ckpt
    from repro_torch.tree import flatten, tree_map

    part = lambda tree: tree_map(lambda a: a[:CKPT_NODES], tree)
    p2, s2 = part(params), part(opt_state)
    nbytes = sum(t.numel() * t.element_size() for t in flatten({"p": p2, "s": s2}).values())
    parent = os.path.join(ROOT, "build")
    os.makedirs(parent, exist_ok=True)
    free = shutil.disk_usage(parent).free
    if free < 1.2 * nbytes:
        fail(f"checkpoint of {nbytes / 1e9:.2f} GB: {parent} has {free / 1e9:.2f} GB free")
    root = tempfile.mkdtemp(prefix="ckpt-", dir=parent)
    try:
        t0 = time.perf_counter()
        d = ckpt.save_run_step(root, p2, s2, step=STEPS + FAULTED_STEPS + 1)
        t_save = time.perf_counter() - t0
        on_disk = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
        t0 = time.perf_counter()
        r_params, r_state, step = ckpt.restore_run(d, device="cuda")
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        got, want = flatten({"p": r_params, "s": r_state}), flatten({"p": p2, "s": s2})
        if got.keys() != want.keys() or step != STEPS + FAULTED_STEPS + 1:
            fail(f"checkpoint: restored step {step} / leaves {sorted(got)[:4]}...")
        for path, t in want.items():
            g = got[path]
            if g.device.type != "cuda" or g.dtype != t.dtype or not torch.equal(g, t):
                fail(f"checkpoint: {path} does not come back bit-equal on the card")
        log(f"main: checkpoint of the first {CKPT_NODES} nodes' params and velocities "
            f"({len(want)} leaves, {nbytes / 1e9:.2f} GB; {on_disk / 1e9:.2f} GB on disk, "
            f"{free / 1e9:.0f} GB free before): save_run_step {t_save:.2f} s "
            f"({nbytes / 1e9 / t_save:.2f} GB/s), restore_run to the card {t_restore:.2f} s "
            f"({nbytes / 1e9 / t_restore:.2f} GB/s); every leaf bit-equal (torch.equal)")
        del r_params, r_state, got
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


def phase_check(torch, plan):
    """Small-input reference: the card against the CPU; then the CLI."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.dist import decen_train as dt
    from repro_torch.kernels.gossip_axpy import gossip_axpy
    from repro_torch.launch import train
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd
    from repro_torch.tree import flatten, tree_map

    cfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), compute_dtype="float32")
    model = Model(cfg)
    opt = sgd(0.05, momentum=0.9)
    sched = plan.schedule(2, seed=0)
    data = DecentralizedBatches(cfg, NODES, 2, 32, seed=0, device="cpu")
    batches = [next(data) for _ in range(2)]
    results = {}
    for dev in ("cpu", "cuda"):
        params = dt.init_stacked_params(model, NODES, seed=0, device="cpu")
        params = tree_map(lambda a: a.to(dev), params)
        opt_state = dt.init_stacked_opt_state(opt, model, NODES, device=dev)
        step = dt.make_train_step(model, opt, plan, gossip_mode="masked")
        for k in range(2):
            batch = {key: v.to(dev) for key, v in batches[k].items()}
            bits = torch.as_tensor(sched.activations[k].astype("float32"), device=dev)
            params, opt_state, losses, _ = step(params, opt_state, batch, bits)
        results[dev] = (flatten(params), losses.cpu())
    worst = 0.0
    for path, want in results["cpu"][0].items():
        got = results["cuda"][0][path].cpu()
        worst = max(worst, float((got - want).norm() / want.norm()))
    loss_err = float(((results["cuda"][1] - results["cpu"][1]).abs()
                      / results["cpu"][1].abs()).max())
    log(f"check: tiny fp32, 2 masked steps, card vs CPU: params max rel err "
        f"{worst:.2e}, losses max rel err {loss_err:.2e} (tolerance {SMALL_TOL:g})")
    if not (worst <= SMALL_TOL and loss_err <= SMALL_TOL):
        fail("the card disagrees with the CPU on the small input")

    gossip_axpy.launches = 0
    rows = train.main(["--preset", "tiny", "--steps", "3"])
    launches = gossip_axpy.launches
    log(f"check: launch.train --preset tiny --steps 3 on the card: gossip_axpy "
        f"launches {launches}, step-0 loss {rows[0]['loss']:.4f}")
    if launches != 3 * 12:
        fail(f"launch.train run: {launches} gossip_axpy launches, expected 36")
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["consensus"]) for r in rows):
        fail("launch.train run: non-finite loss or consensus")
    if abs(rows[0]["loss"] - 6.26) > 0.1:
        fail(f"launch.train run: step-0 loss {rows[0]['loss']} is not near 6.26")
    check_crash_resume(torch)


def check_crash_resume(torch):
    """The training CLI on the card with link drops: an uninterrupted run,
    a run that checkpoints every 3 steps and crashes after step 4, and its
    --resume auto, which must end where the uninterrupted run ends."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import ckpt
    from repro_torch.faults import SimulatedCrash
    from repro_torch.kernels.gossip_axpy import gossip_axpy
    from repro_torch.launch import train

    base = ["--preset", "tiny", "--steps", "8", "--p-drop", str(P_DROP)]
    parent = os.path.join(ROOT, "build")
    os.makedirs(parent, exist_ok=True)
    root = tempfile.mkdtemp(prefix="cli-ckpt-", dir=parent)
    try:
        ck = ["--ckpt-dir", root, "--ckpt-every", "3"]
        gossip_axpy.launches = 0
        whole = train.main(base)
        launches = [gossip_axpy.launches]
        gossip_axpy.launches = 0
        try:
            train.main(base + ck + ["--crash-at-step", "4"])
            fail("launch.train --crash-at-step 4 did not crash")
        except SimulatedCrash as crash:
            if crash.step != 4:
                fail(f"launch.train crashed after step {crash.step}, not 4")
        launches.append(gossip_axpy.launches)
        resumable = ckpt.find_resumable(root)
        if resumable is None or not resumable.endswith("step_00000003"):
            fail(f"after the crash, find_resumable gives {resumable}, not step_00000003")
        gossip_axpy.launches = 0
        resumed = train.main(base + ck + ["--resume", "auto"])
        launches.append(gossip_axpy.launches)
        final = ckpt.find_resumable(root)
        if final is None or not final.endswith("step_00000008"):
            fail(f"after the resumed run, find_resumable gives {final}, not step_00000008")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    a, b = whole[-1], resumed[-1]
    gaps = {key: abs(b[key] - a[key]) for key in ("loss", "consensus")}
    log(f"check: launch.train --preset tiny --steps 8 --p-drop {P_DROP} on the card: "
        f"uninterrupted, crashed after step 4 (checkpoint every 3), then --resume auto "
        f"from step_00000003: gossip_axpy launches {launches}; final step {b['step']} loss "
        f"{b['loss']:.7f} vs {a['loss']:.7f} (gap {gaps['loss']:.3g}), consensus "
        f"{b['consensus']:.7e} vs {a['consensus']:.7e} (gap {gaps['consensus']:.3g}); "
        f"tolerance rtol 1e-5, atol 1e-7")
    if launches != [8 * 12, 5 * 12, 5 * 12]:
        fail(f"crash and resume runs: gossip_axpy launches {launches}, expected [96, 60, 60]")
    if b["step"] != a["step"] or any(gaps[key] > 1e-7 + 1e-5 * abs(a[key]) for key in gaps):
        fail("the resumed run does not end where the uninterrupted run ends")


def main() -> None:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail("src/repro_torch not found: run chip_smoke.py from a checkout of the repo")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs the GPU")
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs.registry import get_config
    from repro_torch.core import named_graph, plan_matcha
    from repro_torch.models.transformer import Model
    from repro_torch.tree import flatten

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip()
    if smi.returncode != 0 or not card:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t_start = time.perf_counter()

    ptxas = phase_build()

    cfg = dataclasses.replace(get_config("internlm2_1_8b"), num_layers=2)
    plan = plan_matcha(named_graph("paper8", NODES, seed=3), 0.5, seed=0)
    leaf_shapes = {
        path: (NODES,) + shape
        for path, (shape, _) in flatten(Model(cfg).param_shapes()).items()
    }
    row = phase_kernels(torch, leaf_shapes, float(plan.alpha))
    fa_row = phase_flash(torch, ptxas)
    ss_row = phase_ssm(torch, ptxas)
    gm_row = phase_gmm(torch, ptxas)
    launches = phase_main(torch, cfg, plan)
    torch.cuda.empty_cache()
    serve_launches = phase_serve(torch)
    phase_profile(torch)
    phase_check(torch, plan)
    phase_serve_check(torch)
    phase_tests()
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")

    kernels = [
        dict(name="gossip_axpy", route="cuda",
             source="src/repro_torch/csrc/gossip_axpy.cu",
             replaces="src/repro/kernels/gossip_axpy.py:80", launches=launches,
             max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
             bound_ms=row["bound_ms"], bound_by="bytes", library_ms=row["library_ms"]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:202",
             launches=serve_launches["flash_attention"], **fa_row),
        dict(name="ssm_scan", route="cuda",
             source="src/repro_torch/csrc/ssm_scan.cu",
             replaces="src/repro/kernels/ssm_scan.py:154",
             launches=serve_launches["ssm_scan"], **ss_row),
        dict(name="grouped_matmul", route="cuda",
             source="src/repro_torch/csrc/grouped_matmul.cu",
             replaces="src/repro/kernels/grouped_matmul.py:134",
             launches=serve_launches["grouped_matmul"], **gm_row),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
