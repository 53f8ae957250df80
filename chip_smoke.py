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
           the card: odd sizes, misaligned views, in place, and the main
           path's shapes; times of the kernel, the plain version and the
           one-call PyTorch yardstick beside the memory bound;
3. main    the decentralized trainer at full published width:
           internlm2-1.8b (d 2048, 16 heads, 8 kv heads, head_dim 128,
           d_ff 8192, vocab 92544), depth cut 24 -> 2 layers, 8 nodes on
           paper8, MATCHA budget 0.5, masked gossip, SGD lr 0.05 momentum
           0.9, 4 x 128 tokens per node, 5 steps; launch counts, per-step
           and per-phase times, peak memory, loss and consensus; then one
           more step whose gossip runs through the kernel and through
           the plain version from the same state, which must agree;
4. check   a small input (the tiny preset, fp32) stepped on the card and
           on the CPU from the same weights and batches must agree, and
           the training CLI ``repro_torch.launch.train`` must train on the card.

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
NODES, BATCH, SEQ, STEPS = 8, 4, 128, 5
SMALL_TOL = 1e-4                # card vs CPU, fp32 tiny preset, 2 steps


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


def phase_build():
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
    k_ms = cuda_ms(torch, lambda: gossip_axpy(x, y, alpha), 10)
    l_ms = cuda_ms(torch, lambda: torch.lerp(x, y, alpha), 10)
    p_ms = cuda_ms(torch, lambda: gossip_axpy_ref(x, y, alpha), 5)
    log(f"kernels: gossip_axpy largest leaf {big} fp32: kernel {k_ms:.3f} ms, "
        f"torch.lerp {l_ms:.3f} ms, plain {p_ms:.3f} ms, bound {leaf_bound:.3f} ms "
        f"({leaf_bound / k_ms:.1%} of the HBM roofline)")
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
    k_ms = cuda_ms(torch, all_leaves(lambda a, b: gossip_axpy(a, b, alpha)), 10)
    l_ms = cuda_ms(torch, all_leaves(lambda a, b: torch.lerp(a, b, alpha)), 10)
    p_ms = cuda_ms(torch, all_leaves(lambda a, b: gossip_axpy_ref(a, b, alpha)), 5)
    log(f"kernels: gossip_axpy one step ({len(xs)} leaves, {elems} elements, "
        f"{12 * elems / 1e9:.1f} GB): kernel {k_ms:.3f} ms, torch.lerp {l_ms:.3f} ms, "
        f"plain {p_ms:.3f} ms, bound {step_bound:.3f} ms "
        f"({step_bound / k_ms:.1%} of the HBM roofline)")
    del xs, ys
    torch.cuda.empty_cache()
    return dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms,
                bound_ms=step_bound, library_ms=l_ms)


def phase_main(torch, cfg, plan):
    """The full-width decentralized trainer; returns the kernel launches."""
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.dist import decen_train as dt
    from repro_torch.dist.gossip import mix_matchings_masked
    from repro_torch.kernels.gossip_axpy import gossip_axpy
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd
    from repro_torch.tree import flatten

    model = Model(cfg)
    log(f"main: {cfg.name} d_model {cfg.d_model} heads {cfg.num_heads} kv_heads "
        f"{cfg.num_kv_heads} head_dim {cfg.head_dim} d_ff {cfg.d_ff} vocab "
        f"{cfg.vocab_size}; reduced: num_layers 24 -> {cfg.num_layers} "
        f"(dataclasses.replace); {model.num_params()} params per replica")
    schedule = plan.schedule(STEPS + 1, seed=0)
    t0 = time.perf_counter()
    params = dt.init_stacked_params(model, NODES, seed=0, device="cuda")
    opt = sgd(0.05, momentum=0.9)
    opt_state = dt.init_stacked_opt_state(opt, model, NODES, device="cuda")
    data = DecentralizedBatches(cfg, NODES, BATCH, SEQ, seed=0, device="cuda")
    batches = [next(data) for _ in range(STEPS + 1)]
    torch.cuda.synchronize()
    log(f"main: set-up (init {NODES} replicas + optimizer state, draw "
        f"{STEPS + 1} batches of {NODES}x{BATCH}x{SEQ} tokens) "
        f"{time.perf_counter() - t0:.1f} s")

    step = dt.make_train_step(model, opt, plan, gossip_mode="masked")
    n_leaves = len(flatten(params))
    torch.cuda.reset_peak_memory_stats()
    gossip_axpy.launches = 0
    step_ms, phase_ms = [], []
    for k in range(STEPS):
        bits = torch.as_tensor(schedule.activations[k].astype("float32"), device="cuda")
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
        log(f"main: step {k} {step_ms[-1]:.1f} ms (fwd_bwd {phases['fwd_bwd']:.1f}, "
            f"optimizer {phases['optimizer']:.1f}, gossip {phases['gossip']:.1f} ms) "
            f"gossip_axpy launches {launched} loss {loss:.4f} consensus {cons:.4e} "
            f"active {len(schedule.active_indices(k))}/{plan.num_matchings}")
        if launched != n_leaves:
            fail(f"step {k}: {launched} gossip_axpy launches, expected {n_leaves}")
        if not (math.isfinite(loss) and math.isfinite(cons)):
            fail(f"step {k}: loss {loss} / consensus {cons} not finite")
    launches = gossip_axpy.launches
    peak = torch.cuda.max_memory_allocated()
    # step 0 pays the first-call set-up of the GEMM libraries
    steady = sorted(range(1, STEPS), key=lambda k: step_ms[k])
    mid = steady[len(steady) // 2]
    log(f"main: median step over steps 1..{STEPS - 1}: {step_ms[mid]:.1f} ms "
        + ", ".join(f"{name} {ms:.1f}" for name, ms in phase_ms[mid].items())
        + f" ms; step 0 {step_ms[0]:.1f} ms")
    log(f"main: gossip_axpy launches {launches} over {STEPS} steps; peak memory "
        f"allocated {peak / 1e9:.2f} GB")
    if launches != n_leaves * STEPS:
        fail(f"{launches} launches on the main path, expected {n_leaves * STEPS}")

    # one more step: local SGD, then its gossip from the same state twice
    local = dt.make_train_step(model, opt, plan, gossip_mode="none")
    bits = torch.as_tensor(schedule.activations[STEPS].astype("float32"), device="cuda")
    params, opt_state, _, _ = local(params, opt_state, batches[STEPS], bits)
    for path, leaf in flatten(params).items():
        got = mix_matchings_masked({path: leaf}, plan.alpha, plan.permutations,
                                   bits, impl="cuda")[path]
        want = mix_matchings_masked({path: leaf}, plan.alpha, plan.permutations,
                                    bits, impl="torch")[path]
        if not torch.equal(got, want):
            fail(f"extra step: {path} differs between kernel and plain gossip")
        del got, want
    log("main: extra step: gossip through the kernel and through the plain "
        "version from the same state agree bit for bit on every leaf")
    return launches


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

    phase_build()

    cfg = dataclasses.replace(get_config("internlm2_1_8b"), num_layers=2)
    plan = plan_matcha(named_graph("paper8", NODES, seed=3), 0.5, seed=0)
    leaf_shapes = {
        path: (NODES,) + shape
        for path, (shape, _) in flatten(Model(cfg).param_shapes()).items()
    }
    row = phase_kernels(torch, leaf_shapes, float(plan.alpha))
    launches = phase_main(torch, cfg, plan)
    torch.cuda.empty_cache()
    phase_check(torch, plan)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")

    kernels = [dict(
        name="gossip_axpy",
        route="cuda",
        source="src/repro_torch/csrc/gossip_axpy.cu",
        replaces="src/repro/kernels/gossip_axpy.py:80",
        launches=launches,
        max_abs_err=row["max_abs_err"],
        ms=row["ms"],
        plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"],
        bound_by="bytes",
        library_ms=row["library_ms"],
    )]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
