#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports the port (``src/repro_torch``) and nothing of JAX or of the
JAX package. Phases, in order; each passes or ends the run with a
non-zero exit:

1. build   every CUDA source under ``src/repro_torch/csrc`` (one nvcc per
           source, in parallel) and print the build time and ptxas report;
           it fails if ptxas serializes a kernel's wgmma calls or a flash
           wgmma instantiation spills registers;
2. kernels each hand-written kernel against its plain PyTorch version on
           the card, at the shapes its main path gives it and on edge
           cases; times of the kernel, the plain version and the
           one-call PyTorch yardstick (where there is one) beside the
           bound: gossip_axpy (odd sizes, misaligned views, in place; at
           the training step's leaves in turns with torch.lerp),
           flash_attention (odd and unequal lengths, kv_len, windows,
           GQA groups 1 and 2, fully masked rows, fp32 and bf16; the
           registry's other head widths at B 2, S 2048, causal, bf16 on
           the wgmma kernel and fp32 on the scalar one, in turns with
           sdpa: nemotron-4-340b 96/8 heads of 192, kimi-k2 64/8 of 112,
           gemma3-4b 8/4 of 256, also with a 1024 window),
           and at the new families' serving shapes, bf16, in turns with
           sdpa: whisper-base's encoder (B 8, 1500 x 1500, 8/8 heads of
           64, non-causal) and cross-attention (B 8, 384 queries over 1500
           keys), gemma3-4b's prefill (B 8, S 2048, 8/4 heads of 256,
           causal and with the 1024 window),
           ssm_scan (chunk halving, fp32 and bf16, decays that underflow,
           the path each case takes; at mamba2-370m's serving shapes the
           tensor-core kernel in turns with the scalar kernel, which takes
           a 2-byte-offset copy of x; at jamba's 128 heads beside its
           bound)
           and grouped_matmul (the sweep of tests/test_kernels.py, empty
           groups, ragged tails, rows past the groups, in fp32 and bf16;
           dbrx-132b's prefill shapes, 65,536 sorted rows x 6144 x 10752
           and the transposed w2 shape, and its decode shape of 32 rows,
           with group sizes from a router pass), with torch._grouped_mm
           as the one-call yardstick; its backward kernels
           grouped_matmul_dx and grouped_matmul_dw against their plain
           versions at dbrx's prefill shapes and at one node's training
           shape (4 x 128 tokens, top-4: 2,048 rows), in turns with
           torch._grouped_mm (dx: dy times w transposed; dw: the 2-D x 2-D
           form over x transposed and dy);
3. main    the decentralized trainer at full published width:
           internlm2-1.8b (d 2048, 16 heads, 8 kv heads, head_dim 128,
           d_ff 8192, vocab 92544), depth cut 24 -> 2 layers, 8 nodes on
           paper8, MATCHA budget 0.5; masked gossip, SGD lr 0.05 momentum
           0.9, 4 x 128 tokens per node, 5 steps, then 2 faulted steps
           (link drops at p_drop 0.35, per-node bits); launch counts,
           each step's spans (unfenced, read after the step: the step,
           fwd_bwd with forward and backward, optimizer, the gossip with
           its target build and apply), dropped exchanges, peak memory,
           loss and consensus; then one more step whose gossip runs
           through the kernel and through the plain version from the same
           state, with the schedule row and with faulted bits, which must
           agree bit for bit, as must all-ones gates and the unfaulted
           gossip; then the first two nodes' params and velocities (8.1
           GB) through save_run_step and restore_run to the card, bit for
           bit, with the save and restore rates; then from that state 5
           overlap steps (the exchange on a side CUDA stream), 2 faulted
           overlap steps and the flush: step times against the masked
           median, overlap_ratio, the gossip_launch span, the launch
           alone, peak memory, the GossipState bytes, 12 gossip_axpy
           launches a step and 12 for the flush, and the pending
           correction through the kernel and the plain version from the
           same state, bit for bit;
4. serve   the serving path (``repro_torch.launch.serve``) at full
           published width: internlm2-1.8b (24 layers), mamba2-370m (48
           layers, d 1024, 32 SSM heads of 64, state 128, vocab 50280),
           dbrx-132b (d 6144, 48 heads, 8 kv heads, head_dim 128, 16
           experts, top-4, expert d_ff 10752, vocab 100352; depth cut
           40 -> 3 layers to fit one card), gemma3-4b (34 layers: 5 x (5
           local + 1 global) + 4 local, d 2560, 8/4 heads of 256, window
           1024, vocab 262144), jamba-v0.1-52b (d 4096, 32/8 heads of 128,
           16 experts top-2 of d_ff 14336, Mamba state 128, vocab 65536,
           bf16 params; depth cut 32 -> 16 layers, two periods),
           whisper-base (6 + 6 layers, d 512, 1500 zero encoder frames;
           prompt 384, within max_position 448) and internvl2-1b (24
           layers, d 896, 14/2 heads of 64, vocab 151655), batch 8,
           prompt 2048, 32 generated tokens, random weights from seed 0;
           prefill and decode times, peak memory, and all four kernels'
           launches, counted from 0 for each model (gossip_axpy none):
           internlm2 24 flash_attention per prefill, mamba2 48 ssm_scan
           per prefill, none in decode; dbrx 3 flash_attention and 9
           grouped_matmul per prefill and 9 grouped_matmul per decode
           step; gemma3 34 flash_attention per prefill; jamba 2
           flash_attention, 14 ssm_scan and 24 grouped_matmul per prefill
           and 24 grouped_matmul per decode step; whisper 18
           flash_attention per prefill (6 encoder, 6 causal self, 6
           cross); internvl2 24 flash_attention per prefill; then a
           profile of one prefill and four decode steps of each model:
           device busy share, kernel launches per step, the costliest
           kernels and each hand-written kernel's share of the busy time;
5. moe     MoE training and long attention on the card: one replica of
           dbrx-132b at published width, depth 40 -> 1 (4.49 G fp32 params),
           one node's batch of 4 x 128 tokens, the loss and every gradient
           through the grouped-matmul kernels and their backward, then
           through the plain versions, compared leaf by leaf (the first
           set of gradients waits on the host); dbrx's MoE block alone at
           B 8 x 2048 (65,536 pairs, bf16 expert leaves), timed fwd+bwd
           with the grouped kernels' share of its device time; the
           masked TrainStep with 16 experts (tiny dbrx, the ragged branch),
           3 steps on 8 nodes, card against CPU at fp32 (scalar kernels)
           and bf16 (wgmma kernels); internlm2-1.8b at published width, 1
           layer, B 1 x S 8192, loss and gradients through sdpa_chunked
           against the unchunked sdpa, fp32 and bf16; exact grouped-matmul
           launch counts per MoE layer and node (3 forward, 3 more under
           remat, 3 dx, 3 dw);
6. check   small inputs (the tiny presets, fp32) run on the card and on
           the CPU from the same weights must agree: two masked training
           steps, and for internlm2, mamba2 and dbrx with 16 experts and
           top-4 (the ragged MoE branch) a prefill, one decode step and
           every cache; the same for gemma3 and jamba at 4 layers (one
           periodic segment; jamba also with 16 experts, the ragged
           branch), whisper with the encoder output in the prefill and the
           decode step, and internvl2 with a vision prefix, and for these
           four one training step's loss and gradients; three overlap
           steps and the flush; then the training CLI
           ``repro_torch.launch.train`` must train on the card (also
           gemma3, jamba, whisper and internvl2 at the tiny preset), and with link drops (--p-drop 0.35),
           and with --gossip-mode overlap, a
           run that checkpoints every 3 steps and crashes after step 4
           must, resumed with --resume auto, end where an uninterrupted
           run ends (overlap: bit for bit); --trace on the training CLI
           (masked and overlap) and the serving CLI must write files the
           port's readers load;
7. tests   the card-only tests (``pytest -m cuda
           tests/test_torch_kernels_cuda.py``) in a child process;
8. dryrun  the dry run (``repro_torch.launch.dryrun``: each configuration
           above traced on meta tensors) against the card, configuration
           by configuration: the masked and the overlap training step
           (internlm2-1.8b, 2 layers, 8 nodes, 4 x 128 tokens), each served
           model's prefill and one decode step (B 8 x 2048; whisper 384),
           the dbrx replica, the dbrx MoE block at 8 x 2048 and
           sdpa_chunked at S 8192 (fp32 and bf16): resident bytes against
           memory_allocated before the first step (within the allocator's
           512-byte rounding of each storage), the peak against
           max_memory_allocated, reset per configuration (within 10%), and
           every kernel's launches against its counter (exact);
9. sweep   every registry kernel case (``analysis.kernel_cases``: flash at
           256 and a ragged 197 positions and windowed, SSD at two chunks,
           the grouped matmul and its dx and dw at 512 and a ragged 549
           rows, the two gossip cases; tiny and full widths of all ten
           models), each operand a prefix of a longer buffer: the path
           taken, ``analysis.kernel_lint`` over the launch configuration
           the library reports and the wrapper's ``KERNEL_CONTRACT``, the
           tiles of the library's probe (the kernel's own block -> tile
           functions on the launch's grid) in bounds but along masked
           axes, disjoint and covering the output, three guarded launches
           (clean, inputs' tails and the rows past the groups poisoned
           with the dtype's largest value, then with NaN) that leave the
           canaries around the output and no sentinel in it, give the
           clean bits under finite poison and no NaN the plain version
           has not, the case through ``kernels.ops`` with
           ``impl="auto"`` launching its kernel once by the wrapper's
           counter, and the kernel against its plain version at the
           phase-2 tolerances (gossip bit for bit); then three planted
           faults each check must flag (a probe box shifted by one tile:
           an overlap and an uncovered tile; a flash launch on k / v
           views shifted into the poisoned tail; ``ops.attention``
           patched to its plain path: ``kernel-launch-missing``), and the
           seconds the contract, tile and poison checks added;
           then ``python -m repro_torch.analysis.check --shard 2
           --all-layouts --faults --strict``: the one-process steps, the
           replicated and FSDP mesh lanes (every rank's view on meta, the
           collective inventory held to the plan, the modules' contracts,
           the byte model and the committed artifact), the schedule gates
           and the arch's kernel cases linted on the card;
10. examples the four examples (``repro_torch.examples``) on the card at a
           few steps each;
11. fsdp   the sharded-replica trainer (``repro_torch.dist.fsdp``) in an
           NCCL world of one (a file store in a temporary directory),
           internlm2-1.8b at published width with depth cut 24 -> 8 (one
           scanned segment), 4 nodes on ``ring``, MATCHA budget 0.5, 4 x
           128 tokens a node, fp32 params, bf16 compute, SGD lr 0.05
           momentum 0.9: 3 masked steps in the monolithic, streamed
           (``scan_aware=False``) and scan-streamed layouts at S 1, then 3
           overlap steps and the flush scan-streamed, each against the
           replicated ``TrainStep`` / ``OverlapStep`` from the same weights
           (monolithic bit for bit; the streamed layouts and overlap within
           loss 5e-6 / 1e-6 and params 2e-6); per layout the median step,
           its phase split, the peak above resident beside the byte
           model's gathered view, and gossip_axpy launches equal to
           ``analysis.launch_counts.fsdp_train_step``; one
           ``measure_fsdp_collectives`` row. With two cards or more the S 2
           and R_data 2 worlds run over NCCL against the world of one;
           with one card a line says they were not run;
12. tp     tensor parallel over a model axis of 2 (``repro_torch.models.tp``,
           the JAX rules of ``repro_torch.dist.sharding``): with one card a
           world of two ranks shares it over gloo (whose all-reduce takes
           CUDA tensors), with two cards or more it runs over NCCL, and
           with four also a (data 2, model 2) world. Training: internlm2-1.8b
           at published width, depth 24 -> 2, 8 nodes on paper8, MATCHA
           budget 0.5, 4 x 128 tokens a node, fp32 params, bf16 compute,
           SGD lr 0.05 momentum 0.9: 3 masked steps against the world of
           one's TrainStep from the same weights (each rank runs that
           reference in turn and keeps its slices; loss within max abs
           3e-3 and each leaf's difference within 5e-2 of the world of
           one's change from the initial weights: T changes the order of
           the row-parallel sums), the same steps with a planted fault
           (attention without ``to_model``) that must exceed that limit,
           gossip_axpy launches a step equal to the world of one's, then 2
           overlap steps and the flush; each rank's resident and peak
           memory, step times and the time in its collectives.
           Serving at T 2, bf16, batch 8, prompt 2048, 8
           generated tokens, seed 0: internlm2-1.8b (24 layers), mamba2-370m
           (48 layers) and dbrx-132b at 3 layers (expert parallel: 8 of 16
           experts a rank) against the world of one, which rank 0 serves
           first, each decode step fed the world of one's token: every
           step whose last position each MoE router sends to the world of
           one's experts has its last logits within max abs 0.25 and its
           token equal where the top-2 margin is over 0.5 (steps that
           rounding re-routes are counted and their logits difference
           logged; at most a quarter may be); each kernel's launches
           equal to the world of one's and phase 4's counts, the shapes
           each kernel received, prefill and decode times and their
           all-reduce time; then data 2 x model 1
           on the same ranks, each serving 4 of the 8 internlm2 requests,
           against the world of one's rows.

13. sp     sequence parallel and kv-seq-sharded serving at T 2, in a world
           of two ranks (gloo sharing one card, whose all-gather,
           reduce-scatter and send/recv of CUDA tensors
           ``repro_torch.dist.comm`` moves through host copies; NCCL with a
           card a rank): internlm2-1.8b at published width, depth 2, 8
           nodes on paper8, 3 masked steps under
           ``train_rules(sequence_parallel=True)`` against the world of
           one by phase 12's limits, and the same steps with a planted
           fault (the row-parallel outputs skip their reduce-scatter) that
           must exceed the params limit; internlm2-1.8b served at batch 8,
           prompt 512, 8 tokens with the KV caches split over their
           positions (``serve_rules(kv_seq_sharded=True)``), each decode
           step fed the world of one's token, the last logits within 0.25,
           and the same with a planted fault (flash-decoding's combine
           without its outputs' all-reduce) that must exceed that limit,
           each rank's flash launches equal to the dry run's for that rank
           (``dryrun.mesh_serve_call``); the collectives recorded from the
           first training step and from a prefill and a decode step equal,
           op for op, the one-process meta inventory of the same rank
           (``analysis.collectives``); the time and bytes in each kind of
           collective.
           With two cards or more, the (pod 2, data 1) gossip over NCCL
           against one process.

Then it prints the card's name and power limit, one JSON line with every
ported kernel's numbers, and, last, the device JSON line.
"""
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet, at the 700 W limit
BF16_FLOP_PER_S = 989e12        # dense bf16 tensor cores, same source
FP32_FLOP_PER_S = 67e12         # fp32 on the CUDA cores, same source
NODES, BATCH, SEQ, STEPS = 8, 4, 128, 5
FAULTED_STEPS, P_DROP = 2, 0.35  # faulted steps after the masked ones, drop rate
CKPT_NODES = 2                  # nodes whose full-width state is checkpointed
OVERLAP_STEPS, OVERLAP_FAULTED = 5, 2  # overlap steps at full width, then faulted ones
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
# dbrx-132b depth of the one-replica training check: 1 layer is 4.49 G
# params, 17.97 GB in fp32 and as much again in gradients
MOE_TRAIN_LAYERS = 1
# the one replica through the kernels against the plain versions, bf16
# compute: both round each expert product to bf16 from fp32 sums taken in
# another order, one bf16 step apart, and the backward carries those steps
# on (the bf16 tolerances of tests/test_torch_model.py)
MOE_REPLICA_TOL = {"loss": 1e-3, "grad": 1e-1}
# the 16-expert TrainStep, card against CPU after 3 steps: fp32 as
# SMALL_TOL; bf16 rounds the card's and the CPU's products at other places
MOE_STEP_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# sdpa_chunked against the unchunked sdpa: the same row computations, the
# score products possibly tiled otherwise by cuBLAS (fp32 sums in another
# order); at bf16 a flipped rounding of the attention output travels on
CHUNKED_TOL = {"float32": {"loss": 1e-5, "grad": 1e-4},
               "bfloat16": {"loss": 1e-3, "grad": 1e-1}}
JAMBA_LAYERS = 16               # jamba-v0.1-52b depth on one card (32 published)
WHISPER_PROMPT = 384            # whisper prompt: prompt + generated within max_position 448
FAMILY_ARCHS = ("gemma3_4b", "jamba_v0_1_52b", "whisper_base", "internvl2_1b")
# the registry's other head widths, bf16 on the wgmma flash kernel and
# fp32 on the scalar one: (model, query heads, kv heads, head_dim, window)
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


def kernel_label(mangled: str) -> str:
    """``flash_wgmma_kernel<256, 2>`` for a mangled entry function name."""
    import re

    base, i = None, 0
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
    return (base or mangled) + (f"<{', '.join(args)}>" if args else "")


def wgmma_serialized(text: str):
    """The kernels whose wgmma calls ptxas serializes (its C7520 note: a
    branch it cannot prove uniform over the warpgroup), from one source's
    ``nvcc -Xptxas -v`` output."""
    import re

    return [kernel_label(m.group(1)) for m in
            re.finditer(r"C7520\).*wgmma.*in the function '(\S+)'", text)]


def ptxas_report(text: str):
    """(kernel, registers, spill store bytes, spill load bytes) for each
    entry function in one source's ``nvcc -Xptxas -v`` output."""
    import re

    rows, label, spills = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            label = kernel_label(m.group(1))
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
    report, serialized = {}, []
    for name, text in logs.items():
        for kernel, regs, st, ld in ptxas_report(text):
            report[kernel] = (regs, st, ld)
            log(f"build: ptxas {kernel}: {regs} registers, {st} bytes spill stores, "
                f"{ld} bytes spill loads")
        serialized += wgmma_serialized(text)
    # the tensor-core kernels' products must stay asynchronous, and the
    # flash wgmma kernels' accumulators in registers
    if serialized:
        fail(f"ptxas serializes the wgmma calls of {serialized}")
    spilled = [k for k, (_, st, ld) in report.items()
               if k.startswith("flash_wgmma") and (st or ld)]
    if spilled:
        fail(f"flash wgmma instantiations spill registers: {spilled}")
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
    from repro_torch.kernels.gossip_axpy import cost, gossip_axpy
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
    leaf_bound = cost(n, f32, f32)[1] / HBM_BYTES_PER_S * 1e3
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

    step_bytes = cost(elems, f32, f32)[1]
    step_bound = step_bytes / HBM_BYTES_PER_S * 1e3
    (k1, k2), (l1, l2) = in_turns(torch, all_leaves(lambda a, b: gossip_axpy(a, b, alpha)),
                                  all_leaves(lambda a, b: torch.lerp(a, b, alpha)), 10)
    k_ms, l_ms = (k1 + k2) / 2, (l1 + l2) / 2
    p_ms = cuda_ms(torch, all_leaves(lambda a, b: gossip_axpy_ref(a, b, alpha)), 5)
    log(f"kernels: gossip_axpy one step ({len(xs)} leaves, {elems} elements, "
        f"{step_bytes / 1e9:.1f} GB): in turns kernel {k1:.3f} ms, torch.lerp "
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


def phase_flash(torch, ptxas):
    """flash_attention against attention_ref; returns the JSON row."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import cost as fa_cost
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

    # the serving path's prefills, bf16: internlm2-1.8b (the JSON row),
    # dbrx-132b, jamba-v0.1-52b, internvl2-1b (GQA 7:1), whisper-base's
    # encoder and cross-attention, and gemma3-4b (hd 256, two warpgroups
    # a block; global and local layers)
    B = SERVE_BATCH
    shapes = [
        # (model, Sq, Sk, Hq, Hkv, hd, causal, window, kernel path)
        ("internlm2-1.8b", SERVE_PROMPT, SERVE_PROMPT, 16, 8, 128, True, 0, "wgmma"),
        ("dbrx-132b", SERVE_PROMPT, SERVE_PROMPT, 48, 8, 128, True, 0, "wgmma"),
        ("jamba-v0.1-52b", SERVE_PROMPT, SERVE_PROMPT, 32, 8, 128, True, 0, "wgmma"),
        ("internvl2-1b", SERVE_PROMPT, SERVE_PROMPT, 14, 2, 64, True, 0, "wgmma"),
        ("whisper-base encoder", 1500, 1500, 8, 8, 64, False, 0, "wgmma"),
        ("whisper-base cross", WHISPER_PROMPT, 1500, 8, 8, 64, False, 0, "wgmma"),
        ("gemma3-4b global", SERVE_PROMPT, SERVE_PROMPT, 8, 4, 256, True, 0, "wgmma"),
        ("gemma3-4b local", SERVE_PROMPT, SERVE_PROMPT, 8, 4, 256, True, 1024, "wgmma"),
    ]
    row = None
    for model, Sq, Sk, Hq, Hkv, hd, causal, window, path in shapes:
        q, k, v = qkv(B, Sq, Sk, Hq, Hkv, hd, torch.bfloat16)
        run = lambda: flash_attention(q, k, v, causal=causal, window=window)
        got = run()
        want = attention_ref(q, k, v, causal=causal, window=window)
        err = close(torch, got, want, FA_TOL["bfloat16"], FA_TOL["bfloat16"])
        if not math.isfinite(err):
            fail(f"flash at {model}'s serving shapes: disagrees with attention_ref")
        max_err = max(max_err, err)
        del got, want
        torch.cuda.empty_cache()
        flops, nbytes = fa_cost(B, Sq, Sk, Hq, Hkv, hd, q.dtype, causal=causal,
                                window=window)
        bound = max(flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        bound_by = ("operations" if flops / BF16_FLOP_PER_S >= nbytes / HBM_BYTES_PER_S
                    else "bytes")
        if kernel_path(q, k) != path:
            fail(f"flash at {model}'s serving shapes does not take the {path} kernel")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if window:
            i = torch.arange(Sq, device="cuda")[:, None]
            j = torch.arange(Sk, device="cuda")[None, :]
            mask_kw = dict(attn_mask=(j <= i) & (i - j < window))
        else:
            mask_kw = dict(is_causal=causal)
        (k1, k2), (l1, l2) = in_turns(
            torch, run,
            lambda: F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **mask_kw),
            10)
        k_ms, l_ms = (k1 + k2) / 2, (l1 + l2) / 2
        p_ms = cuda_ms(torch, lambda: attention_ref(q, k, v, causal=causal, window=window), 3)
        log(f"kernels: flash_attention {model} serving shapes (B {B}, Sq {Sq}, Sk {Sk}, "
            f"heads {Hq}/{Hkv}, hd {hd}, bf16, "
            f"{'causal' if causal else 'non-causal'}{f', window {window}' if window else ''}; "
            f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB): path {path}; in turns kernel "
            f"{k1:.3f} ms, sdpa {l1:.3f} ms, sdpa {l2:.3f} ms, kernel {k2:.3f} ms "
            f"({flops / k_ms / 1e9:.0f} TFLOP/s; {k_ms / l_ms:.2f}x sdpa); plain "
            f"{p_ms:.3f} ms; bound {bound:.3f} ms by {bound_by} ({bound / k_ms:.1%} of "
            f"it; fp32 CUDA-core floor {flops / FP32_FLOP_PER_S * 1e3:.3f} ms); max "
            f"abs err {err:.3g}")
        if row is None:
            row = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=bound_by,
                       library_ms=l_ms)
        del q, k, v, qt, kt, vt, mask_kw
        torch.cuda.empty_cache()
    max_err = max(max_err, flash_wide(torch, qkv))
    log(f"kernels: flash_attention ptxas: {ptxas_note(ptxas, 'flash_')}")
    row["max_abs_err"] = max_err
    return row


def flash_wide(torch, qkv) -> float:
    """flash_attention at the registry's other head widths: B 2, S 2048,
    causal, in bf16 (the wgmma kernel) and fp32 (the scalar one), against
    attention_ref, timed in turns with sdpa; returns the max abs error."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import cost as fa_cost
    from repro_torch.kernels.flash_attention import flash_attention, kernel_path
    from repro_torch.kernels.ref import attention_ref

    B, S = 2, SERVE_PROMPT
    max_err = 0.0
    for model, Hq, Hkv, hd, window in FLASH_WIDE:
        i = torch.arange(S, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < window)
        for dname, dtype, path in (("bfloat16", torch.bfloat16, "wgmma"),
                                   ("float32", torch.float32, "scalar")):
            q, k, v = qkv(B, S, S, Hq, Hkv, hd, dtype)
            if kernel_path(q, k) != path:
                fail(f"flash at {model}'s widths ({hd}) {dname} does not take the {path} "
                     "kernel")
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
            flops, nbytes = fa_cost(B, S, S, Hq, Hkv, hd, dtype, causal=True, window=window)
            rate = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
            t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_PER_S
            bound = max(t_ops, t_bytes) * 1e3
            k_ms, l_ms = (k1 + k2) / 2, (l1 + l2) / 2
            log(f"kernels: flash_attention {model} widths (B {B}, S {S}, heads {Hq}/{Hkv}, "
                f"hd {hd}, {dname}, causal{f', window {window}' if window else ''}; "
                f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB): path {path}; "
                f"in turns kernel {k1:.3f} ms, sdpa {l1:.3f} ms, sdpa {l2:.3f} ms, kernel "
                f"{k2:.3f} ms ({k_ms / l_ms:.2f}x sdpa; {flops / k_ms / 1e9:.1f} TFLOP/s); "
                f"plain {p_ms:.3f} ms; bound {bound:.4f} ms by "
                f"{'operations' if t_ops >= t_bytes else 'bytes'} ({bound / k_ms:.1%} of it); "
                f"max abs err {err:.3g}")
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()
    return max_err


def ssd_bound(B: int, S: int, H: int, P: int, N: int, Q: int):
    """(flops, bytes, bound ms, bound_by) of one bf16 SSD chunk scan
    (``ssm_scan.cost``)."""
    import torch

    from repro_torch.kernels.ssm_scan import cost

    flops, nbytes = cost(B, S, H, P, N, Q, torch.bfloat16)
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return flops, nbytes, max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


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
    flops, nbytes, bound, bound_by = ssd_bound(B, S, H, P, N, Q)
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
    del x, x_off, dt, A, Bm, Cm
    torch.cuda.empty_cache()

    # jamba-v0.1-52b's prefill: 128 heads of 64, state 128 (the chained-state
    # pass sizes its scratch and flags per head)
    H = 128
    x, dt, A, Bm, Cm = inputs(B, S, H, P, N, torch.bfloat16)
    path = kernel_path(x, Bm, Q, Cm)
    if path != "mma":
        fail(f"ssm_scan at jamba's serving shapes takes the {path} kernel, not mma")
    max_err = max(max_err, check(f"jamba serving shapes (B {B}, S {S}, H {H}, P {P}, "
                                 f"N {N}; mma)", "bfloat16",
                                 ssm_scan(x, dt, A, Bm, Cm, chunk=Q),
                                 ssm_scan_ref(x, dt, A, Bm, Cm)))
    j_ms = cuda_ms(torch, lambda: ssm_scan(x, dt, A, Bm, Cm, chunk=Q), 5)
    j_flops, j_bytes, j_bound, j_by = ssd_bound(B, S, H, P, N, Q)
    log(f"kernels: ssm_scan jamba serving shapes ({j_flops / 1e9:.1f} GFLOP, "
        f"{j_bytes / 1e6:.1f} MB): mma {j_ms:.4f} ms; bound {j_bound:.4f} ms by {j_by} "
        f"({j_bound / j_ms:.1%} of it)")
    del x, dt, A, Bm, Cm
    torch.cuda.empty_cache()
    log(f"kernels: ssm_scan ptxas: {ptxas_note(ptxas, 'ssd_')}")
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
    from repro_torch.kernels.grouped_matmul import cost as gmm_cost
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
        G, _, N = w.shape
        flops, nbytes = gmm_cost("forward", M, K, N, G, x.dtype, rows=int(sizes.sum()),
                                 live=int((sizes > 0).sum()))
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

    # dbrx-132b's and jamba-v0.1-52b's shapes, group sizes from a router pass
    shapes = []
    for name, cfg, fp32, seed in (("dbrx", dbrx_serving_config(), ("float32",), 5),
                                  ("jamba", jamba_serving_config(), (), 7)):
        D, F = cfg.d_model, cfg.moe_d_ff
        prefill_sizes = router_group_sizes(torch, cfg, SERVE_BATCH * SERVE_PROMPT, seed)
        decode_sizes = router_group_sizes(torch, cfg, SERVE_BATCH, seed + 1)
        log(f"kernels: grouped_matmul {name} router group sizes, prefill "
            f"{prefill_sizes.tolist()}, decode {decode_sizes.tolist()}")
        P_pre = SERVE_BATCH * SERVE_PROMPT * cfg.moe_top_k
        P_dec = SERVE_BATCH * cfg.moe_top_k
        shapes += [
            # (label, M, K, N, sizes, dtypes, decode)
            (f"{name} prefill w1/w3", P_pre, D, F, prefill_sizes, ("bfloat16", *fp32), False),
            (f"{name} prefill w2", P_pre, F, D, prefill_sizes, ("bfloat16",), False),
            (f"{name} decode w1/w3", P_dec, D, F, decode_sizes, ("bfloat16", *fp32), True),
            (f"{name} decode w2", P_dec, F, D, decode_sizes, ("bfloat16",), True),
        ]
    row = None
    for label, M, K, N, gs, dnames, decode in shapes:
        E = gs.numel()
        for dname in dnames:
            dtype = dtypes[dname]
            x, w = inputs(M, K, N, E, dtype, 1.0 / math.sqrt(K))
            path = kernel_path(x, w)
            if path != ("wgmma" if dname == "bfloat16" else "scalar"):
                fail(f"grouped_matmul {label} {dname} takes the {path} kernel")
            err = check(label, dname, x, w, gs)
            max_err = max(max_err, err)
            b_ms, b_by, flops, nbytes = bound(x, w, gs, x.element_size())
            iters = 10 if decode else 3
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
    return row, gmm_backward(torch, ptxas)


def gmm_backward(torch, ptxas):
    """The dx and dw kernels against their plain versions at dbrx-132b's
    prefill shapes (65,536 sorted rows, bf16) and at one node's training
    shape (4 x 128 tokens, top-4: 2,048 rows), group sizes from router
    passes, timed in turns with torch._grouped_mm; returns {kind: JSON
    row} at the prefill w1/w3 shape."""
    from repro_torch.kernels.grouped_matmul import (
        cost,
        grouped_matmul_dw,
        grouped_matmul_dx,
        kernel_path,
    )
    from repro_torch.kernels.ref import grouped_matmul_dw_ref, grouped_matmul_dx_ref

    gen = torch.Generator(device="cuda").manual_seed(8)
    cfg = dbrx_serving_config()
    D, F, E = cfg.d_model, cfg.moe_d_ff, cfg.moe_num_experts
    prefill = router_group_sizes(torch, cfg, SERVE_BATCH * SERVE_PROMPT, 5)
    train = router_group_sizes(torch, cfg, BATCH * SEQ, 9)
    log(f"kernels: grouped_matmul backward, dbrx training router group sizes "
        f"{train.tolist()}")
    tol = GMM_TOL["bfloat16"]
    rows, max_err = {}, {"dx": 0.0, "dw": 0.0}
    for label, K, N, gs, iters in (("prefill w1/w3", D, F, prefill, 3),
                                   ("prefill w2", F, D, prefill, 3),
                                   ("training w1/w3", D, F, train, 10),
                                   ("training w2", F, D, train, 10)):
        M = int(gs.sum())
        live = int((gs > 0).sum())
        x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn(E, K, N, generator=gen, device="cuda") / math.sqrt(K)).to(
            torch.bfloat16)
        dy = torch.randn(M, N, generator=gen, device="cuda").to(torch.bfloat16)
        offs = torch.cumsum(gs, 0, dtype=torch.int32)
        for kind in ("dx", "dw"):
            flops, nbytes = cost(kind, M, K, N, E, torch.bfloat16, live=live)
            if kind == "dx":
                run = lambda: grouped_matmul_dx(dy, w, gs)
                plain = lambda: grouped_matmul_dx_ref(dy, w, gs)
                lib = lambda: torch._grouped_mm(dy, w.transpose(-2, -1), offs=offs)
                path = kernel_path(dy, w, kind="dx")
            else:
                run = lambda: grouped_matmul_dw(x, dy, gs)
                plain = lambda: grouped_matmul_dw_ref(x, dy, gs)
                lib = lambda: torch._grouped_mm(x.t(), dy, offs=offs)
                path = kernel_path(x, dy, kind="dw")
            if path != "wgmma":
                fail(f"grouped_matmul_{kind} dbrx {label} takes the {path} kernel")
            got = run()
            torch.cuda.synchronize()
            want = plain()
            if kind == "dw" and not all(bool((got[g] == 0).all())
                                        for g in range(E) if int(gs[g]) == 0):
                fail(f"grouped_matmul_dw dbrx {label}: an empty group's dw is not 0")
            err = close(torch, got, want, tol, tol)
            if not math.isfinite(err):
                fail(f"grouped_matmul_{kind} dbrx {label}: disagrees with its plain version")
            max_err[kind] = max(max_err[kind], err)
            l_ms = None
            try:
                lib_out = lib()
                torch.cuda.synchronize()
                lib_note = (f"max abs diff {float((lib_out.float() - want.float()).abs().max()):.3g}")
                del lib_out
            except (RuntimeError, TypeError) as exc:      # report, do not stop
                lib = None
                lib_note = f"torch._grouped_mm refused: {str(exc).splitlines()[0][:160]}"
            del got, want
            if lib is not None:                 # kernel, library, library, kernel
                (k1, k2), (l1, l2) = in_turns(torch, run, lib, iters, warmup=1)
                k_ms, l_ms = (k1 + k2) / 2, (l1 + l2) / 2
                times = (f"in turns kernel {k1:.3f} ms, torch._grouped_mm {l1:.3f} ms, "
                         f"torch._grouped_mm {l2:.3f} ms, kernel {k2:.3f} ms "
                         f"({k_ms / l_ms:.2f}x the library; library {lib_note})")
            else:
                k_ms = cuda_ms(torch, run, iters, warmup=1)
                times = f"kernel {k_ms:.3f} ms; {lib_note}"
            p_ms = cuda_ms(torch, plain, 1, warmup=1)
            t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
            b_ms = max(t_ops, t_bytes) * 1e3
            b_by = "operations" if t_ops >= t_bytes else "bytes"
            log(f"kernels: grouped_matmul_{kind} dbrx {label} ({M} rows, K {K}, N {N}, "
                f"{E} groups) bf16 (path {path}; {flops / 1e12:.3f} TFLOP, "
                f"{nbytes / 1e9:.3f} GB): agrees with its plain version (max abs err "
                f"{err:.3g}); {times}; {flops / k_ms / 1e9:.1f} TFLOP/s; plain {p_ms:.3f} "
                f"ms; bound {b_ms:.3f} ms by {b_by} ({b_ms / k_ms:.1%} of it)")
            if kind not in rows:                 # the first: prefill w1/w3
                rows[kind] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                  library_ms=l_ms)
            torch.cuda.empty_cache()
        del x, w, dy
        torch.cuda.empty_cache()
    for kind in rows:
        rows[kind]["max_abs_err"] = max_err[kind]
        log(f"kernels: grouped_matmul_{kind} ptxas: {ptxas_note(ptxas, f'gmm_{kind}_')}")
    return rows


def jamba_serving_config():
    from repro_torch.configs.registry import get_config

    # bf16 params, the published checkpoint's dtype: 52 GB (104 GB in fp32)
    return dataclasses.replace(get_config("jamba_v0_1_52b"), num_layers=JAMBA_LAYERS,
                               param_dtype="bfloat16")


def serving_configs():
    """(config, prompt length, expected launches per prefill, per decode
    step) of each model the serving phases drive."""
    from repro_torch.configs.registry import get_config

    dense, mamba, dbrx = (get_config("internlm2_1_8b"), get_config("mamba2_370m"),
                          dbrx_serving_config())
    moe = 3 * dbrx.num_layers                   # w1, w3, w2 in every layer
    return [
        (dense, SERVE_PROMPT, {"flash_attention": dense.num_layers}, {}),
        (mamba, SERVE_PROMPT, {"ssm_scan": mamba.num_layers}, {}),
        (dbrx, SERVE_PROMPT, {"flash_attention": dbrx.num_layers, "grouped_matmul": moe},
         {"grouped_matmul": moe}),
        # 5 x (5 local + 1 global) + 4 local layers, each on the kernel
        (get_config("gemma3_4b"), SERVE_PROMPT, {"flash_attention": 34}, {}),
        # 2 attention and 14 Mamba layers; 8 MoE layers of 16 experts, 3
        # expert products each, in the prefill and in every decode step
        (jamba_serving_config(), SERVE_PROMPT,
         {"flash_attention": 2, "ssm_scan": 14, "grouped_matmul": 24},
         {"grouped_matmul": 24}),
        # 6 encoder, 6 causal self- and 6 cross-attention layers; the decode
        # skips cross-attention, as the JAX runtime does
        (get_config("whisper_base"), WHISPER_PROMPT, {"flash_attention": 18}, {}),
        (get_config("internvl2_1b"), SERVE_PROMPT, {"flash_attention": 24}, {}),
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
    for cfg, prompt, per_prefill, per_decode in serving_configs():
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res = serve.run(cfg, batch=SERVE_BATCH, prompt_len=prompt,
                        gen=SERVE_GEN, seed=0, device="cuda")
        total = time.perf_counter() - t0
        counts = {name: fn.launches for name, fn in kernels.items()}
        for name, n in counts.items():
            launches[name] += n
        log(f"serve: {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}, "
            f"vocab {cfg.vocab_size}, {cfg.param_dtype} params) batch {SERVE_BATCH} "
            f"prompt {prompt} gen "
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


def hand_written(name: str):
    """The port's kernel (``flash_wgmma_kernel``, ``ssd_tc_kernel``, ...)
    that a profiler event of this name ran, or None for any other."""
    import re

    m = re.search(r"\b(flash|gmm|ssd|gossip_axpy)_\w*kernel\b", name)
    return m.group(0) if m else None


def profile_summary(prof, wall_ms, steps, label):
    """Prints a profiled window's device busy time against the host
    clock, launches, the costliest kernels and each hand-written kernel's
    share; returns (busy ms per step, {kernel: ms per step}), or
    (None, {}) where the profiler saw no device time."""
    from torch.autograd import DeviceType

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
        return None, {}
    busy_ms = busy_us / 1e3
    log(f"profile: {label}: host clock {wall_ms / steps:.2f} ms per step, device "
        f"busy {busy_ms / steps:.2f} ms per step ({busy_ms / wall_ms:.1%}; idle "
        f"{1 - busy_ms / wall_ms:.1%}), {launches / steps:.0f} kernel launches per "
        f"step, {len(spans) / steps:.0f} device activities per step")
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:6]
    for name, (t_us, n) in top:
        log(f"profile: {label}:   {t_us / 1e3 / steps:9.3f} ms/step x{n // steps:<5d} "
            f"{name[:90]}")
    # the hand-written kernels' share, whether or not they made the top six
    ours = {}
    for name, (t_us, n) in by_name.items():
        kernel = hand_written(name)
        if kernel:
            t, k = ours.get(kernel, (0.0, 0))
            ours[kernel] = (t + t_us, k + n)
    for name, (t_us, n) in sorted(ours.items()):
        log(f"profile: {label}: hand-written {name}: {t_us / 1e3 / steps:.3f} ms/step "
            f"x{n // steps} ({t_us / 1e3 / busy_ms:.1%} of busy)")
    return busy_ms / steps, {k: t / 1e3 / steps for k, (t, _) in ours.items()}


def phase_profile(torch):
    """Where a serving step's time goes: torch.profiler over one prefill
    and four decode steps of each full model (random prompt ids): the
    device's busy time (the sum of kernel times) against the host clock,
    kernel launches per step, and the kernels that take the most time.
    Prints "not measured" where the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.dist import serve as sv
    from repro_torch.models.transformer import Model

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    gen = torch.Generator(device="cuda").manual_seed(3)
    for cfg, prompt, _, _ in serving_configs():
        model = Model(cfg)
        params = model.init(0, device="cuda")
        max_len = prompt + 8
        tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, prompt),
                               generator=gen, device="cuda", dtype=torch.int32)
        caches = model.init_cache(SERVE_BATCH, max_len, device="cuda")
        prefill = sv.make_prefill_step(model, max_len=max_len)
        decode = sv.make_decode_step(model, max_len=max_len)
        frontend = {}
        if cfg.frontend == "audio":
            frontend["encoder_frames"] = torch.zeros(
                (SERVE_BATCH, cfg.encoder_seq, cfg.frontend_dim), dtype=torch.bfloat16,
                device="cuda")
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            logits, caches = prefill(params, tokens, caches, **frontend)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        profile_summary(prof, wall, 1, f"{cfg.name} prefill")
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        logits, caches = decode(params, tok, caches, prompt)     # warm-up
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(4):
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
                logits, caches = decode(params, tok, caches, prompt + 1 + i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        profile_summary(prof, wall, 4, f"{cfg.name} decode")
        del params, caches, logits
        torch.cuda.empty_cache()


def plain_grouped_matmul():
    """A context in which the model's expert products take the plain
    versions on the card (``ops.grouped_matmul(..., impl="torch")``)."""
    import contextlib
    import functools

    from repro_torch.kernels import ops

    @contextlib.contextmanager
    def patched():
        kernel = ops.grouped_matmul
        ops.grouped_matmul = functools.partial(kernel, impl="torch")
        try:
            yield
        finally:
            ops.grouped_matmul = kernel

    return patched()


def gmm_counters():
    from repro_torch.kernels.grouped_matmul import (
        grouped_matmul,
        grouped_matmul_dw,
        grouped_matmul_dx,
    )

    return {"grouped_matmul": grouped_matmul, "grouped_matmul_dx": grouped_matmul_dx,
            "grouped_matmul_dw": grouped_matmul_dw}


def moe_launches(cfg, passes: int = 1):
    """Grouped-matmul launches of ``passes`` model fwd/bwd passes over
    SEQ-token sequences (``analysis.launch_counts.forward_backward``: per
    MoE layer 3 forward, 3 more under remat, 3 dx and 3 dw)."""
    from repro_torch.analysis import launch_counts

    counts = launch_counts.forward_backward(cfg, seq=SEQ, passes=passes)
    return {k: counts[k] for k in gmm_counters()}


def phase_moe_train(torch, plan):
    """MoE training on the card through the grouped-matmul kernels and
    their backward, and attention at the chunked threshold; returns the
    dx and dw launches of the whole phase (counted from 0)."""
    counters = gmm_counters()
    for fn in counters.values():
        fn.launches = 0
    moe_replica(torch)
    moe_block_fwd_bwd(torch)
    moe_train_step(torch, plan)
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"moe: grouped-matmul launches over the phase {launches}")
    if not all(launches.values()):
        fail(f"moe: a grouped-matmul kernel of the training path never ran: {launches}")
    chunked_attention(torch)
    return launches


def rel_norm(torch, got, want) -> float:
    return float((got.float() - want.float()).norm() / max(float(want.float().norm()), 1e-30))


def moe_replica(torch):
    """One replica of dbrx-132b at published width, depth 40 -> 1, fp32
    params, bf16 compute, one node's trainer batch: the loss and every
    gradient through the kernels, then through the plain versions."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.models.transformer import Model
    from repro_torch.tree import flatten

    cfg = dataclasses.replace(get_config("dbrx_132b"), num_layers=MOE_TRAIN_LAYERS)
    model = Model(cfg)
    log(f"moe: {cfg.name} d_model {cfg.d_model} {cfg.moe_num_experts} experts top-"
        f"{cfg.moe_top_k} expert d_ff {cfg.moe_d_ff} vocab {cfg.vocab_size}, "
        f"{cfg.param_dtype} params, {cfg.compute_dtype} compute, remat {cfg.remat}; "
        f"reduced: num_layers 40 -> {cfg.num_layers} (dataclasses.replace); "
        f"{model.num_params()} params in one replica")
    params = model.init(0, device="cuda")
    leaves = flatten(params)
    for leaf in leaves.values():
        leaf.requires_grad_()
    batch = {k: v[0] for k, v in next(DecentralizedBatches(
        cfg, 1, BATCH, SEQ, seed=0, device="cuda")).items()}
    counters = gmm_counters()
    torch.autograd.grad(model.loss(params, batch)[0], list(leaves.values()))   # warm-up
    res = {}
    for route in ("kernels", "plain"):
        before = {name: fn.launches for name, fn in counters.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if route == "kernels":
            loss, _ = model.loss(params, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        else:
            with plain_grouped_matmul():
                loss, _ = model.loss(params, batch)
                grads = torch.autograd.grad(loss, list(leaves.values()))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = {name: fn.launches - before[name] for name, fn in counters.items()}
        want = moe_launches(cfg) if route == "kernels" else dict.fromkeys(counters, 0)
        log(f"moe: {cfg.name} one replica, {BATCH} x {SEQ} tokens, loss and "
            f"{len(grads)} gradients through the {route}: loss "
            f"{float(loss.detach()):.6f}, {ms:.1f} ms (host clock, after a warm-up of the "
            f"kernels' pass), peak memory "
            f"allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches "
            f"{launched}")
        if launched != want:
            fail(f"{cfg.name} replica through the {route}: launches {launched}, expected "
                 f"{want}")
        if not (math.isfinite(float(loss.detach()))
                and all(bool(torch.isfinite(g).all()) for g in grads)):
            fail(f"{cfg.name} replica through the {route}: non-finite loss or gradients")
        if route == "kernels":           # to the host: both sets do not fit beside
            res[route] = (float(loss.detach()), [g.cpu() for g in grads])
        else:
            res[route] = (float(loss.detach()), list(grads))
        del loss, grads
        torch.cuda.empty_cache()
    loss_err = abs(res["kernels"][0] - res["plain"][0]) / abs(res["plain"][0])
    errs = {path: rel_norm(torch, got.to("cuda"), want)
            for path, got, want in zip(leaves, res["kernels"][1], res["plain"][1])}
    worst = max(errs, key=errs.get)
    experts = {path: e for path, e in errs.items() if ".ffn.w" in path}
    log(f"moe: {cfg.name} one replica, kernels vs plain versions: loss rel err "
        f"{loss_err:.2e}; gradients max rel norm err {errs[worst]:.2e} ({worst}); "
        f"expert leaves {', '.join(f'{p} {e:.2e}' for p, e in sorted(experts.items()))} "
        f"(tolerance: loss {MOE_REPLICA_TOL['loss']:g}, gradients "
        f"{MOE_REPLICA_TOL['grad']:g})")
    if not (loss_err <= MOE_REPLICA_TOL["loss"] and errs[worst] <= MOE_REPLICA_TOL["grad"]):
        fail(f"{cfg.name} replica: the kernels' loss or gradients disagree with the plain "
             f"versions'")
    del params, leaves, res
    torch.cuda.empty_cache()


def moe_block_fwd_bwd(torch):
    """dbrx-132b's MoE block alone at the serving prefill's shapes (B 8 x
    2048 tokens, top-4: 65,536 pairs), bf16 expert leaves that require
    grad: the time of a forward and backward and the grouped kernels'
    share of its device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import ffn
    from repro_torch.models.module import lecun_normal

    cfg = dbrx_serving_config()
    D, F, E = cfg.d_model, cfg.moe_d_ff, cfg.moe_num_experts
    gen = torch.Generator(device="cuda").manual_seed(11)
    bf16 = torch.bfloat16
    p = {"router": {"w": lecun_normal(gen, (D, E), torch.float32, "cuda")},
         "w1": (torch.randn(E, D, F, generator=gen, device="cuda") / math.sqrt(D)).to(bf16),
         "w3": (torch.randn(E, D, F, generator=gen, device="cuda") / math.sqrt(D)).to(bf16),
         "w2": (torch.randn(E, F, D, generator=gen, device="cuda") / math.sqrt(F)).to(bf16)}
    x = torch.randn(SERVE_BATCH, SERVE_PROMPT, D, generator=gen, device="cuda").to(bf16)
    ct = torch.randn(x.shape, generator=gen, device="cuda").to(bf16)
    leaves = [x, p["router"]["w"], p["w1"], p["w3"], p["w2"]]
    for leaf in leaves:
        leaf.requires_grad_()

    def step():
        y, _ = ffn.moe_block(p, x, cfg)
        return torch.autograd.grad(y, leaves, grad_outputs=ct)

    counters = gmm_counters()
    before = {name: fn.launches for name, fn in counters.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    grads = step()                                   # warm-up
    torch.cuda.synchronize()
    launched = {name: fn.launches - before[name] for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if launched != dict.fromkeys(counters, 3):        # w1, w3, w2: no remat here
        fail(f"dbrx MoE block fwd+bwd: launches {launched}, expected 3 of each")
    if not all(bool(torch.isfinite(g).all()) for g in grads):
        fail("dbrx MoE block fwd+bwd: non-finite gradients")
    del grads
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy, ours = profile_summary(prof, wall, 1, "dbrx MoE block fwd+bwd (B 8 x 2048)")
    flops = 3 * 3 * 2 * SERVE_BATCH * SERVE_PROMPT * cfg.moe_top_k * D * F
    share = ("not measured (the profiler saw no device time)" if busy is None else
             f"{sum(ours.values()):.2f} of {busy:.2f} ms of device time "
             f"({sum(ours.values()) / busy:.1%}): "
             + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(ours.items())))
    log(f"moe: dbrx MoE block fwd+bwd at B {SERVE_BATCH} x {SERVE_PROMPT} "
        f"({SERVE_BATCH * SERVE_PROMPT * cfg.moe_top_k} pairs, bf16 expert leaves): "
        f"{', '.join(f'{t:.1f}' for t in times)} ms (host clock, after a warm-up); "
        f"launches {launched}; grouped kernels {share}; their bound "
        f"{flops / BF16_FLOP_PER_S * 1e3:.2f} ms ({flops / 1e12:.1f} TFLOP); peak "
        f"memory allocated {peak / 1e9:.2f} GB")
    del p, x, ct, leaves
    torch.cuda.empty_cache()


def moe_train_step(torch, plan):
    """TrainStep with 16 experts (the ragged branch): 3 masked gossip
    steps on paper8, 8 nodes, on the card and on the CPU from the same
    weights and batches, at fp32 compute (the scalar kernels) and at bf16
    (the wgmma kernels)."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.dist import decen_train as dt
    from repro_torch.kernels.gossip_axpy import gossip_axpy
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd
    from repro_torch.tree import flatten, tree_map

    steps = 3
    sched = plan.schedule(steps, seed=0)
    counters = dict(gmm_counters(), gossip_axpy=gossip_axpy)
    for compute, tol in MOE_STEP_TOL.items():
        cfg = dataclasses.replace(get_smoke_config("dbrx_132b"), moe_num_experts=16,
                                  moe_top_k=4, compute_dtype=compute)
        model = Model(cfg)
        opt = sgd(0.05, momentum=0.9)
        data = DecentralizedBatches(cfg, NODES, BATCH, SEQ, seed=0, device="cpu")
        batches = [next(data) for _ in range(steps)]
        out = {}
        for dev in ("cpu", "cuda"):
            params = dt.init_stacked_params(model, NODES, seed=0, device="cpu")
            params = tree_map(lambda a: a.to(dev), params)
            opt_state = dt.init_stacked_opt_state(opt, model, NODES, device=dev)
            step = dt.make_train_step(model, opt, plan, gossip_mode="masked")
            before = {name: fn.launches for name, fn in counters.items()}
            losses = []
            for k in range(steps):
                batch = {key: v.to(dev) for key, v in batches[k].items()}
                bits = torch.as_tensor(sched.activations[k].astype("float32"), device=dev)
                params, opt_state, loss, _ = step(params, opt_state, batch, bits)
                losses.append(loss.cpu())
            launched = {name: fn.launches - before[name] for name, fn in counters.items()}
            out[dev] = ({k: v.cpu() for k, v in flatten(params).items()},
                        torch.stack(losses), launched)
        leaves = len(out["cpu"][0])
        want = dict(moe_launches(cfg, steps * NODES), gossip_axpy=steps * leaves)
        if out["cuda"][2] != want or any(out["cpu"][2].values()):
            fail(f"16-expert TrainStep {compute}: the card launched {out['cuda'][2]}, the "
                 f"CPU {out['cpu'][2]}; expected {want} and none")
        worst = max(rel_norm(torch, out["cuda"][0][k], w) for k, w in out["cpu"][0].items())
        loss_err = float(((out["cuda"][1] - out["cpu"][1]).abs() / out["cpu"][1].abs()).max())
        log(f"moe: TrainStep {cfg.name} 16 experts top-4 (tiny, {cfg.num_layers} layers), "
            f"{compute} compute, {steps} masked steps on paper8 x {NODES} nodes, card "
            f"(kernels: {out['cuda'][2]}) vs CPU (plain): losses max rel err "
            f"{loss_err:.2e}, params max rel err {worst:.2e} (tolerance {tol:g}); card "
            f"losses {[round(float(v), 5) for v in out['cuda'][1].mean(1)]}")
        if not (loss_err <= tol and worst <= tol):
            fail(f"16-expert TrainStep {compute}: the card disagrees with the CPU")


def chunked_attention(torch):
    """internlm2-1.8b at published width, depth 24 -> 1, B 1 x S 8192: the
    loss and every gradient through ``sdpa_chunked`` (the default at this
    length) and through the unchunked ``sdpa``, at fp32 and bf16 compute."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.models import attention
    from repro_torch.models.transformer import Model
    from repro_torch.tree import flatten

    S = attention.CHUNKED_SDPA_THRESHOLD
    chunked = attention.sdpa_chunked
    calls = []

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return chunked(*args, **kw)

    for compute, tol in CHUNKED_TOL.items():
        cfg = dataclasses.replace(get_config("internlm2_1_8b"), num_layers=1,
                                  compute_dtype=compute)
        model = Model(cfg)
        params = model.init(0, device="cuda")
        leaves = flatten(params)
        for leaf in leaves.values():
            leaf.requires_grad_()
        batch = {k: v[0] for k, v in next(DecentralizedBatches(
            cfg, 1, 1, S, seed=0, device="cuda")).items()}
        res = {}
        for route, threshold in (("chunked", S), ("unchunked", 1 << 30)):
            calls.clear()
            attention.sdpa_chunked, attention.CHUNKED_SDPA_THRESHOLD = counted, threshold
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                loss, _ = model.loss(params, batch)
                grads = torch.autograd.grad(loss, list(leaves.values()))
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            finally:
                attention.sdpa_chunked, attention.CHUNKED_SDPA_THRESHOLD = chunked, S
            # remat runs the layer again in the backward
            if len(calls) != (cfg.num_layers * (1 + cfg.remat) if route == "chunked" else 0):
                fail(f"chunked attention {compute} {route}: sdpa_chunked ran {len(calls)} "
                     f"times")
            res[route] = (float(loss.detach()), grads)
            log(f"moe: {cfg.name} ({cfg.num_layers} layer, {compute} compute) B 1 x S {S}, "
                f"loss and {len(grads)} gradients through {route} attention: loss "
                f"{res[route][0]:.6f}, {ms:.1f} ms (host clock, first call), peak memory "
                f"allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            del loss
        loss_err = abs(res["chunked"][0] - res["unchunked"][0]) / abs(res["unchunked"][0])
        errs = {path: rel_norm(torch, g, w) for path, g, w in
                zip(leaves, res["chunked"][1], res["unchunked"][1])}
        worst = max(errs, key=errs.get)
        log(f"moe: {cfg.name} S {S} {compute}, sdpa_chunked vs unchunked sdpa: loss rel err "
            f"{loss_err:.2e}, gradients max rel norm err {errs[worst]:.2e} ({worst}) "
            f"(tolerance: loss {tol['loss']:g}, gradients {tol['grad']:g})")
        if not (loss_err <= tol["loss"] and errs[worst] <= tol["grad"]):
            fail(f"sdpa_chunked at S {S} {compute} disagrees with the unchunked sdpa")
        del params, leaves, res
        torch.cuda.empty_cache()


def tiny_launches(cfg, seq: int, *, encoder: bool = False):
    """Kernel launches of a prefill of ``seq`` tokens from position 0 plus
    one decode step (``analysis.launch_counts``; ``encoder``: with the
    encoder output in both)."""
    from repro_torch.analysis import launch_counts

    counts = launch_counts.prefill(cfg, seq=seq, encoder=encoder)
    counts["grouped_matmul"] += launch_counts.decode(cfg)["grouped_matmul"]
    return {k: counts[k] for k in ("flash_attention", "ssm_scan", "grouped_matmul")}


def tiny_config(arch, **over):
    """A tiny preset in fp32, gemma3 and jamba at 4 layers (one periodic
    segment each)."""
    from repro_torch.configs.registry import get_smoke_config

    if arch in ("gemma3_4b", "jamba_v0_1_52b"):
        over["num_layers"] = 4
    return dataclasses.replace(get_smoke_config(arch), compute_dtype="float32", **over)


def phase_serve_check(torch):
    """Tiny fp32 serving on the card (kernels) against the CPU (plain
    versions), from the same weights and prompts; then one training step
    of each new family, card against CPU."""
    import numpy as np

    from repro_torch.data.pipeline import to_bfloat16
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.models.transformer import Model
    from repro_torch.tree import flatten, tree_map

    kernels = {"flash_attention": flash_attention, "ssm_scan": ssm_scan,
               "grouped_matmul": grouped_matmul}
    B, S, max_len = 2, 100, 128
    checks = [
        tiny_config("internlm2_1_8b"),
        tiny_config("mamba2_370m"),
        # the stock dbrx smoke model has 4 experts (the einsum branch):
        # 16 experts, top-4 take the ragged branch and its grouped matmuls
        tiny_config("dbrx_132b", moe_num_experts=16, moe_top_k=4),
        tiny_config("gemma3_4b"),
        tiny_config("jamba_v0_1_52b"),
        tiny_config("jamba_v0_1_52b", moe_num_experts=16),
        # whisper: the encoder output in the prefill and the decode step;
        # internvl2: a prefix of 16 in the prefill (max_len covers it)
        tiny_config("whisper_base"),
        tiny_config("internvl2_1b"),
    ]
    for cfg in checks:
        model = Model(cfg)
        params = model.init(0, device="cpu")
        rng = np.random.default_rng(0)
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
        stub = (to_bfloat16(rng.normal(size=(B, cfg.encoder_seq, cfg.frontend_dim)))
                if cfg.frontend else None)
        out = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda a: a.to(dev), params)
            tokens = torch.as_tensor(toks, dtype=torch.int32, device=dev)
            caches = model.init_cache(B, max_len, device=dev)
            before = {name: fn.launches for name, fn in kernels.items()}
            pre, dec, P, outs = {}, {}, 0, []
            with torch.inference_mode():
                if cfg.frontend == "audio":
                    enc = model._encode(p, stub.to(dev), prefill=True)
                    pre = dec = dict(encoder_out=enc)
                    outs.append(enc.cpu())
                elif cfg.frontend == "vision":
                    pre, P = dict(prefix_embeddings=stub.to(dev)), cfg.encoder_seq
                lp, caches = model.serve_forward(p, tokens[:, :S], caches, start_position=0,
                                                 max_len=max_len, **pre)
                prefill_caches = flatten(dict(enumerate(caches)))
                prefill_caches = {k: v.cpu().clone() for k, v in prefill_caches.items()}
                ld, caches = model.serve_forward(p, tokens[:, S:], caches,
                                                 start_position=P + S, max_len=max_len, **dec)
            launched = {name: fn.launches - before[name] for name, fn in kernels.items()}
            outs += [lp.cpu(), ld.cpu()]
            leaves = [*prefill_caches.values(),
                      *(v.cpu() for v in flatten(dict(enumerate(caches))).values())]
            out[dev] = (outs, leaves, launched)
        expected = tiny_launches(cfg, S, encoder=cfg.frontend == "audio")
        if out["cuda"][2] != expected or any(out["cpu"][2].values()):
            fail(f"{cfg.name}: the card ran {out['cuda'][2]} kernel launches, the CPU "
                 f"{out['cpu'][2]}; expected {expected} and none")
        worst = 0.0
        for got, want in zip(out["cuda"][0] + out["cuda"][1], out["cpu"][0] + out["cpu"][1]):
            g, w = got.float(), want.float()
            worst = max(worst, float((g - w).abs().max() / max(w.abs().max(), 1e-30)))
        log(f"check: {cfg.name} ({cfg.num_layers} layers, {cfg.moe_num_experts} experts, "
            f"segments {[type(seg).__name__ for seg in model.segments]}) fp32 serving, card "
            f"(kernels: {out['cuda'][2]}) vs CPU (plain): "
            f"{'encoder output, ' if cfg.frontend == 'audio' else ''}"
            f"{'prefill behind a prefix of ' + str(P) + ', ' if P else ''}prefill logits, "
            f"one decode step and the {len(out['cpu'][1]) // 2} cache leaves after each "
            f"within {worst:.2e} of the largest magnitude (tolerance {SERVE_TOL:g})")
        if not worst <= SERVE_TOL:
            fail(f"{cfg.name}: the card's serving disagrees with the CPU's")
    check_family_training(torch)


def check_family_training(torch):
    """One training step's loss and gradients of each new family (tiny,
    fp32, a pipeline batch with its frontend stub), card against CPU;
    no kernel runs under grad."""
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.transformer import Model
    from repro_torch.tree import tree_leaves, tree_map

    for arch in FAMILY_ARCHS:
        cfg = tiny_config(arch)
        model = Model(cfg)
        params = model.init(0, device="cpu")
        batch = {k: v[0] for k, v in next(DecentralizedBatches(
            cfg, 1, 2, 32, seed=0, device="cpu")).items()}
        res = {}
        launches = flash_attention.launches
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda a: a.to(dev).detach().requires_grad_(), params)
            loss, _ = model.loss(p, {k: v.to(dev) for k, v in batch.items()})
            grads = torch.autograd.grad(loss, tree_leaves(p))
            res[dev] = (float(loss.detach()), [g.cpu() for g in grads])
        loss_err = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
        grad_err = max(float((g - w).norm() / max(float(w.norm()), 1e-30))
                       for g, w in zip(res["cuda"][1], res["cpu"][1]))
        log(f"check: {cfg.name} ({cfg.num_layers} layers) tiny fp32 training step, card vs "
            f"CPU: loss {res['cuda'][0]:.6f}, rel err {loss_err:.2e}; {len(res['cpu'][1])} "
            f"gradients, max rel err {grad_err:.2e} (tolerance {SMALL_TOL:g})")
        if flash_attention.launches != launches:
            fail(f"{cfg.name}: a training step launched the flash kernel")
        if not (loss_err <= SMALL_TOL and grad_err <= SMALL_TOL):
            fail(f"{cfg.name}: the card's training step disagrees with the CPU's")


def peak_reading(torch) -> int:
    """max_memory_allocated since the last reading (or reset), and a reset."""
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    return peak


def phase_main(torch, cfg, plan):
    """The full-width decentralized trainer: masked steps, faulted steps,
    then overlap steps (plain and faulted) and the flush, each step's
    spans read after it; returns the kernel launches of the masked and
    the overlap path, each counted from 0."""
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.dist import decen_train as dt
    from repro_torch.faults import FaultSpec, make_fault_schedule
    from repro_torch.kernels.gossip_axpy import gossip_axpy
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd
    from repro_torch.telemetry import StepTimer, TraceRecorder
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
    timer = StepTimer(TraceRecorder())
    steps = {f: dt.make_train_step(model, opt, plan, gossip_mode="masked", faulted=f,
                                   timer=timer) for f in (False, True)}
    n_leaves = len(flatten(params))
    torch.cuda.reset_peak_memory_stats()
    gossip_axpy.launches = 0
    step_ms, phase_ms = [], []
    step_peaks, cons_peaks = [], []    # each step's, and the consensus reading's after it
    for k in range(STEPS + FAULTED_STEPS):
        faulted = k >= STEPS
        row = schedule.activations[k].astype("float32")
        bits = torch.as_tensor(fault_sched.node_bits(row, k) if faulted else row,
                               device="cuda")
        step = steps[faulted]
        before = gossip_axpy.launches
        params, opt_state, losses, _ = step(params, opt_state, batches[k], bits, step=k)
        phases = step.last_phases.ms()        # waits for the step's end event
        step_ms.append(phases["step"])
        step_peaks.append(peak_reading(torch))
        launched = gossip_axpy.launches - before
        phase_ms.append(phases)
        loss = float(losses.mean())
        cons = float(dt.consensus_distance(params))
        cons_peaks.append(peak_reading(torch))
        faults_note = (f" faulted (p_drop {P_DROP}): {fault_sched.dropped_links(row, k)} "
                       f"node-exchanges dropped, straggler delay "
                       f"{fault_sched.max_delay(k):g} units" if faulted else "")
        log(f"main: step {k} {step_ms[-1]:.1f} ms (fwd_bwd {phases['fwd_bwd']:.1f}: forward "
            f"{phases['forward']:.1f}, backward {phases['backward']:.1f}; optimizer "
            f"{phases['optimizer']:.1f}; gossip {phases['gossip']:.1f}: target "
            f"{phases['gossip/target']:.1f}, apply {phases['gossip/apply']:.1f} ms; "
            f"pairs set {step.last_phases.counts()['pairs_set']:g} of "
            f"{step.last_phases.counts()['pairs_exchanged']:g}) "
            f"gossip_axpy launches {launched} loss {loss:.4f} consensus {cons:.4e} "
            f"active {len(schedule.active_indices(k))}/{plan.num_matchings}{faults_note}")
        if launched != n_leaves:
            fail(f"step {k}: {launched} gossip_axpy launches, expected {n_leaves}")
        if not (math.isfinite(loss) and math.isfinite(cons)):
            fail(f"step {k}: loss {loss} / consensus {cons} not finite")
    launches = gossip_axpy.launches
    peak = max(step_peaks + cons_peaks)
    # step 0 pays the first-call set-up of the GEMM libraries
    steady = sorted(range(1, STEPS), key=lambda k: step_ms[k])
    mid = steady[len(steady) // 2]
    log(f"main: median masked step over steps 1..{STEPS - 1}: {step_ms[mid]:.1f} ms "
        + ", ".join(f"{name} {ms:.1f}" for name, ms in phase_ms[mid].items())
        + f" ms; step 0 {step_ms[0]:.1f} ms; faulted steps "
        + ", ".join(f"{step_ms[k]:.1f} (gossip {phase_ms[k]['gossip']:.1f})"
                    for k in range(STEPS, STEPS + FAULTED_STEPS)) + " ms")
    log(f"main: gossip_axpy launches {launches} over {STEPS} masked and "
        f"{FAULTED_STEPS} faulted steps; peak memory allocated {peak / 1e9:.2f} GB: the "
        f"steps' {max(step_peaks) / 1e9:.3f} GB, consensus_distance between them "
        f"{max(cons_peaks) / 1e9:.3f} GB")
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
    torch.cuda.empty_cache()
    masked = dict(step_ms=step_ms[mid], phases=phase_ms[mid], peak=peak)
    overlap_launches = phase_overlap(torch, model, opt, plan, params, opt_state, batches,
                                     masked)
    return launches + overlap_launches


def phase_overlap(torch, model, opt, plan, params, opt_state, batches, masked):
    """Overlap steps at full width from the masked run's state, then
    faulted overlap steps and the flush: step times (from the step
    span's start on the main stream to the later of its end and the
    side stream's gossip_launch end) against the masked median,
    overlap_ratio, the gossip_launch span on the side stream, peak
    memory and the GossipState bytes; the gossip_axpy launches (12 a
    step, 12 for the flush) are returned. Before the flush, the pending
    correction lands through the kernel and through the plain version
    from the same state, leaf by leaf, bit for bit."""
    from repro_torch.dist import decen_train as dt
    from repro_torch.dist.gossip import delayed_delta_inplace
    from repro_torch.faults import FaultSpec, make_fault_schedule
    from repro_torch.kernels.gossip_axpy import gossip_axpy
    from repro_torch.telemetry import StepTimer, TraceRecorder
    from repro_torch.telemetry import probes as tprobes
    from repro_torch.tree import flatten

    total = OVERLAP_STEPS + OVERLAP_FAULTED
    schedule = plan.schedule(total, seed=1)
    fault_sched = make_fault_schedule(plan, total, FaultSpec(p_drop=P_DROP, seed=1))
    bplan = dt.param_bucket_plan(model)
    rec = TraceRecorder()
    timer = StepTimer(rec)
    steps = {f: dt.make_train_step(model, opt, plan, gossip_mode="overlap", bucket_plan=bplan,
                                   faulted=f, timer=timer) for f in (False, True)}
    flush = dt.make_gossip_flush(plan, bplan)
    n_leaves = len(flatten(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gstate = dt.init_gossip_state(plan, bplan, device="cuda")
    log(f"overlap: {bplan.num_buckets} buckets (largest {max(bplan.bucket_sizes)} elements a "
        f"node), GossipState {gstate.nbytes / 1e9:.2f} GB; memory allocated before the first "
        f"step {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    gossip_axpy.launches = 0
    step_ms, apply_ms = [], []
    step_peaks, cons_peaks = [], []    # each step's, and the readings' after it
    for k in range(total):
        faulted = k >= OVERLAP_STEPS
        row = schedule.activations[k].astype("float32")
        bits = torch.as_tensor(fault_sched.node_bits(row, k) if faulted else row, device="cuda")
        step = steps[faulted]
        before = gossip_axpy.launches
        params, opt_state, gstate, losses, _ = step(
            params, opt_state, gstate, batches[k % len(batches)], bits, step=k)
        # reading the spans waits for both streams' end events
        events = {e.name: e.args for e in step.last_phases.events()
                  if e.name in ("step", "gossip_launch")}
        phases = step.last_phases.ms()
        main = events["step"]
        begin = (events["gossip_launch"]["device_start_us"] - main["device_start_us"]) / 1e3
        launch_ms = phases["gossip_launch"]
        step_ms.append(max(main["device_dur_us"] / 1e3, begin + launch_ms))
        step_peaks.append(peak_reading(torch))
        launched = gossip_axpy.launches - before
        apply_ms.append(phases["gossip_apply"])
        m = tprobes.step_metrics(step=k, step_ms=step_ms[-1], comm_ms=launch_ms,
                                 gossip_mode="overlap")
        loss = float(losses.mean())
        cons = float(dt.consensus_distance(params))
        cons_peaks.append(peak_reading(torch))
        main_ms = phases["gossip_apply"] + phases["fwd_bwd"] + phases["optimizer"]
        faults_note = (f" faulted (p_drop {P_DROP}): {fault_sched.dropped_links(row, k)} "
                       f"node-exchanges dropped" if faulted else "")
        log(f"overlap: step {k} {step_ms[-1]:.1f} ms (main stream: gossip_apply "
            f"{phases['gossip_apply']:.1f}, fwd_bwd {phases['fwd_bwd']:.1f}, optimizer "
            f"{phases['optimizer']:.1f} ms); gossip_launch on the side stream "
            f"{launch_ms:.1f} ms, from {begin:.1f} to {begin + launch_ms:.1f} ms of the "
            f"step; both streams busy {main_ms + launch_ms - step_ms[-1]:.1f} ms; "
            f"overlap_ratio {m['overlap_ratio']:.4f}; gossip_axpy launches {launched} loss "
            f"{loss:.4f} consensus {cons:.4e}{faults_note}")
        if launched != n_leaves:
            fail(f"overlap step {k}: {launched} gossip_axpy launches, expected {n_leaves}")
        if not (math.isfinite(loss) and math.isfinite(cons)):
            fail(f"overlap step {k}: loss {loss} / consensus {cons} not finite")
    peak = max(step_peaks + cons_peaks)
    counted = gossip_axpy.launches
    check_overlap_apply(torch, bplan, float(plan.alpha), params, gstate)
    gossip_axpy.launches = counted       # the comparison's launches are not the path's
    t0 = time.perf_counter()
    params = flush(params, gstate, inplace=True)
    torch.cuda.synchronize()
    flush_ms = (time.perf_counter() - t0) * 1e3
    launches = gossip_axpy.launches
    cons = float(dt.consensus_distance(params))
    # the launch alone, on an idle card, for the hidden share below
    perms = torch.as_tensor(plan.permutations, dtype=torch.int64, device="cuda")
    ones = torch.ones(plan.num_matchings, device="cuda")
    alone = cuda_ms(torch, lambda: delayed_delta_inplace(gstate.delta, ones, perms), 2, 1)
    launch_bound = 2 * gstate.nbytes / HBM_BYTES_PER_S * 1e3
    steady = sorted(range(1, OVERLAP_STEPS), key=lambda k: step_ms[k])
    mid = steady[len(steady) // 2]
    main_alone = masked["phases"]["fwd_bwd"] + masked["phases"]["optimizer"]
    serial = apply_ms[mid] + main_alone + alone
    log(f"overlap: median step over steps 1..{OVERLAP_STEPS - 1}: {step_ms[mid]:.1f} ms "
        f"against the masked median {masked['step_ms']:.1f} ms of this run "
        f"({step_ms[mid] / masked['step_ms']:.3f}x); step 0 {step_ms[0]:.1f} ms; faulted "
        f"overlap steps " + ", ".join(f"{step_ms[k]:.1f}" for k in range(OVERLAP_STEPS, total))
        + f" ms; flush {flush_ms:.1f} ms, consensus after it {cons:.4e}")
    log(f"overlap: the launch alone on an idle card {alone:.1f} ms (bound {launch_bound:.2f} ms: "
        f"read the snapshot, write the delta); serial estimate of the median step (its "
        f"gossip_apply {apply_ms[mid]:.1f} + the masked median's fwd_bwd and optimizer "
        f"{main_alone:.1f} + the launch alone) {serial:.1f} ms, so "
        f"{(serial - step_ms[mid]) / alone:.1%} of the launch was hidden")
    log(f"overlap: peak memory allocated over the overlap steps {peak / 1e9:.2f} GB: the "
        f"steps' {max(step_peaks) / 1e9:.3f} GB, consensus_distance between them "
        f"{max(cons_peaks) / 1e9:.3f} GB (masked {masked['peak'] / 1e9:.2f} GB), GossipState "
        f"{gstate.nbytes / 1e9:.2f} GB; gossip_axpy launches {launches} over {total} overlap "
        "steps and the flush")
    if launches != n_leaves * (total + 1):
        fail(f"{launches} launches on the overlap path, expected {n_leaves * (total + 1)}")
    if not math.isfinite(cons):
        fail(f"overlap: consensus {cons} after the flush")
    return launches


# ---------------------------------------------------------------------------
# Phase 11: the sharded-replica (FSDP) trainer through NCCL
# ---------------------------------------------------------------------------
FSDP_LAYERS, FSDP_NODES, FSDP_STEPS = 8, 4, 3
# streamed layouts against monolithic (tests/test_stream_fsdp.py's limits)
FSDP_TOL = {"loss_atol": 5e-6, "loss_rtol": 1e-6, "params": 2e-6}
FSDP_MULTI_TOL = 5e-5           # S 2 against the world of one (tests/test_fsdp_parity.py)
FSDP_DEVICE = "cuda"            # the phase's device (NCCL on it)


def fsdp_config():
    """internlm2-1.8b at published width, depth 24 -> 8: one scanned
    segment (``SCAN_THRESHOLD`` 8), so the scan-aware layout streams rows."""
    from repro_torch.configs.registry import get_config

    return dataclasses.replace(get_config("internlm2_1_8b"), num_layers=FSDP_LAYERS)


def fsdp_bytes(cfg, nodes: int = FSDP_NODES) -> dict:
    """The phase's byte reckoning from the shapes (fp32 buckets, S 1):
    one node's params, the params, velocities and overlap GossipState of
    every node, and the gathered view of each layout."""
    from repro_torch.analysis import bytes_model

    (row,) = bytes_model.fsdp_bytes_rows(shard_factors=(1,), cfg=cfg, label=cfg.name)
    node = row["padded_param_bytes"]
    return dict(params_per_node=row["raw_param_bytes"] // 4, node_bytes=node,
                params=nodes * node, velocities=nodes * node, gossip_state=nodes * node,
                monolithic=row["peak_transient_bytes_monolithic"],
                streamed=row["peak_transient_bytes_streamed"],
                scan_streamed=row["peak_transient_bytes_scan_streamed"])


def fsdp_expected_launches(num_buckets: int, gossip_mode: str, steps: int = FSDP_STEPS) -> int:
    from repro_torch.analysis import launch_counts

    return launch_counts.fsdp_train_step(num_buckets, gossip_mode=gossip_mode, steps=steps,
                                         flush=gossip_mode == "overlap")["gossip_axpy"]


def fsdp_not_run_line(cards: int):
    """The line printed when the multi-card worlds cannot run (None with
    two cards or more)."""
    if cards >= 2:
        return None
    return (f"fsdp: {cards} CUDA card here: the S 2 and R_data 2 worlds over NCCL were not "
            "run (they need two cards; the CPU tests hold them over gloo)")


def fsdp_replicated(torch, model, opt, plan, batches, bits, mode):
    """The replicated step from seed 0: its params (kept on the card) and
    its (steps, nodes) losses."""
    from repro_torch.dist import decen_train as dt

    params = dt.init_stacked_params(model, FSDP_NODES, seed=0, device=FSDP_DEVICE)
    opt_state = dt.init_stacked_opt_state(opt, model, FSDP_NODES, device=FSDP_DEVICE)
    step = dt.make_train_step(model, opt, plan, gossip_mode=mode)
    gstate = (dt.init_gossip_state(plan, step.bplan, device=FSDP_DEVICE) if mode == "overlap"
              else None)
    losses = []
    for batch, b in zip(batches, bits):
        if gstate is not None:
            params, opt_state, gstate, loss, _ = step(params, opt_state, gstate, batch, b)
        else:
            params, opt_state, loss, _ = step(params, opt_state, batch, b)
        losses.append(loss)
    if gstate is not None:
        params = dt.make_gossip_flush(plan, step.bplan)(params, gstate, inplace=True)
    del opt_state, gstate
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return params, torch.stack(losses)


def fsdp_sharded(torch, model, opt, plan, spec, layout, batches, bits, mode):
    """The sharded step from seed 0: shards, losses and the run's
    numbers (step times, phase splits, launches, resident and peak)."""
    from repro_torch.dist import fsdp
    from repro_torch.kernels.gossip_axpy import gossip_axpy
    from repro_torch.telemetry import StepTimer, TraceRecorder

    shards = fsdp.init_fsdp_params(model, layout, spec, seed=0, device=FSDP_DEVICE)
    opt_state = fsdp.init_fsdp_opt_state(opt, layout, spec, device=FSDP_DEVICE)
    step = fsdp.make_fsdp_train_step(model, opt, plan, spec, layout, gossip_mode=mode,
                                     timer=StepTimer(TraceRecorder()))
    gstate = fsdp.init_fsdp_gossip_state(layout, spec, device=FSDP_DEVICE) if mode == "overlap" \
        else None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, phases = [], [], []
    gossip_axpy.launches = 0
    for batch, b in zip(batches, bits):
        t0 = time.perf_counter()
        if gstate is not None:
            shards, opt_state, gstate, loss, _ = step(shards, opt_state, gstate, batch, b)
        else:
            shards, opt_state, loss, _ = step(shards, opt_state, batch, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        phases.append(step.last_phases.ms())
        losses.append(loss)
    if gstate is not None:
        shards = fsdp.make_fsdp_gossip_flush(plan, layout)(shards, gstate, inplace=True)
    torch.cuda.synchronize()
    launches = gossip_axpy.launches
    peak = torch.cuda.max_memory_allocated() - resident
    del opt_state, gstate
    torch.cuda.empty_cache()
    return shards, torch.stack(losses), dict(step_ms=step_ms, phases=phases,
                                             launches=launches, resident=resident, peak=peak)


def fsdp_params_err(torch, layout, shards, ref_params):
    """Max abs difference of the sharded run's params (an S 1 world's
    shards, read as views) from the replicated run's, and whether every
    leaf is bit-equal."""
    from repro_torch.dist import bucketing
    from repro_torch.tree import flatten

    got = flatten(layout.unravel_stacked(bucketing.unshard_buckets(
        tuple(s.unsqueeze(1) for s in shards))))
    want = flatten(ref_params)
    err, equal = 0.0, True
    for path, w in want.items():
        equal = equal and torch.equal(got[path], w)
        err = max(err, float((got[path] - w).abs().max()))
    return err, equal


def phase_fsdp(torch, cfg=None):
    """Phase 11 (see the module docstring)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.core import named_graph, plan_matcha
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.dist import decen_train as dt
    from repro_torch.dist import fsdp
    from repro_torch.launch.mesh import backend_for, make_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd
    from repro_torch.telemetry import probes as tprobes

    t_phase = time.perf_counter()
    cfg = cfg or fsdp_config()
    model = Model(cfg)
    opt = sgd(0.05, momentum=0.9)
    plan = plan_matcha(named_graph("ring", FSDP_NODES, seed=3), 0.5, seed=0)
    schedule = plan.schedule(FSDP_STEPS, seed=0)
    bits = [torch.as_tensor(schedule.activations[k].astype("float32"), device=FSDP_DEVICE)
            for k in range(FSDP_STEPS)]
    data = DecentralizedBatches(cfg, FSDP_NODES, BATCH, SEQ, seed=0, device=FSDP_DEVICE)
    batches = [next(data) for _ in range(FSDP_STEPS)]
    reck = fsdp_bytes(cfg)
    gb = lambda b: f"{b / 1e9:.3f} GB"
    log(f"fsdp: {cfg.name} d_model {cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} of "
        f"{cfg.head_dim} d_ff {cfg.d_ff} vocab {cfg.vocab_size}; reduced: num_layers 24 -> "
        f"{FSDP_LAYERS}; {reck['params_per_node']} params a node ({gb(reck['node_bytes'])} fp32), "
        f"{FSDP_NODES} nodes on ring: params {gb(reck['params'])}, velocities "
        f"{gb(reck['velocities'])}, overlap GossipState {gb(reck['gossip_state'])}; gathered "
        f"view monolithic {gb(reck['monolithic'])}, streamed {gb(reck['streamed'])}, "
        f"scan-streamed {gb(reck['scan_streamed'])}")
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend_for(FSDP_DEVICE), init_method=f"file://{tmp}/store",
                                rank=0, world_size=1, device_id=torch.device(FSDP_DEVICE, 0))
        try:
            spec = dt.make_spec(make_mesh(shard=1, device=FSDP_DEVICE), FSDP_NODES)
            layouts = {"monolithic": fsdp.make_layout(model, spec),
                       "streamed": fsdp.make_stream_layout(model, spec, scan_aware=False),
                       "scan-streamed": fsdp.make_stream_layout(model, spec)}
            for mode in ("masked", "overlap"):
                ref, ref_losses = fsdp_replicated(torch, model, opt, plan, batches, bits, mode)
                names = ("scan-streamed",) if mode == "overlap" else tuple(layouts)
                for name in names:
                    layout = layouts[name]
                    shards, losses, run = fsdp_sharded(
                        torch, model, opt, plan, spec, layout, batches, bits,
                        "sequential" if mode == "masked" else mode)
                    err, equal = fsdp_params_err(torch, layout, shards, ref)
                    del shards
                    torch.cuda.empty_cache()
                    run.update(name=f"{name} {mode}", buckets=layout.plan.num_buckets,
                               params_err=err, params_equal=equal,
                               loss_err=float((losses - ref_losses).abs().max()),
                               loss_equal=torch.equal(losses, ref_losses),
                               loss_close=torch.allclose(losses, ref_losses,
                                                         atol=FSDP_TOL["loss_atol"],
                                                         rtol=FSDP_TOL["loss_rtol"]),
                               expected=fsdp_expected_launches(
                                   layout.plan.num_buckets,
                                   "sequential" if mode == "masked" else mode),
                               predicted=reck[name.replace("-", "_")],
                               loss=float(losses[-1].mean()))
                    runs[run["name"]] = run
                del ref
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            probe = tprobes.measure_fsdp_collectives(spec, layouts["scan-streamed"], iters=3)
            probe_s = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    for run in runs.values():
        steady = sorted(range(FSDP_STEPS), key=lambda k: run["step_ms"][k])
        mid = steady[len(steady) // 2]
        split = ", ".join(f"{k} {v:.1f}" for k, v in run["phases"][mid].items())
        log(f"fsdp: {run['name']}: {run['buckets']} buckets; median step "
            f"{run['step_ms'][mid]:.1f} ms (steps " + ", ".join(
                f"{t:.1f}" for t in run["step_ms"]) + f" ms; phases of the median step: "
            f"{split} ms); resident {gb(run['resident'])}, peak above resident "
            f"{gb(run['peak'])} (byte model's gathered view {gb(run['predicted'])}); "
            f"gossip_axpy launches {run['launches']} (expected {run['expected']}); last loss "
            f"{run['loss']:.4f}; against the replicated step: loss max diff "
            f"{run['loss_err']:.3e} (bit-equal {run['loss_equal']}), params max diff "
            f"{run['params_err']:.3e} (bit-equal {run['params_equal']})")
    bw = probe["bytes_per_node"] * FSDP_NODES / 1e9
    log(f"fsdp: measure_fsdp_collectives over the NCCL shard group of one (scan-streamed "
        f"layout, {FSDP_NODES} nodes, {bw:.2f} GB of fp32 buckets): gather mean "
        f"{probe['gather']['mean_ms']:.3f} ms (p50 {probe['gather']['p50_ms']:.3f}), "
        f"reduce_scatter mean {probe['reduce_scatter']['mean_ms']:.3f} ms (p50 "
        f"{probe['reduce_scatter']['p50_ms']:.3f}); {probe_s:.1f} s with set-up")
    note = fsdp_not_run_line(torch.cuda.device_count())
    if note:
        log(note)
    else:
        fsdp_multi_card(torch)
    log(f"fsdp: phase {time.perf_counter() - t_phase:.1f} s")
    for run in runs.values():
        if run["launches"] != run["expected"]:
            fail(f"fsdp {run['name']}: {run['launches']} gossip_axpy launches, "
                 f"expected {run['expected']}")
        if not math.isfinite(run["loss"]):
            fail(f"fsdp {run['name']}: loss {run['loss']} not finite")
    mono = runs["monolithic masked"]
    if not (mono["params_equal"] and mono["loss_equal"]):
        fail("fsdp: the monolithic S 1 step is not bit-equal to the replicated step "
             f"(loss diff {mono['loss_err']:.3e}, params {mono['params_err']:.3e})")
    for name in ("streamed masked", "scan-streamed masked", "scan-streamed overlap"):
        run = runs[name]
        if not (run["loss_close"] and run["params_err"] <= FSDP_TOL["params"]):
            fail(f"fsdp {name}: loss diff {run['loss_err']:.3e}, params "
                 f"{run['params_err']:.3e} past {FSDP_TOL}")


def _fsdp_rank(rank: int, world: int, init_method: str, case: str, out: str) -> None:
    """One rank of a two-card world (``case`` s2: S 2; r2: R_data 2) at
    the tiny preset, fp32: 3 masked steps against the replicated
    single-process step on this rank's card; rank 0 writes the max
    params and loss differences to ``out``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, SRC)
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core import named_graph, plan_matcha
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.dist import decen_train as dt
    from repro_torch.dist import fsdp
    from repro_torch.launch.mesh import init_world, make_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd
    from repro_torch.tree import flatten

    device = init_world("cuda", rank=rank, world_size=world, init_method=init_method)
    try:
        cfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), compute_dtype="float32")
        model, opt = Model(cfg), sgd(0.05, momentum=0.9)
        plan = plan_matcha(named_graph("ring", FSDP_NODES, seed=3), 0.5, seed=0)
        sched = plan.schedule(FSDP_STEPS, seed=0)
        data = DecentralizedBatches(cfg, FSDP_NODES, BATCH, 32, seed=0, device=device)
        batches = [next(data) for _ in range(FSDP_STEPS)]
        bits = [sched.activations[k].astype("float32") for k in range(FSDP_STEPS)]
        spec = dt.make_spec(make_mesh(shard=world if case == "s2" else 1, device=device),
                            FSDP_NODES)

        def replicated(s):
            p = dt.init_stacked_params(model, FSDP_NODES, seed=0, device=device)
            o = dt.init_stacked_opt_state(opt, model, FSDP_NODES, device=device)
            if s is not None:
                p, o = s.local(p), s.local(o)
            step = dt.make_train_step(model, opt, plan, spec=s)
            losses = []
            for batch, b in zip(batches, bits):
                p, o, loss, _ = step(p, o, batch, b)
                losses.append(loss)
            return p, torch.stack(losses)

        ref, ref_losses = replicated(None)
        if case == "s2":
            layout = fsdp.make_stream_layout(model, spec)
            shards = fsdp.init_fsdp_params(model, layout, spec, seed=0, device=device)
            opt_state = fsdp.init_fsdp_opt_state(opt, layout, spec, device=device)
            step = fsdp.make_fsdp_train_step(model, opt, plan, spec, layout)
            losses = []
            for batch, b in zip(batches, bits):
                shards, opt_state, loss, _ = step(shards, opt_state, batch, b)
                losses.append(loss)
            got, losses = fsdp.gather_params(layout, shards, spec), torch.stack(losses)
        else:
            got, losses = replicated(spec)
            ref = spec.local(ref)
            ref_losses = ref_losses[:, spec.node_lo:spec.node_hi]
        g, w = flatten(got), flatten(ref)
        err = dict(params=max(float((g[k] - w[k]).abs().max()) for k in w),
                   loss=float((losses - ref_losses).abs().max()))
        if rank == 0:
            with open(out, "w") as f:
                json.dump(err, f)
    finally:
        dist.destroy_process_group()


def fsdp_multi_card(torch) -> None:
    """The S 2 and R_data 2 worlds over NCCL on two cards against the
    single-process step (S 2 within 5e-5, R_data 2 bit for bit)."""
    import tempfile

    from repro_torch.launch.mesh import spawn

    for case, tol in (("s2", FSDP_MULTI_TOL), ("r2", 0.0)):
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "err.json")
            spawn(_fsdp_rank, 2, "cuda", args=(case, out))
            with open(out) as f:
                err = json.load(f)
        log(f"fsdp: {case} over NCCL on 2 cards against one process: params max diff "
            f"{err['params']:.3e}, loss {err['loss']:.3e} (limit {tol})")
        if not (err["params"] <= tol and err["loss"] <= tol):
            fail(f"fsdp {case} over NCCL: {err} past {tol}")


# ---------------------------------------------------------------------------
# Phase 12: tensor parallel over a model axis
# ---------------------------------------------------------------------------
TP = 2                          # the model axis of the phase's worlds
TP_STEPS, TP_OVERLAP_STEPS = 3, 2
TP_GEN = 8                      # generated tokens of each served request
TP_SERVED = ("internlm2-1.8b", "mamba2-370m", "dbrx-132b")
# against the world of one, bf16 compute: T changes the order of the
# row-parallel sums and rounds each rank's partial product to bf16 before
# the fp32 sum (measured values in PERF.md). After 3 steps: the loss's max
# abs difference, and per leaf the norm of the params' difference over the
# norm of the world of one's change from the initial weights (max over
# leaves), 3x the readings; a halved gradient on a leaf reads ~0.5.
TP_TRAIN_TOL = {"loss": 3e-3, "params": 5e-2}
TP_LOGIT_TOL = 0.25             # max abs on each step's last logits


def tp_world(cards: int):
    """``(backend, share)`` of the phase's world: on fewer cards than
    ranks, gloo with the ranks sharing the card (gloo's all-reduce takes
    CUDA tensors, checked on the H100 once); NCCL with a card a rank."""
    return ("gloo", True) if cards < TP else ("nccl", False)


class CommClock:
    """Host time, calls and bytes of every collective
    ``repro_torch.dist.comm`` issues over a group in this rank (its four
    entries patched), each fenced by a synchronize before it starts and
    after it ends, by entry. The bytes are the tensor reduced, the
    all-gather's output, the reduce-scatter's input, the exchange's
    sends."""

    ENTRIES = ("all_reduce", "all_gather", "reduce_scatter", "exchange")
    GROUP_ARG = {"all_reduce": 1, "all_gather": 2, "reduce_scatter": 2, "exchange": 1}

    def __init__(self, torch):
        from repro_torch.dist import comm

        self.by_entry = dict.fromkeys(self.ENTRIES, 0.0)
        self.calls = dict.fromkeys(self.ENTRIES, 0)
        self.bytes = dict.fromkeys(self.ENTRIES, 0)
        for name in self.ENTRIES:
            orig = getattr(comm, name)

            def timed(*args, _orig=orig, _name=name, **kw):
                if args[self.GROUP_ARG[_name]] is None:
                    return _orig(*args, **kw)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _orig(*args, **kw)
                torch.cuda.synchronize()
                self.by_entry[_name] += (time.perf_counter() - t0) * 1e3
                self.calls[_name] += 1
                self.bytes[_name] += self._bytes(_name, args)
                return out

            setattr(comm, name, timed)

    @staticmethod
    def _bytes(name, args):
        if name == "exchange":
            return sum(t.numel() * t.element_size() for _, t in args[0])
        t = args[1] if name == "reduce_scatter" else args[0]
        return t.numel() * t.element_size()

    @property
    def ms(self) -> float:
        """The time in every entry so far."""
        return sum(self.by_entry.values())


class KernelShapes:
    """The input shapes of every call of the three serving kernels while
    active: ``ops.attention``, ``ops.ssd`` and ``ops.grouped_matmul``,
    the entries the model calls them through, wrapped (the kernels'
    wrappers and their launch counters stay as they are)."""

    NAMES = {"attention": "flash_attention", "ssd": "ssm_scan",
             "grouped_matmul": "grouped_matmul"}

    def __init__(self):
        self.seen = {}
        self.sizes = []

    def __enter__(self):
        from repro_torch.kernels import ops

        self._orig = []
        for entry, name in self.NAMES.items():
            fn = getattr(ops, entry)
            self._orig.append((ops, entry, fn))

            def rec(*args, _fn=fn, _name=name, **kw):
                key = (_name,) + tuple(tuple(a.shape) for a in args[:3]
                                       if hasattr(a, "shape"))
                self.seen[key] = self.seen.get(key, 0) + 1
                if _name == "grouped_matmul":
                    self.sizes.append(args[2])
                return _fn(*args, **kw)

            setattr(ops, entry, rec)
        return self

    def __exit__(self, *exc):
        for mod, entry, fn in self._orig:
            setattr(mod, entry, fn)

    def lines(self):
        covered = [int(s.sum()) for s in self.sizes]
        rows = f"; grouped_matmul rows in the groups {min(covered)}-{max(covered)}" \
            if covered else ""
        return ", ".join(f"{k[0]} {list(k[1:])} x{n}" for k, n in self.seen.items()) + rows


class Routes:
    """The experts each MoE layer's router picks for the last position of
    every row while active (``models.ffn._router`` wrapped, kept on the
    device until read)."""

    def __init__(self, rows: int):
        self.rows, self.seen = rows, []

    def __enter__(self):
        import torch

        from repro_torch.models import ffn

        self._orig = orig = ffn._router

        def router(p, x, cfg):
            gates, idx, aux = orig(p, x, cfg)
            last = idx.reshape(self.rows, -1, idx.shape[-1])[:, -1]
            self.seen.append(torch.sort(last, dim=-1).values)
            return gates, idx, aux

        ffn._router = router
        return self

    def __exit__(self, *exc):
        from repro_torch.models import ffn

        ffn._router = self._orig

    def table(self, steps: int):
        """``(rows, steps, layers x k)``, the calls in step order."""
        import torch

        if not self.seen:
            return torch.zeros(self.rows, steps, 1)
        t = torch.stack(self.seen).cpu().reshape(steps, -1, self.rows, self.seen[0].shape[-1])
        return t.permute(2, 0, 1, 3).reshape(self.rows, steps, -1).float()


def tp_reference_train(torch, model, opt, plan, batches, bits, spec):
    """The world of one's masked steps from seed 0 (no rules): the losses,
    its gossip_axpy launches a step and this model rank's slices of the
    final params, on the host."""
    from repro_torch.dist import decen_train as dt
    from repro_torch.dist.sharding import no_rules
    from repro_torch.kernels.gossip_axpy import gossip_axpy
    from repro_torch.tree import flatten

    dev = spec.mesh.device
    with no_rules():
        params = dt.init_stacked_params(model, NODES, seed=0, device=dev)
        opt_state = dt.init_stacked_opt_state(opt, model, NODES, device=dev)
        step = dt.make_train_step(model, opt, plan)
        gossip_axpy.launches = 0
        losses = []
        for k in range(TP_STEPS):
            params, opt_state, loss, _ = step(params, opt_state, batches[k], bits[k])
            losses.append(loss)
        torch.cuda.synchronize()
    launches = gossip_axpy.launches // TP_STEPS
    del opt_state
    mine = {}
    for path, leaf in flatten(spec.local(params)).items():
        d = spec.split.get(path)
        if d is not None:
            k = leaf.shape[d + 1] // spec.tp
            leaf = leaf.narrow(d + 1, spec.mesh.model_rank * k, k)
        mine[path] = leaf.cpu()
    del params
    torch.cuda.empty_cache()
    losses = torch.stack(losses)[:, spec.node_lo:spec.node_hi].cpu()
    return dict(losses=losses, params=mine, launches=launches)


@contextlib.contextmanager
def attention_without_to_model():
    """A planted fault, the training comparison's negative control: the
    attention block's inputs enter its sharded heads without ``to_model``,
    so each rank's backward gives them only its heads' part of their
    gradient, and a replicated leaf upstream gets a partial gradient."""
    from repro_torch.models import attention, tp

    orig = attention.tpl
    attention.tpl = types.SimpleNamespace(**vars(tp))
    attention.tpl.to_model = lambda t: t
    try:
        yield
    finally:
        attention.tpl = orig


def tp_param_errors(torch, params, want, init):
    """This rank's params against the world of one's slices ``want``: the
    max abs difference, and per leaf the norm of the difference over the
    norm of the world of one's change from ``init`` (one node's initial
    slices; every node starts there)."""
    from repro_torch.tree import flatten

    abs_err, rel = 0.0, {}
    for path, leaf in flatten(params).items():
        w = want[path].to(leaf.device, torch.float32)
        d = leaf.float() - w
        abs_err = max(abs_err, float(d.abs().max()))
        change = w.sub_(init[path].float())
        rel[path] = float(d.norm() / change.norm().clamp_min(1e-30))
        del w, d, change
    return abs_err, rel


def tp_train(torch, mesh, clock):
    """Phase 12's training half on this rank: the masked steps against the
    world of one, then overlap steps and the flush."""
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.core import named_graph, plan_matcha
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.dist import decen_train as dt
    from repro_torch.dist.sharding import use_rules
    from repro_torch.kernels.gossip_axpy import gossip_axpy
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd
    from repro_torch.tree import flatten, tree_map

    dev = mesh.device
    cfg = dataclasses.replace(get_config("internlm2_1_8b"), num_layers=2)
    model, opt = Model(cfg), sgd(0.05, momentum=0.9)
    plan = plan_matcha(named_graph("paper8", NODES, seed=3), 0.5, seed=0)
    total = TP_STEPS + TP_OVERLAP_STEPS
    schedule = plan.schedule(total, seed=0)
    data = DecentralizedBatches(cfg, NODES, BATCH, SEQ, seed=0, device=dev)
    batches = [next(data) for _ in range(total)]
    bits = [torch.as_tensor(schedule.activations[k].astype("float32"), device=dev)
            for k in range(total)]
    spec = dt.make_spec(mesh, NODES, cfg=cfg)
    ref = None
    for r in range(mesh.size):          # one rank at a time: the card holds one world of one
        if mesh.rank == r:
            t0 = time.perf_counter()
            ref = tp_reference_train(torch, model, opt, plan, batches, bits, spec)
            ref["s"] = time.perf_counter() - t0
        dist.barrier()
    with use_rules(spec.rules):
        params = dt.init_stacked_params(model, NODES, seed=0, device=dev)
        opt_state = dt.init_stacked_opt_state(opt, model, NODES, device=dev)
    if mesh.data > 1:                   # this data rank's nodes
        params, opt_state = (tree_map(lambda a: a.clone(), spec.local(t))
                             for t in (params, opt_state))
    step = dt.make_train_step(model, opt, plan, spec=spec)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    gossip_axpy.launches = 0
    losses, step_ms, coll_ms = [], [], []
    for k in range(TP_STEPS):
        c0 = clock.ms
        t0 = time.perf_counter()
        params, opt_state, loss, _ = step(params, opt_state, batches[k], bits[k])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        coll_ms.append(clock.ms - c0)
        losses.append(loss)
    launches = gossip_axpy.launches // TP_STEPS
    peak = torch.cuda.max_memory_allocated(dev)
    losses = torch.stack(losses).cpu()
    with use_rules(spec.rules):
        init = flatten(model.init(0, device=dev))
    params_err, params_rel = tp_param_errors(torch, params, ref["params"], init)
    # two overlap steps from here, then the flush
    ostep = dt.make_train_step(model, opt, plan, gossip_mode="overlap", spec=spec)
    gstate = dt.init_gossip_state(plan, ostep.bplan, device=dev, spec=spec)
    gossip_axpy.launches = 0
    ov_ms = []
    for k in range(TP_STEPS, total):
        t0 = time.perf_counter()
        params, opt_state, gstate, loss, _ = ostep(params, opt_state, gstate, batches[k],
                                                    bits[k])
        torch.cuda.synchronize()
        ov_ms.append((time.perf_counter() - t0) * 1e3)
    params = dt.make_gossip_flush(plan, ostep.bplan)(params, gstate, inplace=True)
    cons = float(dt.consensus_distance(params, spec))
    torch.cuda.synchronize()
    ov_launches = gossip_axpy.launches
    ov_loss = float(loss.float().mean())
    del params, opt_state, gstate
    torch.cuda.empty_cache()
    # the negative control: the masked steps again with a planted fault
    with use_rules(spec.rules):
        params = dt.init_stacked_params(model, NODES, seed=0, device=dev)
        opt_state = dt.init_stacked_opt_state(opt, model, NODES, device=dev)
    if mesh.data > 1:
        params, opt_state = (tree_map(lambda a: a.clone(), spec.local(t))
                             for t in (params, opt_state))
    fault_losses = []
    with attention_without_to_model():
        for k in range(TP_STEPS):
            params, opt_state, loss, _ = step(params, opt_state, batches[k], bits[k])
            fault_losses.append(loss)
    fault_abs, fault_rel = tp_param_errors(torch, params, ref["params"], init)
    fault_loss = float((torch.stack(fault_losses).cpu() - ref["losses"]).abs().max())
    del params, opt_state, init, ref["params"]
    torch.cuda.empty_cache()
    worst = max(params_rel, key=params_rel.get)
    fault_worst = max(fault_rel, key=fault_rel.get)
    mid = sorted(range(TP_STEPS), key=lambda k: step_ms[k])[TP_STEPS // 2]
    return dict(cfg=cfg.name, leaves=len(spec.split), params_per_node=model.num_params(),
                ref_launches=ref["launches"], launches=launches, ref_s=ref["s"],
                loss_err=float((losses - ref["losses"]).abs().max()),
                loss=float(losses[-1].mean()), params_err=params_err,
                params_rel=params_rel[worst], params_worst=worst,
                fault_loss=fault_loss, fault_abs=fault_abs,
                fault_rel=fault_rel[fault_worst], fault_worst=fault_worst,
                resident=resident, peak=peak, step_ms=step_ms, median_ms=step_ms[mid],
                coll_ms=coll_ms, overlap_ms=ov_ms, overlap_launches=ov_launches,
                overlap_loss=ov_loss, consensus=cons)


def tp_serve_run(torch, cfg, prompt, rules, clock, *, rows=None, feed=None):
    """One served batch (``SERVE_BATCH`` prompts, ``TP_GEN`` tokens, seed 0)
    under ``rules`` (None: the world of one): each step's last logits
    (the prefill's first), the tokens and each step's top-2 margin,
    times, launches, the kernels' input shapes and the collectives'
    time. ``feed``: the tokens each decode step takes, (B, TP_GEN), the
    world of one's (by default the batch's own). ``routes``: each step's
    experts of the last position at every MoE layer, sorted, (B, TP_GEN,
    layers x k) (zeros, one column, for a model without experts)."""
    import numpy as np

    from repro_torch.data.pipeline import SyntheticCorpus
    from repro_torch.dist import serve as sv
    from repro_torch.dist.sharding import no_rules, use_rules
    from repro_torch.models.transformer import Model

    counters = all_counters()
    dev = torch.device("cuda", torch.cuda.current_device())
    model = Model(cfg)
    max_len = prompt + TP_GEN
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    prompts = np.stack([corpus.sample(rng, prompt) for _ in range(SERVE_BATCH)])
    if rows is not None:
        prompts = prompts[rows]
    tokens = torch.as_tensor(prompts.astype(np.int32), device=dev)
    scope = use_rules(rules) if rules is not None else no_rules()
    with scope:
        params = model.init(0, device=dev)
        caches = model.init_cache(tokens.shape[0], max_len, device=dev)
    prefill = sv.make_prefill_step(model, rules, max_len=max_len)
    decode = sv.make_decode_step(model, rules, max_len=max_len)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0

    def top2(logits):
        v = torch.topk(logits[:, -1].float(), 2, dim=-1).values
        return (v[:, 0] - v[:, 1]).cpu()

    with KernelShapes() as shapes, Routes(tokens.shape[0]) as routes, \
            (no_rules() if rules is None else use_rules(rules)):
        c0 = clock.ms
        t0 = time.perf_counter()
        logits, caches = prefill(params, tokens, caches)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_coll = clock.ms - c0
        after = {k: fn.launches for k, fn in counters.items()}
        steps = [logits[:, -1].float().cpu()]
        out, margins = [torch.argmax(logits[:, -1], dim=-1)], [top2(logits)]
        c0 = clock.ms
        t0 = time.perf_counter()
        for i in range(TP_GEN - 1):
            nxt = out[-1] if feed is None else feed[:, i].to(dev)
            logits, caches = decode(params, nxt[:, None].to(torch.int32), caches,
                                    prompt + i)
            out.append(torch.argmax(logits[:, -1], dim=-1))
            margins.append(top2(logits))
            steps.append(logits[:, -1].float().cpu())
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / (TP_GEN - 1)
        decode_coll = (clock.ms - c0) / (TP_GEN - 1)
    res = dict(prefill_ms=prefill_ms, decode_ms=decode_ms, prefill_coll=prefill_coll,
               decode_coll=decode_coll, logits=torch.stack(steps, dim=1),
               tokens=torch.stack(out, dim=1).cpu(), margins=torch.stack(margins, dim=1),
               routes=routes.table(TP_GEN),
               prefill_launches={k: n for k, n in after.items() if n},
               decode_launches={k: fn.launches - after[k] for k, fn in counters.items()
                                if fn.launches - after[k]},
               peak=torch.cuda.max_memory_allocated(dev), shapes=shapes.lines())
    del params, caches, logits
    torch.cuda.empty_cache()
    return res


def serve_agree(got: dict, want: dict, rows) -> dict:
    """A batch served on the world of one's tokens (``tp_serve_run``'s
    ``feed``) against the world of one's ``rows``. Each step whose last
    position the routers sent to the world of one's experts at every MoE
    layer counts (a top-k choice that rounding flips changes that
    position's output by a whole expert's term: such steps are counted
    apart, with their logits difference): its last logits must lie within
    ``TP_LOGIT_TOL``, and its token must equal the world of one's where
    the top-2 margin is over twice that (each side's logits may move by
    the tolerance, so below that the argmax may rightly differ). At most
    a quarter of the steps may be routed otherwise."""
    import torch

    logits, tokens, margins, routes = (want[k][rows]
                                       for k in ("logits", "tokens", "margins", "routes"))
    same = (got["routes"] == routes).all(dim=-1)                  # (B, steps)
    diff = (got["logits"] - logits).abs().amax(dim=-1)
    sure = (margins > 2 * TP_LOGIT_TOL) & same
    res = dict(logits_err=float(diff[same].max()) if same.any() else math.inf,
               rerouted=int((~same).sum()), steps=same.numel(),
               rerouted_err=float(diff[~same].max()) if (~same).any() else 0.0,
               compared=int(sure.sum()),
               tokens_ok=torch.equal(got["tokens"][sure].long(), tokens[sure].long()))
    res["ok"] = (res["logits_err"] <= TP_LOGIT_TOL and res["tokens_ok"]
                 and 4 * res["rerouted"] <= res["steps"])
    return res


def _share(torch, res: dict, keys, src: int = 0) -> dict:
    """``res``'s tensors at ``keys`` broadcast from rank ``src`` (the world
    of one's, which one rank computed)."""
    import torch.distributed as dist

    out = {}
    for key in keys:
        t = res[key] if res is not None else None
        shape = torch.zeros(4, dtype=torch.float32, device="cuda")    # ndim, then dims
        if t is not None:
            shape[:t.dim() + 1] = torch.tensor([t.dim()] + list(t.shape))
        dist.broadcast(shape, src)
        dims = [int(x) for x in shape.tolist()]
        buf = (t.to("cuda", torch.float32) if t is not None
               else torch.empty(dims[1:1 + dims[0]], device="cuda"))
        dist.broadcast(buf, src)
        out[key] = buf.cpu()
    return out


def tp_serve(torch, mesh, clock):
    """Phase 12's serving half on this rank: each model at T 2 against the
    world of one (which rank 0 serves first, its results broadcast)."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import serve_rules

    configs = {cfg.name: (cfg, prompt, pre, dec) for cfg, prompt, pre, dec in serving_configs()}
    per = SERVE_BATCH // mesh.data
    rows = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)
    out = {}
    for name in TP_SERVED:
        cfg, prompt, pre, dec = configs[name]
        ref = None
        if mesh.rank == 0:
            ref = tp_serve_run(torch, cfg, prompt, None, clock)
        dist.barrier()
        want = _share(torch, ref, ("logits", "tokens", "margins", "routes"))
        got = tp_serve_run(torch, cfg, prompt, serve_rules(mesh, cfg), clock, rows=rows,
                           feed=want["tokens"][rows].long())
        expect_pre = {k: n for k, n in pre.items() if n}
        expect_dec = {k: n * (TP_GEN - 1) for k, n in dec.items() if n}
        out[name] = dict(
            layers=cfg.num_layers, prefill_ms=got["prefill_ms"], decode_ms=got["decode_ms"],
            prefill_coll=got["prefill_coll"], decode_coll=got["decode_coll"],
            peak=got["peak"], shapes=got["shapes"],
            ref_prefill_ms=ref["prefill_ms"] if ref else None,
            ref_decode_ms=ref["decode_ms"] if ref else None,
            ref_peak=ref["peak"] if ref else None,
            ref_launches=(ref["prefill_launches"], ref["decode_launches"]) if ref else None,
            launches=(got["prefill_launches"], got["decode_launches"]),
            expected=(expect_pre, expect_dec),
            tokens=got["tokens"][0].tolist(), ref_tokens=want["tokens"][0].long().tolist())
        out[name].update(serve_agree(got, want, rows))
        if name == TP_SERVED[0]:
            out["_dense_ref"] = want
        dist.barrier()
    return out


def tp_data_par(torch, mesh, clock, want):
    """``--data-par 2`` on the same ranks (model axis 1): each serves half
    the requests of internlm2-1.8b, against the world of one's rows."""
    configs = {cfg.name: (cfg, prompt) for cfg, prompt, _, _ in serving_configs()}
    cfg, prompt = configs[TP_SERVED[0]]
    per = SERVE_BATCH // mesh.data
    rows = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)
    got = tp_serve_run(torch, cfg, prompt, None, clock, rows=rows,
                       feed=want["tokens"][rows].long())
    return dict(rows=per, prefill_ms=got["prefill_ms"], decode_ms=got["decode_ms"],
                **serve_agree(got, want, rows))


def _tp_rank(rank: int, world: int, init_method: str, backend: str, out: str) -> None:
    """One rank of phase 12's world; writes its results to ``out.<rank>``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.mesh import init_world, make_mesh

    device = init_world("cuda", rank=rank, world_size=world, init_method=init_method,
                        backend=backend)
    try:
        clock = CommClock(torch)
        mesh = make_mesh(model=TP, device=device)
        t0 = time.perf_counter()
        res = {"train": tp_train(torch, mesh, clock)}
        res["train_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["serve"] = tp_serve(torch, mesh, clock)
        want = res["serve"].pop("_dense_ref")
        res["serve_s"] = time.perf_counter() - t0
        if world == TP:
            t0 = time.perf_counter()
            res["data_par"] = tp_data_par(torch, make_mesh(model=1, device=device), clock, want)
            res["data_par_s"] = time.perf_counter() - t0
        res["collectives"] = [clock.by_entry["all_reduce"], clock.calls["all_reduce"],
                              clock.bytes["all_reduce"]]
        with open(f"{out}.{rank}", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def phase_tp(torch):
    """Phase 12 (see the module docstring)."""
    import tempfile

    from repro_torch.launch.mesh import spawn

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    backend, share = tp_world(cards)
    worlds = [TP] + ([2 * TP] if cards >= 2 * TP else [])
    if share:
        log(f"tp: {cards} CUDA card here: a world of {TP} ranks shares it over gloo "
            "(its all-reduce takes CUDA tensors; NCCL puts one rank on a card)")
    else:
        log(f"tp: {cards} CUDA cards: worlds over NCCL, a card a rank")
    torch.cuda.empty_cache()
    results = {}
    for world in worlds:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "rank")
            spawn(_tp_rank, world, "cuda", args=(backend, out), share=share)
            results[world] = [json.load(open(f"{out}.{r}")) for r in range(world)]
    failures = []
    gb = lambda b: f"{b / 1e9:.2f} GB"
    for world, ranks in results.items():
        tag = f"tp: world {world} ({'data 2 x ' if world > TP else ''}model {TP}, {backend})"
        for r, res in enumerate(ranks):
            t = res["train"]
            log(f"{tag} rank {r}: training {t['cfg']} at 2 layers, {NODES} nodes on paper8, "
                f"{t['params_per_node']} params a node ({t['leaves']} leaves split): 3 masked "
                f"steps {', '.join(f'{x:.1f}' for x in t['step_ms'])} ms (median "
                f"{t['median_ms']:.1f}; in its collectives "
                f"{', '.join(f'{x:.1f}' for x in t['coll_ms'])} ms); resident "
                f"{gb(t['resident'])}, peak {gb(t['peak'])}; gossip_axpy launches a step "
                f"{t['launches']} (world of one {t['ref_launches']}); against the world "
                f"of one: loss max diff {t['loss_err']:.3e}, params max diff "
                f"{t['params_err']:.3e}, params difference over change {t['params_rel']:.3e} "
                f"at {t['params_worst']} (limits {TP_TRAIN_TOL}); planted fault (attention "
                f"without to_model): loss {t['fault_loss']:.3e}, params max diff "
                f"{t['fault_abs']:.3e}, over change {t['fault_rel']:.3e} at "
                f"{t['fault_worst']}; last loss {t['loss']:.4f}; "
                f"then {TP_OVERLAP_STEPS} overlap steps "
                f"{', '.join(f'{x:.1f}' for x in t['overlap_ms'])} ms and the flush: "
                f"{t['overlap_launches']} gossip_axpy launches, consensus "
                f"{t['consensus']:.3e}; world of one on this rank {t['ref_s']:.1f} s")
            if t["launches"] != t["ref_launches"]:
                failures.append(f"rank {r}: {t['launches']} gossip_axpy launches a step, the "
                                f"world of one {t['ref_launches']}")
            want_ov = t["ref_launches"] * (TP_OVERLAP_STEPS + 1)
            if t["overlap_launches"] != want_ov:
                failures.append(f"rank {r}: {t['overlap_launches']} overlap launches, "
                                f"expected {want_ov}")
            if not (t["loss_err"] <= TP_TRAIN_TOL["loss"]
                    and t["params_rel"] <= TP_TRAIN_TOL["params"]):
                failures.append(f"rank {r}: training past {TP_TRAIN_TOL}: loss "
                                f"{t['loss_err']:.3e}, params {t['params_rel']:.3e}")
            if t["fault_rel"] <= TP_TRAIN_TOL["params"]:
                failures.append(f"rank {r}: the planted fault passed the params limit "
                                f"({t['fault_rel']:.3e})")
            if not (math.isfinite(t["overlap_loss"]) and math.isfinite(t["consensus"])):
                failures.append(f"rank {r}: overlap loss or consensus not finite")
            for name, s in res["serve"].items():
                log(f"{tag} rank {r}: serving {name} ({s['layers']} layers) batch "
                    f"{SERVE_BATCH} prompt {SERVE_PROMPT} gen {TP_GEN}: prefill "
                    f"{s['prefill_ms']:.1f} ms (all-reduces {s['prefill_coll']:.1f} ms), "
                    f"decode {s['decode_ms']:.2f} ms/token (all-reduces "
                    f"{s['decode_coll']:.2f} ms/token), peak {gb(s['peak'])}"
                    + (f"; world of one prefill {s['ref_prefill_ms']:.1f} ms, decode "
                       f"{s['ref_decode_ms']:.2f} ms/token, peak {gb(s['ref_peak'])}"
                       if s["ref_prefill_ms"] else "")
                    + f"; launches (prefill, decode) {s['launches']}, expected "
                    f"{s['expected']}; kernel inputs: {s['shapes']}; fed the world of "
                    f"one's tokens: {s['rerouted']} of {s['steps']} request steps routed to "
                    f"other experts (logits max diff there {s['rerouted_err']:.3e}), the "
                    f"others' last logits max diff {s['logits_err']:.3e} (limit "
                    f"{TP_LOGIT_TOL}); {s['compared']} tokens past a top-2 margin of "
                    f"{2 * TP_LOGIT_TOL} agree {s['tokens_ok']}: {s['tokens']} (world of "
                    f"one {s['ref_tokens']})")
                if [dict(x) for x in s["launches"]] != [dict(x) for x in s["expected"]]:
                    failures.append(f"rank {r} {name}: launches {s['launches']}, expected "
                                    f"{s['expected']}")
                if s["ref_launches"] is not None and \
                        [dict(x) for x in s["ref_launches"]] != [dict(x) for x in s["launches"]]:
                    failures.append(f"rank {r} {name}: launches {s['launches']}, the world "
                                    f"of one {s['ref_launches']}")
                if not s["ok"]:
                    failures.append(f"rank {r} {name}: logits max diff {s['logits_err']:.3e}, "
                                    f"tokens agree {s['tokens_ok']}, {s['rerouted']} of "
                                    f"{s['steps']} steps routed otherwise")
            d = res.get("data_par")
            if d:
                log(f"tp: data 2 x model 1 on the same ranks ({backend}), rank {r}: "
                    f"internlm2-1.8b, {d['rows']} of {SERVE_BATCH} requests: prefill "
                    f"{d['prefill_ms']:.1f} ms, decode {d['decode_ms']:.2f} ms/token; "
                    f"every step's last logits max diff {d['logits_err']:.3e}; "
                    f"{d['compared']} tokens past the margin agree {d['tokens_ok']}")
                if not d["ok"]:
                    failures.append(f"rank {r} data-par: logits {d['logits_err']:.3e} or "
                                    "tokens past the tolerance")
            ms, calls, nbytes = res["collectives"]
            log(f"{tag} rank {r}: {calls} all-reduces of {nbytes / 1e9:.2f} GB (fp32) in "
                f"{ms / 1e3:.1f} s; training {res['train_s']:.1f} s, serving "
                f"{res['serve_s']:.1f} s" + (f", data-par {res['data_par_s']:.1f} s"
                                             if "data_par_s" in res else ""))
    if cards < 2 * TP:
        log(f"tp: {cards} CUDA card(s): the (data 2, model 2) world over NCCL was not run "
            f"(it needs {2 * TP} cards; the CPU tests hold it over gloo)")
    log(f"tp: phase {time.perf_counter() - t_phase:.1f} s")
    if failures:
        fail("tp: " + "; ".join(failures))


# ---------------------------------------------------------------------------
# Phase 13: sequence parallel, kv-seq-sharded serving, the inventory
# ---------------------------------------------------------------------------
SP_PROMPT = 512                 # phase 13's served prompt (batch SERVE_BATCH)


@contextlib.contextmanager
def kv_seq_without_o_reduce():
    """A planted fault, the kv-seq serving comparison's negative control:
    flash-decoding's combine (``models.attention._sdpa_split``) skips its
    third all-reduce, the unnormalized outputs, so each rank divides its
    own slots' output by the sum over every rank's slots."""
    from repro_torch.dist import comm
    from repro_torch.models import attention

    orig_split, orig_reduce = attention._sdpa_split, comm.all_reduce

    def split(*args, **kw):
        calls = []

        def all_reduce(t, group, op="sum"):
            calls.append(op)
            return t if len(calls) == 3 else orig_reduce(t, group, op)

        comm.all_reduce = all_reduce
        try:
            return orig_split(*args, **kw)
        finally:
            comm.all_reduce = orig_reduce

    attention._sdpa_split = split
    try:
        yield
    finally:
        attention._sdpa_split = orig_split


@contextlib.contextmanager
def sp_without_reduce_scatter():
    """A planted fault, the sequence-parallel comparison's negative
    control: each block's row-parallel output skips its reduce-scatter,
    so each rank keeps only its own partial sum of its sequence slice."""
    from repro_torch.models import tp

    orig = tp._SeqReduceScatter.forward

    def forward(ctx, x, tp_):
        ctx.tp = tp_
        return tp._slice_seq(x, tp_)

    tp._SeqReduceScatter.forward = staticmethod(forward)
    try:
        yield
    finally:
        tp._SeqReduceScatter.forward = orig


def meta_view_records(cfg, mesh_rank, *, train: bool, batches=None, bits=None, plan=None,
                      prompt: int = 0):
    """The one-process meta inventory of this rank on the phase's mesh
    (``virtual_mesh(model=TP)``): one sequence-parallel masked step, or a
    kv-seq-sharded prefill and one decode step."""
    from repro_torch.analysis.collectives import collect
    from repro_torch.dist import decen_train as dt
    from repro_torch.dist import serve as sv
    from repro_torch.dist.sharding import serve_rules, use_rules
    from repro_torch.launch.mesh import virtual_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd

    vm = virtual_mesh(model=TP, rank=mesh_rank)
    model = Model(cfg)
    if train:
        opt = sgd(0.05, momentum=0.9)
        spec = dt.make_spec(vm, NODES, cfg=cfg, sequence_parallel=True)
        with use_rules(spec.rules):
            params = dt.init_stacked_params(model, NODES, seed=0, device="meta")
            state = dt.init_stacked_opt_state(opt, model, NODES, device="meta")
        step = dt.make_train_step(model, opt, plan, spec=spec)
        batch = {k: v.to("meta") for k, v in batches[0].items()}
        return collect(step, params, state, batch, bits[0].cpu().numpy())
    rules = serve_rules(vm, cfg, kv_seq_sharded=True)
    max_len = prompt + TP_GEN
    with use_rules(rules):
        params = model.init(0, device="meta")
        caches = model.init_cache(SERVE_BATCH, max_len, device="meta")
    prefill = sv.make_prefill_step(model, rules, max_len=max_len)
    decode = sv.make_decode_step(model, rules, max_len=max_len)
    toks = torch_empty_tokens(SERVE_BATCH, prompt)
    one = torch_empty_tokens(SERVE_BATCH, 1)

    def run():
        prefill(params, toks, caches)
        decode(params, one, caches, prompt)

    return collect(run)


def torch_empty_tokens(b: int, s: int):
    import torch

    return torch.empty((b, s), dtype=torch.int32, device="meta")


def sp_train(torch, mesh, clock):
    """Phase 13's training half on this rank: 3 sequence-parallel masked
    steps against the world of one (phase 12's reference, whose slices
    are the same: sequence parallel splits no parameter), the first
    step's collectives against the meta view, then the steps again with a
    planted fault."""
    from repro_torch.analysis.collectives import collect, inventory
    from repro_torch.configs.registry import get_config
    from repro_torch.core import named_graph, plan_matcha
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.dist import decen_train as dt
    from repro_torch.dist.sharding import use_rules
    from repro_torch.kernels.gossip_axpy import gossip_axpy
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd
    from repro_torch.tree import flatten

    import torch.distributed as dist

    dev = mesh.device
    cfg = dataclasses.replace(get_config("internlm2_1_8b"), num_layers=2)
    model, opt = Model(cfg), sgd(0.05, momentum=0.9)
    plan = plan_matcha(named_graph("paper8", NODES, seed=3), 0.5, seed=0)
    schedule = plan.schedule(TP_STEPS, seed=0)
    data = DecentralizedBatches(cfg, NODES, BATCH, SEQ, seed=0, device=dev)
    batches = [next(data) for _ in range(TP_STEPS)]
    bits = [torch.as_tensor(schedule.activations[k].astype("float32"), device=dev)
            for k in range(TP_STEPS)]
    spec = dt.make_spec(mesh, NODES, cfg=cfg, sequence_parallel=True)
    ref = None
    for r in range(mesh.size):          # one rank at a time: the card holds one world of one
        if mesh.rank == r:
            t0 = time.perf_counter()
            ref = tp_reference_train(torch, model, opt, plan, batches, bits, spec)
            ref["s"] = time.perf_counter() - t0
        dist.barrier()

    def fresh():
        with use_rules(spec.rules):
            return (dt.init_stacked_params(model, NODES, seed=0, device=dev),
                    dt.init_stacked_opt_state(opt, model, NODES, device=dev))

    params, opt_state = fresh()
    step = dt.make_train_step(model, opt, plan, spec=spec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    gossip_axpy.launches = 0
    losses, step_ms, coll_ms = [], [], []
    records = None
    for k in range(TP_STEPS):
        c0 = clock.ms
        t0 = time.perf_counter()
        if k == 0:
            out = {}

            def first():
                out["r"] = step(params, opt_state, batches[k], bits[k])

            # autograd's backward runs on its own thread on the card: the
            # c10d dispatch count is taken by the CPU tests
            records = collect(first)
            params, opt_state, loss, _ = out.pop("r")
        else:
            params, opt_state, loss, _ = step(params, opt_state, batches[k], bits[k])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        coll_ms.append(clock.ms - c0)
        losses.append(loss)
    launches = gossip_axpy.launches // TP_STEPS
    peak = torch.cuda.max_memory_allocated(dev)
    losses = torch.stack(losses).cpu()
    with use_rules(spec.rules):
        init = flatten(model.init(0, device=dev))
    params_err, params_rel = tp_param_errors(torch, params, ref["params"], init)
    del params, opt_state
    torch.cuda.empty_cache()
    meta = meta_view_records(cfg, mesh.model_rank, train=True, batches=batches, bits=bits,
                             plan=plan)
    inv_real, inv_meta = inventory(records), inventory(meta)
    params, opt_state = fresh()
    fault_losses = []
    with sp_without_reduce_scatter():
        for k in range(TP_STEPS):
            params, opt_state, loss, _ = step(params, opt_state, batches[k], bits[k])
            fault_losses.append(loss)
    fault_abs, fault_rel = tp_param_errors(torch, params, ref["params"], init)
    fault_loss = float((torch.stack(fault_losses).cpu() - ref["losses"]).abs().max())
    del params, opt_state, init, ref["params"]
    torch.cuda.empty_cache()
    worst = max(params_rel, key=params_rel.get)
    fault_worst = max(fault_rel, key=fault_rel.get)
    kinds = {}
    for (kind, axes, dtype, nbytes), n in inv_real.items():
        kinds[kind] = kinds.get(kind, 0) + n
    return dict(cfg=cfg.name, launches=launches, ref_launches=ref["launches"], ref_s=ref["s"],
                loss_err=float((losses - ref["losses"]).abs().max()),
                loss=float(losses[-1].mean()), params_err=params_err,
                params_rel=params_rel[worst], params_worst=worst, fault_loss=fault_loss,
                fault_abs=fault_abs, fault_rel=fault_rel[fault_worst],
                fault_worst=fault_worst, peak=peak, step_ms=step_ms, coll_ms=coll_ms,
                inventory_equal=inv_real == inv_meta, inventory_ops=sum(inv_real.values()),
                inventory_kinds=kinds,
                inventory_diff=sorted(str(k) for k in set(inv_real.items())
                                      ^ set(inv_meta.items()))[:6])


def sp_serve(torch, mesh, clock):
    """Phase 13's serving half on this rank: internlm2-1.8b with the KV
    caches split over their positions at T 2, fed the world of one's
    tokens (rank 0 serves that first), the same with a planted fault
    (``kv_seq_without_o_reduce``) that must exceed the logits limit, its
    flash launches against the dry run's, and a prefill and decode step's
    collectives against the meta view."""
    import torch.distributed as dist

    from repro_torch.analysis.collectives import collect, inventory
    from repro_torch.dist import serve as sv
    from repro_torch.dist.sharding import serve_rules, use_rules
    from repro_torch.launch import dryrun
    from repro_torch.models.transformer import Model

    configs = {cfg.name: cfg for cfg, _, _, _ in serving_configs()}
    cfg = configs[TP_SERVED[0]]
    ref = None
    if mesh.rank == 0:
        ref = tp_serve_run(torch, cfg, SP_PROMPT, None, clock)
    dist.barrier()
    want = _share(torch, ref, ("logits", "tokens", "margins", "routes"))
    rules = serve_rules(mesh, cfg, kv_seq_sharded=True)
    got = tp_serve_run(torch, cfg, SP_PROMPT, rules, clock, feed=want["tokens"].long())
    agree = serve_agree(got, want, slice(None))
    with kv_seq_without_o_reduce():
        bad = tp_serve_run(torch, cfg, SP_PROMPT, rules, clock, feed=want["tokens"].long())
    fault_logits = serve_agree(bad, want, slice(None))["logits_err"]
    # the dry run of this rank on the same mesh: its kernel launches
    vm = dryrun.production_mesh(multi_pod=False, rank=mesh.rank, dims=(1, TP))
    pre = dryrun.trace(lambda: dryrun.mesh_serve_call(
        cfg, mesh=vm, multi_pod=False, kv_seq_shard=True, kind="prefill",
        batch=SERVE_BATCH, seq=SP_PROMPT)[:2])
    dec = dryrun.trace(lambda: dryrun.mesh_serve_call(
        cfg, mesh=vm, multi_pod=False, kv_seq_shard=True, kind="decode",
        batch=SERVE_BATCH, seq=SP_PROMPT)[:2])
    predicted = ({k: n for k, n in pre.launches.items() if n},
                 {k: n * (TP_GEN - 1) for k, n in dec.launches.items() if n})
    # one prefill and one decode step on the card, recorded
    model = Model(cfg)
    max_len = SP_PROMPT + TP_GEN
    with use_rules(rules):
        params = model.init(0, device=mesh.device)
        caches = model.init_cache(SERVE_BATCH, max_len, device=mesh.device)
    prefill = sv.make_prefill_step(model, rules, max_len=max_len)
    decode = sv.make_decode_step(model, rules, max_len=max_len)
    toks = torch.zeros((SERVE_BATCH, SP_PROMPT), dtype=torch.int32, device=mesh.device)

    def run():
        prefill(params, toks, caches)
        decode(params, toks[:, :1], caches, SP_PROMPT)

    real = collect(run)
    del params, caches
    torch.cuda.empty_cache()
    meta = meta_view_records(cfg, mesh.model_rank, train=False, prompt=SP_PROMPT)
    return dict(layers=cfg.num_layers, prefill_ms=got["prefill_ms"],
                decode_ms=got["decode_ms"], prefill_coll=got["prefill_coll"],
                decode_coll=got["decode_coll"], peak=got["peak"], shapes=got["shapes"],
                ref_prefill_ms=ref["prefill_ms"] if ref else None,
                ref_decode_ms=ref["decode_ms"] if ref else None,
                launches=(got["prefill_launches"], got["decode_launches"]),
                predicted=predicted, tokens=got["tokens"][0].tolist(),
                ref_tokens=want["tokens"][0].long().tolist(),
                inventory_equal=inventory(real) == inventory(meta),
                inventory_ops=len(real), fault_logits=fault_logits, **agree)


def _sp_rank(rank: int, world: int, init_method: str, backend: str, out: str) -> None:
    """One rank of phase 13's world; writes its results to ``out.<rank>``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.mesh import init_world, make_mesh

    device = init_world("cuda", rank=rank, world_size=world, init_method=init_method,
                        backend=backend)
    try:
        clock = CommClock(torch)
        mesh = make_mesh(model=TP, device=device)
        t0 = time.perf_counter()
        res = {"train": sp_train(torch, mesh, clock)}
        res["train_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["serve"] = sp_serve(torch, mesh, clock)
        res["serve_s"] = time.perf_counter() - t0
        res["collectives"] = {"ms": clock.by_entry, "calls": clock.calls,
                              "bytes": clock.bytes}
        with open(f"{out}.{rank}", "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _pod_rank(rank: int, world: int, init_method: str, out: str) -> None:
    """One rank of the (pod 2, data 1) NCCL world: 3 masked steps of the
    tiny fp32 model, 8 nodes on paper8, against the single-process step."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, SRC)
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core import named_graph, plan_matcha
    from repro_torch.data.pipeline import DecentralizedBatches
    from repro_torch.dist import decen_train as dt
    from repro_torch.launch.mesh import init_world, make_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd
    from repro_torch.tree import flatten, tree_map

    device = init_world("cuda", rank=rank, world_size=world, init_method=init_method)
    try:
        cfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), compute_dtype="float32")
        model, opt = Model(cfg), sgd(0.05, momentum=0.9)
        plan = plan_matcha(named_graph("paper8", NODES, seed=3), 0.5, seed=0)
        sched = plan.schedule(3, seed=0)
        it = DecentralizedBatches(cfg, NODES, 2, 32, seed=0, device=device)
        batches = [next(it) for _ in range(3)]
        spec = dt.make_spec(make_mesh(multi_pod=True, device=device), NODES, multi_pod=True)
        res = {}
        for name, sp in (("one", None), ("pod", spec)):
            params = dt.init_stacked_params(model, NODES, device=device)
            state = dt.init_stacked_opt_state(opt, model, NODES, device=device)
            if sp is not None:
                params, state = sp.local(params), sp.local(state)
            step = dt.make_train_step(model, opt, plan, spec=sp)
            for k in range(3):
                params, state, _, _ = step(params, state, batches[k],
                                           sched.activations[k].astype(np.float32))
            res[name] = params
        mine = tree_map(lambda a: a[spec.node_lo:spec.node_hi], res["one"])
        err = max(float((flatten(res["pod"])[k] - v).abs().max())
                  for k, v in flatten(mine).items())
        with open(f"{out}.{rank}", "w") as f:
            json.dump({"params_err": err}, f)
    finally:
        dist.destroy_process_group()


def phase_sp(torch):
    """Phase 13 (see the module docstring)."""
    import tempfile

    from repro_torch.launch.mesh import spawn

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    backend, share = tp_world(cards)
    log(f"sp: {cards} CUDA card(s): a world of {TP} ranks over {backend}"
        + (" sharing the card (repro_torch.dist.comm moves gloo's all-gather, "
           "reduce-scatter and send/recv of CUDA tensors through host copies)" if share else ""))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank")
        spawn(_sp_rank, TP, "cuda", args=(backend, out), share=share)
        ranks = [json.load(open(f"{out}.{r}")) for r in range(TP)]
    failures = []
    gb = lambda b: f"{b / 1e9:.2f} GB"
    for r, res in enumerate(ranks):
        t, s = res["train"], res["serve"]
        log(f"sp: rank {r}: sequence-parallel training {t['cfg']} at 2 layers, {NODES} nodes "
            f"on paper8, {BATCH} x {SEQ} tokens a node: 3 masked steps "
            f"{', '.join(f'{x:.1f}' for x in t['step_ms'])} ms (in collectives "
            f"{', '.join(f'{x:.1f}' for x in t['coll_ms'])} ms); peak {gb(t['peak'])}; "
            f"gossip_axpy launches a step {t['launches']} (world of one "
            f"{t['ref_launches']}); against the world of one: loss max diff "
            f"{t['loss_err']:.3e}, params max diff {t['params_err']:.3e}, params difference "
            f"over change {t['params_rel']:.3e} at {t['params_worst']} (limits "
            f"{TP_TRAIN_TOL}); planted fault (the row-parallel outputs skip their "
            f"reduce-scatter): loss {t['fault_loss']:.3e}, over change {t['fault_rel']:.3e} "
            f"at {t['fault_worst']}; the first step's inventory ({t['inventory_ops']} ops, "
            f"{t['inventory_kinds']}) equals the meta view's: {t['inventory_equal']}"
            + (f" (differs: {t['inventory_diff']})" if not t["inventory_equal"] else ""))
        log(f"sp: rank {r}: kv-seq-sharded serving internlm2-1.8b ({s['layers']} layers) "
            f"batch {SERVE_BATCH} prompt {SP_PROMPT} gen {TP_GEN}: prefill "
            f"{s['prefill_ms']:.1f} ms (collectives {s['prefill_coll']:.1f} ms), decode "
            f"{s['decode_ms']:.2f} ms/token (collectives {s['decode_coll']:.2f} ms/token), "
            f"peak {gb(s['peak'])}"
            + (f"; world of one prefill {s['ref_prefill_ms']:.1f} ms, decode "
               f"{s['ref_decode_ms']:.2f} ms/token" if s["ref_prefill_ms"] else "")
            + f"; launches (prefill, decode) {s['launches']}, the dry run's {s['predicted']}; "
            f"kernel inputs: {s['shapes']}; fed the world of one's tokens: last logits max "
            f"diff {s['logits_err']:.3e} (limit {TP_LOGIT_TOL}; planted fault, the combine "
            f"without its outputs' all-reduce: {s['fault_logits']:.3e}); {s['compared']} "
            f"tokens past "
            f"the margin agree {s['tokens_ok']}: {s['tokens']} (world of one "
            f"{s['ref_tokens']}); a prefill and decode step's inventory ({s['inventory_ops']} "
            f"ops) equals the meta view's: {s['inventory_equal']}")
        c = res["collectives"]
        log(f"sp: rank {r}: collectives by entry {c['calls']} in ms "
            f"{ {k: round(v, 1) for k, v in c['ms'].items()} }, GB "
            f"{ {k: round(v / 1e9, 3) for k, v in c['bytes'].items()} }; training {res['train_s']:.1f} s, "
            f"serving {res['serve_s']:.1f} s")
        if t["launches"] != t["ref_launches"]:
            failures.append(f"rank {r}: {t['launches']} gossip_axpy launches a step, the world "
                            f"of one {t['ref_launches']}")
        if not (t["loss_err"] <= TP_TRAIN_TOL["loss"]
                and t["params_rel"] <= TP_TRAIN_TOL["params"]):
            failures.append(f"rank {r}: sequence-parallel training past {TP_TRAIN_TOL}: loss "
                            f"{t['loss_err']:.3e}, params {t['params_rel']:.3e}")
        if t["fault_rel"] <= TP_TRAIN_TOL["params"]:
            failures.append(f"rank {r}: the planted fault passed the params limit "
                            f"({t['fault_rel']:.3e})")
        if not (t["inventory_equal"] and s["inventory_equal"]):
            failures.append(f"rank {r}: a recorded inventory differs from its meta view")
        if [dict(x) for x in s["launches"]] != [dict(x) for x in s["predicted"]]:
            failures.append(f"rank {r}: serving launches {s['launches']}, the dry run "
                            f"predicts {s['predicted']}")
        if not s["ok"]:
            failures.append(f"rank {r}: kv-seq serving logits {s['logits_err']:.3e}, tokens "
                            f"agree {s['tokens_ok']}")
        if s["fault_logits"] <= TP_LOGIT_TOL:
            failures.append(f"rank {r}: the planted serving fault passed the logits limit "
                            f"({s['fault_logits']:.3e})")
    if cards >= 2:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "rank")
            spawn(_pod_rank, 2, "cuda", args=(out,))
            errs = [json.load(open(f"{out}.{r}"))["params_err"] for r in range(2)]
        log(f"sp: (pod 2, data 1) over NCCL, 3 masked steps of the tiny fp32 model against "
            f"one process: params max diff {max(errs):.3e}")
        if max(errs) > 0:
            failures.append(f"pod gossip over NCCL differs from one process ({max(errs):.3e})")
    else:
        log(f"sp: {cards} CUDA card: the (pod 2, data 1) gossip over NCCL was not run (it "
            "needs 2 cards; the CPU tests hold the pod axis over gloo)")
    log(f"sp: phase {time.perf_counter() - t_phase:.1f} s")
    if failures:
        fail("sp: " + "; ".join(failures))


def check_overlap_apply(torch, bplan, alpha, params, gstate):
    """The pending correction landed on every leaf through the kernel and
    through the plain version, out of place, from the same state: bit
    for bit."""
    import functools

    from repro_torch.dist import bucketing
    from repro_torch.dist.decen_train import apply_delayed_leaf

    gstate.wait()
    n = 0
    for i, bkt, off, size in bucketing.leaf_slices(bplan, gstate.delta):
        path = bplan.treedef[i]
        x = functools.reduce(lambda t, key: t[key], path, params)
        d = bkt[:, off:off + size]
        got = apply_delayed_leaf(x, d, alpha, impl="cuda")
        want = apply_delayed_leaf(x, d, alpha, impl="torch")
        if not torch.equal(got, want):
            fail(f"overlap: {'.'.join(path)} differs between kernel and plain delayed apply")
        n += 1
        del got, want
    log(f"overlap: the pending correction through the kernel and through the plain version "
        f"from the same state agree bit for bit on all {n} leaves")


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
    check_overlap_small(torch, model, opt, plan, data)

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
    for arch in FAMILY_ARCHS:
        gossip_axpy.launches = 0
        rows = train.main(["--preset", "tiny", "--steps", "3", "--arch", arch])
        leaves = len(flatten(Model(get_smoke_config(arch)).param_shapes()))
        log(f"check: launch.train --arch {arch} --preset tiny --steps 3 on the card: "
            f"gossip_axpy launches {gossip_axpy.launches}, losses "
            f"{[round(r['loss'], 4) for r in rows]}")
        if gossip_axpy.launches != 3 * leaves:
            fail(f"launch.train --arch {arch}: {gossip_axpy.launches} gossip_axpy launches, "
                 f"expected {3 * leaves}")
        if not all(math.isfinite(r["loss"]) and math.isfinite(r["consensus"]) for r in rows):
            fail(f"launch.train --arch {arch}: non-finite loss or consensus")
    check_crash_resume(torch)
    check_overlap_crash_resume(torch)
    check_traces(torch)


def check_overlap_small(torch, model, opt, plan, data):
    """Three tiny fp32 overlap steps and the flush on the card (side
    stream, kernel) and on the CPU (in order, plain version), from the
    same weights and batches: params, deltas and losses within
    SMALL_TOL."""
    from repro_torch.dist import decen_train as dt
    from repro_torch.tree import flatten, tree_map

    steps = 3
    sched = plan.schedule(steps, seed=2)
    batches = [next(data) for _ in range(steps)]
    bplan = dt.param_bucket_plan(model)
    results = {}
    for dev in ("cpu", "cuda"):
        params = dt.init_stacked_params(model, NODES, seed=0, device="cpu")
        params = tree_map(lambda a: a.to(dev), params)
        opt_state = dt.init_stacked_opt_state(opt, model, NODES, device=dev)
        gstate = dt.init_gossip_state(plan, bplan, device=dev)
        step = dt.make_train_step(model, opt, plan, gossip_mode="overlap", bucket_plan=bplan)
        for k in range(steps):
            batch = {key: v.to(dev) for key, v in batches[k].items()}
            bits = torch.as_tensor(sched.activations[k].astype("float32"), device=dev)
            params, opt_state, gstate, losses, _ = step(params, opt_state, gstate, batch, bits)
        gstate.wait()
        delta = [t.cpu() for t in gstate.delta]
        params = dt.make_gossip_flush(plan, bplan)(params, gstate)
        results[dev] = (flatten(params), delta, losses.cpu())
    worst = 0.0
    for path, want in results["cpu"][0].items():
        got = results["cuda"][0][path].cpu()
        worst = max(worst, float((got - want).norm() / want.norm()))
    for got, want in zip(results["cuda"][1], results["cpu"][1]):
        worst = max(worst, float((got - want).norm() / want.norm()))
    loss_err = float(((results["cuda"][2] - results["cpu"][2]).abs()
                      / results["cpu"][2].abs()).max())
    log(f"check: tiny fp32, {steps} overlap steps and the flush, card (side stream) vs CPU: "
        f"params and in-flight deltas max rel err {worst:.2e}, losses max rel err "
        f"{loss_err:.2e} (tolerance {SMALL_TOL:g})")
    if not (worst <= SMALL_TOL and loss_err <= SMALL_TOL):
        fail("the card's overlap steps disagree with the CPU's on the small input")


def check_overlap_crash_resume(torch):
    """The training CLI on the card with --gossip-mode overlap: an
    uninterrupted run, a run that checkpoints every 3 steps and crashes
    after step 4, and its --resume auto; the final checkpoints must be
    bit-equal."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import ckpt
    from repro_torch.faults import SimulatedCrash
    from repro_torch.kernels.gossip_axpy import gossip_axpy
    from repro_torch.launch import train
    from repro_torch.tree import flatten

    base = ["--preset", "tiny", "--steps", "8", "--gossip-mode", "overlap"]
    parent = os.path.join(ROOT, "build")
    os.makedirs(parent, exist_ok=True)
    root = tempfile.mkdtemp(prefix="cli-overlap-", dir=parent)
    try:
        a, b = os.path.join(root, "a"), os.path.join(root, "b")
        ck = ["--ckpt-dir", b, "--ckpt-every", "3"]
        launches = []
        gossip_axpy.launches = 0
        whole = train.main(base + ["--ckpt-dir", a])
        launches.append(gossip_axpy.launches)
        gossip_axpy.launches = 0
        try:
            train.main(base + ck + ["--crash-at-step", "4"])
            fail("launch.train --gossip-mode overlap --crash-at-step 4 did not crash")
        except SimulatedCrash as crash:
            if crash.step != 4:
                fail(f"launch.train crashed after step {crash.step}, not 4")
        launches.append(gossip_axpy.launches)
        gossip_axpy.launches = 0
        resumed = train.main(base + ck + ["--resume", "auto"])
        launches.append(gossip_axpy.launches)
        got = ckpt.restore_run(ckpt.find_resumable(b), device="cpu")
        want = ckpt.restore_run(ckpt.find_resumable(a), device="cpu")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    fa, fb = flatten({"p": want[0], "s": want[1]}), flatten({"p": got[0], "s": got[1]})
    same = fa.keys() == fb.keys() and all(torch.equal(fb[k], t) for k, t in fa.items())
    log(f"check: launch.train --preset tiny --steps 8 --gossip-mode overlap on the card: "
        f"uninterrupted, crashed after step 4 (checkpoint every 3, flushed), then --resume "
        f"auto: gossip_axpy launches {launches}; final loss {resumed[-1]['loss']:.7f} vs "
        f"{whole[-1]['loss']:.7f}, consensus {resumed[-1]['consensus']:.7e} vs "
        f"{whole[-1]['consensus']:.7e}; final checkpoints (step {got[2]} / {want[2]}) "
        f"{'bit-equal' if same else 'DIFFER'} on {len(fa)} leaves")
    # 12 leaves: a step lands 12, a checkpoint's flush 12, the final flush 12
    if launches != [8 * 12 + 12, 5 * 12 + 12, 5 * 12 + 12 + 12]:
        fail(f"overlap crash and resume runs: gossip_axpy launches {launches}, "
             "expected [108, 72, 84]")
    if not same or got[2] != want[2] or resumed[-1]["loss"] != whole[-1]["loss"]:
        fail("the resumed overlap run does not end bit-equal to the uninterrupted run")


def check_traces(torch):
    """--trace on the card: train (masked and overlap) and serve write
    events.jsonl, trace.json and (train) metrics.jsonl that the port's
    readers load, with the spans each run must record."""
    import shutil
    import tempfile

    from repro_torch.launch import serve, train
    from repro_torch.telemetry import read_jsonl
    from repro_torch.telemetry.trace import read_chrome_trace

    parent = os.path.join(ROOT, "build")
    os.makedirs(parent, exist_ok=True)
    root = tempfile.mkdtemp(prefix="trace-", dir=parent)
    try:
        for mode, want in (("masked", {"step", "fwd_bwd", "forward", "backward", "optimizer",
                                       "gossip", "gossip/target", "gossip/apply"}),
                           ("overlap", {"step", "forward", "backward", "gossip_apply",
                                        "gossip_launch"})):
            out = os.path.join(root, mode)
            train.main(["--preset", "tiny", "--steps", "3", "--gossip-mode", mode,
                        "--trace", out])
            header, events = read_jsonl(os.path.join(out, "events.jsonl"))
            with open(os.path.join(out, "metrics.jsonl")) as f:
                metrics = [json.loads(line) for line in f]
            names = {e.name for e in events}
            if (header["meta"]["device"] != "cuda" or [m["step"] for m in metrics] != [0, 1, 2]
                    or not want <= names
                    or any(n.startswith("gossip/matching") for n in names)
                    or read_chrome_trace(os.path.join(out, "trace.json")) != events):
                fail(f"train --trace ({mode}): {sorted(names)}, metrics {metrics}")
            launch = [e for e in events if e.name == "gossip_launch"]
            log(f"check: launch.train --trace ({mode}) on the card: {len(events)} events "
                f"({sorted(names)}); metrics steps 0-2, step ms "
                + ", ".join(f"{m['step_ms']:.1f}" for m in metrics)
                + (", gossip_launch ms " + ", ".join(f"{e.args['device_dur_us'] / 1e3:.2f}"
                                                     for e in launch)
                   if launch else ""))
        out = os.path.join(root, "serve")
        serve.main(["--preset", "tiny", "--batch", "2", "--prompt-len", "32", "--gen", "4",
                    "--trace", out])
        _, events = read_jsonl(os.path.join(out, "events.jsonl"))
        spans = [(e.name, e.step) for e in events]
        if (spans != [("prefill", -1)] + [("decode", i) for i in range(3)]
                or read_chrome_trace(os.path.join(out, "trace.json")) != events):
            fail(f"serve --trace: spans {spans}")
        log("check: launch.serve --trace on the card: prefill "
            f"{events[0].dur_us / 1e3:.2f} ms, decode "
            + ", ".join(f"{e.dur_us / 1e3:.2f}" for e in events[1:]) + " ms")
    finally:
        shutil.rmtree(root, ignore_errors=True)


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


DRY_PEAK_TOL = 0.10             # predicted peak within 10% of max_memory_allocated
DRY_GEN = 2                     # serving in the dry-run phase: a prefill and one decode step
EXAMPLE_STEPS = 6               # training steps of each example on the card


def all_counters():
    """Every hand-written kernel's wrapper, by name (each counts its launches)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gossip_axpy import gossip_axpy
    from repro_torch.kernels.ssm_scan import ssm_scan

    return {"flash_attention": flash_attention, "ssm_scan": ssm_scan,
            **gmm_counters(), "gossip_axpy": gossip_axpy}


def dry_configs():
    """(label, predict, measure) of every configuration the earlier phases
    drive: ``predict()`` traces it on meta and returns the CostMode,
    ``measure(counters)`` runs it on the card and returns (resident,
    peak) bytes over what was allocated before it."""
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.dist import decen_train as dt
    from repro_torch.launch import dryrun, serve

    train_cfg = dataclasses.replace(get_config("internlm2_1_8b"), num_layers=2)

    def built(build, warmup=0):
        def predict():
            return dryrun.trace(lambda: build("meta"), warmup=warmup)

        def measure():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            state, run = build("cuda")
            for _ in range(warmup):
                run()
            for fn in all_counters().values():
                fn.launches = 0         # the measured step's launches only
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
            out = run()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            del out, state, run
            return resident, peak
        return predict, measure

    def training(mode, warmup=0):
        def build(device):
            st = dryrun.train_state(train_cfg, nodes=NODES, batch=BATCH, seq=SEQ,
                                    gossip_mode=mode, device=device)
            return st, st.run
        return built(build, warmup)

    def consensus(mode):
        # the consensus distance phase 3 reads between steps, over the state
        def build(device):
            st = dryrun.train_state(train_cfg, nodes=NODES, batch=BATCH, seq=SEQ,
                                    gossip_mode=mode, device=device)
            return st, lambda: dt.consensus_distance(st.params)
        return built(build)

    def serving(cfg, prompt):
        def predict():
            from repro_torch.analysis.cost import CostMode

            with CostMode() as cm:
                serve.run(cfg, batch=SERVE_BATCH, prompt_len=prompt, gen=DRY_GEN, seed=0,
                          device="meta", cost=cm)
            return cm

        def measure():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            res = serve.run(cfg, batch=SERVE_BATCH, prompt_len=prompt, gen=DRY_GEN, seed=0,
                            device="cuda")
            out = res["resident_bytes"] - base, res["peak_bytes"] - base
            del res
            return out
        return predict, measure

    out = [(f"train masked ({train_cfg.name}, {train_cfg.num_layers} layers, {NODES} "
            f"nodes, {BATCH} x {SEQ})", *training("masked")),
           (f"train overlap ({train_cfg.name}, {train_cfg.num_layers} layers, {NODES} "
            f"nodes, {BATCH} x {SEQ}, the step after a warm-up step: a live exchange in "
            "flight, as phase 3's steady steps)", *training("overlap", warmup=1))]
    for mode in ("masked", "overlap"):
        out.append((f"consensus_distance over the {mode} state (phase 3 reads it between "
                    "steps)", *consensus(mode)))
    for cfg, prompt, _, _ in serving_configs():
        out.append((f"serve {cfg.name} ({cfg.num_layers} layers, B {SERVE_BATCH} x {prompt}, "
                    f"prefill + {DRY_GEN - 1} decode)", *serving(cfg, prompt)))
    replica = dataclasses.replace(get_config("dbrx_132b"), num_layers=MOE_TRAIN_LAYERS)
    out.append((f"dbrx replica ({replica.num_layers} layer, {BATCH} x {SEQ}, loss and "
                "gradients)", *built(lambda device: dryrun.replica_call(
                    replica, batch=BATCH, seq=SEQ, device=device))))
    out.append((f"dbrx MoE block fwd+bwd (B {SERVE_BATCH} x {SERVE_PROMPT})",
                *built(lambda device: dryrun.moe_block_call(
                    dbrx_serving_config(), batch=SERVE_BATCH, seq=SERVE_PROMPT,
                    device=device))))
    for compute in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config("internlm2_1_8b"), num_layers=1,
                                  compute_dtype=compute)
        out.append((f"sdpa_chunked ({cfg.name}, 1 layer, {compute}, B 1 x S 8192, loss and "
                    "gradients)", *built(lambda device, cfg=cfg: dryrun.replica_call(
                        cfg, batch=1, seq=8192, device=device))))
    return out


def phase_dryrun(torch):
    """The dry run (``repro_torch.launch.dryrun``, meta tensors) against the
    card for every configuration the earlier phases drive: resident bytes
    against memory_allocated, the peak against max_memory_allocated (the
    stats reset per configuration, each counted over what was allocated
    before it), kernel launches against the wrappers' counters."""
    import gc

    counters = all_counters()
    rows, failures = [], []
    for label, predict, measure in dry_configs():
        t0 = time.perf_counter()
        cm = predict()
        predicted = dict(cm.launches)
        gc.collect()
        torch.cuda.empty_cache()
        for fn in counters.values():
            fn.launches = 0
        resident, peak = measure()
        launched = {k: fn.launches for k, fn in counters.items() if fn.launches}
        gc.collect()
        torch.cuda.empty_cache()
        p_res, p_peak = cm.argument_bytes, cm.peak
        res_gap, peak_gap = p_res - resident, (p_peak - peak) / peak
        log(f"dryrun: {label}: resident predicted {p_res} B ({p_res / 1e9:.3f} GB), measured "
            f"{resident} B (memory_allocated; gap {res_gap} B, the allocator's rounding "
            f"of {cm.resident_storages} storages allows {cm.resident_slack()}); peak "
            f"predicted {p_peak / 1e9:.3f} GB, measured {peak / 1e9:.3f} GB "
            f"(max_memory_allocated; gap {peak_gap:+.2%}); launches predicted {predicted}, "
            f"counted {launched} ({time.perf_counter() - t0:.1f} s)")
        rows.append((label, peak_gap))
        if predicted != launched:
            failures.append(f"{label}: predicted launches {predicted}, the card counted "
                            f"{launched}")
        if abs(res_gap) > cm.resident_slack():
            failures.append(f"{label}: resident bytes {p_res} predicted, {resident} measured: "
                            "more apart than the allocator's rounding of its storages")
        if abs(peak_gap) > DRY_PEAK_TOL:
            failures.append(f"{label}: peak {p_peak} predicted, {peak} measured "
                            f"({peak_gap:+.2%}, over {DRY_PEAK_TOL:.0%})")
    if failures:
        fail("dry run against the card: " + "; ".join(failures))
    log(f"dryrun: {len(rows)} configurations, launches exact, residents within the "
        f"allocator's rounding, peaks within {max(abs(g) for _, g in rows):.2%} of the card's")


def sweep_close(torch, case, got, want):
    """Max abs error of a sweep case's kernel output against its plain
    version, at the phase-2 tolerances (gossip bit for bit); inf if it
    disagrees."""
    k, dname = case.kernel, case.args[0][1]
    if k == "gossip_axpy":
        return 0.0 if torch.equal(got, want) else math.inf
    if k == "ssm_scan":
        atol, rtol = SSM_TOL[dname]
        return max(close(torch, g, w, atol, rtol) for g, w in zip(got, want))
    tol = (FA_TOL if k == "flash_attention" else GMM_TOL)[dname]
    # in slices along dim 0: kimi-k2's dw is 11 GB in bf16, 23 GB as the
    # plain version's fp32
    step = max(1, (1 << 27) // max(1, got[0].numel()))
    return max(close(torch, got[i:i + step], want[i:i + step], tol, tol)
               for i in range(0, got.shape[0], step))


LEAK_SHIFT = 7                  # keys the planted flash fault's k / v views move on


def shifted_kv(k, v, shift: int = LEAK_SHIFT):
    """k and v moved ``shift`` key positions on in their storage: the same
    shapes, whose last batch row's last keys lie past the operands, in
    the poisoned tail (a caller that slices its cache one position late)."""
    off = shift * k.stride(1)
    return (k.as_strided(k.shape, k.stride(), k.storage_offset() + off),
            v.as_strided(v.shape, v.stride(), v.storage_offset() + off))


def leaky_flash(attend):
    """A guarded launch for ``kernel_lint.poison_case`` that runs
    ``attend(q, k, v, out)`` on ``shifted_kv`` views: the planted fault
    the poison check must flag."""
    def launch(q, k, v, out):
        ks, vs = shifted_kv(k, v)
        return attend(q, ks, vs, out)
    return launch


@contextlib.contextmanager
def plain_attention():
    """``kernels.ops.attention`` patched to its plain path whatever the
    device: the planted fault ``kernel-launch-missing`` must flag."""
    from repro_torch.kernels import ops, ref

    orig = ops.attention
    ops.attention = lambda q, k, v, *, causal=True, window=0, impl="auto": \
        ref.attention_ref(q, k, v, causal=causal, window=window)
    try:
        yield
    finally:
        ops.attention = orig


def planted_names(viols) -> set:
    return {v.name for v in viols}


def sweep_faults(torch, cases):
    """The planted faults each check of the sweep must flag, on one full
    internlm2-1.8b flash case each."""
    from repro_torch.analysis import kernel_lint
    from repro_torch.kernels import flash_attention as fa

    aligned = next(c for c in cases if c.label == "internlm2_1_8b/full/flash_attention/aligned")
    t = aligned.make("cuda", pad=kernel_lint.POISON_PAD)
    boxes = kernel_lint.case_tiles(aligned, t)
    contract = kernel_lint.contract_for(aligned.kernel)
    got, _ = kernel_lint.lint_tiles(kernel_lint.shift_box(boxes),
                                    kernel_lint.output_extent(aligned, t), contract)
    if not {"output-overlap-undeclared", "output-not-covered"} <= planted_names(got):
        fail(f"sweep fault: a shifted probe box gave {sorted(planted_names(got))}")
    log(f"sweep fault: one of {len(boxes)} probe boxes shifted by one tile: "
        f"{sorted(planted_names(got))}")
    ragged = next(c for c in cases if c.label == "internlm2_1_8b/full/flash_attention/ragged")
    t = ragged.make("cuda", pad=kernel_lint.POISON_PAD)
    leak = leaky_flash(lambda q, k, v, out: fa.flash_attention(q, k, v, causal=True,
                                                               out=out[0]))
    got, _ = kernel_lint.poison_case(ragged, t, launch=leak)
    if not planted_names(got) & {"masked-tail-read", "masked-tail-guard-missing"}:
        fail(f"sweep fault: flash on k / v views {LEAK_SHIFT} keys into the poisoned tail "
             f"gave {sorted(planted_names(got))}")
    log(f"sweep fault: flash on k / v views {LEAK_SHIFT} keys into the poisoned tail: "
        f"{sorted(planted_names(got))}")
    with plain_attention():
        _, n = kernel_lint.run_counted(aligned, t)
    got = kernel_lint.launch_violations(aligned, n)
    if planted_names(got) != {"kernel-launch-missing"}:
        fail(f"sweep fault: ops.attention on its plain path gave {sorted(planted_names(got))}")
    log(f"sweep fault: ops.attention patched to its plain path: {n} flash launches, "
        f"{sorted(planted_names(got))}")
    del t
    torch.cuda.empty_cache()


def phase_sweep(torch):
    """Every registry kernel case (``analysis.kernel_cases.sweep_cases``,
    tiny and full, ragged tails included) on the card: the path it takes,
    ``kernel_lint`` over its launch configuration, contract and probe
    tiles, its poisoned and guarded launches, its launches through
    ``impl="auto"``, the kernel against its plain version; a grouped
    product's rows past the groups must be 0. Then the planted faults and
    the checker."""
    from repro_torch.analysis import kernel_cases, kernel_lint

    cases = kernel_cases.sweep_cases()
    t0 = time.perf_counter()
    paths = {}
    worst = {}
    added = {"tiles": 0.0, "poison": 0.0}
    for case in cases:
        t = case.make("cuda", pad=kernel_lint.POISON_PAD)
        viols, stats = kernel_lint.lint_case(case, t)
        added["tiles"] += stats["tiles"]["seconds"]
        ta = time.perf_counter()
        pv, pstats = kernel_lint.poison_case(case, t)
        added["poison"] += time.perf_counter() - ta
        got, n = kernel_lint.run_counted(case, t)
        viols += pv + kernel_lint.launch_violations(case, n)
        if viols:
            fail(f"sweep {case.label}: " + "; ".join(f"[{v.name}] {v.detail}" for v in viols))
        torch.cuda.synchronize()
        want = case.run_plain(*t)
        err = sweep_close(torch, case, got, want)
        if not math.isfinite(err):
            fail(f"sweep {case.label}: the kernel ({stats['kernel_path']}) disagrees with its "
                 "plain version")
        if case.kernel in ("grouped_matmul", "grouped_matmul_dx"):
            tail = int(t[2].sum())
            if not bool((got[tail:] == 0).all()):
                fail(f"sweep {case.label}: rows past the groups are not 0")
        paths[stats["kernel_path"]] = paths.get(stats["kernel_path"], 0) + 1
        worst[case.kernel] = max(worst.get(case.kernel, 0.0), err)
        log(f"sweep: {case.label} {[tuple(x.shape) for x in t]} {case.args[0][1]}: path "
            f"{stats['kernel_path']}, grid {stats['grid']} x {stats['threads']} threads, "
            f"{stats['smem_bytes']} B shared, covers {stats['cover']} of {stats['extent']}; "
            f"{stats['tiles']['boxes']} tiles disjoint and covering; {pstats['poisoned_inputs']} "
            f"tails and {pstats['poisoned_rows']} rows poisoned, canaries and tails held; "
            f"{n} launch; max abs err {err:.3g}")
        del t, got, want
        torch.cuda.empty_cache()
    log(sweep_summary(len(cases), time.perf_counter() - t0, added, paths, worst))
    tf = time.perf_counter()
    sweep_faults(torch, cases)
    log(f"sweep: planted faults flagged in {time.perf_counter() - tf:.2f} s")
    phase_checker()


def sweep_summary(n: int, secs: float, added: dict, paths: dict, worst: dict) -> str:
    """Phase 9's closing line: the cases, the phase's seconds and what the
    tile probes and poisoned launches added to them."""
    return (f"sweep: {n} registry cases pass kernel_lint (launch rules, contract, tiles), "
            f"the poison and launch checks and their tolerances in {secs:.1f} s, of which "
            f"the tile probes took {added['tiles']:.1f} s and the poisoned launches "
            f"{added['poison']:.1f} s; paths {paths}; max abs err by kernel {worst}")


CHECK_ARGV = ["--shard", "2", "--all-layouts", "--faults", "--strict"]


def phase_checker():
    """``python -m repro_torch.analysis.check --shard 2 --all-layouts
    --faults --strict`` on the card's machine: the one-process steps, the
    replicated and FSDP mesh lanes with their collective checks, the
    schedule gates and the arch's kernel cases through ``kernel_lint`` on
    the card."""
    import contextlib as ctx
    import io

    from repro_torch.analysis import check

    t0 = time.perf_counter()
    report, err = io.StringIO(), io.StringIO()
    with ctx.redirect_stdout(report), ctx.redirect_stderr(err):
        rc = check.main(CHECK_ARGV)
    rep = json.loads(report.getvalue())
    lanes = [k for k in rep["steps"] if k.startswith(("replicated/", "fsdp/"))]
    ops = sum(len(rep["steps"][k]["collectives"]) for k in lanes)
    log(f"check: {' '.join(CHECK_ARGV)}: rc {rc}, {rep['num_violations']} violations, "
        f"{len(rep['steps'])} steps ({len(lanes)} mesh lanes, {ops} collectives recorded), "
        f"kernel cases on the card {rep['kernels']['card']}, artifact row "
        f"{'held' if rep['artifact']['row'] else 'absent'} "
        f"({time.perf_counter() - t0:.1f} s)")
    if rc != 0 or not rep["ok"]:
        fail("check: " + err.getvalue()[-2000:])


def phase_examples(torch):
    """The four examples (``repro_torch.examples``) on the card, at small
    step counts."""
    from repro_torch.examples import (
        quickstart,
        serve_batched,
        topology_explorer,
        train_decentralized,
    )

    t0 = time.perf_counter()
    res = quickstart.main(["--steps", str(EXAMPLE_STEPS)])
    log(f"examples: quickstart on the card, {EXAMPLE_STEPS} steps: {res}")
    rows = topology_explorer.main([])
    log(f"examples: topology_explorer on the card: {len(rows)} radii")
    # its 2 x 2 mesh is four ranks: on fewer cards they share them over gloo
    backend = "gloo" if torch.cuda.device_count() < 4 else "nccl"
    res = serve_batched.main(["--gen", "4", "--backend", backend])
    if not bool(torch.isfinite(res["logits"]).all()):
        fail("examples: serve_batched gave non-finite logits")
    log(f"examples: serve_batched on the card (data 2 x model 2 over {backend}): generated "
        f"{res['generated'][0].tolist()}")
    for mode in ("masked", "overlap"):
        res = train_decentralized.main(["--steps", str(EXAMPLE_STEPS), "--gossip-mode", mode])
        log(f"examples: train_decentralized ({mode}) on the card, {EXAMPLE_STEPS} steps: "
            f"losses {res['losses']}")
    log(f"examples: all four ran on the card in {time.perf_counter() - t0:.1f} s")


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
    gm_row, gm_bwd_rows = phase_gmm(torch, ptxas)
    launches = phase_main(torch, cfg, plan)
    torch.cuda.empty_cache()
    serve_launches = phase_serve(torch)
    phase_profile(torch)
    moe_train_launches = phase_moe_train(torch, plan)
    phase_check(torch, plan)
    phase_serve_check(torch)
    phase_tests()
    phase_dryrun(torch)
    phase_sweep(torch)
    phase_examples(torch)
    torch.cuda.empty_cache()
    phase_fsdp(torch)
    torch.cuda.empty_cache()
    phase_tp(torch)
    torch.cuda.empty_cache()
    phase_sp(torch)
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s "
        "(558.5 s on an NVIDIA H100 80GB HBM3 at 700 W before phase 13 and the checker's "
        "FSDP lanes)")

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
    ] + [
        # no TPU kernel: the VJP of lax.ragged_dot in the JAX model
        dict(name=f"grouped_matmul_{kind}", route="cuda",
             source="src/repro_torch/csrc/grouped_matmul.cu",
             replaces="src/repro/models/ffn.py:119",
             launches=moe_train_launches[f"grouped_matmul_{kind}"], **gm_bwd_rows[kind])
        for kind in ("dx", "dw")
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
