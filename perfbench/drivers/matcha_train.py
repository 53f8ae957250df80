"""Driver of the ``matcha_train`` traffic kind: MATCHA decentralized
training through the port's ``TrainStep``, built as the port's training
CLI builds it.

Set-up: the plan (``core.plan_matcha`` on the traffic's
graph and budget) and its a-priori schedule, the step
(``make_train_step``, SGD with momentum), the node-stacked state, and the
benchmark's inputs made from ``--seed``: one replica's weights drawn on
the device (``perfbench.weights``), every node's batches for the window
from the frozen corpus, the schedule's activation rows, all on the
device. Then the first ``check_steps`` steps through the window's own
call and feed, after which the numbers the reference is held to are
read (each step's losses, the first gradient from the velocity, each
leaf's change), and ``warm_steps`` more.

The window calls the same step on the same state, step after step, with
a CUDA event on the main stream at every boundary and nothing fenced:
the host waits for the previous boundary only, and the window ends at
the first boundary past ``--seconds``, then synchronizes. The traced run
(``--trace 1``) keeps each step's phase spans (CUDA events inside
``TrainStep``) and profiles the first ``trace_steps`` steps with
torch.profiler (the CUDA activity alone); the phase spans are averaged
over the steps after them.

The driver runs every node on one card, in this process.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import faults, weights
from perfbench.frozen import corpus, gossip_bytes, planner
from perfbench.frozen import profile as fprof
from perfbench.manifest import load_module
from perfbench.reference import decen

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PEAK_BF16_FLOPS = 989e12      # one H100 SXM, dense bf16, NVIDIA's data sheet


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Job:
    """What the card runs: the set-up and readings of each ``(seed,
    fault)`` task, then, with ``seconds``, the window on the first
    task's state."""

    config: dict
    traffic: dict
    family_path: str
    tasks: list
    seconds: Optional[float] = None
    trace: bool = False
    device: str = "cuda"


def program_config(config: dict):
    """The port's ModelConfig of a configuration file: the registry arch
    with every size the file states."""
    from repro_torch.configs.registry import get_config

    base = get_config(config["arch"])
    fields = {f.name for f in dataclasses.fields(base)} - {"name", "source", "family"}
    return dataclasses.replace(base, **{k: v for k, v in config.items() if k in fields})


class Clock:
    """Step boundaries: CUDA events on the current stream on the card,
    the host clock on the CPU (where every operation runs in order)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait(self, mark) -> None:
        if self.cuda:
            mark.synchronize()

    def seconds(self, a, b) -> float:
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a


def _nest(flat: Dict[str, torch.Tensor]) -> dict:
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *keys, last = path.split(".")
        for key in keys:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def _norms(t: torch.Tensor) -> List[float]:
    return torch.linalg.vector_norm(t.reshape(t.shape[0], -1).float(), dim=1).tolist()


def feed(traffic: dict, vocab: int, count: int, seed: int, device):
    """``count`` batches of every node: (tokens, labels), each
    ``(count, nodes, batch, seq)`` int32 on ``device``."""
    toks = corpus.batches(vocab, traffic["nodes"], traffic["batch"], traffic["seq"], count, seed)
    return (torch.from_numpy(toks[..., :-1].copy()).to(device),
            torch.from_numpy(toks[..., 1:].copy()).to(device))


# ---------------------------------------------------------------------------
# The program
# ---------------------------------------------------------------------------
def run_job(job: Job) -> dict:
    """Every task of ``job`` on one device: the readings of each and,
    with ``job.seconds``, the window on the first task's state."""
    device = torch.device(job.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return _run(job, device)


def _run(job: Job, device) -> dict:
    from repro_torch.core import named_graph, plan_matcha
    from repro_torch.dist import decen_train as dt
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd
    from repro_torch.tree import flatten

    tr = job.traffic
    stages, t_stage = [], [time.perf_counter()]

    def stage(name: str) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        stages.append([name, now - t_stage[0]])
        t_stage[0] = now

    family = load_module(Path(job.family_path))
    cfg = program_config(job.config)
    model = Model(cfg)
    specs = family.param_specs(job.config)
    shapes = {path: tuple(shape) for path, (shape, _) in flatten(model.param_shapes()).items()}
    if shapes != {path: tuple(shape) for path, shape, _ in specs}:
        raise ValueError(f"the reference's parameter tree differs from {cfg.name}'s")
    mesh = mesh_lib.make_mesh(device=device)
    spec = dt.make_spec(mesh, tr["nodes"], cfg=cfg)
    plan = plan_matcha(named_graph(tr["graph"], tr["nodes"], seed=3), tr["budget"],
                       seed=tr["plan_seed"])
    count = tr["batches"]
    bits = torch.as_tensor(plan.schedule(count, seed=tr["schedule_seed"]).activations
                           .astype(np.float32), device=device)
    if tr["optimizer"] != "sgd":
        raise ValueError(f"the matcha_train driver runs SGD, not {tr['optimizer']!r}")
    opt = sgd(tr["lr"], momentum=tr["momentum"])
    step = dt.make_train_step(model, opt, plan, gossip_mode=tr["gossip_mode"], spec=spec)
    stage("mesh, plan and step")
    clock = Clock(device)
    out = {"tasks": [],
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    for t, (seed, plant) in enumerate(job.tasks):
        with faults.planted(plant, step) as stepf:
            tokens, labels = feed(tr, cfg.vocab_size, count if job.seconds else tr["check_steps"],
                                  seed, device)
            stage("feed")
            replica = weights.make(specs, seed, device)
            params = _nest({k: v.unsqueeze(0).repeat((spec.local_nodes,) + (1,) * v.dim())
                            for k, v in replica.items()})
            # the replica waits on the host for the change: the card is the state's
            replica = {k: v.cpu() for k, v in replica.items()}
            opt_state = dt.init_stacked_opt_state(opt, model, spec.local_nodes, device=device)
            stage("weights and state")
            losses, grad = [], {}
            for k in range(tr["check_steps"]):
                params, opt_state, loss, _ = stepf(
                    params, opt_state, {"tokens": tokens[k], "labels": labels[k]}, bits[k],
                    step=k)
                losses.append(loss.detach().float().clone())
                if k == 0:
                    grad = {path: _norms(v) for path, v in flatten(opt_state["velocity"]).items()}
                stage(f"step {k}")
            change = {path: _norms(v - replica[path].to(v.device))
                      for path, v in flatten(params).items()}
            del replica
            task = {"seed": seed, "plant": plant, "readings": {
                "loss": torch.stack(losses).tolist(), "grad": grad, "change": change}}
            stage("readings")
            if t == 0 and job.seconds:
                task["window"] = _window(job, stepf, params, opt_state, tokens, labels, bits,
                                         clock, device, stage)
            out["tasks"].append(task)
            del params, opt_state, tokens, labels
            if device.type == "cuda":
                torch.cuda.empty_cache()
    out["stages"] = stages
    return out


def _window(job: Job, stepf, params, opt_state, tokens, labels, bits, clock: Clock,
            device, stage) -> dict:
    tr = job.traffic
    count, first = tokens.shape[0], tr["check_steps"]

    def run(k):
        b = k % count
        return stepf(params, opt_state, {"tokens": tokens[b], "labels": labels[b]}, bits[b],
                     step=k)

    for k in range(first, first + tr["warm_steps"]):
        run(k)
    stage("warm-up steps")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    prof = None
    if job.trace:
        from torch.profiler import ProfilerActivity, profile

        # the device's activity and the runtime calls only: tracing every
        # host operator would slow a host-bound step and inflate its idle share
        prof = profile(activities=[ProfilerActivity.CUDA if device.type == "cuda"
                                   else ProfilerActivity.CPU])
        prof.__enter__()
    trace_steps = tr["trace_steps"] if job.trace else 0
    start_wall = time.time()
    marks, losses, phases = [clock.mark()], [], []
    profiled_s = None
    k = first + tr["warm_steps"]
    while True:
        _, _, loss, _ = run(k)
        marks.append(clock.mark())
        losses.append(loss)
        if job.trace:
            phases.append(stepf.last_phases)
        k += 1
        if prof is not None and len(marks) - 1 == trace_steps:
            clock.wait(marks[-1])
            prof.__exit__(None, None, None)
            profiled_s = clock.seconds(marks[0], marks[-1])
        clock.wait(marks[-2])
        if clock.seconds(marks[0], marks[-2]) >= job.seconds:
            break
    clock.wait(marks[-1])
    if cuda:
        torch.cuda.synchronize(device)
    issued = len(marks) - 1
    steps = issued - 1
    out = {
        "start_wall": start_wall,
        "steps": steps,
        "window_s": clock.seconds(marks[0], marks[steps]),
        "step_ms": [clock.seconds(marks[i], marks[i + 1]) * 1e3 for i in range(steps)],
        "bad_steps": int((~torch.stack(losses[:steps]).isfinite().all(dim=1)).sum()),
        "peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0,
    }
    if job.trace:
        # the spans of the steps the profiler did not watch, where there are any
        spans = phases[trace_steps:steps] or phases[:steps]
        out["phases"] = [p.ms() for p in spans]
        if prof is not None and profiled_s is None:
            prof.__exit__(None, None, None)
            profiled_s = clock.seconds(marks[0], marks[-1])
        summary = fprof.summarize(fprof.device_spans(prof), fprof.host_spans(prof))
        axpy_s, axpy_n = fprof.kernel_seconds(summary["ops"], "gossip_axpy_kernel")
        out["profile"] = {
            "steps": min(trace_steps, issued), "window_s": profiled_s,
            "busy_s": summary["busy_s"], "gossip_axpy_s": axpy_s, "gossip_axpy_launches": axpy_n,
            "device_ops": [[name, secs] for name, secs, _ in summary["ops"][:10]],
            "idle_gaps": [[name, secs] for name, secs in summary["gaps"]],
        }
    return out


# ---------------------------------------------------------------------------
# The reference and the result
# ---------------------------------------------------------------------------
def reference(config: dict, traffic: dict, family, seed: int, device,
              precision: str = "fp32") -> dict:
    """The plain reference's readings after the check steps, from the
    inputs the benchmark made for ``seed``, with the plan worked out again
    by the frozen planner."""
    steps = traffic["check_steps"]
    plan = planner.plan(traffic["graph"], traffic["nodes"], traffic["budget"],
                        seed=traffic["plan_seed"])
    tokens, labels = feed(traffic, config["vocab_size"], steps, seed, device)
    # the replica waits on the host, so that the nodes' state has the card
    replica = {k: v.cpu() for k, v in weights.make(family.param_specs(config), seed,
                                                    device).items()}
    return decen.readings(family, config, replica, tokens, labels, plan.permutations,
                          plan.alpha, plan.schedule(steps, traffic["schedule_seed"]),
                          lr=traffic["lr"], momentum=traffic["momentum"], steps=steps,
                          precision=precision)


def judge(gaps: dict, limits: dict) -> Dict[str, dict]:
    """Each number the cell's limits name, beside its limit."""
    return {name: {"value": gaps[name], "limit": limit} for name, limit in limits.items()}


def leaf_sizes(config: dict, family) -> List[int]:
    return [int(np.prod(shape)) for _, shape, _ in family.param_specs(config)]


def metrics_of(cell, run: dict, setup_s: float, trace: bool) -> dict:
    """The cell's end-to-end metrics (``--trace 0``) or per-layer ones,
    from what ``run_job`` returned."""
    tr, family = cell.traffic, cell.family()
    window = run["tasks"][0]["window"]
    tokens = tr["nodes"] * tr["batch"] * tr["seq"]
    flops = family.flops_per_token(cell.config, tr["seq"]) * tokens
    out = {}
    if not trace:
        rec = SimpleNamespace(
            steps=window["steps"], window_s=window["window_s"], step_ms=window["step_ms"],
            tokens_per_step=tokens, flops_per_step=flops, chips=cell.chips,
            peak_flops=PEAK_BF16_FLOPS, setup_s=setup_s)
        for m in cell.end_to_end:
            out[m["name"]] = {"value": cell.reader("end_to_end", m["name"]).read(rec),
                              "unit": m["unit"]}
        return out
    rec = SimpleNamespace(
        windows=[window], chips=cell.chips, flops_per_step=flops, peak_flops=PEAK_BF16_FLOPS,
        axpy_bytes_per_step=[gossip_bytes.axpy_bytes_per_step(
            leaf_sizes(cell.config, family), tr["nodes"])],
        hbm_bytes_per_s=gossip_bytes.HBM_BYTES_PER_S)
    for m in cell.per_layer:
        value = cell.reader("metrics", m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, start_wall: float,
             device: str = "cuda", plant: Optional[str] = None) -> dict:
    """One run of a cell: set-up and window, the reference, the
    comparison. Returns ``result`` (the last line's object, its
    ``checks`` last: each compared number beside its limit), ``gaps``
    (the comparison in full), ``peak`` (the window's peak bytes) and
    ``stages`` (set-up's seconds by stage). ``plant``: a fault of
    ``perfbench.faults`` under the timed path (the tests')."""
    if cell.chips != 1:
        raise ValueError(f"{cell.name}: the matcha_train driver runs one card, "
                         f"not {cell.chips}")
    job = Job(config=cell.config, traffic=cell.traffic,
              family_path=str(cell.path("reference", f"{cell.config['reference']}.py")),
              tasks=[(seed, plant)], seconds=seconds, trace=trace, device=device)
    run = run_job(job)
    window = run["tasks"][0]["window"]
    setup_s = window["start_wall"] - start_wall
    metrics = metrics_of(cell, run, setup_s, trace)
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    ref = reference(cell.config, cell.traffic, cell.family(), seed, dev)
    gaps = decen.compare(run["tasks"][0]["readings"], ref)
    checks = judge(gaps, cell.limits)
    bad = window["bad_steps"]
    correct = bad == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    info = {"platform": "gpu" if device == "cuda" else device, "kind": run["kind"],
            "count": cell.chips, "memory_peak_bytes": window["peak_bytes"]}
    result = {"correct": correct, "attempted": window["steps"], "failed": bad,
              "metrics": metrics, "device": info}
    if trace:
        profile = window["profile"]
        info["busy_s"] = profile["busy_s"]
        info["window_s"] = profile["window_s"]
        result["breakdown"] = {"device_ops": profile["device_ops"],
                               "idle_gaps": profile["idle_gaps"]}
    result["checks"] = checks
    return {"result": result, "gaps": gaps, "peak": window["peak_bytes"],
            "stages": run["stages"]}
