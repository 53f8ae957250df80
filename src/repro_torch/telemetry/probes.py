"""Measured communication probes + per-step metrics records.

The port of ``repro.telemetry.probes``. A host clock around the overlap
step sees the whole step; what it cannot see inside is measured here,
apart: each matching's exchange re-issued as its own probe on a
payload the size of the real one (:func:`measure_matchings`). On one
card a matching's exchange is the gather ``x[pi_j]`` along the node
dim of the ``(nodes, per_node_elements)`` fp32 buffer, the same
operation the gossip step runs for that matching; on the card each
repetition is timed with CUDA events around it, on the CPU with the
host clock. All durations are milliseconds; summaries report
mean/p50/p95 over ``iters`` repetitions after ``warmup`` uncounted
ones.

``measure_fsdp_collectives`` times the sharded step's all-gather and
reduce-scatter apart, over the mesh's shard group. ``step_metrics``,
``format_metrics_line``, ``fault_event`` and ``summarize_ms`` are the
JAX package's, unchanged.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.telemetry.timers import StepTimer
from repro_torch.telemetry.trace import TraceEvent


def summarize_ms(samples: Sequence[float]) -> Dict[str, float]:
    """mean/p50/p95 (milliseconds) + sample count of one probe's
    repetitions."""
    arr = np.asarray(list(samples), dtype=np.float64)
    if arr.size == 0:
        return {"mean_ms": 0.0, "p50_ms": 0.0, "p95_ms": 0.0, "n": 0}
    return {
        "mean_ms": float(arr.mean()),
        "p50_ms": float(np.percentile(arr, 50)),
        "p95_ms": float(np.percentile(arr, 95)),
        "n": int(arr.size),
    }


def _probe_loop(timer: StepTimer, name: str, fn, *, iters: int, warmup: int,
                device, cat: str, tid: int, **args) -> Dict[str, float]:
    """warmup (uncounted) + iters timed repetitions of ``fn``, each
    recorded as one event when ``timer`` is enabled."""
    import torch

    cuda = device.type == "cuda"
    for _ in range(max(warmup, 0)):
        fn()
    if cuda:
        torch.cuda.synchronize(device)
    samples = []
    for _ in range(max(iters, 1)):
        ts_us = timer.recorder.now_us() if timer.enabled else 0.0
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            dur_ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            fn()
            dur_ms = (time.perf_counter() - t0) * 1e3
        samples.append(dur_ms)
        timer.record(TraceEvent(
            name=name, cat=cat, ts_us=ts_us, dur_us=dur_ms * 1e3,
            pid=timer.pid, tid=tid, args=dict(args),
        ))
    return summarize_ms(samples)


def measure_matchings(
    plan,
    *,
    per_node_elements: int,
    timer: Optional[StepTimer] = None,
    iters: int = 5,
    warmup: int = 1,
    seed: int = 0,
    device="cuda",
) -> List[Dict[str, Any]]:
    """Measured per-matching exchange time.

    For each matching j of ``plan`` this gathers a ``(num_nodes,
    per_node_elements)`` fp32 buffer along the node dim with matching
    j's involution, ``x[pi_j]`` (the exchange the gossip step runs for
    that matching: every node receives its partner's payload), and
    times ``iters`` repetitions. Returns one row per matching::

        {"matching": j, "bytes_per_node": 4 * per_node_elements,
         "mean_ms": ..., "p50_ms": ..., "p95_ms": ..., "n": iters}

    Events are recorded (cat ``"comm"``, tid 1, names
    ``gossip/matching{j}``) when ``timer`` is enabled. The buffer and
    one gathered copy are alive at a time: two copies of the payload.
    """
    import torch

    from repro_torch.device import resolve_device

    device = resolve_device(device)
    timer = timer or StepTimer()
    perms = np.asarray(plan.permutations)
    n = perms.shape[1]
    per_node_elements = int(per_node_elements)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, per_node_elements), generator=gen, device=device,
                    dtype=torch.float32)
    idx = torch.as_tensor(perms, dtype=torch.int64, device=device)
    rows = []
    for j in range(perms.shape[0]):
        summary = _probe_loop(
            timer, f"gossip/matching{j}", lambda i=idx[j]: x.index_select(0, i),
            iters=iters, warmup=warmup, device=device, cat="comm", tid=1,
            bytes_per_node=4 * per_node_elements, matching=j,
        )
        rows.append({"matching": j, "bytes_per_node": 4 * per_node_elements,
                     **summary})
    return rows


def measure_fsdp_collectives(
    spec,
    layout,
    *,
    timer: Optional[StepTimer] = None,
    iters: int = 3,
    warmup: int = 1,
    seed: int = 0,
) -> Dict[str, Dict[str, float]]:
    """Measured cost of the two FSDP collectives of one step, isolated.

    ``"gather"``: every bucket shard all-gathered over the shard group,
    once per node this rank holds (the monolithic step's
    re-materialization). ``"reduce_scatter"``: one reduce-scatter a
    bucket and node on full-size fp32 payloads (the gradient path). The
    payloads are one node's buckets at ``layout.shard_sizes`` (reused
    for every node), on the spec's device; each repetition is timed
    with CUDA events on the card, the host clock on the CPU. Returns
    ``{"gather": summary, "reduce_scatter": summary, "bytes_per_node":
    ...}`` (ms summaries as :func:`summarize_ms`; bytes: the gathered
    fp32 bucket bytes of one node)."""
    import torch

    from repro_torch.dist.fsdp import gather_shard, reduce_scatter_full

    timer = timer or StepTimer()
    mesh = spec.mesh
    device = torch.device(mesh.device or "cpu")
    gen = torch.Generator(device=device).manual_seed(seed)
    shards = [torch.randn((sz,), generator=gen, device=device) for sz in layout.shard_sizes]
    fulls = [torch.randn((sz * layout.num_shards,), generator=gen, device=device)
             for sz in layout.shard_sizes]
    nodes = spec.local_nodes

    def gather():
        for _ in range(nodes):
            for sh in shards:
                gather_shard(sh, mesh)

    def reduce_scatter():
        for _ in range(nodes):
            for full in fulls:
                reduce_scatter_full(full, mesh)

    out = {}
    for name, fn in (("gather", gather), ("reduce_scatter", reduce_scatter)):
        out[name] = _probe_loop(timer, name, fn, iters=iters, warmup=warmup,
                                device=device, cat="comm", tid=1,
                                buckets=len(shards), nodes=nodes)
    out["bytes_per_node"] = 4 * sum(f.numel() for f in fulls)
    return out


# ---------------------------------------------------------------------------
# Fault events
# ---------------------------------------------------------------------------
def fault_event(recorder, *, step: int, kind: str, **extras) -> None:
    """Record one injected-fault event in the trace stream.

    ``kind`` names the fault (``"link_drop"``, ``"straggler"``,
    ``"crash"``); ``extras`` carry its parameters (dropped-exchange
    count, delay units, ...). Events land with ``cat="fault"`` on the
    comm thread lane as zero-duration instants, so a Perfetto view of a
    faulted run shows exactly where the schedule injected what. A
    ``None`` recorder no-ops — the untraced loop pays nothing."""
    if recorder is None:
        return
    recorder.record(TraceEvent(
        name=f"fault/{kind}", cat="fault", ts_us=recorder.now_us(),
        dur_us=0.0, step=int(step), tid=1, args=dict(extras),
    ))


# ---------------------------------------------------------------------------
# Per-step metrics
# ---------------------------------------------------------------------------
def step_metrics(
    *,
    step: int,
    step_ms: float,
    comm_ms: float,
    gossip_mode: str,
    comm_bytes: int = 0,
    phase_ms: Optional[Dict[str, float]] = None,
) -> Dict[str, Any]:
    """One step's measured metrics record (the ``--trace`` log line and
    CSV columns).

    ``step_ms``    fenced whole-step wall time.
    ``comm_ms``    the step's communication time: the measured
                   ``gossip`` phase when the phased executor ran,
                   otherwise the per-matching probe means summed over
                   the activated matchings.
    ``comm_bytes`` per-node bytes the step's exchange moved
                   (``analysis.bytes_model`` per-matching bytes x
                   activated matchings) — modeled, marked as such in
                   the docs.
    ``overlap_ratio``  fraction of the step's comm that does NOT extend
                   the step: 0 by construction for sequential modes
                   (the exchange serializes after the fwd/bwd); for
                   ``overlap`` mode, ``min(comm_ms, step_ms) / step_ms``
                   — an upper bound on the hidden fraction, since the
                   probe-measured comm either fits under the compute or
                   extends the step.
    """
    step_ms = float(step_ms)
    comm_ms = float(comm_ms)
    overlapped = gossip_mode == "overlap"
    if step_ms > 0 and overlapped:
        overlap_ratio = min(comm_ms, step_ms) / step_ms
    else:
        overlap_ratio = 0.0
    out = {
        "step": int(step),
        "step_ms": round(step_ms, 4),
        "comm_ms": round(comm_ms, 4),
        "comm_fraction": round(comm_ms / step_ms, 4) if step_ms > 0 else 0.0,
        "overlap_ratio": round(overlap_ratio, 4),
        "comm_bytes": int(comm_bytes),
    }
    if phase_ms:
        for k, v in phase_ms.items():
            out[f"{k}_ms"] = round(float(v), 4)
    return out


def format_metrics_line(m: Dict[str, Any]) -> str:
    """Human-readable one-liner for the training CLI's log."""
    parts = [
        f"trace step {m['step']:4d}",
        f"step {m['step_ms']:8.2f} ms",
        f"comm {m['comm_ms']:7.2f} ms ({100 * m['comm_fraction']:.0f}%)",
        f"overlap {m['overlap_ratio']:.2f}",
        f"comm_bytes {m['comm_bytes']}",
    ]
    extra = [k for k in m if k.endswith("_ms") and k not in
             ("step_ms", "comm_ms")]
    if extra:
        parts.append(" ".join(f"{k[:-3]} {m[k]:.2f}" for k in sorted(extra)))
    return "  ".join(parts)
