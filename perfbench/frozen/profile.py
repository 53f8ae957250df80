"""The benchmark's own arithmetic over a torch.profiler trace.

A copy of the port's ``chip_smoke.profile_summary`` reduction, returning
numbers instead of printing them: the device's busy time is the union of
the intervals of its activities (kernels, copies, sets; not the ranges
that annotations project onto the device), each kernel's time is summed
by name, and the gaps between busy intervals are named by what the host
was doing at their middle: the innermost host events that cover it (with
the CUDA activity alone, the runtime calls), else host code between
runtime calls.
"""
from __future__ import annotations

from typing import Dict, List, Tuple


def device_spans(prof) -> List[Tuple[float, float, str]]:
    """(start us, end us, name) of every device activity, sorted."""
    from torch.autograd import DeviceType

    return sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA and not e.name.startswith("Command Buffer")
        and not getattr(e, "is_user_annotation", False)
    )


def host_spans(prof) -> List[Tuple[float, float, str]]:
    from torch.autograd import DeviceType

    return sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == DeviceType.CPU
    )


def busy_intervals(spans) -> List[Tuple[float, float]]:
    """The union of the spans' intervals."""
    out: List[Tuple[float, float]] = []
    for start, end, _ in spans:
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def summarize(spans, host, *, top: int = 10) -> Dict:
    """Busy seconds, device time by name (seconds, launches) and the
    ``top`` longest idle gaps between busy intervals with the host's
    innermost events at each gap's middle."""
    intervals = busy_intervals(spans)
    busy_us = sum(end - start for start, end in intervals)
    by_name: Dict[str, List[float]] = {}
    for start, end, name in spans:
        t = by_name.setdefault(name, [0.0, 0])
        t[0] += end - start
        t[1] += 1
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(intervals, intervals[1:])),
                  reverse=True)[:top]
    named = []
    for length, lo, hi in gaps:
        mid = 0.5 * (lo + hi)
        cover = [(s, name) for s, e, name in host if s <= mid <= e]
        inner = [name for _, name in sorted(cover)[-2:]]
        named.append((" / ".join(inner) if inner else "host code between runtime calls",
                      length / 1e6))
    ops = sorted(((name, t / 1e6, n) for name, (t, n) in by_name.items()),
                 key=lambda r: r[1], reverse=True)
    return dict(busy_s=busy_us / 1e6, ops=ops, gaps=named)


def kernel_seconds(ops, pattern: str) -> Tuple[float, int]:
    """Seconds and launches of the device operations whose name holds
    ``pattern``."""
    t = n = 0
    for name, secs, count in ops:
        if pattern in name:
            t += secs
            n += count
    return t, n
