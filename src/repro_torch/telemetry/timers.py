"""The port's spans: host and device intervals, nothing recorded when off.

The port of ``repro.telemetry.timers``, and the one span system of the
port. A span of an enabled :class:`StepTimer` keeps

* a host interval on the Unix-epoch wall clock (``time.time_ns``), the
  clock torch.profiler stamps its events with (its events are relative
  to ``prof.profiler.kineto_results.trace_start_ns()``, an instant on
  that clock), so a span, the profile's runtime calls and the device's
  kernels lie on one axis;
* with ``device=`` a CUDA device, a device interval: CUDA events
  recorded on the current stream at entry (after the host stamp) and at
  exit (before it). Nothing synchronizes inside the step: the events are
  read when the span is read, which waits for its end event;
* an id, its parent's id (the innermost span open at entry; ``None`` at
  the top), the step and free-form args (``node``, ``leaf``,
  ``bytes``, ...);
* counters (``span.count(name=tensor)``): device tensors read with the
  events.

A span with no device interval and no counters is recorded into the
timer's ``TraceRecorder`` as it exits; any other when it is read
(:meth:`StepTimer.read`, or the :class:`StepSpans` view it belongs to).
Unread spans are kept up to the recorder's capacity, oldest dropped.
The event's ``ts_us`` / ``dur_us`` are the host interval; its args add
``id``, ``parent``, and ``device_start_us`` (from the timer's first CUDA
event, on the device's clock) and ``device_dur_us`` where there are
events, plus the counters.

:class:`StepSpans` is one step's view: ``spans(name, **args)`` opens a
span on the step's device and ``ms()`` sums each name's time over the
step (the device interval where there is one, else the host interval).
A step built with a disabled timer (``StepTimer(None)``) takes
:data:`NO_SPANS` instead, whose every span is the shared no-op: it reads
no clock, creates no CUDA event and keeps no list.

``span.fence(x)`` waits for the card (``torch.cuda.synchronize`` on every
card that holds a tensor in ``x``): for a caller that asks for a fenced
host time (the serving CLI's prefill and decode, :func:`timed_step`,
:meth:`StepTimer.measure`). Spans inside the train steps are never
fenced.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.telemetry.trace import TraceEvent, TraceRecorder

# Canonical span names (free-form names are also fine):
#   step            one whole train step
#   fwd_bwd         forward + backward on one node's batch
#   forward         the node's loss (inside fwd_bwd)
#   backward        its gradient and clip (inside fwd_bwd; remat's
#                   recompute of the forward runs here)
#   optimizer       one node's update
#   gossip          the per-step matching exchange (sequential modes)
#   gossip/target   one leaf's fp32 target build (inside gossip)
#   gossip/apply    one leaf's ops.gossip_apply (inside gossip)
#   gossip_apply    the overlap step's landing of the pending correction
#   gossip_launch   the overlap step's exchange on its side stream
#                   (cat "comm", tid 1)
#   gather / reduce_scatter   the monolithic FSDP step's collectives
#   prefill / decode   serve-side spans (fenced)
PHASES: Tuple[str, ...] = (
    "step",
    "fwd_bwd",
    "forward",
    "backward",
    "optimizer",
    "gossip",
    "gossip/target",
    "gossip/apply",
    "gossip_apply",
    "gossip_launch",
    "prefill",
    "decode",
)


def _cuda_devices(x: Any, found: set) -> set:
    import torch

    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            found.add(x.device)
    elif isinstance(x, torch.device):
        if x.type == "cuda":
            found.add(x)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, found)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, found)
    return found


def fence(x: Any) -> Any:
    """Wait until every card that holds a tensor in ``x`` (a tensor, a
    device, or dicts / lists / tuples of them) has finished its queued
    work; returns ``x``. Nothing to wait for on the CPU."""
    devices = _cuda_devices(x, set())
    if devices:
        import torch

        for dev in devices:
            torch.cuda.synchronize(dev)
    return x


class _NullSpan:
    """Shared do-nothing span for disabled timers: identity ``fence``,
    no clock reads, no events."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def fence(self, x: Any) -> Any:
        return x


_NULL_SPAN = _NullSpan()


class _Span:
    """One span of an enabled timer (see the module docstring). Created
    by :meth:`StepTimer.phase`."""

    __slots__ = ("_timer", "name", "cat", "step", "tid", "args", "id", "parent",
                 "depth", "t0_ns", "t1_ns", "_stream", "_start", "_end", "counters",
                 "_interval", "_recorded")

    def __init__(self, timer: "StepTimer", name: str, cat: str, step: int, tid: int,
                 args: dict, stream):
        self._timer = timer
        self.name = name
        self.cat = cat
        self.step = step
        self.tid = tid
        self.args = args
        self.id = self.parent = None
        self.depth = 0
        self.t0_ns = self.t1_ns = 0
        self._stream = stream
        self._start = self._end = None
        self.counters: Dict[str, Any] = {}
        self._interval = None     # (start us from the timer's anchor, dur us), once read
        self._recorded = False

    def __enter__(self) -> "_Span":
        timer = self._timer
        self.id = timer._next_id
        timer._next_id += 1
        self.parent = timer._open[-1] if timer._open else None
        self.depth = len(timer._open)
        timer._open.append(self.id)
        self.t0_ns = time.time_ns()
        if self._stream is not None:
            import torch

            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(self._stream)
            if timer._anchor is None:
                timer._anchor = self._start
        return self

    def __exit__(self, *exc) -> bool:
        if self._stream is not None:
            import torch

            self._end = torch.cuda.Event(enable_timing=True)
            self._end.record(self._stream)
        self.t1_ns = time.time_ns()
        self._timer._open.pop()
        if self._end is None and not self.counters:
            self._record()
        else:
            self._timer._pending.append(self)
        return False

    def fence(self, x: Any) -> Any:
        """Wait for the work behind ``x``; returns ``x``."""
        return fence(x)

    def count(self, **counters) -> None:
        """Attach counters (device tensors or numbers), read with the span."""
        self.counters.update(counters)

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6

    def device_interval(self) -> Optional[Tuple[float, float]]:
        """``(start, duration)`` in us: the start from the timer's first
        CUDA event, on the device's clock; ``None`` without events. Waits
        for the span's end event."""
        if self._end is None:
            return None
        if self._interval is None:
            self._end.synchronize()
            anchor = self._timer._anchor
            self._interval = (anchor.elapsed_time(self._start) * 1e3,
                              self._start.elapsed_time(self._end) * 1e3)
        return self._interval

    def ms(self) -> float:
        """The span's time: its device interval's where it has one."""
        dev = self.device_interval()
        return dev[1] / 1e3 if dev is not None else self.host_ms

    def counts(self) -> Dict[str, float]:
        return {k: float(v) for k, v in self.counters.items()}

    def event(self) -> TraceEvent:
        """The span as the recorder keeps it (reading it first)."""
        args = dict(self.args, id=self.id, parent=self.parent)
        dev = self.device_interval()
        if dev is not None:
            args["device_start_us"], args["device_dur_us"] = dev
        args.update(self.counts())
        rec = self._timer.recorder
        return TraceEvent(name=self.name, cat=self.cat, ts_us=rec.us(self.t0_ns),
                          dur_us=(self.t1_ns - self.t0_ns) / 1e3, step=self.step,
                          pid=self._timer.pid, tid=self.tid, depth=self.depth, args=args)

    def _record(self) -> None:
        if not self._recorded:
            self._recorded = True
            self._timer.recorder.record(self.event())


class StepTimer:
    """Span timer bound to one :class:`TraceRecorder`.

    ``StepTimer(recorder)`` is enabled; ``StepTimer(None)`` (or
    ``enabled=False``) is the zero-cost off state — every ``phase()``
    call returns the same no-op span object.

    Usage::

        with timer.phase("gossip", step=k, device=dev) as span:
            ...                       # nothing waits for the card
        timer.read()                  # read the device intervals, record

    Spans nest; each records its parent's id and its nesting ``depth``.
    """

    def __init__(
        self,
        recorder: Optional[TraceRecorder] = None,
        *,
        enabled: Optional[bool] = None,
        pid: int = 0,
    ):
        self.recorder = recorder
        self.enabled = (recorder is not None) if enabled is None else bool(enabled)
        if self.enabled and recorder is None:
            raise ValueError("an enabled StepTimer needs a TraceRecorder")
        self.pid = int(pid)
        self._next_id = 1
        self._open: List[int] = []      # ids of the spans open now, outermost first
        # closed spans not yet recorded, bounded as the recorder is
        self._pending: deque = deque(maxlen=recorder.capacity if recorder else 1)
        self._anchor = None             # the first CUDA event of any span

    def phase(
        self,
        name: str,
        *,
        cat: str = "phase",
        step: int = -1,
        tid: int = 0,
        device=None,
        **args: Any,
    ):
        """Context manager for one span (see the module docstring): with a
        CUDA ``device``, its device interval from events on that device's
        current stream. ``args`` become the event's ``args``."""
        if not self.enabled:
            return _NULL_SPAN
        stream = None
        if device is not None:
            import torch

            device = torch.device(device)
            if device.type == "cuda":
                stream = torch.cuda.current_stream(device)
        return _Span(self, name, cat, int(step), int(tid), dict(args), stream)

    def read(self) -> None:
        """Read every closed span's device interval and counters (waiting
        for the card) and record them."""
        while self._pending:
            self._pending.popleft()._record()

    def record(self, event: TraceEvent) -> None:
        """Record an event timed elsewhere; no-op when off."""
        if self.enabled:
            self.recorder.record(event)

    def measure(
        self,
        name: str,
        fn: Callable[[], Any],
        *,
        cat: str = "probe",
        step: int = -1,
        tid: int = 1,
        **args: Any,
    ) -> Tuple[Any, float]:
        """Run ``fn()`` fenced inside one span; returns
        ``(result, dur_ms)``. With the timer disabled the call still
        fences (a measurement was explicitly requested) but records
        nothing and returns ``dur_ms`` from a local clock."""
        if not self.enabled:
            t0 = time.perf_counter()
            out = fence(fn())
            return out, (time.perf_counter() - t0) * 1e3
        with self.phase(name, cat=cat, step=step, tid=tid, **args) as span:
            t0 = time.perf_counter()
            out = span.fence(fn())
            dur = (time.perf_counter() - t0) * 1e3
        return out, dur


class StepSpans:
    """The spans of one step: ``spans(name, **args)`` opens one on the
    step's device (a context manager), and the view reads them:
    ``ms()`` name -> ms summed over the step, ``counts()`` each counter
    summed, ``events()`` the recorded form."""

    def __init__(self, timer: StepTimer, *, step: int = -1, device=None):
        self.timer = timer
        self.step = int(step)
        self.device = device
        self.spans: List[_Span] = []

    def __call__(self, name: str, *, cat: str = "phase", tid: int = 0, **args: Any) -> _Span:
        span = self.timer.phase(name, cat=cat, step=self.step, tid=tid, device=self.device,
                                **args)
        self.spans.append(span)
        return span

    def ms(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for span in self.spans:
            out[span.name] = out.get(span.name, 0.0) + span.ms()
        return out

    def counts(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for span in self.spans:
            for k, v in span.counts().items():
                out[k] = out.get(k, 0.0) + v
        return out

    def events(self) -> List[TraceEvent]:
        for span in self.spans:
            span._record()
        return [span.event() for span in self.spans]


class _NoSpans:
    """The spans of a step built with a disabled timer: every call is
    the shared no-op span."""

    __slots__ = ()

    def __call__(self, name: str, **args: Any) -> _NullSpan:
        return _NULL_SPAN


NO_SPANS = _NoSpans()


def timed_step(step_fn: Callable, timer: StepTimer, *, name: str = "step"):
    """Wrap a step so each call is one fenced ``"step"``-category span.
    With a disabled timer this returns ``step_fn`` itself — the same
    object, so the no-trace path runs the unchanged step.

    The wrapper threads a ``step=`` keyword (consumed, not forwarded)
    for the event's step index."""
    if not timer.enabled:
        return step_fn

    def wrapped(*args, step: int = -1, **kwargs):
        with timer.phase(name, cat="step", step=step) as span:
            out = step_fn(*args, **kwargs)
            span.fence(out)
        return out

    return wrapped
