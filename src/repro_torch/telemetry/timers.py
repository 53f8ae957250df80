"""Device-synchronized phase timers with a zero-cost off path.

The port of ``repro.telemetry.timers``. ``StepTimer`` measures the
host-observed wall time of work PyTorch queues on the card. Kernel
launches return before the card finishes, so ``t1 - t0`` around a call
measures only the enqueue unless the span is fenced; a phase span
therefore ends with ``span.fence(outputs)``, which runs
``torch.cuda.synchronize`` on every card that holds a tensor in
``outputs`` (on the CPU the work is done when the call returns, and
the fence does nothing). That fence is also the overhead: it
serializes the host and the card at every phase boundary, so per-phase
numbers are only collected when tracing is on.

Off path: a disabled timer's ``phase(...)`` returns a shared no-op span
whose ``fence`` is identity, and :func:`timed_step` returns the wrapped
callable unchanged (``timed_step(f, off) is f``), so a run without
``--trace`` runs the same code: no fences, no events.

Phase names are free-form; the canonical ones the port emits are in
``PHASES``. Spans nest (``depth`` is recorded per event): the train
CLI wraps the whole step in a ``"step"`` span and the phased step
emits child spans per runtime phase.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional, Tuple

from repro_torch.telemetry.trace import TraceEvent, TraceRecorder

# Canonical phase names (free-form names are also fine):
#   step            one whole train step (fenced outputs)
#   fwd_bwd         forward + backward on one node's batch
#   optimizer       one node's update
#   gossip          the per-step matching exchange (sequential modes)
#   gossip_launch   the overlap step's exchange on its side stream
#                   (cat "comm", tid 1; timed by CUDA events, not fenced)
#   gossip/matchingJ   one matching's gather (comm probes)
#   prefill / decode   serve-side spans
PHASES: Tuple[str, ...] = (
    "step",
    "fwd_bwd",
    "optimizer",
    "gossip",
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
    """One live phase span of an enabled timer. Created by
    :meth:`StepTimer.phase`; records its ``TraceEvent`` on exit."""

    __slots__ = ("_timer", "name", "cat", "step", "tid", "args",
                 "_t0_us", "depth")

    def __init__(self, timer: "StepTimer", name: str, cat: str,
                 step: int, tid: int, args: dict):
        self._timer = timer
        self.name = name
        self.cat = cat
        self.step = step
        self.tid = tid
        self.args = args
        self._t0_us = 0.0
        self.depth = 0

    def __enter__(self) -> "_Span":
        self.depth = self._timer._enter()
        self._t0_us = self._timer.recorder.now_us()
        return self

    def fence(self, x: Any) -> Any:
        """Wait for the work behind ``x``; returns ``x``. Call on the
        phase's outputs so the span covers the device work."""
        return fence(x)

    def __exit__(self, *exc) -> bool:
        t1 = self._timer.recorder.now_us()
        self._timer._exit()
        self._timer.recorder.record(TraceEvent(
            name=self.name,
            cat=self.cat,
            ts_us=self._t0_us,
            dur_us=max(t1 - self._t0_us, 0.0),
            step=self.step,
            pid=self._timer.pid,
            tid=self.tid,
            depth=self.depth,
            args=self.args,
        ))
        return False


class StepTimer:
    """Phase timer bound to one :class:`TraceRecorder`.

    ``StepTimer(recorder)`` is enabled; ``StepTimer(None)`` (or
    ``enabled=False``) is the zero-cost off state — every ``phase()``
    call returns the same no-op span object.

    Usage::

        with timer.phase("step", cat="step", step=k) as span:
            out = step_fn(params, opt_state, batch, bits)
            span.fence(out)          # synchronize when enabled

    Spans may nest; each recorded event carries its nesting ``depth``
    and a start timestamp from the recorder's monotonic clock.
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
        self._depth = 0

    # -- nesting bookkeeping (enabled path only) -----------------------------
    def _enter(self) -> int:
        d = self._depth
        self._depth += 1
        return d

    def _exit(self) -> None:
        self._depth -= 1

    # -- public API ----------------------------------------------------------
    def phase(
        self,
        name: str,
        *,
        cat: str = "phase",
        step: int = -1,
        tid: int = 0,
        **args: Any,
    ):
        """Context manager for one span (see class docstring). ``args``
        become the event's free-form ``args`` dict."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, int(step), int(tid), dict(args))

    def record(self, event: TraceEvent) -> None:
        """Record a span timed elsewhere (CUDA events); no-op when off."""
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
