"""Measured wall-clock telemetry for the port's runtime.

The port of ``repro.telemetry``. MATCHA's headline claim is an
error-runtime win — less wall-clock time to the same loss — while the
training CLI charges time with the paper's linear delay model; this
package is the measurement side.

* :mod:`repro_torch.telemetry.trace` — the event model, a copy of the
  JAX package's: ``TraceEvent``, ``TraceRecorder`` (bounded ring
  buffer), the JSONL event log and the lossless Chrome-trace export,
  under the same schema ``repro.telemetry/1``.
* :mod:`repro_torch.telemetry.timers` — ``StepTimer``: phase spans
  fenced with ``torch.cuda.synchronize`` when tracing is on, and a
  zero-cost off path (``timed_step`` returns the wrapped callable
  itself).
* :mod:`repro_torch.telemetry.probes` — per-matching gather probes
  timed with CUDA events and the per-step metrics record.

Nothing here imports ``repro_torch.dist``; ``torch`` is imported only
where a span fences or a probe runs, so reading a trace file needs
neither.
"""
from __future__ import annotations

from repro_torch.telemetry.timers import PHASES, StepTimer, timed_step
from repro_torch.telemetry.trace import (
    TraceEvent,
    TraceRecorder,
    from_chrome_trace,
    read_jsonl,
    to_chrome_trace,
    write_chrome_trace,
    write_jsonl,
)

__all__ = [
    "PHASES",
    "StepTimer",
    "TraceEvent",
    "TraceRecorder",
    "from_chrome_trace",
    "read_jsonl",
    "timed_step",
    "to_chrome_trace",
    "write_chrome_trace",
    "write_jsonl",
]
