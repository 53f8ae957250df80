"""Trace event model: ring buffer, JSONL event log, Chrome-trace export.

A copy of ``repro.telemetry.trace`` (pure Python), kept in the port so
that nothing here imports the JAX package. The schema, the file names
and both export forms are the same, so the JAX package's readers load
the port's files and the reverse (``tests/test_torch_telemetry.py``).

One ``TraceEvent`` is a *completed* span — there are no begin/end pairs
to mismatch. Timestamps and durations are host-clock **microseconds**;
``ts_us`` is relative to the owning :class:`TraceRecorder`'s epoch (its
construction time), so events from one run share one time origin and
the exported trace starts near t=0. The host clock is the Unix-epoch
wall clock (``time.time_ns``), the one torch.profiler stamps its events
with, and both export headers carry the epoch in Unix nanoseconds
(``meta["epoch_unix_ns"]``): ``epoch_unix_ns + 1000 * ts_us`` puts an
event on a profile's axis.

Two interchangeable on-disk forms, both produced by
:meth:`TraceRecorder.flush`:

* **JSONL event log** (``events.jsonl``): line 1 is a header object
  (``{"schema": "repro.telemetry/1", "meta": {...}, "dropped": N}``),
  every following line one event. Grep/pandas-friendly, append-safe.
* **Chrome trace** (``trace.json``): the ``traceEvents`` JSON format
  that ``chrome://tracing`` and https://ui.perfetto.dev load directly.
  Every event becomes one complete (``"ph": "X"``) slice; ``pid``/
  ``tid`` map to the recorder's process/lane ids, and the fields the
  Chrome format has no column for (``step``, ``depth``, extra args)
  ride in ``args`` — so :func:`from_chrome_trace` inverts
  :func:`to_chrome_trace` losslessly (the round-trip is tested).

The ring buffer is bounded (``capacity`` events, default 64k): a
forgotten ``--trace`` on a week-long run degrades to keeping the most
recent window instead of eating the host's memory. Dropped-event counts
are reported in the JSONL header and the Chrome trace's ``otherData``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

SCHEMA = "repro.telemetry/1"

# canonical file names inside a --trace directory
EVENTS_JSONL = "events.jsonl"
CHROME_TRACE = "trace.json"


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One completed span.

    ``name``    what ran (e.g. ``"step"``, ``"fwd_bwd"``,
                ``"gossip/matching3"``).
    ``cat``     coarse category used for aggregation and Perfetto
                filtering: ``"step"`` | ``"phase"`` | ``"comm"`` |
                ``"serve"`` | ``"probe"`` | ``"fault"`` (injected
                fault instants — ``repro_torch.faults``).
    ``ts_us``   span start, microseconds since the recorder epoch.
    ``dur_us``  span length, microseconds (>= 0).
    ``step``    training/decoding step index, -1 when not step-scoped.
    ``pid``     process id lane (one per host process; 0 single-host).
    ``tid``     thread lane: 0 = step phases, 1 = comm probes.
    ``depth``   phase-nesting depth at record time (0 = outermost).
    ``args``    free-form JSON-serializable extras (counts, bytes, ...).
    """

    name: str
    cat: str
    ts_us: float
    dur_us: float
    step: int = -1
    pid: int = 0
    tid: int = 0
    depth: int = 0
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if not d["args"]:
            del d["args"]
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "TraceEvent":
        return cls(
            name=d["name"],
            cat=d["cat"],
            ts_us=float(d["ts_us"]),
            dur_us=float(d["dur_us"]),
            step=int(d.get("step", -1)),
            pid=int(d.get("pid", 0)),
            tid=int(d.get("tid", 0)),
            depth=int(d.get("depth", 0)),
            args=dict(d.get("args", {})),
        )


class TraceRecorder:
    """Bounded in-memory event sink shared by every timer of one run.

    ``record`` is O(1) and allocation-light (one dataclass per event);
    the flush to disk happens once, at the end of the run. ``meta`` is
    free-form run provenance (arch, nodes, gossip mode, ...) carried
    into both export headers.
    """

    def __init__(
        self,
        *,
        capacity: int = 65536,
        meta: Optional[Dict[str, Any]] = None,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.meta: Dict[str, Any] = dict(meta or {})
        self._events: deque = deque(maxlen=self.capacity)
        self.num_recorded = 0          # total ever seen (>= len(events))
        self.epoch_ns = time.time_ns()

    # -- recording -----------------------------------------------------------
    def now_us(self) -> float:
        """Microseconds since the recorder epoch (the Unix wall clock)."""
        return self.us(time.time_ns())

    def us(self, unix_ns: int) -> float:
        """A Unix-clock instant in microseconds since the recorder epoch."""
        return (unix_ns - self.epoch_ns) / 1e3

    def record(self, event: TraceEvent) -> None:
        self._events.append(event)
        self.num_recorded += 1

    @property
    def num_dropped(self) -> int:
        return self.num_recorded - len(self._events)

    def events(self) -> List[TraceEvent]:
        """Snapshot of the retained events, in record order."""
        return list(self._events)

    # -- export --------------------------------------------------------------
    def flush(self, out_dir: str) -> Tuple[str, str]:
        """Write both export forms into ``out_dir``; returns
        ``(jsonl_path, chrome_path)``."""
        os.makedirs(out_dir, exist_ok=True)
        events = self.events()
        meta = dict(self.meta, epoch_unix_ns=self.epoch_ns)
        jsonl = os.path.join(out_dir, EVENTS_JSONL)
        chrome = os.path.join(out_dir, CHROME_TRACE)
        write_jsonl(events, jsonl, meta=meta, dropped=self.num_dropped)
        write_chrome_trace(events, chrome, meta=meta,
                           dropped=self.num_dropped)
        return jsonl, chrome


# ---------------------------------------------------------------------------
# JSONL event log
# ---------------------------------------------------------------------------
def write_jsonl(
    events: Iterable[TraceEvent],
    path: str,
    *,
    meta: Optional[Dict[str, Any]] = None,
    dropped: int = 0,
) -> None:
    """Header line + one event per line (see module docstring)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps(
            {"schema": SCHEMA, "meta": dict(meta or {}),
             "dropped": int(dropped)}
        ) + "\n")
        for ev in events:
            f.write(json.dumps(ev.to_json()) + "\n")


def read_jsonl(path: str) -> Tuple[Dict[str, Any], List[TraceEvent]]:
    """Inverse of :func:`write_jsonl`: ``(header, events)``. Raises
    ``ValueError`` on a missing/foreign schema header."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty event log")
    header = json.loads(lines[0])
    if header.get("schema") != SCHEMA:
        raise ValueError(
            f"{path}: expected schema {SCHEMA!r}, "
            f"got {header.get('schema')!r}"
        )
    return header, [TraceEvent.from_json(json.loads(ln)) for ln in lines[1:]]


# ---------------------------------------------------------------------------
# Chrome trace (chrome://tracing / Perfetto)
# ---------------------------------------------------------------------------
_CHROME_ARG_KEYS = ("step", "depth")   # TraceEvent fields tunneled via args


def to_chrome_trace(
    events: Iterable[TraceEvent],
    *,
    meta: Optional[Dict[str, Any]] = None,
    dropped: int = 0,
) -> Dict[str, Any]:
    """Chrome ``traceEvents`` object: one complete ("X") slice per
    event. ``ts``/``dur`` stay in microseconds (the format's native
    unit), so no precision is lost across the round-trip."""
    out = []
    for ev in events:
        args = dict(ev.args)
        for k in _CHROME_ARG_KEYS:
            args[k] = getattr(ev, k)
        out.append({
            "name": ev.name,
            "cat": ev.cat,
            "ph": "X",
            "ts": ev.ts_us,
            "dur": ev.dur_us,
            "pid": ev.pid,
            "tid": ev.tid,
            "args": args,
        })
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "schema": SCHEMA,
            "meta": dict(meta or {}),
            "dropped": int(dropped),
        },
    }


def from_chrome_trace(doc: Dict[str, Any]) -> List[TraceEvent]:
    """Inverse of :func:`to_chrome_trace` for the events this package
    wrote (complete "X" slices; other phase kinds are rejected — this
    is a round-trip check, not a general Chrome-trace parser)."""
    events = []
    for e in doc["traceEvents"]:
        if e.get("ph") != "X":
            raise ValueError(
                f"unsupported Chrome event phase {e.get('ph')!r} "
                "(only complete 'X' slices round-trip)"
            )
        args = dict(e.get("args", {}))
        step = int(args.pop("step", -1))
        depth = int(args.pop("depth", 0))
        events.append(TraceEvent(
            name=e["name"],
            cat=e.get("cat", ""),
            ts_us=float(e["ts"]),
            dur_us=float(e["dur"]),
            step=step,
            pid=int(e.get("pid", 0)),
            tid=int(e.get("tid", 0)),
            depth=depth,
            args=args,
        ))
    return events


def write_chrome_trace(
    events: Iterable[TraceEvent],
    path: str,
    *,
    meta: Optional[Dict[str, Any]] = None,
    dropped: int = 0,
) -> None:
    """Write ``to_chrome_trace(events)`` as JSON to ``path`` (loads in
    chrome://tracing / Perfetto), creating parent dirs as needed."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(to_chrome_trace(events, meta=meta, dropped=dropped), f)


def read_chrome_trace(path: str) -> List[TraceEvent]:
    """Load a ``write_chrome_trace`` file back into ``TraceEvent``s."""
    with open(path) as f:
        return from_chrome_trace(json.load(f))
