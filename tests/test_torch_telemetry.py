"""The port's telemetry against ``repro.telemetry``.

* The trace model is a copy: JSONL and Chrome round trips, files the
  port writes load in the JAX package's readers and the reverse, the
  ring buffer drops the oldest.
* The off path is free: a disabled timer's spans are one shared no-op
  and ``timed_step(f, off) is f``.
* ``step_metrics`` / ``format_metrics_line`` equal the JAX package's on
  the same inputs (exactly: the same Python).
* ``measure_matchings`` on the CPU: one row per matching, the JAX
  package's fields, and ``gossip/matching{j}`` events (cat ``comm``,
  tid 1).
* The phased step (fenced, recorded spans) is bit-equal to the unphased
  step, refuses overlap with the JAX message, and an overlap step with a
  timer records its ``gossip_launch`` spans.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.telemetry as jt
from repro.telemetry import probes as jprobes
from repro_torch import core
from repro_torch import telemetry as tt
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import DecentralizedBatches
from repro_torch.dist import decen_train as dt
from repro_torch.models.transformer import Model
from repro_torch.optim.optimizers import sgd
from repro_torch.telemetry import probes as tprobes
from repro_torch.telemetry import trace as ttrace
from repro_torch.tree import flatten

NODES = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several test workers at once,
    and oversubscribed OpenMP threads slow these training loops tenfold
    (one thread is as fast here when the file runs alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _events(mod):
    return [
        mod.TraceEvent(name="step", cat="step", ts_us=100, dur_us=5000, step=0),
        mod.TraceEvent(name="fwd_bwd", cat="phase", ts_us=150, dur_us=3000, step=0,
                       depth=1, args={"node": 3}),
        mod.TraceEvent(name="gossip/matching2", cat="comm", ts_us=9000, dur_us=40,
                       tid=1, args={"bytes": 1024, "mode": "probe"}),
    ]


def test_schema_and_file_names_are_the_jax_packages():
    from repro.telemetry import trace as jtrace

    assert ttrace.SCHEMA == jtrace.SCHEMA == "repro.telemetry/1"
    assert (ttrace.EVENTS_JSONL, ttrace.CHROME_TRACE) == (jtrace.EVENTS_JSONL,
                                                          jtrace.CHROME_TRACE)
    assert set(tt.__all__) == set(jt.__all__)


def test_jsonl_and_chrome_round_trips(tmp_path):
    events = _events(tt)
    path = str(tmp_path / "events.jsonl")
    tt.write_jsonl(events, path, meta={"arch": "x"}, dropped=3)
    header, back = tt.read_jsonl(path)
    assert header == {"schema": "repro.telemetry/1", "meta": {"arch": "x"}, "dropped": 3}
    assert back == events
    doc = tt.to_chrome_trace(events, meta={"a": 1}, dropped=2)
    assert all(e["ph"] == "X" for e in doc["traceEvents"])
    assert tt.from_chrome_trace(doc) == events
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as f:
        f.write('{"schema": "other/1"}\n')
    with pytest.raises(ValueError, match="schema"):
        tt.read_jsonl(bad)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_files_load_in_the_other_packages_readers(tmp_path, writer):
    from repro.telemetry import trace as jtrace

    src, dst = (ttrace, jtrace) if writer == "port" else (jtrace, ttrace)
    rec = src.TraceRecorder(meta={"gossip_mode": "overlap"})
    for ev in _events(src):
        rec.record(ev)
    jsonl, chrome = rec.flush(str(tmp_path))
    header, events = dst.read_jsonl(jsonl)
    assert header["meta"] == {"gossip_mode": "overlap"}
    as_json = lambda evs: [e.to_json() for e in evs]
    assert as_json(events) == as_json(_events(src))
    assert as_json(dst.read_chrome_trace(chrome)) == as_json(_events(src))


def test_ring_buffer_drops_oldest():
    rec = tt.TraceRecorder(capacity=4)
    for i in range(10):
        rec.record(tt.TraceEvent(name=f"e{i}", cat="step", ts_us=i, dur_us=1))
    assert [e.name for e in rec.events()] == ["e6", "e7", "e8", "e9"]
    assert rec.num_recorded == 10 and rec.num_dropped == 6
    with pytest.raises(ValueError):
        tt.TraceRecorder(capacity=0)


def test_disabled_timer_is_structurally_free():
    off = tt.StepTimer(None)
    assert not off.enabled
    s1, s2 = off.phase("step"), off.phase("fwd_bwd", step=3)
    assert s1 is s2
    obj = object()
    with s1 as sp:
        assert sp.fence(obj) is obj

    def f(a, b):
        return a + b

    assert tt.timed_step(f, off) is f
    out, ms = off.measure("x", lambda: 7)
    assert out == 7 and ms >= 0.0
    with pytest.raises(ValueError):
        tt.StepTimer(None, enabled=True)


def test_enabled_timer_nests_and_records():
    rec = tt.TraceRecorder()
    timer = tt.StepTimer(rec)
    step = tt.timed_step(lambda x: x * 2, timer)
    with timer.phase("outer", cat="step", step=1):
        with timer.phase("inner", step=1, node=2):
            pass
    assert step(torch.ones(2), step=5).tolist() == [2.0, 2.0]
    evs = rec.events()
    assert [(e.name, e.depth) for e in evs] == [("inner", 1), ("outer", 0), ("step", 0)]
    assert evs[0].args == {"node": 2} and evs[2].step == 5
    assert evs[1].ts_us <= evs[0].ts_us and evs[0].dur_us <= evs[1].dur_us


def test_step_metrics_equal_the_jax_packages():
    cases = [
        dict(step=3, step_ms=50.0, comm_ms=10.0, gossip_mode="masked", comm_bytes=4096,
             phase_ms={"fwd_bwd": 35.0, "gossip": 10.0}),
        dict(step=0, step_ms=50.0, comm_ms=30.0, gossip_mode="overlap"),
        dict(step=7, step_ms=12.3456789, comm_ms=99.0, gossip_mode="overlap",
             comm_bytes=10),
        dict(step=1, step_ms=0.0, comm_ms=1.0, gossip_mode="static"),
    ]
    for kw in cases:
        got, want = tprobes.step_metrics(**kw), jprobes.step_metrics(**kw)
        assert got == want
        assert tprobes.format_metrics_line(got) == jprobes.format_metrics_line(want)
    for samples in ([], [1.0, 2.0, 10.0]):
        assert tprobes.summarize_ms(samples) == jprobes.summarize_ms(samples)
    rec = tt.TraceRecorder()
    tprobes.fault_event(rec, step=4, kind="link_drop", dropped_exchanges=2)
    tprobes.fault_event(None, step=4, kind="crash")
    (ev,) = rec.events()
    assert (ev.name, ev.cat, ev.step, ev.tid, ev.args) == (
        "fault/link_drop", "fault", 4, 1, {"dropped_exchanges": 2})
    # the FSDP collectives' probe, at a world of one on the CPU
    from repro_torch.dist import fsdp
    from repro_torch.launch.mesh import make_test_mesh

    spec = dt.make_spec(make_test_mesh(), 4)
    layout = fsdp.make_layout(Model(get_smoke_config("internlm2_1_8b")), spec)
    got = tprobes.measure_fsdp_collectives(spec, layout, timer=tt.StepTimer(rec), iters=2)
    assert got["gather"]["n"] == got["reduce_scatter"]["n"] == 2
    assert got["bytes_per_node"] == 4 * layout.plan.total_elements
    assert [e.name for e in rec.events()[1:]] == ["gather"] * 2 + ["reduce_scatter"] * 2


def test_measure_matchings_rows_on_the_cpu():
    plan = core.plan_matcha(core.named_graph("paper8", NODES, seed=3), 0.5, seed=0)
    rec = tt.TraceRecorder()
    rows = tprobes.measure_matchings(plan, per_node_elements=1000, iters=2,
                                     timer=tt.StepTimer(rec), device="cpu")
    assert [r["matching"] for r in rows] == list(range(plan.num_matchings))
    for r in rows:
        assert set(r) == {"matching", "bytes_per_node", "mean_ms", "p50_ms", "p95_ms", "n"}
        assert r["bytes_per_node"] == 4000 and r["n"] == 2 and r["mean_ms"] >= 0
    evs = rec.events()
    assert len(evs) == 2 * plan.num_matchings
    assert {(e.name, e.cat, e.tid) for e in evs} == {
        (f"gossip/matching{j}", "comm", 1) for j in range(plan.num_matchings)}
    assert evs[0].args == {"bytes_per_node": 4000, "matching": 0}


def _tiny_run(make_step, steps=2, overlap=False):
    cfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), compute_dtype="float32")
    model = Model(cfg)
    plan = core.plan_matcha(core.named_graph("paper8", NODES, seed=3), 0.5, seed=0)
    sched = plan.schedule(steps, seed=0)
    opt = sgd(0.05, momentum=0.9)
    params = dt.init_stacked_params(model, NODES, seed=0, device="cpu")
    opt_state = dt.init_stacked_opt_state(opt, model, NODES, device="cpu")
    data = DecentralizedBatches(cfg, NODES, 2, 16, seed=0, device="cpu")
    step = make_step(model, opt, plan)
    gstate = dt.init_gossip_state(plan, step.bplan, device="cpu") if overlap else None
    phase_ms = []
    for k in range(steps):
        bits = torch.as_tensor(sched.activations[k].astype(np.float32))
        if overlap:
            params, opt_state, gstate, losses, _ = step(params, opt_state, gstate,
                                                        next(data), bits, step=k)
        else:
            params, opt_state, losses, _ = step(params, opt_state, next(data), bits, step=k)
        phase_ms.append(step.last_phase_ms)
    return flatten({"p": params, "s": opt_state}), losses, phase_ms


@pytest.mark.parametrize("mode", ["masked", "static"])
def test_phased_step_is_bit_equal_to_the_unphased_step(mode):
    rec = tt.TraceRecorder()
    timer = tt.StepTimer(rec)
    active = (0, 2, 3)
    plain = _tiny_run(lambda m, o, p: dt.make_train_step(m, o, p, gossip_mode=mode,
                                                         active=active))
    phased = _tiny_run(lambda m, o, p: dt.make_phased_train_step(
        m, o, p, timer=timer, gossip_mode=mode, active=active))
    for path, t in plain[0].items():
        assert torch.equal(phased[0][path], t), path
    assert torch.equal(phased[1], plain[1])
    for ms in phased[2]:
        assert set(ms) == {"fwd_bwd", "optimizer", "gossip"} and all(v >= 0 for v in ms.values())
    evs = rec.events()
    # per step: fwd_bwd and optimizer for each node, then gossip
    assert [(e.name, e.step) for e in evs if e.name == "gossip"] == [("gossip", 0), ("gossip", 1)]
    assert sorted(e.args["node"] for e in evs if e.name == "fwd_bwd" and e.step == 1) == \
        list(range(NODES))
    assert {e.cat for e in evs} == {"phase"}


def test_phased_step_refuses_overlap_and_the_overlap_step_records_its_launch():
    plan = core.plan_matcha(core.named_graph("paper8", NODES, seed=3), 0.5, seed=0)
    with pytest.raises(ValueError, match="fencing phases would serialize"):
        dt.make_phased_train_step(None, sgd(0.1), plan, gossip_mode="overlap")
    rec = tt.TraceRecorder()
    timer = tt.StepTimer(rec)
    traced = _tiny_run(lambda m, o, p: dt.make_train_step(
        m, o, p, gossip_mode="overlap", timer=timer), overlap=True)
    plain = _tiny_run(lambda m, o, p: dt.make_train_step(
        m, o, p, gossip_mode="overlap"), overlap=True)
    for path, t in plain[0].items():
        assert torch.equal(traced[0][path], t), path
    launches = [e for e in rec.events() if e.name == "gossip_launch"]
    assert [(e.cat, e.tid, e.step) for e in launches] == [("comm", 1, 0), ("comm", 1, 1)]
    assert all(e.dur_us >= 0 and e.args == {"buckets": 1} for e in launches)
