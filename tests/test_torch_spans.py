"""The port's span system inside the train steps (``telemetry.timers``).

* Spans nest: each names the span open around it as its parent; each
  node's ``forward`` and ``backward`` sit once inside its ``fwd_bwd``,
  and each leaf's ``gossip/target`` and ``gossip/apply`` once inside the
  step's ``gossip`` (overlap: ``gossip_apply`` and ``gossip_launch``), in
  masked, static and overlap mode, and in the sharded step's layouts.
* Off is off: a step built with a disabled timer (``StepTimer(None)``)
  reads no clock, creates no CUDA event and keeps no spans (the clocks
  and ``torch.cuda.Event`` patched to raise).
* A step built without a timer keeps the traced step's spans, without
  the counters, for ``last_phases`` (what the benchmark's traced run
  reads).
* A traced step, and one built without a timer, are bit-equal to the
  untraced one in masked, static and overlap mode, with the (M,) row and
  with per-node bits.
* The gossip's counter equals the schedule's share, worked out by hand.
* The export round-trips, the JAX package's readers load it, and its
  epoch puts the spans on the Unix clock.
* The training CLI's ``--trace`` never fences.
"""
import dataclasses
import functools
import time

import numpy as np
import pytest
import torch

from repro.telemetry import trace as jtrace
from repro_torch import core
from repro_torch import telemetry as tt
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.pipeline import DecentralizedBatches
from repro_torch.dist import decen_train as dt
from repro_torch.dist import fsdp
from repro_torch.faults import FaultSpec, make_fault_schedule
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.transformer import Model
from repro_torch.optim.optimizers import sgd
from repro_torch.telemetry import timers
from repro_torch.telemetry import trace as ttrace
from repro_torch.tree import flatten

NODES, STEPS = 8, 2
ACTIVE = (0, 2, 3)          # the static step's matchings
MODES = ("masked", "static", "overlap")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several test workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), compute_dtype="float32")
    plan = core.plan_matcha(core.named_graph("paper8", NODES, seed=3), 0.5, seed=0)
    return cfg, plan, plan.schedule(STEPS, seed=0)


def _bits(k: int, faulted: bool) -> np.ndarray:
    _, plan, sched = _setup()
    row = sched.activations[k].astype(np.float32)
    if not faulted:
        return row
    return make_fault_schedule(plan, STEPS, FaultSpec(p_drop=0.35, seed=0)).node_bits(row, k)


def _run(mode: str, faulted: bool, timer=None):
    """``STEPS`` steps from one state; the state, the losses and each
    step's ``last_phases``."""
    cfg, plan, _ = _setup()
    model = Model(cfg)
    opt = sgd(0.05, momentum=0.9)
    params = dt.init_stacked_params(model, NODES, seed=0, device="cpu")
    opt_state = dt.init_stacked_opt_state(opt, model, NODES, device="cpu")
    data = DecentralizedBatches(cfg, NODES, 2, 16, seed=0, device="cpu")
    batches = [next(data) for _ in range(STEPS)]
    bits = [torch.as_tensor(_bits(k, faulted)) for k in range(STEPS)]
    step = dt.make_train_step(model, opt, plan, gossip_mode=mode, active=ACTIVE,
                              faulted=faulted, timer=timer)
    gstate = dt.init_gossip_state(plan, step.bplan, device="cpu") if mode == "overlap" else None
    views, losses = [], []
    for k in range(STEPS):
        if gstate is not None:
            params, opt_state, gstate, loss, _ = step(params, opt_state, gstate, batches[k],
                                                      bits[k], step=k)
        else:
            params, opt_state, loss, _ = step(params, opt_state, batches[k], bits[k], step=k)
        views.append(step.last_phases)
        losses.append(loss)
    return flatten({"p": params, "s": opt_state}), torch.stack(losses), views


@functools.lru_cache(maxsize=None)
def _traced(mode: str, faulted: bool):
    rec = tt.TraceRecorder()
    timer = tt.StepTimer(rec)
    state, losses, views = _run(mode, faulted, timer)
    timer.read()
    return state, losses, views, rec


@functools.lru_cache(maxsize=None)
def _untraced(mode: str, faulted: bool):
    return _run(mode, faulted, tt.StepTimer(None))


@functools.lru_cache(maxsize=None)
def _default(mode: str, faulted: bool):
    """Built without a timer, as the benchmark builds the step."""
    return _run(mode, faulted)


def _leaves():
    """Each node-stacked fp32 leaf's bytes, by path."""
    cfg, _, _ = _setup()
    return {path: NODES * int(np.prod(shape)) * 4
            for path, (shape, _) in flatten(Model(cfg).param_shapes()).items()}


@pytest.mark.parametrize("mode", MODES)
def test_spans_nest_with_parent_ids_once_per_node_and_leaf(mode):
    *_, rec = _traced(mode, False)
    events = rec.events()
    by_id = {e.args["id"]: e for e in events}
    assert len(by_id) == len(events)
    for e in events:
        parent = e.args["parent"]
        assert (parent is None) == (e.name == "step")
        if parent is not None:
            p = by_id[parent]
            assert p.depth == e.depth - 1 and p.step == e.step
            assert p.ts_us <= e.ts_us and e.ts_us + e.dur_us <= p.ts_us + p.dur_us + 1e-3
    leaves = _leaves()
    for k in range(STEPS):
        mine = [e for e in events if e.step == k]
        named = lambda name: [e for e in mine if e.name == name]
        (top,) = named("step")
        for i in range(NODES):
            (fb,) = [e for e in named("fwd_bwd") if e.args["node"] == i]
            assert fb.args["parent"] == top.args["id"]
            for inner in ("forward", "backward"):
                (sp,) = [e for e in named(inner) if e.args["node"] == i]
                assert sp.args["parent"] == fb.args["id"]
            (opt,) = [e for e in named("optimizer") if e.args["node"] == i]
            assert opt.args["parent"] == top.args["id"]
        if mode == "overlap":
            assert not named("gossip") and not named("gossip/target")
            for name in ("gossip_apply", "gossip_launch"):
                (sp,) = named(name)
                assert sp.args["parent"] == top.args["id"]
            (launch,) = named("gossip_launch")
            assert (launch.cat, launch.tid, launch.args["buckets"]) == ("comm", 1, 1)
            continue
        (gossip,) = named("gossip")
        assert gossip.args["parent"] == top.args["id"]
        for half in ("gossip/target", "gossip/apply"):
            spans = named(half)
            assert all(e.args["parent"] == gossip.args["id"] for e in spans)
            assert {e.args["leaf"]: e.args["bytes"] for e in spans} == leaves
            assert len(spans) == len(leaves)


@pytest.mark.parametrize("mode", MODES)
def test_views_split_the_step_by_span_name(mode):
    _, _, views, _ = _traced(mode, False)
    gossip = {"gossip_apply", "gossip_launch"} if mode == "overlap" else \
        {"gossip", "gossip/target", "gossip/apply"}
    for view in views:
        ms = view.ms()
        assert set(ms) == {"step", "fwd_bwd", "forward", "backward", "optimizer"} | gossip
        assert all(v >= 0 for v in ms.values())
        # on the CPU each span's time is its host interval: children fit inside
        assert ms["forward"] + ms["backward"] <= ms["fwd_bwd"]
        assert ms["fwd_bwd"] + ms["optimizer"] <= ms["step"]
        if mode != "overlap":
            assert ms["gossip/target"] + ms["gossip/apply"] <= ms["gossip"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("faulted", [False, True], ids=["row", "per_node"])
def test_traced_step_is_bit_equal_to_the_untraced_step(mode, faulted):
    traced, t_losses, views, _ = _traced(mode, faulted)
    default, d_losses, d_views = _default(mode, faulted)
    plain, p_losses, p_views = _untraced(mode, faulted)
    assert p_views == [None] * STEPS
    assert all(isinstance(v, timers.StepSpans) for v in views + d_views)
    assert traced.keys() == plain.keys() == default.keys()
    for path, t in plain.items():
        assert torch.equal(traced[path], t), path
        assert torch.equal(default[path], t), path
    assert torch.equal(t_losses, p_losses) and torch.equal(d_losses, p_losses)


@pytest.mark.parametrize("mode", MODES)
def test_an_untraced_step_reads_no_clock_and_makes_no_event(mode, monkeypatch):
    cfg, plan, _ = _setup()
    model = Model(cfg)
    opt = sgd(0.05, momentum=0.9)
    params = dt.init_stacked_params(model, NODES, seed=0, device="cpu")
    opt_state = dt.init_stacked_opt_state(opt, model, NODES, device="cpu")
    batch = next(DecentralizedBatches(cfg, NODES, 2, 16, seed=0, device="cpu"))
    bits = torch.as_tensor(_bits(0, False))
    step = dt.make_train_step(model, opt, plan, gossip_mode=mode, active=ACTIVE,
                              timer=tt.StepTimer(None))
    gstate = dt.init_gossip_state(plan, step.bplan, device="cpu") if mode == "overlap" else None

    def boom(*args, **kwargs):
        raise AssertionError("an untraced step read a clock or made a CUDA event")

    for name in ("time", "time_ns", "perf_counter", "perf_counter_ns", "monotonic",
                 "monotonic_ns"):
        monkeypatch.setattr(time, name, boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    args = (params, opt_state, gstate, batch, bits) if gstate is not None else \
        (params, opt_state, batch, bits)
    out = step(*args, step=0)
    monkeypatch.undo()
    assert torch.isfinite(out[-2]).all()
    assert step.last_phases is None and step.last_phase_ms == {}
    assert not step.timer.enabled


@pytest.mark.parametrize("mode", MODES)
def test_a_step_built_without_a_timer_keeps_its_spans_without_the_counters(mode):
    _, _, views, _ = _traced(mode, False)
    _, _, d_views = _default(mode, False)
    for k, (view, own) in enumerate(zip(views, d_views)):
        assert own.step == k and own.timer is not view.timer
        assert set(own.ms()) == set(view.ms())
        assert [(e.name, e.args.get("node"), e.args.get("leaf")) for e in own.events()] == \
            [(e.name, e.args.get("node"), e.args.get("leaf")) for e in view.events()]
        assert own.counts() == {} and view.counts()
    # a call's spans at a time: the step's own recorder stays bounded
    assert d_views[0].timer is d_views[-1].timer
    assert len(d_views[0].timer.recorder.events()) <= d_views[0].timer.recorder.capacity


@pytest.mark.parametrize("mode,faulted", [("masked", False), ("masked", True),
                                          ("static", False), ("static", True),
                                          ("overlap", False), ("overlap", True)])
def test_the_counter_is_the_schedules_share(mode, faulted):
    _, _, views, _ = _traced(mode, faulted)
    cfg, plan, _ = _setup()
    M = plan.num_matchings
    for k, view in enumerate(views):
        got = view.counts()
        # the training attention's calls ride on the forward and backward
        # spans: fp32 on the CPU, every one plain, each layer again under remat
        assert {key: got.pop(key) for key in ("attention_kernel", "attention_plain")} == {
            "attention_kernel": 0, "attention_plain": 2 * NODES * cfg.num_layers}
        bits = _bits(k, faulted)
        if mode == "static":
            want_pairs = NODES * len(ACTIVE)
            want_set = bits[:, list(ACTIVE)].sum() if faulted else want_pairs
        else:
            want_pairs = NODES * M
            want_set = bits.sum() if faulted else NODES * bits.sum()
        assert got == {"pairs_exchanged": want_pairs, "pairs_set": pytest.approx(want_set)}
    if mode == "masked" and not faulted:
        share = sum(v.counts()["pairs_set"] for v in views) / \
            sum(v.counts()["pairs_exchanged"] for v in views)
        rows = np.stack([_bits(k, False) for k in range(STEPS)])
        assert share == pytest.approx(rows.mean())


def test_export_round_trips_and_the_jax_readers_load_it(tmp_path):
    before = time.time_ns()
    rec = tt.TraceRecorder(meta={"arch": "internlm2_1_8b"})
    timer = tt.StepTimer(rec)
    _run("masked", True, timer)
    after = time.time_ns()
    timer.read()
    events = rec.events()
    jsonl, chrome = rec.flush(str(tmp_path))
    for reader in (ttrace, jtrace):
        header, back = reader.read_jsonl(jsonl)
        assert header["meta"] == {"arch": "internlm2_1_8b", "epoch_unix_ns": rec.epoch_ns}
        assert [e.to_json() for e in back] == [e.to_json() for e in events]
        assert [e.to_json() for e in reader.read_chrome_trace(chrome)] == \
            [e.to_json() for e in events]
    epoch = header["meta"]["epoch_unix_ns"]
    for e in events:
        start = epoch + 1e3 * e.ts_us
        assert before <= start <= start + 1e3 * e.dur_us <= after
        assert {"id", "parent"} <= set(e.args)
    (gossip,) = [e for e in events if e.name == "gossip" and e.step == 0]
    assert gossip.args["pairs_exchanged"] == NODES * 6


@pytest.mark.parametrize("layout", ["monolithic", "streamed"])
def test_the_sharded_step_records_the_same_spans(layout):
    cfg, plan, _ = _setup()
    model = Model(cfg)
    spec = dt.make_spec(make_test_mesh(), NODES)
    lay = fsdp.make_layout(model, spec) if layout == "monolithic" else \
        fsdp.make_stream_layout(model, spec)
    batch = next(DecentralizedBatches(cfg, NODES, 2, 16, seed=0, device="cpu"))
    bits = torch.as_tensor(_bits(0, False))
    out = []
    for timer in (tt.StepTimer(None), None, tt.StepTimer(tt.TraceRecorder())):
        opt = sgd(0.05, momentum=0.9)
        step = fsdp.make_fsdp_train_step(model, opt, plan, spec, lay, timer=timer)
        shards = fsdp.init_fsdp_params(model, lay, spec, device="cpu")
        state = fsdp.init_fsdp_opt_state(opt, lay, spec, device="cpu")
        shards, state, losses, _ = step(shards, state, batch, bits, step=0)
        out.append((shards, losses, step.last_phases))
    (plain, p_losses, none), (default, d_losses, own), (traced, t_losses, view) = out
    assert none is None
    assert all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(plain, traced, default))
    assert torch.equal(p_losses, t_losses) and torch.equal(p_losses, d_losses)
    names = {"step", "fwd_bwd", "forward", "backward", "optimizer", "gossip",
             "gossip/target", "gossip/apply"}
    if layout == "monolithic":
        names |= {"gather", "reduce_scatter"}
    assert set(view.ms()) == set(own.ms()) == names and own.counts() == {}
    assert view.counts() == {"pairs_exchanged": NODES * plan.num_matchings,
                             "pairs_set": NODES * _bits(0, False).sum()}


@pytest.mark.parametrize("mode", ["masked", "overlap"])
def test_the_cli_trace_records_unfenced_spans(mode, tmp_path, monkeypatch, capsys):
    from repro_torch.launch import train

    def no_fence(x):
        raise AssertionError("a traced training step was fenced")

    monkeypatch.setattr(timers, "fence", no_fence)
    tr = str(tmp_path / "tr")
    train.main(["--device", "cpu", "--preset", "tiny", "--steps", "2", "--batch-per-node",
                "2", "--seq", "32", "--gossip-mode", mode, "--trace", tr])
    out = capsys.readouterr().out
    assert out.count("trace step") == 2
    header, events = jtrace.read_jsonl(f"{tr}/events.jsonl")
    steps = [e for e in events if e.name == "step"]
    assert [e.step for e in steps] == [0, 1] and all(e.cat == "step" for e in steps)
    comm = "gossip_launch" if mode == "overlap" else "gossip"
    assert {comm, "forward", "backward"} <= {e.name for e in events}
