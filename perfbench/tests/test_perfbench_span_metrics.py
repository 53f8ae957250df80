"""The readers of the spans inside the step (``forward_ms``,
``backward_ms``, ``gossip_target_ms``) on hand-made windows: the means a
step of their span's device ms, and nothing where the input is missing:
on the CPU (no device activity in the profile) and from a program whose
step records only ``fwd_bwd``, ``optimizer`` and ``gossip``."""
from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench import manifest

ROOT = Path(__file__).resolve().parents[2]
NEW = ("forward_ms", "backward_ms", "gossip_target_ms")


def _window():
    """What the driver's traced window keeps: ``last_phases.ms()`` of the
    steps after the profiled ones, and the profile's summary."""
    return {"steps": 3, "window_s": 0.3, "step_ms": [100.0] * 3, "start_wall": 0.0,
            "phases": [{"step": 99.0, "fwd_bwd": 40.0, "forward": 12.0, "backward": 27.0,
                        "optimizer": 15.0, "gossip": 40.0, "gossip/target": 34.0,
                        "gossip/apply": 5.0},
                       {"step": 99.0, "fwd_bwd": 42.0, "forward": 13.0, "backward": 28.0,
                        "optimizer": 15.0, "gossip": 40.0, "gossip/target": 36.0,
                        "gossip/apply": 3.0}],
            "profile": {"steps": 1, "window_s": 0.1, "busy_s": 0.07}}


def _read(name, *windows):
    reader = manifest.load_module(ROOT / "perfbench" / "metrics" / f"{name}.py")
    return reader.read(SimpleNamespace(windows=list(windows)))


@pytest.mark.parametrize("name,want", [
    ("forward_ms", 12.5), ("backward_ms", 27.5), ("gossip_target_ms", 35.0)])
def test_each_new_reader_on_a_hand_made_window(name, want):
    assert _read(name, _window()) == pytest.approx(want)
    # averaged over the ranks' windows as over their steps
    other = _window()
    other["phases"] = [dict(p, forward=p["forward"] + 4, backward=p["backward"] + 4,
                            **{"gossip/target": p["gossip/target"] + 4})
                       for p in other["phases"]]
    assert _read(name, _window(), other) == pytest.approx(want + 2)


@pytest.mark.parametrize("name", NEW)
def test_each_new_reader_is_none_on_the_cpu(name):
    # the spans read the host's clock there: no device activity was profiled
    cpu = _window()
    cpu["profile"]["busy_s"] = 0.0
    assert _read(name, cpu) is None
    assert _read(name, dict(_window(), profile=None)) is None


@pytest.mark.parametrize("name", NEW)
def test_each_new_reader_is_none_without_its_spans(name):
    # a program whose step has no spans inside fwd_bwd and gossip
    parent = _window()
    parent["phases"] = [{"fwd_bwd": 1.0, "optimizer": 2.0, "gossip": 3.0}] * 2
    assert _read(name, parent) is None
    assert _read(name, {k: v for k, v in _window().items() if k != "phases"}) is None


@pytest.mark.parametrize("name", NEW)
def test_each_new_metric_is_declared_for_the_cell_it_reads(name):
    entry, = [m for m in manifest.load(ROOT)["per_layer"] if m["name"] == name]
    assert entry["source"] == "program_span" and entry["moves"] == "tokens_per_s"
    assert entry["workloads"] == ["internlm2-d10.matcha50.seq4096"]
