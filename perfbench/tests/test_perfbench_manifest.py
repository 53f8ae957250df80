"""The manifest against the benchmark's contract, and the harness's
lookups by name: every file a name points at exists, and a cell and a
metric added as new files in a copy of the manifest are found without
any other file being edited."""
import json
import re
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench import manifest

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|head|expan|top_k|d_model|d_ff")


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_top_level_keys_and_paths(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"][:2] == ["python3", "perfbench/run.py"]
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.endswith("_torch")
        assert (ROOT / p).is_dir()
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_units_and_entry_keys(bench):
    groups = ("configs", "workloads", "end_to_end", "per_layer")
    for group in groups:
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and 1 <= len(m["layer"]) <= 200
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_every_cell_reports_what_it_must(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in bench["end_to_end"]}
    assert e2e["setup_s"] == cells
    for cell in cells:
        assert sum(cell in ws for n, ws in e2e.items() if n != "setup_s") >= 1
        assert any(cell in m.get("workloads", cells) for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]]
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("kind", ["configs", "workloads", "metrics"])
def test_every_name_has_its_files(bench, kind):
    if kind == "configs":
        for c in bench["configs"]:
            conf = json.loads((ROOT / c["file"]).read_text())
            assert sorted(conf["reduced"]) == sorted(c["reduced"])
            for key in conf["reduced"]:
                assert not WIDTHS.search(key), key
                assert conf["published"][key] != conf[key]
            assert (ROOT / "perfbench" / "reference" / f"{conf['reference']}.py").is_file()
    elif kind == "workloads":
        for w in bench["workloads"]:
            cell = manifest.cell(w["name"])
            assert cell.driver().run_cell
            assert set(cell.limits) <= {"loss_gap", "grad_gap", "change_gap",
                                        "grad_med_gap", "change_med_gap"}
            assert {"loss_gap", "grad_gap", "change_gap"} <= set(cell.limits)
    else:
        for m in bench["end_to_end"]:
            assert (ROOT / "perfbench" / "end_to_end" / f"{m['name']}.py").is_file()
        for m in bench["per_layer"]:
            assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()


def _copy_root(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    (root / "perfbench").mkdir(parents=True)
    shutil.copy(ROOT / "BENCHMARK.json", root)
    for d in ("configs", "traffic", "limits", "metrics", "end_to_end", "reference"):
        shutil.copytree(ROOT / "perfbench" / d, root / "perfbench" / d)
    return root


def _listing():
    return sorted((p.relative_to(ROOT), p.stat().st_mtime_ns)
                  for p in (ROOT / "perfbench").rglob("*")
                  if p.is_file() and "__pycache__" not in p.parts)


def test_a_new_cell_and_metric_are_found_by_name(tmp_path):
    before = _listing()
    root = _copy_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    first = bench["workloads"][0]
    traffic = json.loads((root / "perfbench" / "traffic" / f"{first['traffic']}.json").read_text())
    traffic["seq"] = 256
    (root / "perfbench" / "traffic" / "dummy.seq256.json").write_text(json.dumps(traffic))
    (root / "perfbench" / "limits" / "dummy-cell.json").write_text(
        json.dumps({"loss_gap": 1.0, "grad_gap": 1.0, "change_gap": 1.0}))
    (root / "perfbench" / "metrics" / "dummy_ms.py").write_text(
        "def read(rec):\n    return 42.0 * len(rec.windows)\n")
    bench["workloads"].append({"name": "dummy-cell", "config": first["config"],
                               "traffic": "dummy.seq256", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "device",
                               "moves": "tokens_per_s", "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = manifest.cell("dummy-cell", root)
    assert cell.traffic["seq"] == 256 and cell.limits["loss_gap"] == 1.0
    assert "dummy_ms" in [m["name"] for m in cell.per_layer]
    assert "dummy_ms" not in [m["name"] for m in manifest.cell(first["name"], root).per_layer]

    from perfbench.drivers import matcha_train as mt

    window = {"steps": 4, "window_s": 2.0, "step_ms": [500.0] * 4, "start_wall": 0.0,
              "phases": [{"fwd_bwd": 1.0, "optimizer": 2.0, "gossip": 3.0}] * 4,
              "profile": {"steps": 2, "window_s": 1.0, "busy_s": 0.5, "gossip_axpy_s": 0.1,
                          "gossip_axpy_launches": 24, "device_ops": [], "idle_gaps": []}}
    run = {"tasks": [{"window": window}]}
    traced = mt.metrics_of(cell, run, setup_s=1.0, trace=True)
    assert traced == {"dummy_ms": {"value": 42.0, "unit": "ms"}}
    traced = mt.metrics_of(manifest.cell(first["name"], root), run, setup_s=1.0, trace=True)
    assert traced["gossip_ms"]["value"] == 3.0 and traced["device_idle_pct"]["value"] == 50.0
    assert "dummy_ms" not in traced
    plain = mt.metrics_of(cell, run, setup_s=1.0, trace=False)
    assert set(plain) == {m["name"] for m in cell.end_to_end}
    assert plain["tokens_per_s"]["value"] == 4 * traffic["nodes"] * traffic["batch"] * 256 / 2.0
    assert _listing() == before


def test_end_to_end_readers_on_a_hand_made_window():
    readers = {n: manifest.load_module(ROOT / "perfbench" / "end_to_end" / f"{n}.py")
               for n in ("tokens_per_s", "mfu", "setup_s")}
    run = SimpleNamespace(steps=10, window_s=5.0, step_ms=[float(i) for i in range(1, 11)],
                          tokens_per_step=4096, flops_per_step=989e12 * 0.5, chips=1,
                          peak_flops=989e12, setup_s=12.5)
    assert readers["tokens_per_s"].read(run) == 8192.0
    assert readers["mfu"].read(run) == pytest.approx(100.0)
    assert readers["setup_s"].read(run) == 12.5
