"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, cell or
metric sits in a file of its own under ``perfbench/``, found by the name
that ``BENCHMARK.json`` gives it:

    configs/<config>.json        the sizes as run, the registry arch, the
                                 reference family, ``reduced`` / ``assumed``
    traffic/<traffic>.json       a traffic mix: the driver ``kind`` and its
                                 parameters (nodes, graph, budget, ...)
    limits/<cell>.json           the limits of the numbers that decide
                                 ``correct`` in one cell
    end_to_end/<metric>.py       ``read(run)`` of one end-to-end metric
    metrics/<metric>.py          ``read(rec)`` of one per-layer metric
    reference/<family>.py        the plain reference of one model family
    drivers/<kind>.py            the driver of one kind of traffic (a package
                                 module: ``perfbench.drivers.<kind>``)

so a later change adds a cell, a configuration or a metric by adding
files and entries. Every lookup takes the ``root`` that holds
``BENCHMARK.json`` and ``perfbench/``.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[1]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: Optional[str] = None):
    """The module in ``path`` (a file whose name need not be an identifier)."""
    name = name or "perfbench_file_" + "".join(ch if ch.isalnum() else "_"
                                               for ch in str(path))
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with every file it names, loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    def path(self, *parts: str) -> Path:
        return self.root.joinpath("perfbench", *parts)

    def family(self):
        return load_module(self.path("reference", f"{self.config['reference']}.py"))

    def driver(self):
        """The traffic kind's driver, imported as a package module."""
        return importlib.import_module(f"perfbench.drivers.{self.traffic['kind']}")

    def reader(self, kind: str, metric: str):
        return load_module(self.path(kind, f"{metric}.py"))


def load(root: Path = ROOT) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT, manifest: Optional[dict] = None) -> Cell:
    """The manifest's workload ``name`` with its files."""
    root = Path(root)
    manifest = manifest or load(root)
    try:
        entry = next(w for w in manifest["workloads"] if w["name"] == name)
    except StopIteration:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}") from None
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    return make_cell(name, conf["file"], entry["traffic"], int(entry["chips"]), root,
                     manifest)


def make_cell(name: str, config_file: str, traffic: str, chips: int, root: Path = ROOT,
              manifest: Optional[dict] = None) -> Cell:
    """A cell from its files: a configuration file (relative to ``root``),
    a traffic mix and ``limits/<name>.json``, with the manifest's metrics
    that list ``name`` (or list no cells)."""
    root = Path(root)
    manifest = manifest or load(root)

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name=name, chips=int(chips), config=_json(root / config_file),
                traffic=_json(root / "perfbench" / "traffic" / f"{traffic}.json"),
                limits=_json(root / "perfbench" / "limits" / f"{name}.json"),
                end_to_end=mine(manifest["end_to_end"]), per_layer=mine(manifest["per_layer"]),
                root=root)
