"""The port's collective inventory and the JAX package's collective checks.

* ``python -m repro_torch.analysis.check --shard 2 --all-layouts
  --faults --strict`` passes on the tiny config: every gossiping lane and
  every FSDP lane records collectives, the ``none`` lanes no exchange,
  and the report carries JAX's keys (``steps.<label>.collectives``,
  ``analytic_row``, ``artifact``). Its ``analytic_row`` equals JAX's
  ``bytes_model.fsdp_bytes_row`` (over JAX's own layouts) and the
  committed ``benchmarks/results/BENCH_comm_time.json`` row.
* Every violation name of ``repro_torch.analysis.checks`` fires on a
  planted fault: a real lane's records with one field broken, a declared
  site taken away, a no-gossip step that exchanges.
* The recorder: a record's kind, axes, bytes and source; a virtual group
  refuses tensors with values.
"""
import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from repro.analysis import bytes_model as jax_bytes_model
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.dist import fsdp as jax_fsdp
from repro.models.transformer import Model as JaxModel
from repro_torch.analysis import check, checks
from repro_torch.analysis.collectives import COLLECTIVE_KINDS, collect, join
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import named_graph, plan_matcha
from repro_torch.dist import bucketing, comm
from repro_torch.dist import decen_train as dt
from repro_torch.dist import gossip
from repro_torch.launch.mesh import virtual_mesh

ARCH = "internlm2_1_8b"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(REPO, "benchmarks", "results", "BENCH_comm_time.json")


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    out = tmp_path_factory.mktemp("check") / "report.json"
    argv = ["--shard", "2", "--all-layouts", "--faults", "--strict", "--artifact", ARTIFACT,
            "--out", str(out)]
    assert check.main(argv) == 0
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def lanes():
    cfg = get_smoke_config(ARCH)
    plan = plan_matcha(named_graph("ring", 4, seed=3), 0.5, budget_steps=200, seed=0)
    row = check.analytic_row(cfg, nodes=4, shard=2, arch=ARCH)
    masked, _ = check.replicated_lane(cfg, plan, nodes=4, batch=4, seq=32, mode="masked",
                                      faulted=False, where="masked")
    mono, _, stats = check.fsdp_lane(cfg, plan, nodes=4, shard=2, batch=4, seq=32,
                                     layout="monolithic", mode="sequential", faulted=False,
                                     row=row, where="mono")
    return types.SimpleNamespace(cfg=cfg, plan=plan, row=row, masked=masked, mono=mono,
                                 stats=stats)


def test_check_cli_passes_with_every_fsdp_lane(report):
    assert report["ok"] and report["num_violations"] == 0
    steps = report["steps"]
    for label, st in steps.items():
        if not (label.startswith("replicated/") or label.startswith("fsdp/")):
            continue
        kinds = {r["kind"] for r in st["collectives"]}
        if label.split("/")[-1].startswith("none"):
            assert "ppermute" not in kinds, label
        else:
            assert "ppermute" in kinds, label
        if label.startswith("fsdp/"):
            assert {"all_gather", "psum_scatter"} <= kinds, label
        assert kinds <= set(COLLECTIVE_KINDS)
    fsdp_labels = {k for k in steps if k.startswith("fsdp/")}
    assert len(fsdp_labels) == 3 * 5          # 3 layouts x (3 modes + 2 faulted)
    assert {k for k in steps if k.startswith("replicated/")} == {
        "replicated/masked", "replicated/static", "replicated/overlap", "replicated/none",
        "replicated/masked+faults", "replicated/static+faults", "replicated/overlap+faults"}
    assert report["artifact"]["row"] is not None and report["artifact"]["violations"] == []


def test_analytic_row_equals_jax_and_the_committed_artifact(report):
    jcfg = jax_smoke_config(ARCH)
    jm = JaxModel(jcfg)
    spec = types.SimpleNamespace(num_shards=2, num_nodes=4)
    lay = jax_fsdp.make_layout(jm, spec)
    g = jax_fsdp.make_stream_layout(jm, spec, scan_aware=False)
    sc = jax_fsdp.make_stream_layout(jm, spec, scan_aware=True)
    raw = 4 * int(sum(np.prod(a.shape) for a in jax_fsdp.jax.tree.leaves(lay.abs_local)))
    want = jax_bytes_model.fsdp_bytes_row(bplan=lay.plan, gplan=g.plan, splan=sc.plan,
                                          shard=2, arch=ARCH, raw_param_bytes=raw)
    assert report["analytic_row"] == want
    with open(ARTIFACT) as f:
        rows = [r for r in json.load(f)["fsdp"] if r["arch"] == ARCH and r["shard"] == 2]
    for key, v in rows[0].items():
        assert report["analytic_row"][key] == v, key


def test_lane_records_follow_the_plan_and_the_bytes(lanes):
    perms = [r for r in lanes.masked if r.kind == "ppermute"]
    assert {tuple(sorted(r.perm)) for r in perms} == {tuple(sorted(p)) for p in
                                                      lanes.plan.ppermute_pairs()}
    assert all(r.axes == ("data",) and r.source[1] == "__call__" for r in perms)
    assert checks.check_ppermutes(lanes.masked, num_nodes=4, node_axes=("data",),
                                  planned_pairs=lanes.plan.ppermute_pairs(),
                                  expect_all_planned=True) == []
    assert checks.check_bytes_fsdp(lanes.mono, lanes.row, layout_kind="monolithic",
                                   gossip=True) == []
    assert checks.check_collective_axes(lanes.mono) == []


def _broken(records, kind, **change):
    """The records with the first ``kind`` record changed."""
    out, done = [], False
    for r in records:
        if r.kind == kind and not done:
            r, done = dataclasses.replace(r, **change), True
        out.append(r)
    assert done
    return out


def _names(viols):
    return {v.name for v in viols}


@pytest.mark.parametrize("name,plant", [
    ("ppermute-bad-axes", lambda L: _broken(L.masked, "ppermute", axes=("model",))),
    ("ppermute-out-of-range", lambda L: _broken(L.masked, "ppermute", perm=((0, 7), (7, 0)))),
    ("ppermute-duplicate-dest", lambda L: _broken(L.masked, "ppermute",
                                                  perm=((0, 1), (2, 1), (1, 0), (3, 3)))),
    ("ppermute-not-involution", lambda L: _broken(L.masked, "ppermute",
                                                  perm=((0, 1), (1, 2), (2, 0), (3, 3)))),
    ("ppermute-unplanned", lambda L: _broken(L.masked, "ppermute",
                                             perm=((0, 2), (2, 0), (1, 3), (3, 1)))),
    ("matching-not-exchanged", lambda L: [r for r in L.masked if r.kind != "ppermute"
                                          or r.perm != L.masked[0].perm]),
])
def test_ppermute_violations_fire_on_planted_faults(lanes, name, plant):
    viols = checks.check_ppermutes(plant(lanes), num_nodes=4, node_axes=("data",),
                                   planned_pairs=lanes.plan.ppermute_pairs(),
                                   expect_all_planned=True)
    assert name in _names(viols)


def test_collective_axes_violations_fire_on_planted_faults(lanes):
    bad = _broken(lanes.mono, "all_gather", axes=("data",))
    assert _names(checks.check_collective_axes(bad)) == {"collective-bad-axes"}
    src = (os.path.abspath(bucketing.__file__), "ravel", 1)
    inb = _broken(lanes.mono, "psum_scatter", source=src)
    assert _names(checks.check_collective_axes(inb)) == {"collective-in-bucketing"}


def test_byte_and_artifact_violations_fire_on_planted_faults(lanes):
    gather = next(r for r in lanes.mono if r.kind == "all_gather")
    small = _broken(lanes.mono, "all_gather", bytes=gather.bytes // 2)
    assert "bytes-mismatch" in _names(checks.check_bytes_fsdp(
        small, lanes.row, layout_kind="monolithic", gossip=True))
    fat = _broken(lanes.mono, "ppermute", bytes=lanes.row["per_matching_comm_bytes"] * 2)
    assert "bytes-mismatch" in _names(checks.check_bytes_fsdp(
        fat, lanes.row, layout_kind="monolithic", gossip=True))
    drifted = dict(lanes.row, per_device_param_bytes=lanes.row["per_device_param_bytes"] * 2)
    assert _names(checks.cross_check_artifact(drifted, lanes.row)) == {"artifact-mismatch"}


def test_memory_ladder_violations_fire_on_planted_faults(lanes):
    from repro_torch.models.transformer import Model

    spec = dt.make_spec(virtual_mesh(data=4, shard=2), 4)
    m = Model(lanes.cfg)
    mono = check.fsdp_layout(m, spec, "monolithic")
    stream = check.fsdp_layout(m, spec, "streamed")
    assert checks.check_memory_ladder(lanes.stats["max_fp_elements"], mono) == []
    assert _names(checks.check_memory_ladder(mono.plan.total_elements - 1, mono)) == {
        "monolithic-not-materialized"}
    bound = checks.ladder_bound(stream)
    assert _names(checks.check_memory_ladder(bound + 1, stream)) == {"ladder-bound-exceeded"}
    # 8 layers make a scanned segment: its stacked rows must never be held
    scan = check.fsdp_layout(Model(dataclasses.replace(lanes.cfg, num_layers=8)), spec,
                             "scan_streamed")
    rows = min(n for n, r in zip(scan.plan.bucket_sizes, scan.plan.repeats) if r > 1)
    assert checks.check_memory_ladder(checks.ladder_bound(scan), scan) == []
    assert "scan-residual-materialized" in _names(checks.check_memory_ladder(rows, scan))


def test_unexpected_collective_fires_on_a_gossiping_none_step(lanes, monkeypatch):
    make = dt.make_train_step
    monkeypatch.setattr(dt, "make_train_step", lambda *a, **k: make(
        *a, **dict(k, gossip_mode="masked" if k.get("gossip_mode") == "none"
                   else k.get("gossip_mode"))))
    _, viols = check.replicated_lane(lanes.cfg, lanes.plan, nodes=4, batch=2, seq=16,
                                     mode="none", faulted=False, where="none")
    assert "unexpected-collective" in _names(viols)


def test_fp32_upcast_lint_fires_outside_the_declared_sites(monkeypatch):
    stacked = {"w": torch.randn(4, 8).to(torch.bfloat16)}
    perms = np.array([[1, 0, 3, 2]])
    with checks.DtypeLint("lint") as lint:
        gossip.mix_matchings_masked(stacked, 0.3, perms, np.ones(1, np.float32))
    assert lint.violations == []
    monkeypatch.setattr(gossip, "FP32_UPCAST_SITES", ())
    with checks.DtypeLint("lint") as lint:
        gossip.mix_matchings_masked(stacked, 0.3, perms, np.ones(1, np.float32))
    assert _names(lint.violations) == {"fp32-upcast-unwhitelisted"}
    assert "in target()" in lint.violations[0].detail


def test_recorder_names_kind_axes_bytes_and_source():
    m = virtual_mesh(data=2, shard=2, rank=1)
    x = torch.empty(6, device="meta")
    out = torch.empty(12, device="meta")

    def run():
        comm.all_reduce(x, m.shard_group)
        comm.all_gather(out, x, m.shard_group)
        comm.reduce_scatter(x[:3], out, m.shard_group)
        comm.exchange([(3, x)], m.nodes_group, ((0, 1),))

    recs = collect(run)
    assert [(r.kind, r.axes, r.bytes) for r in recs] == [
        ("psum", ("shard",), 24), ("all_gather", ("shard",), 48),
        ("psum_scatter", ("shard",), 48), ("ppermute", ("data",), 24)]
    # issued from outside the port: no source frame (the recorder's own
    # analysis frames are not sources)
    assert recs[0].source == () and recs[3].perm == ((0, 1),)
    joined = join([recs, [dataclasses.replace(r, perm=((1, 0),)) if r.kind == "ppermute"
                          else r for r in recs]])
    assert joined[-1].perm == ((0, 1), (1, 0))
    with pytest.raises(RuntimeError, match="meta tensors only"):
        comm.all_reduce(torch.zeros(2), m.shard_group)
