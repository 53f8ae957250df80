"""CLI: check the port's steps, schedule and kernels without running them.

    PYTHONPATH=src python -m repro_torch.analysis.check --strict
    PYTHONPATH=src python -m repro_torch.analysis.check --kernel-sweep registry --faults

The port's counterpart of ``repro.analysis.check`` on one card. Where the
JAX checker traces each step to a jaxpr, this one runs each step on meta
tensors through ``repro_torch.analysis.cost.CostMode`` (nothing
executes, nothing is allocated) and checks:

* the masked, static and overlap train steps of ``--arch`` (with
  ``--faults`` also their faulted variants, which take per-node bits),
  and the serving prefill and decode steps, each held to: no float64 op
  on the device; matching validity (the step's permutations are
  matchings of the plan, every gossip gather is one node permutation
  along the node dim, one per matching and leaf, or per matching and
  bucket block in overlap); the memory bound (the peak at most
  ``bytes_model``'s resident bytes plus the step's transient bound);
* above the step: Theorem 2's convergence condition for the plan
  (``repro_torch.analysis.schedule``: exact rho < 1, connectivity, the
  sampler), with ``--faults`` the degraded-mode gates at ``--p-drop``,
  and with ``--spectral-csv`` the committed spectral CSV re-derived;
* below it: every kernel case of ``--arch`` (``--kernel-sweep arch``) or
  of the registry (``registry``) through its wrapper's meta branch (the
  wrapper's shape, dtype and width checks), and on a machine with the
  card ``kernel_lint`` over each case's launch configuration.

The mesh lanes (JAX's lane loop) run each step as the ranks of a mesh
that holds one node per data rank (``launch.mesh.virtual_mesh``): every
rank's view in turn, on meta tensors, in this process, so gossip
exchanges run as send/recv and not as the one-process gathers. Each lane
records its collectives (``repro_torch.analysis.collectives``), joins
the views of the node axes, and holds them to:

* the collective contract of the module that issued each
  (``checks.check_collective_axes``) and the dtype lint (dist-layer fp32
  upcasts only at declared ``FP32_UPCAST_SITES``);
* replicated lanes (``replicated/{masked,static,overlap,none}``): every
  exchange a matching of the plan, every matching exchanged, each
  matching's bytes the replica's leaves (overlap: its fp32 buckets), no
  exchange in the ``none`` step (``unexpected-collective``);
* FSDP lanes (``fsdp/{layout}/{sequential,overlap,none}`` at
  ``--shard``): the same matching checks, the bytes against
  ``bytes_model.fsdp_bytes_row`` (the report's ``analytic_row``), which is
  held to the committed ``--artifact`` row (``artifact``), the memory
  ladder on the ``none`` step, and the resident bucket shards against the
  row's per-device bytes.

``--skip-steps`` runs the schedule and kernel checks only. The report is
JSON on stdout (progress on stderr); ``--strict`` exits 1 on any
violation.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

STEP_MODES = ("masked", "static", "overlap")
REPLICATED_MODES = ("masked", "static", "overlap", "none")
FSDP_MODES = ("sequential", "overlap", "none")
LAYOUTS = ("monolithic", "streamed", "scan_streamed")
ARTIFACT = os.path.join("benchmarks", "results", "BENCH_comm_time.json")


def build_parser() -> argparse.ArgumentParser:
    """The checker's CLI (``repro_torch.analysis.docs_lint`` reads it
    without running anything)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--arch", default="internlm2_1_8b")
    ap.add_argument("--preset", default="tiny", choices=("tiny", "full"))
    ap.add_argument("--graph", default="ring")
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--budget", type=float, default=0.5)
    ap.add_argument("--batch-per-node", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--shard", type=int, default=1, help="the FSDP lanes' shard factor")
    ap.add_argument("--layouts", default=",".join(LAYOUTS),
                    help="comma list from " + ",".join(LAYOUTS))
    ap.add_argument("--all-layouts", action="store_true",
                    help="check every FSDP layout (same as the default --layouts)")
    ap.add_argument("--gossip-modes", default="all",
                    help="'all' or a comma list (one process: " + ",".join(STEP_MODES)
                    + "; replicated: " + ",".join(REPLICATED_MODES) + "; fsdp: "
                    + ",".join(FSDP_MODES) + "; masked/sequential alias each other)")
    ap.add_argument("--artifact", default=ARTIFACT,
                    help="BENCH_comm_time.json to cross-check (skipped if missing)")
    ap.add_argument("--kernel-sweep", default="arch", choices=("arch", "registry", "none"),
                    help="kernel cases of the selected --arch, of every registry arch, "
                         "or none")
    ap.add_argument("--skip-steps", action="store_true",
                    help="skip the step checks (schedule and kernel checks only)")
    ap.add_argument("--faults", action="store_true",
                    help="add the faulted steps and the degraded-mode schedule gates")
    ap.add_argument("--p-drop", type=float, default=0.3,
                    help="link-drop probability the --faults gates verify at")
    ap.add_argument("--spectral-csv", default="",
                    help="re-derive this spectral_norm_vs_budget.csv (skipped when empty)")
    ap.add_argument("--strict", action="store_true", help="exit 1 on any violation")
    ap.add_argument("--out", default="", help="also write the JSON report to this path")
    return ap


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def check_train_step(cfg, plan, *, nodes: int, batch: int, seq: int, mode: str,
                     faulted: bool, where: str):
    """Trace one train step on meta and hold it to the step checks;
    returns ``(violations, stats)``."""
    import numpy as np

    from repro_torch.analysis import bytes_model
    from repro_torch.analysis.checks import Violation, check_within
    from repro_torch.analysis.cost import CostMode
    from repro_torch.configs.base import InputShape
    from repro_torch.core.matching import validate_permutations
    from repro_torch.data.pipeline import input_specs
    from repro_torch.dist import decen_train as dt
    from repro_torch.dist.gossip import DELTA_BLOCK
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd
    from repro_torch.tree import tree_leaves

    model = Model(cfg)
    opt = sgd(0.05, momentum=0.9)
    M = plan.num_matchings
    kw = dict(gossip_mode=mode, faulted=faulted)
    if mode == "static":
        kw["active"] = tuple(range(M))
    step = dt.make_train_step(model, opt, plan, **kw)
    bits = np.ones((nodes, M) if faulted else (M,), np.float32)
    out = []
    with CostMode() as cm:
        params = dt.init_stacked_params(model, nodes, device="meta")
        state = dt.init_stacked_opt_state(opt, model, nodes, device="meta")
        data = input_specs(cfg, InputShape("check", seq, nodes * batch, "train"),
                           num_nodes=nodes)
        args = (params, state, data, bits)
        if mode == "overlap":
            args = (params, state, dt.init_gossip_state(plan, step.bplan, device="meta"),
                    data, bits)
        resident = cm.mark_resident()
        step(*args)
    if cm.float64_ops:
        out.append(Violation("float64-op", f"{len(cm.float64_ops)} ops on float64, first "
                             f"{cm.float64_ops[0]}", where))
    # matching validity: the permutations the gathers index with, and the gathers
    try:
        validate_permutations(step.perms, nodes)
    except ValueError as e:
        out.append(Violation("plan-invalid", str(e), where))
    for j, perm in enumerate(np.asarray(step.perms)):
        pairs = {frozenset((d, int(perm[d]))) for d in range(nodes) if perm[d] != d}
        edges = {frozenset(map(int, e)) for e in plan.matchings[j].edges}
        if pairs != edges:
            out.append(Violation("gather-not-planned",
                                 f"permutation {j} pairs {sorted(map(sorted, pairs))}, not "
                                 f"matching {j}'s edges {sorted(map(sorted, edges))}", where))
    leaves = [s for s, d in tree_leaves(model.param_shapes()) if d.is_floating_point]
    if mode == "overlap":
        want = M * sum(-(-size // DELTA_BLOCK) for size in step.bplan.bucket_sizes)
    else:
        want = M * len(leaves)
    got = sum(1 for dim, n in cm.gathers if dim == 0 and n == nodes)
    if got != want:
        out.append(Violation("gather-count", f"{got} node gathers traced, the plan's "
                             f"{M} matchings make {want}", where))
    res = bytes_model.train_resident_bytes(cfg, nodes=nodes, batch=batch, seq=seq,
                                           gossip_mode=mode)
    bound = res + bytes_model.train_transient_bound(cfg, nodes=nodes, batch=batch, seq=seq,
                                                    gossip_mode=mode)
    # the tracer books each storage as the allocator rounds it: within 1%
    out += check_within("resident bytes", resident, res, where=where)
    if cm.peak > bound:
        out.append(Violation("memory-bound", f"peak {cm.peak} bytes over the bound {bound} "
                             f"(resident {res})", where))
    return out, dict(resident_bytes=resident, analytic_resident_bytes=res,
                     peak_bytes=cm.peak, bound_bytes=bound, gathers=got,
                     launches=dict(cm.launches), flops=dict(cm.flops))


def check_serve_steps(cfg, *, batch: int, seq: int):
    """Trace a prefill and a decode step on meta: no float64 op."""
    from repro_torch.analysis.checks import Violation
    from repro_torch.launch import dryrun

    out, stats = [], {}
    for kind in ("prefill", "decode"):
        where = f"serve/{kind}"
        cm = dryrun.trace(lambda: dryrun.serve_call(cfg, kind=kind, batch=batch, seq=seq))
        if cm.float64_ops:
            out.append(Violation("float64-op", f"{len(cm.float64_ops)} ops on float64",
                                 where))
        stats[where] = dict(peak_bytes=cm.peak, launches=dict(cm.launches))
    return out, stats


def check_kernel_cases(cases, *, card: bool):
    """Each case through its wrapper's meta branch, and on the card
    ``kernel_lint`` over its launch configuration."""
    import torch

    from repro_torch.analysis import kernel_lint
    from repro_torch.analysis.checks import Violation
    from repro_torch.analysis.cost import CostMode

    report, out = {}, []
    for case in cases:
        viols, stats = [], {}
        try:
            with CostMode() as cm:
                case.run_kernel(*case.make("meta"))
            stats.update(launches=dict(cm.launches), flops=dict(cm.flops),
                         bytes=cm.kernel_bytes)
        except (ValueError, RuntimeError) as e:
            viols.append(Violation("kernel-refuses-case", str(e), case.label))
        if card and not viols:
            t = case.make("cuda")
            lv, lstats = kernel_lint.lint_case(case, t)
            viols += lv
            stats.update(lstats)
            del t
            torch.cuda.empty_cache()
        report[case.label] = dict(stats=stats, violations=[v.to_json() for v in viols])
        out += viols
    return out, report


# ---------------------------------------------------------------------------
# Mesh lanes: every rank's view of a step on a virtual mesh
# ---------------------------------------------------------------------------
def run_views(make, ranks, *, where: str):
    """Run ``make(rank)()`` for each rank on the meta device; returns
    ``(records of each rank, dtype-lint violations, the first rank's
    CostMode)``. ``make(rank)`` builds the rank's state and returns the
    call. The first rank runs inside a ``CostMode`` and the dtype lint
    (every rank runs the same ops on its own rows)."""
    from repro_torch.analysis.checks import DtypeLint
    from repro_torch.analysis.collectives import collect
    from repro_torch.analysis.cost import CostMode

    views, first, lint = {}, None, None
    for r in ranks:
        if first is None:
            with CostMode() as first, DtypeLint(where) as lint:
                run = make(r)
                first.mark_resident()
                views[r] = collect(run)
        else:
            views[r] = collect(make(r))
    return views, list(lint.violations), first


def _lane_args(cfg, plan, *, nodes: int, batch: int, seq: int, faulted: bool):
    import numpy as np

    from repro_torch.configs.base import InputShape
    from repro_torch.data.pipeline import input_specs

    data = input_specs(cfg, InputShape("check", seq, nodes * batch, "train"),
                       num_nodes=nodes)
    M = plan.num_matchings
    return data, np.ones((nodes, M) if faulted else (M,), np.float32)


def replicated_lane(cfg, plan, *, nodes: int, batch: int, seq: int, mode: str,
                    faulted: bool, where: str):
    """One replicated step on a ``(data = nodes)`` mesh: every node's
    view; returns ``(joined records, violations)``."""
    from repro_torch.analysis import bytes_model, checks
    from repro_torch.analysis.collectives import join, ppermute_totals
    from repro_torch.dist import bucketing
    from repro_torch.dist import decen_train as dt
    from repro_torch.launch.mesh import virtual_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd

    model, opt = Model(cfg), sgd(0.05, momentum=0.9)
    data, bits = _lane_args(cfg, plan, nodes=nodes, batch=batch, seq=seq, faulted=faulted)
    kw = dict(gossip_mode=mode, faulted=faulted)
    if mode == "static":
        kw["active"] = tuple(range(plan.num_matchings))

    def make(rank):
        spec = dt.make_spec(virtual_mesh(data=nodes, rank=rank), nodes)
        step = dt.make_train_step(model, opt, plan, spec=spec, **kw)
        params = dt.init_stacked_params(model, spec.local_nodes, device="meta")
        state = dt.init_stacked_opt_state(opt, model, spec.local_nodes, device="meta")
        if mode == "overlap":
            g = dt.init_gossip_state(plan, step.bplan, device="meta", spec=spec)
            return lambda: step(params, state, g, data, bits)
        return lambda: step(params, state, data, bits)

    views, viols, _ = run_views(make, range(nodes), where=where)
    records = join([views[r] for r in range(nodes)])
    viols += checks.check_collective_axes(records, where=where)
    if mode == "none":
        viols += [checks.Violation("unexpected-collective",
                                   "ppermute issued in the no-gossip step", where)
                  for r in records if r.kind == "ppermute"]
    else:
        viols += checks.check_ppermutes(records, num_nodes=nodes, node_axes=("data",),
                                        planned_pairs=plan.ppermute_pairs(),
                                        expect_all_planned=True,
                                        where=where)
        # per-matching traffic: storage-dtype leaves in step (masked /
        # static), fp32 buckets one step delayed (overlap)
        if mode == "overlap":
            want = 4 * bucketing.plan_buckets(model.param_shapes()).total_elements
        else:
            want = bytes_model.tree_storage_bytes(model.param_shapes())
        for total in ppermute_totals(records).values():
            viols += checks.check_within("replicated per_matching bytes", total, want,
                                         where=where)
    return records, viols


def fsdp_layout(model, spec, name: str):
    """The FSDP layout ``name`` (one of ``LAYOUTS``) of ``model``."""
    from repro_torch.dist import fsdp

    if name == "monolithic":
        return fsdp.make_layout(model, spec)
    return fsdp.make_stream_layout(model, spec, scan_aware=name == "scan_streamed")


def analytic_row(cfg, *, nodes: int, shard: int, arch: str) -> dict:
    """``bytes_model.fsdp_bytes_row`` of the three layouts at ``shard``."""
    from repro_torch.analysis import bytes_model
    from repro_torch.dist import decen_train as dt
    from repro_torch.launch.mesh import virtual_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.tree import tree_leaves

    model = Model(cfg)
    spec = dt.make_spec(virtual_mesh(data=nodes, shard=shard), nodes)
    plans = {name: fsdp_layout(model, spec, name).plan for name in LAYOUTS}
    raw = 4 * sum(int(np.prod(shape)) for shape, _ in tree_leaves(model.param_shapes()))
    return bytes_model.fsdp_bytes_row(bplan=plans["monolithic"], gplan=plans["streamed"],
                                      splan=plans["scan_streamed"], shard=shard,
                                      arch=arch, raw_param_bytes=raw)


def fsdp_lane(cfg, plan, *, nodes: int, shard: int, batch: int, seq: int, layout: str,
              mode: str, faulted: bool, row: dict, where: str):
    """One FSDP step on a ``(data = nodes, shard)`` mesh: the views of the
    shard-0 ranks of every node, joined; returns ``(records,
    violations, stats)``."""
    from repro_torch.analysis import checks
    from repro_torch.analysis.collectives import join
    from repro_torch.dist import decen_train as dt
    from repro_torch.dist import fsdp
    from repro_torch.launch.mesh import virtual_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.optim.optimizers import sgd

    model, opt = Model(cfg), sgd(0.05, momentum=0.9)
    data, bits = _lane_args(cfg, plan, nodes=nodes, batch=batch, seq=seq, faulted=faulted)
    shapes = {}

    def make(rank):
        spec = dt.make_spec(virtual_mesh(data=nodes, shard=shard, rank=rank), nodes)
        lay = fsdp_layout(model, spec, layout)
        step = fsdp.make_fsdp_train_step(model, opt, plan, spec, lay, gossip_mode=mode,
                                         faulted=faulted)
        shards = fsdp.init_fsdp_params(model, lay, spec, device="meta")
        state = fsdp.init_fsdp_opt_state(opt, lay, spec, device="meta")
        shapes[rank] = (lay, [tuple(b.shape) for b in shards])
        if mode == "overlap":
            g = fsdp.init_fsdp_gossip_state(lay, spec, device="meta")
            return lambda: step(shards, state, g, data, bits)
        return lambda: step(shards, state, data, bits)

    ranks = [r * shard for r in range(nodes)]          # shard rank 0 of every node
    views, viols, cm = run_views(make, ranks, where=where)
    records = join([views[r] for r in ranks])
    lay, bucket_shapes = shapes[0]
    viols += checks.check_collective_axes(records, where=where)
    viols += checks.check_bytes_fsdp(records, row, layout_kind=layout,
                                     gossip=mode != "none", where=where)
    if mode == "none":
        viols += checks.check_memory_ladder(cm.max_fp_elements, lay, where=where)
        viols += [checks.Violation("unexpected-collective",
                                   "ppermute issued in the no-gossip step", where)
                  for r in records if r.kind == "ppermute"]
    else:
        viols += checks.check_ppermutes(records, num_nodes=nodes, node_axes=("data",),
                                        planned_pairs=plan.ppermute_pairs(),
                                        expect_all_planned=True, where=where)
    # the resident bucket shards: (local nodes, slice) fp32 each
    got = 4 * sum(shape[-1] for shape in bucket_shapes)
    viols += checks.check_within("per_device_param_bytes", got,
                                 row["per_device_param_bytes"], where=where)
    return records, viols, dict(max_fp_elements=cm.max_fp_elements)


def mesh_lanes(cfg, plan, args, layouts, want, report: dict, violations: list) -> None:
    """The replicated and FSDP lanes into ``report["steps"]`` (with the
    ``analytic_row`` and the ``artifact`` cross-check)."""
    from repro_torch.analysis import checks

    def record(label, records, viols, **stats):
        from repro_torch.analysis.collectives import inventory

        report["steps"][label] = dict(
            stats, collectives=[r.to_json() for r in records],
            inventory={" ".join(map(str, k)): n for k, n in inventory(records).items()},
            violations=[v.to_json() for v in viols])
        violations.extend(viols)
        _log(f"  {label}: {len(records)} collectives, {len(viols)} violations")

    B, S, nodes = args.batch_per_node, args.seq, args.nodes
    _log(f"replicated lanes: {nodes} nodes over {nodes} data ranks")
    variants = [(m, False) for m in REPLICATED_MODES]
    if args.faults:
        variants += [(m, True) for m in REPLICATED_MODES if m != "none"]
    for mode, faulted in variants:
        if not want(mode):
            continue
        label = f"replicated/{mode}" + ("+faults" if faulted else "")
        records, viols = replicated_lane(cfg, plan, nodes=nodes, batch=B, seq=S, mode=mode,
                                         faulted=faulted, where=label)
        record(label, records, viols)

    _log(f"fsdp lanes: {nodes} nodes, shard {args.shard}")
    row = analytic_row(cfg, nodes=nodes, shard=args.shard, arch=args.arch)
    report["analytic_row"] = row
    if args.preset == "tiny" and args.artifact and os.path.exists(args.artifact):
        with open(args.artifact) as f:
            rows = json.load(f).get("fsdp", [])
        match = [r for r in rows if r["arch"] == args.arch and r["shard"] == args.shard]
        if match:
            report["artifact"]["row"] = match[0]
            av = checks.cross_check_artifact(row, match[0], where="artifact")
            report["artifact"]["violations"] = [v.to_json() for v in av]
            violations.extend(av)
            _log(f"  artifact row ({args.arch}, shard={args.shard}): {len(av)} violations")
        else:
            _log(f"  artifact has no ({args.arch}, shard={args.shard}) row: skipped")
    for lname in layouts:
        variants = [(m, False) for m in FSDP_MODES]
        if args.faults:
            variants += [(m, True) for m in FSDP_MODES if m != "none"]
        for mode, faulted in variants:
            if not want(mode):
                continue
            label = f"fsdp/{lname}/{mode}" + ("+faults" if faulted else "")
            records, viols, stats = fsdp_lane(cfg, plan, nodes=nodes, shard=args.shard,
                                              batch=B, seq=S, layout=lname, mode=mode,
                                              faulted=faulted, row=row, where=label)
            record(label, records, viols, **stats)


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    layouts = LAYOUTS if args.all_layouts else tuple(
        x for x in args.layouts.split(",") if x)
    for lay in layouts:
        if lay not in LAYOUTS:
            ap.error(f"unknown layout {lay!r}; choose from {LAYOUTS}")
    import torch

    from repro_torch.analysis import kernel_cases
    from repro_torch.analysis import schedule as schedule_checks
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.core import named_graph, plan_matcha

    cfg = get_smoke_config(args.arch) if args.preset == "tiny" else get_config(args.arch)
    plan = plan_matcha(named_graph(args.graph, args.nodes, seed=3), args.budget,
                       budget_steps=200, seed=0)
    picked = None if args.gossip_modes == "all" else {
        "masked" if m == "sequential" else m for m in args.gossip_modes.split(",") if m}
    for m in picked or ():
        if m not in REPLICATED_MODES:
            ap.error(f"unknown gossip mode {m!r}; choose from {REPLICATED_MODES + FSDP_MODES}")

    def want(mode: str) -> bool:
        return picked is None or ("masked" if mode == "sequential" else mode) in picked

    modes = tuple(m for m in STEP_MODES if want(m))
    report = {"arch": args.arch, "preset": args.preset, "graph": args.graph,
              "nodes": args.nodes, "budget": args.budget,
              "num_matchings": plan.num_matchings, "shard": args.shard, "steps": {},
              "artifact": {"path": args.artifact, "row": None, "violations": []},
              "schedule": {"violations": []}, "kernels": {"cases": {}, "card": False}}
    violations = []

    _log("schedule verifier: exact rho / connectivity / sampler")
    sv = schedule_checks.check_plan_spectral(plan, where="schedule/plan")
    sv += schedule_checks.check_empirical_rho(plan, where="schedule/empirical")
    if args.spectral_csv:
        sv += schedule_checks.check_spectral_csv(args.spectral_csv, where="schedule/csv")
    if args.faults:
        sv += schedule_checks.check_faulted_spectral(plan, args.p_drop,
                                                     where="schedule/faulted")
        sv += schedule_checks.check_degraded_mixing(plan, p_drop=args.p_drop,
                                                    where="schedule/degraded-mixing")
    report["schedule"]["violations"] = [v.to_json() for v in sv]
    violations += sv

    if args.kernel_sweep != "none":
        cases = kernel_cases.sweep_cases(args.arch if args.kernel_sweep == "arch" else None)
        card = torch.cuda.is_available()
        _log(f"kernel cases: {len(cases)} ({args.kernel_sweep}); launch lint "
             f"{'on the card' if card else 'needs the card: meta branches only'}")
        kv, report["kernels"]["cases"] = check_kernel_cases(cases, card=card)
        report["kernels"]["card"] = card
        violations += kv

    if not args.skip_steps:
        lanes = [(m, False) for m in modes] + [(m, True) for m in modes if args.faults]
        for mode, faulted in lanes:
            where = f"train/{mode}" + ("+faults" if faulted else "")
            v, stats = check_train_step(cfg, plan, nodes=args.nodes,
                                        batch=args.batch_per_node, seq=args.seq,
                                        mode=mode, faulted=faulted, where=where)
            report["steps"][where] = dict(stats, violations=[x.to_json() for x in v])
            violations += v
            _log(f"  {where}: peak {stats['peak_bytes']} bytes (bound "
                 f"{stats['bound_bytes']}), {stats['gathers']} gathers, {len(v)} violations")
        mesh_lanes(cfg, plan, args, layouts, want, report, violations)
        v, stats = check_serve_steps(cfg, batch=args.batch_per_node, seq=args.seq)
        for where, st in stats.items():
            report["steps"][where] = dict(st, violations=[x.to_json() for x in v
                                                          if x.where == where])
        violations += v

    report["num_violations"] = len(violations)
    report["ok"] = not violations
    text = json.dumps(report, indent=2, default=str)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    if violations:
        _log(f"FAIL: {len(violations)} violations")
        for v in violations[:20]:
            _log(f"  [{v.name}] {v.where}: {v.detail}")
        return 1 if args.strict else 0
    _log("OK: all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
