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

``--skip-steps`` runs the schedule and kernel checks only. The report is
JSON on stdout (progress on stderr); ``--strict`` exits 1 on any
violation. ``--shard``, ``--layouts``, ``--all-layouts`` and
``--artifact`` (the FSDP lanes) exit: the sharded runtime is ported
(``repro_torch.dist.fsdp``) but its check lanes wait for the rest of
the multi-GPU port (ROADMAP queue 1, item 15).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

STEP_MODES = ("masked", "static", "overlap")
ITEM_15 = "ROADMAP queue 1, item 15: tensor parallel and the serving and dry-run meshes"
_UNPORTED = ("shard", "layouts", "all_layouts", "artifact")


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
    ap.add_argument("--gossip-modes", default="all",
                    help="'all' or a comma list of " + ",".join(STEP_MODES))
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
    ap.add_argument("--shard", type=int, default=1, help=f"not ported ({ITEM_15})")
    ap.add_argument("--layouts", default="", help=f"not ported ({ITEM_15})")
    ap.add_argument("--all-layouts", action="store_true", help=f"not ported ({ITEM_15})")
    ap.add_argument("--artifact", default="", help=f"not ported ({ITEM_15})")
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


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    for dest in _UNPORTED:
        if getattr(args, dest) != ap.get_default(dest):
            raise SystemExit(f"--{dest.replace('_', '-')} is not ported to repro_torch yet "
                             f"({ITEM_15})")
    import torch

    from repro_torch.analysis import kernel_cases
    from repro_torch.analysis import schedule as schedule_checks
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.core import named_graph, plan_matcha

    cfg = get_smoke_config(args.arch) if args.preset == "tiny" else get_config(args.arch)
    plan = plan_matcha(named_graph(args.graph, args.nodes, seed=3), args.budget,
                       budget_steps=200, seed=0)
    modes = STEP_MODES if args.gossip_modes == "all" else tuple(
        m for m in args.gossip_modes.split(",") if m)
    for m in modes:
        if m not in STEP_MODES:
            ap.error(f"unknown gossip mode {m!r}; choose from {STEP_MODES}")
    report = {"arch": args.arch, "preset": args.preset, "graph": args.graph,
              "nodes": args.nodes, "budget": args.budget,
              "num_matchings": plan.num_matchings, "steps": {},
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
