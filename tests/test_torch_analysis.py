"""The port's analysis checks against the JAX package's, and the lints
on hand-made inputs.

* ``schedule``'s violations equal the JAX ``schedule``'s on the same
  plans (paper8 and ring at several budgets; faulted at p_drop 0.3 and
  1.0; a plan whose stored rho is wrong);
* ``kernel_cases`` has the JAX ``sweep_cases()``'s labels, shapes and
  dtypes for every arch, plus the grouped matmul's dx and dw, and every
  case passes its wrapper's own checks (the meta branch);
* ``kernel_lint`` accepts a valid launch configuration and rejects ones
  with too much shared memory, a grid that drops a tail, a bf16
  accumulator, too many threads or an empty grid;
* ``docs_lint`` passes on the tree and catches a planted unknown flag,
  in a fenced block and in the README's indented block of the port's
  own commands;
* ``check --strict --kernel-sweep none`` passes on the tiny config, and
  the FSDP flags exit naming ROADMAP item 15;
* ``launch_counts`` gives the launches ``chip_smoke.py`` holds the card
  to for each served model.
"""
import dataclasses
import shutil
from pathlib import Path

import pytest
import torch

from repro.analysis import kernel_cases as jax_kernel_cases
from repro.analysis import schedule as jax_schedule
from repro.core import named_graph as jax_named_graph
from repro.core import plan_matcha as jax_plan_matcha
from repro_torch.analysis import check, docs_lint, kernel_cases, kernel_lint, launch_counts
from repro_torch.analysis import schedule
from repro_torch.analysis.cost import CostMode
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core import named_graph, plan_matcha

REPO = Path(__file__).resolve().parents[1]


def _records(violations):
    return [(v.name, v.detail, v.where) for v in violations]


def _checks(mod, plan, p_drop):
    return (mod.check_plan_spectral(plan, where="plan")
            + mod.check_empirical_rho(plan, where="empirical")
            + mod.check_faulted_spectral(plan, p_drop, where="faulted")
            + mod.check_degraded_mixing(plan, p_drop=min(p_drop, 0.9), where="degraded"))


@pytest.mark.parametrize("p_drop", [0.3, 1.0])
@pytest.mark.parametrize("budget", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("graph", ["paper8", "ring"])
def test_schedule_violations_equal_jax(graph, budget, p_drop):
    jplan = jax_plan_matcha(jax_named_graph(graph, 8, seed=3), budget, seed=0)
    plan = plan_matcha(named_graph(graph, 8, seed=3), budget, seed=0)
    want = _records(_checks(jax_schedule, jplan, p_drop))
    assert _records(_checks(schedule, plan, p_drop)) == want
    if p_drop == 1.0:
        assert "faulted-support-disconnected" in {name for name, _, _ in want}


def test_schedule_rho_mismatch_equals_jax():
    jplan = jax_plan_matcha(jax_named_graph("paper8", 8, seed=3), 0.5, seed=0)
    plan = plan_matcha(named_graph("paper8", 8, seed=3), 0.5, seed=0)
    want = _records(jax_schedule.check_plan_spectral(dataclasses.replace(jplan, rho=0.1)))
    assert [name for name, _, _ in want] == ["plan-rho-mismatch"]
    assert _records(schedule.check_plan_spectral(dataclasses.replace(plan, rho=0.1))) == want


def _shapes(args):
    return [(tuple(a.shape), str(a.dtype)) for a in args]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_kernel_cases_match_jax_sweep_cases(arch):
    want = {c.label: _shapes(c.args) for c in jax_kernel_cases.sweep_cases(arch)}
    cases = kernel_cases.sweep_cases(arch)
    got = {c.label: [(s, d) for s, d in c.args] for c in cases
           if c.kernel not in ("grouped_matmul_dx", "grouped_matmul_dw")}
    assert got == want
    extra = [c for c in cases if c.kernel in ("grouped_matmul_dx", "grouped_matmul_dw")]
    assert len(extra) == 2 * sum(c.kernel == "grouped_matmul" for c in cases)
    # each case through its wrapper's meta branch: the wrapper's own
    # shape, dtype and width checks accept it, and its output is the
    # plain version's shape
    for c in cases:
        with CostMode() as cm:
            out = c.run_kernel(*c.make("meta"))
        assert sum(cm.launches.values()) == 1, c.label
        s0, s1, groups = c.args[0][0], c.args[1][0], c.args[-1][0][0]
        want = {"flash_attention": s0, "ssm_scan": s0, "gossip_axpy": s0,
                "grouped_matmul": (s0[0], s1[-1]), "grouped_matmul_dx": (s0[0], s1[1]),
                "grouped_matmul_dw": (groups, s0[1], s1[1])}[c.kernel]
        out = out[0] if c.kernel == "ssm_scan" else out
        assert tuple(out.shape) == tuple(want), c.label


def test_kernel_cases_make_the_same_operands_on_the_cpu_from_a_seed():
    case = next(c for c in kernel_cases.sweep_cases("dbrx_132b")
                if c.label.endswith("grouped_matmul/ragged"))
    a, b = case.make("cpu", seed=3), case.make("cpu", seed=3)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    sizes = a[2]
    assert sizes.dtype == torch.int32 and int(sizes.sum()) == a[0].shape[0] - 5
    got, want = case.run_plain(*a), case.run_plain(*b)
    assert torch.equal(got, want) and bool((got[int(sizes.sum()):] == 0).all())


GOOD = dict(grid=(4, 16, 2), cover=(256, 16, 2), threads=256, smem_bytes=83008, path=1,
            acc_bytes=4)


@pytest.mark.parametrize("bad,name", [
    (dict(smem_bytes=232449), "smem-over-limit"),
    (dict(cover=(192, 16, 2)), "grid-drops-tail"),
    (dict(acc_bytes=2), "accumulator-dtype"),
    (dict(threads=1056), "block-threads"),
    (dict(threads=100), "block-threads"),
    (dict(grid=(0, 16, 2)), "grid-out-of-range"),
    (dict(grid=(4, 70000, 2)), "grid-out-of-range"),
])
def test_kernel_lint_rejects_bad_configs(bad, name):
    extent = (197, 16, 2)
    assert kernel_lint.lint_config(GOOD, extent) == []
    viols = kernel_lint.lint_config(dict(GOOD, **bad), extent, where="case")
    assert [v.name for v in viols] == [name] and viols[0].where == "case"


def test_kernel_lint_extent_follows_each_wrapper():
    want = {"flash_attention": (256, 16, 2), "ssm_scan": (256, 32, 2),
            "grouped_matmul": (549, 10752, 1), "grouped_matmul_dx": (549, 6144, 1),
            "grouped_matmul_dw": (6144, 10752, 16), "gossip_axpy": (33 * 129, 1, 1)}
    got = {}
    for arch in ("dbrx_132b", "mamba2_370m"):
        for c in kernel_cases.sweep_cases(arch):
            if c.label.startswith(f"{arch}/full/") and (c.label.endswith("ragged")
                                                        or c.kernel == "ssm_scan"):
                got.setdefault(c.kernel, kernel_lint.output_extent(c, c.make("meta")))
    got["gossip_axpy"] = kernel_lint.output_extent(kernel_cases.shared_cases()[1],
                                                   kernel_cases.shared_cases()[1].make("meta"))
    got["flash_attention"] = kernel_lint.output_extent(
        kernel_cases.KernelCase("x", "flash_attention",
                                (((2, 256, 16, 64), "bfloat16"),) * 3), [
            torch.empty(2, 256, 16, 64, device="meta")])
    assert got == want


@pytest.mark.parametrize("where", ["fenced", "indented"])
def test_docs_lint_passes_on_the_tree_and_catches_a_planted_flag(tmp_path, where):
    assert docs_lint.run(str(REPO)) == []
    docs = [d for d, _ in docs_lint.doc_files(str(REPO))]
    assert len(docs) == len(docs_lint.DOC_FILES) == 2
    for doc in docs + [p.name for p in REPO.glob("*.md")]:
        (tmp_path / doc).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(REPO / doc, tmp_path / doc)
    readme = tmp_path / "README.md"
    text = readme.read_text()
    at = text.index(docs_lint.DOC_FILES[0][1])
    if where == "fenced":
        at = text.index("\n```\n", at) + 5
        line = ""
    else:       # the port's own commands: an indented block the JAX lint skips
        at = text.index("\n    PYTHONPATH=src python -m repro_torch.launch.dryrun", at) + 1
        line = "    "
    readme.write_text(text[:at] + line + "PYTHONPATH=src python -m "
                      "repro_torch.launch.dryrun --arch all --no-such-flag\n" + text[at:])
    got = docs_lint.run(str(tmp_path))
    assert got == [("README.md", "flag --no-such-flag not accepted by python -m "
                                 "repro_torch.launch.dryrun")]


def test_check_strict_passes_on_the_tiny_config(capsys):
    assert check.main(["--strict", "--kernel-sweep", "none"]) == 0
    assert '"ok": true' in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--shard", "2"], ["--all-layouts"],
                                  ["--layouts", "monolithic"], ["--artifact", "x.json"]])
def test_check_fsdp_flags_exit_naming_item_15(argv):
    with pytest.raises(SystemExit, match="item 15"):
        check.main(argv)


@pytest.mark.parametrize("arch,layers,prefill,decode", [
    ("internlm2_1_8b", 0, {"flash_attention": 24}, {}),
    ("mamba2_370m", 0, {"ssm_scan": 48}, {}),
    ("dbrx_132b", 3, {"flash_attention": 3, "grouped_matmul": 9}, {"grouped_matmul": 9}),
    ("gemma3_4b", 0, {"flash_attention": 34}, {}),
    ("jamba_v0_1_52b", 16, {"flash_attention": 2, "ssm_scan": 14, "grouped_matmul": 24},
     {"grouped_matmul": 24}),
    ("whisper_base", 0, {"flash_attention": 18}, {}),
    ("internvl2_1b", 0, {"flash_attention": 24}, {}),
])
def test_launch_counts_of_the_served_models(arch, layers, prefill, decode):
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    nz = lambda d: {k: v for k, v in d.items() if v}   # noqa: E731
    assert nz(launch_counts.prefill(cfg, seq=2048, encoder=arch == "whisper_base")) == prefill
    assert nz(launch_counts.decode(cfg)) == decode
