"""The port's kernel contracts (``repro_torch.analysis.kernel_lint``) on
the CPU: the tile lint on hand-made boxes (one case per rule, in the manner
of ``tests/test_pallas_lint.py``), every swept kernel's ``KERNEL_CONTRACT``
against its fields and the JAX kernel's, the contract checks on launch
configurations, the poisoned-tail and canary launches with the plain
versions (clean) and with deliberately leaky or stray functions (flagged),
``kernel-launch-missing`` on meta tensors with a wrapper patched to its
plain path, and the ``hardcoded-impl`` source lint. The tile probes and
the kernels' own poisoned launches run on the card (``chip_smoke.py``
phase 9)."""
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_fa
from repro.kernels import gossip_axpy as jax_ga
from repro.kernels import grouped_matmul as jax_gm
from repro.kernels import ssm_scan as jax_ss
from repro_torch.analysis import check, kernel_cases, kernel_lint
from repro_torch.kernels import ops, ref

CONTRACT = dict(kernel="synthetic", grid=("m", "k"), out_dims=("m", "n"), reduction_axes=(),
                masked={"n": "N"}, acc_dtype="float32", smem_limit_bytes=1024, launches=1)


def _names(viols):
    return [v.name for v in viols]


def _tiles(rows=4, ks=1, width=64, n=128):
    """``rows`` x ``ks`` writers, writer (i, j) storing rows
    [width i, width i + width) and all n columns."""
    return [((i, j), (width * i, 0), (width * i + width, n)) for i in range(rows)
            for j in range(ks)]


@pytest.mark.parametrize("boxes,extent,over,want", [
    (_tiles(), (256, 128), {}, []),                                    # clean tiling
    (_tiles() + [((4, 0), (32, 0), (96, 128))], (256, 128), {},
     ["output-overlap-undeclared"]),                                   # an extra box
    (_tiles(ks=2), (256, 128), {"reduction_axes": (1,)}, []),          # along a reduction axis
    (_tiles(ks=2), (256, 128), {}, ["output-overlap-undeclared"]),     # ... undeclared
    (_tiles(), (200, 128), {}, ["tile-out-of-bounds"]),                # past an unmasked axis
    (_tiles(n=192), (256, 150), {}, []),                               # past a masked axis
    (_tiles()[:3], (256, 128), {}, ["output-not-covered"]),            # a dropped tile
    (kernel_lint.shift_box(_tiles()), (256, 128), {},
     ["output-overlap-undeclared", "output-not-covered"]),             # a box shifted a tile
    ([((0,), (-8, 0), (64, 128))] + _tiles()[1:], (256, 128), {},
     ["tile-out-of-bounds"]),                                          # below zero
])
def test_lint_tiles_rules(boxes, extent, over, want):
    got, stats = kernel_lint.lint_tiles(boxes, extent, dict(CONTRACT, **over), where="case")
    assert _names(got) == want
    assert all(v.where == "case" for v in got)
    assert stats["boxes"] == len(boxes)


def test_lint_tiles_counts_elements_and_reads_probe_arrays():
    arr = kernel_lint.as_boxes(_tiles(rows=3))
    assert arr.shape == (3, 9) and arr[0].tolist() == [0, 0, 0, 0, 0, 0, 64, 128, 1]
    got, _ = kernel_lint.lint_tiles(arr, (256, 128), CONTRACT)
    assert _names(got) == ["output-not-covered"] and "8192 output elements" in got[0].detail
    # three dims, a batch of boxes that covers each element twice
    boxes = [((b,), (0, 0, b % 2), (8, 8, b % 2 + 1)) for b in range(4)]
    got, _ = kernel_lint.lint_tiles(boxes, (8, 8, 2), dict(CONTRACT, out_dims=("a", "b", "c")))
    assert _names(got) == ["output-overlap-undeclared"]
    assert "128 output elements" in got[0].detail


SWEPT = sorted({c.kernel for c in kernel_cases.sweep_cases()})
JAX_CONTRACTS = {"flash_attention": jax_fa.KERNEL_CONTRACT,
                 "ssm_scan": jax_ss.KERNEL_CONTRACT,
                 "gossip_axpy": jax_ga.KERNEL_CONTRACT,
                 "grouped_matmul": jax_gm.KERNEL_CONTRACT}


@pytest.mark.parametrize("kernel", SWEPT)
def test_each_swept_kernel_has_a_whole_contract(kernel):
    c = kernel_lint.contract_for(kernel)
    assert set(kernel_lint.CONTRACT_FIELDS) <= set(c) and c["kernel"] == kernel
    assert 1 <= len(c["grid"]) <= 3 and 1 <= len(c["out_dims"]) <= 3
    assert all(0 <= ax < len(c["grid"]) for ax in c["reduction_axes"])
    assert c["smem_limit_bytes"] <= kernel_lint.SMEM_LIMIT and c["launches"] == 1
    want = JAX_CONTRACTS.get(kernel)
    if want is not None:
        # the JAX kernel's masked axes keep their names; the port adds its own
        assert c["acc_dtype"] == want["acc_dtype"]
        assert set(want["masked"]) <= set(c["masked"])
    # every case's guards are masked axes, and its output has no dim past
    # the contract's
    for case in kernel_cases.sweep_cases():
        if case.kernel == kernel:
            assert set(dict(case.guards)) <= set(c["masked"]), case.label
            extent = kernel_lint.output_extent(case, case.make("meta"))
            assert all(e == 1 for e in extent[len(c["out_dims"]):]), case.label


def test_masked_names_of_the_jax_kernels():
    assert kernel_lint.contract_for("flash_attention")["masked"]["kv"] == "kv_len"
    for k in ("grouped_matmul", "grouped_matmul_dx", "grouped_matmul_dw"):
        assert kernel_lint.contract_for(k)["masked"]["rows"] == "group_sizes"
    assert "tail" in kernel_lint.contract_for("gossip_axpy")["masked"]
    ragged = [c for c in kernel_cases.sweep_cases("internlm2_1_8b")
              if c.label.endswith("flash_attention/ragged")]
    assert dict(ragged[0].guards) == {"kv": 197, "q": 197}


CFG = dict(grid=(4, 16, 2), cover=(256, 16, 2), threads=256, smem_bytes=512, path=1,
           acc_bytes=4)


@pytest.mark.parametrize("cfg,contract,guards,want", [
    ({}, {"grid": ("q", "h", "b")}, (), []),
    ({}, {}, (), ["kernel-contract-mismatch"]),                       # 3-D grid, 2 axes named
    ({"grid": (7, 1, 1)}, {"grid": ("tile",)}, (), []),
    ({"grid": (7, 2, 1)}, {"grid": ("tile",)}, (), ["kernel-contract-mismatch"]),
    ({}, {"grid": ("q", "h", "b"), "reduction_axes": (3,)}, (), ["kernel-contract-mismatch"]),
    ({}, {"grid": ("q", "h", "b")}, (("kv", 197),), ["kernel-contract-mismatch"]),
    ({}, {"grid": ("q", "h", "b")}, (("n", 100),), []),
    ({"smem_bytes": 2048}, {"grid": ("q", "h", "b")}, (), ["smem-over-contract"]),
    ({"acc_bytes": 2}, {"grid": ("q", "h", "b")}, (), ["accumulator-dtype"]),
])
def test_check_contract(cfg, contract, guards, want):
    got = kernel_lint.check_contract(dict(CFG, **cfg), dict(CONTRACT, **contract), guards,
                                     where="c")
    assert _names(got) == want


def test_check_contract_flags_a_contract_missing_fields():
    partial = {k: v for k, v in CONTRACT.items() if k != "masked"}
    assert _names(kernel_lint.check_contract(CFG, partial)) == ["kernel-contract-mismatch"]


def plain_launch(case):
    """The plain version as a guarded launch: its outputs copied into the
    buffers."""
    def launch(*t, out):
        res = case.run_plain(*t)
        for o, r in zip(out, res if isinstance(res, tuple) else (res,)):
            o.copy_(r)
    return launch


def _tiny(kernel, tag=""):
    arch = {"ssm_scan": "mamba2_370m"}.get(kernel, "dbrx_132b")
    return next(c for c in kernel_cases.sweep_cases(arch)
                if c.kernel == kernel and "/tiny/" in c.label and c.label.endswith(tag))


POISON_CASES = [kernel_cases.shared_cases()[1], _tiny("flash_attention", "ragged"),
                _tiny("grouped_matmul", "ragged"), _tiny("grouped_matmul_dx", "ragged"),
                _tiny("grouped_matmul_dw", "ragged"), _tiny("ssm_scan")]


@pytest.mark.parametrize("case", POISON_CASES, ids=lambda c: c.label)
def test_poison_case_passes_the_plain_versions_and_leaves_the_operands(case):
    t = case.make("cpu", pad=kernel_lint.POISON_PAD)
    before = [a.clone() for a in t]
    got, stats = kernel_lint.poison_case(case, t, launch=plain_launch(case))
    assert got == [] and stats["launches"] == 3
    assert stats["poisoned_inputs"] == sum(a.is_floating_point() for a in t)
    if case.kernel.startswith("grouped_matmul"):
        assert stats["poisoned_rows"] == kernel_cases.ROWS_PAST_GROUPS * (
            2 if case.kernel.endswith("dw") else 1)
    assert all(torch.equal(a, b) for a, b in zip(t, before))
    for a in t:        # the tails are zero again
        if a.is_floating_point():
            _, tail = kernel_lint.with_tail(a)
            assert not tail.any()


def _shifted(t, by=1):
    return t.as_strided(t.shape, t.stride(), t.storage_offset() + by)


def test_poison_case_flags_a_read_past_the_view():
    case = kernel_cases.shared_cases()[1]
    t = case.make("cpu")                      # no pad: poison_case copies into padded buffers

    def leaky(x, y, out):                     # reads one element past x
        out[0].copy_(ref.gossip_axpy_ref(_shifted(x), y, 0.375))

    got, _ = kernel_lint.poison_case(case, t, launch=leaky)
    assert _names(got) == ["masked-tail-read", "masked-tail-guard-missing"]


def test_poison_case_flags_a_read_that_multiplies_the_tail_by_zero():
    case = kernel_cases.shared_cases()[0]
    t = case.make("cpu")

    def guarded_by_zero(x, y, out):           # the tail read, then masked by a product
        past = x.as_strided((1, 1), (1, 1), x.storage_offset() + x.numel())
        out[0].copy_(ref.gossip_axpy_ref(x, y, 0.375) + 0.0 * past)

    got, _ = kernel_lint.poison_case(case, t, launch=guarded_by_zero)
    assert _names(got) == ["masked-tail-guard-missing"]


def test_poison_case_flags_rows_past_the_groups_read():
    case = _tiny("grouped_matmul", "ragged")
    t = case.make("cpu")

    def no_row_mask(x, w, sizes, out):        # every row through the last group's weights
        out[0].copy_((x.float() @ w[-1].float()).to(x.dtype))

    got, _ = kernel_lint.poison_case(case, t, launch=no_row_mask)
    assert {"masked-tail-read", "masked-tail-guard-missing"} <= set(_names(got))


def test_poison_case_flags_stray_and_missing_writes():
    case = kernel_cases.shared_cases()[1]
    t = case.make("cpu")

    def stray(x, y, out):                     # one element late: past the end, first unset
        _shifted(out[0]).copy_(ref.gossip_axpy_ref(x, y, 0.375))

    got = set(_names(kernel_lint.poison_case(case, t, launch=stray)[0]))
    assert {"write-out-of-bounds", "output-not-covered"} <= got

    def short(x, y, out):                     # the last row never stored
        out[0][:-1].copy_(ref.gossip_axpy_ref(x, y, 0.375)[:-1])

    got = _names(kernel_lint.poison_case(case, t, launch=short)[0])
    assert "output-not-covered" in got and "write-out-of-bounds" not in got


def test_guarded_buffer_holds_sentinels_and_canaries():
    g = kernel_lint.Guarded((3, 5), torch.bfloat16, "cpu")
    assert g.body.data_ptr() % 512 == 0 or g.body.data_ptr() - g.raw.data_ptr() == 4096
    assert bool(torch.isnan(g.body).all())
    assert len(g.check("t", "w")) == 1                       # every sentinel left
    g.body.zero_()
    assert g.check("t", "w") == []
    g.raw[-1] = 0
    assert _names(g.check("t", "w")) == ["write-out-of-bounds"]


META_CASES = [c for c in kernel_cases.sweep_cases("dbrx_132b") if "/tiny/" in c.label] + \
    kernel_cases.shared_cases() + [_tiny("ssm_scan")]


def test_cases_go_through_impl_auto_and_launch_once_on_meta():
    viols, report = check.check_kernel_cases(META_CASES, card=False)
    assert viols == []
    for case in META_CASES:
        assert report[case.label]["stats"]["launches"] == {case.kernel: 1}
    # on the CPU impl="auto" takes the plain versions: no launch, the
    # kernel's output shape
    case = _tiny("grouped_matmul_dw", "ragged")
    t = case.make("cpu")
    assert torch.equal(case.run_kernel(*t), case.run_plain(*t))


@pytest.mark.parametrize("target,plain", [
    ("attention", lambda q, k, v, *, causal=True, window=0, impl="auto":
     ref.attention_ref(q, k, v, causal=causal, window=window)),
    ("gossip_update", lambda x, y, alpha, *, impl="auto":
     {k: ref.gossip_axpy_ref(x[k], y[k], alpha) for k in x}),
])
def test_a_wrapper_patched_to_its_plain_path_is_kernel_launch_missing(monkeypatch, target,
                                                                     plain):
    monkeypatch.setattr(ops, target, plain)
    viols, report = check.check_kernel_cases(META_CASES, card=False)
    kernel = {"attention": "flash_attention", "gossip_update": "gossip_axpy"}[target]
    flagged = {v.where for v in viols if v.name == "kernel-launch-missing"}
    assert flagged == {c.label for c in META_CASES if c.kernel == kernel}
    assert all(v.name == "kernel-launch-missing" for v in viols)


def test_launch_violations_count_against_the_contract():
    case = kernel_cases.shared_cases()[0]
    assert kernel_lint.launch_violations(case, 1) == []
    for n in (0, 2):
        got = kernel_lint.launch_violations(case, n)
        assert _names(got) == ["kernel-launch-missing"] and got[0].where == case.label


def test_hardcoded_impl_lint_clean_tree_and_planted_file(tmp_path):
    assert kernel_lint.check_impl_literals() == []
    (tmp_path / "kernels").mkdir()
    (tmp_path / "kernels" / "ops.py").write_text("f(impl='cuda')\n")     # the one allowed
    (tmp_path / "model.py").write_text(
        "import ops\n"
        "def fwd(x, impl='auto'):\n"
        "    y = ops.attention(x, x, x, impl=impl)\n"
        "    z = ops.ssd(x, impl='torch')\n"
        "    return moe(y, impl='einsum' if z else 'ragged', other='cuda')\n")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b.py").write_text("g(impl='meta')\ng(impl=\"auto\")\n")
    got = kernel_lint.check_impl_literals(str(tmp_path))
    assert _names(got) == ["hardcoded-impl", "hardcoded-impl"]
    assert [v.where for v in got] == ["model.py", "sub/b.py"]
    assert "model.py:4" in got[0].detail and "'meta'" in got[1].detail


def test_check_report_carries_the_source_lint(tmp_path):
    import json

    out = tmp_path / "r.json"
    assert check.main(["--strict", "--skip-steps", "--kernel-sweep", "none", "--out",
                       str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["kernels"]["source_lint"] == [] and rep["ok"]


def test_shift_box_moves_the_lowest_box_one_width():
    arr = kernel_lint.shift_box(np.asarray(kernel_lint.as_boxes(_tiles(rows=2))[::-1]))
    assert sorted(arr[:, 3].tolist()) == [64, 64] and sorted(arr[:, 6].tolist()) == [128, 128]
