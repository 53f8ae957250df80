"""chip_smoke.py's helpers that run without a card: the ptxas report
parser and its wgmma-serialization note, the count of live (query, key)
pairs behind the flash bound (now the kernel module's ``cost()``), the
SSD chunk scan's bound and the profiler's names of the port's kernels,
the grouped-matmul launches a MoE training pass makes, and the dry-run,
sweep and examples phases: listed, wired into ``main`` and, for the dry
run, predicting on meta tensors what the card measured."""
import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

# the shape of `nvcc -Xptxas -v` output for two entry functions
PTXAS_LOG = """\
ptxas info    : 8 bytes gmem
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_23f0aea718flash_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_NS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_23f0aea718flash_wgmma_kernelILi128EEEv14CUtensorMap_stS1_S1_NS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 135 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_23f0aea719flash_scalar_kernelIfLi32EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_23f0aea719flash_scalar_kernelIfLi32EEEvNS_6ParamsE
    24 bytes stack frame, 20 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 79 registers, used 1 barriers
"""


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ptxas_report_names_each_kernel_with_registers_and_spills(smoke):
    assert smoke.ptxas_report(PTXAS_LOG) == [
        ("flash_wgmma_kernel<128>", 135, 0, 0),
        ("flash_scalar_kernel<fp32, 32>", 79, 20, 28),
    ]
    report = {k: tuple(v) for k, *v in smoke.ptxas_report(PTXAS_LOG)}
    note = smoke.ptxas_note(report, "flash_wgmma")
    assert note == "flash_wgmma_kernel<128> 135 registers, 0/0 bytes spilled (stores/loads)"
    assert "not available" in smoke.ptxas_note({}, "gmm_")


def test_wgmma_serialized_names_the_kernels_ptxas_serializes(smoke):
    note = ("ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async "
            "instructions are serialized due to program dependence on compiler-inserted "
            "WG.AR in divergent path in the function '_ZN51_GLOBAL__N__52ee7d0f_18_flash_"
            "attention_cu_23f0aea718flash_wgmma_kernelILi256ELi2EEEv14CUtensorMap_stS1_S1_"
            "NS_6ParamsE'\n")
    assert smoke.wgmma_serialized(note + PTXAS_LOG) == ["flash_wgmma_kernel<256, 2>"]
    assert smoke.wgmma_serialized(PTXAS_LOG) == []


@pytest.mark.parametrize("Sq,Sk,causal,window,kv_len,want", [
    (4, 4, True, 0, 0, 10),        # 1 + 2 + 3 + 4
    (4, 4, False, 0, 0, 16),
    (4, 6, False, 0, 3, 12),       # keys past kv_len are not live
    (5, 5, True, 2, 0, 9),         # 1 + 2 + 2 + 2 + 2
])
def test_flash_pairs_counts_the_live_query_key_pairs(smoke, Sq, Sk, causal, window,
                                                     kv_len, want):
    # the count behind the flash bound lives in the kernel module's cost()
    from repro_torch.kernels.flash_attention import cost, live_pairs

    assert live_pairs(Sq, Sk, causal, window, kv_len) == want
    flops, _ = cost(1, Sq, Sk, 1, 1, 32, smoke_bf16(), causal=causal, window=window,
                    kv_len=kv_len)
    assert flops == 4 * 32 * want


def smoke_bf16():
    import torch

    return torch.bfloat16


@pytest.mark.parametrize("H,want_mb", [(32, 153.1), (128, 587.2)], ids=["mamba2", "jamba"])
def test_ssd_bound_counts_each_operand_once(smoke, H, want_mb):
    # B 8, S 2048, P 64, N 128, chunk 128: bf16 x and y dominate the bytes
    flops, nbytes, bound_ms, bound_by = smoke.ssd_bound(8, 2048, H, 64, 128, 128)
    assert nbytes / 1e6 == pytest.approx(want_mb, abs=0.1)
    assert bound_by == "bytes"
    assert bound_ms == pytest.approx(nbytes / smoke.HBM_BYTES_PER_S * 1e3)
    assert flops / 1e9 == pytest.approx(30.2 * H / 32, rel=0.01)


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::flash_wgmma_kernel<256, 2>(CUtensorMap, CUtensorMap, "
     "CUtensorMap, (anonymous namespace)::Params)", "flash_wgmma_kernel"),
    ("void (anonymous namespace)::ssd_tc_kernel<64, 128>(Params)", "ssd_tc_kernel"),
    ("gmm_wgmma_kernel", "gmm_wgmma_kernel"),
    ("(anonymous namespace)::gmm_dx_wgmma_kernel(CUtensorMap_st, CUtensorMap_st, int "
     "const*, __nv_bfloat16*, int, int, int, int, int, int)", "gmm_dx_wgmma_kernel"),
    ("(anonymous namespace)::gmm_dw_wgmma_kernel(CUtensorMap_st, ...)", "gmm_dw_wgmma_kernel"),
    ("void (anonymous namespace)::gmm_dw_scalar_kernel<float>(...)", "gmm_dw_scalar_kernel"),
    ("void gossip_axpy_kernel<float, float>(GossipArgs)", "gossip_axpy_kernel"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", None),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", None),
])
def test_hand_written_names_the_ports_kernels_only(smoke, name, want):
    assert smoke.hand_written(name) == want


@pytest.mark.parametrize("remat,passes", [(True, 1), (False, 1), (True, 24)])
def test_moe_launches_counts_forward_remat_dx_and_dw(smoke, remat, passes):
    import dataclasses

    from repro_torch.configs.registry import get_smoke_config

    # the tiny dbrx: 2 MoE layers; 3 expert products each, run again in
    # the backward under remat, then 3 dx and 3 dw
    cfg = dataclasses.replace(get_smoke_config("dbrx_132b"), moe_num_experts=16,
                              remat=remat)
    assert smoke.moe_launches(cfg, passes) == {
        "grouped_matmul": 2 * 3 * (1 + remat) * passes,
        "grouped_matmul_dx": 2 * 3 * passes,
        "grouped_matmul_dw": 2 * 3 * passes,
    }


def test_new_phases_are_listed_and_wired(smoke):
    import ast

    doc = smoke.__doc__
    for n, name in ((8, "dryrun"), (9, "sweep"), (10, "examples")):
        assert f"{n}. {name}" in doc
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    calls = [c.func.id for c in ast.walk(main)
             if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)]
    order = [calls.index(p) for p in ("phase_tests", "phase_dryrun", "phase_sweep",
                                      "phase_examples")]
    assert order == sorted(order)
    assert smoke.DRY_PEAK_TOL == 0.10


def test_dry_configs_cover_every_driven_configuration(smoke):
    labels = [label for label, _, _ in smoke.dry_configs()]
    assert len(labels) == 2 + 2 + len(smoke.serving_configs()) + 4
    assert labels[0].startswith("train masked") and labels[1].startswith("train overlap")
    assert "after a warm-up step" in labels[1]
    assert all(label.startswith("consensus_distance") for label in labels[2:4])
    assert sum(label.startswith("sdpa_chunked") for label in labels) == 2


def test_dry_run_predicts_what_the_card_measured(smoke):
    """The card's numbers (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6):
    masked step resident 32,313,606,656 B, peak 44.51 GB; the dbrx MoE
    block 6,744,834,048 B and 18.728 GB."""
    configs = {label.split(" (")[0]: predict for label, predict, _ in smoke.dry_configs()}
    cm = configs["train masked"]()
    assert cm.argument_bytes == 32313606656
    assert abs(cm.peak / 44.511e9 - 1) < smoke.DRY_PEAK_TOL
    assert dict(cm.launches) == {"gossip_axpy": 12}
    cm = configs["dbrx MoE block fwd+bwd"]()
    assert cm.argument_bytes == 6744834048
    assert abs(cm.peak / 18.728e9 - 1) < 0.001
    assert dict(cm.launches) == dict.fromkeys(
        ("grouped_matmul", "grouped_matmul_dx", "grouped_matmul_dw"), 3)


def test_dry_run_predicts_the_steady_overlap_step_and_the_consensus_peaks(smoke):
    """The card's numbers (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6): the
    overlap step after a warm-up step 48,470,393,344 B resident and
    56.551 GB at the peak, as from a fresh state; ``consensus_distance``
    over the overlap state 61.359 GB and over the masked state 45.203:
    the peaks phase 3 reports (61.427 / 45.270 GB with what else it
    holds), which are this call's, not a step's."""
    configs = {label.split(" (")[0]: predict for label, predict, _ in smoke.dry_configs()}
    cm = configs["train overlap"]()
    assert cm.argument_bytes == 48470393344
    assert abs(cm.peak / 56.551e9 - 1) < 0.001
    assert dict(cm.launches) == {"gossip_axpy": 12}
    for mode, peak in (("masked", 45.203e9), ("overlap", 61.359e9)):
        cm = configs[f"consensus_distance over the {mode} state"]()
        assert abs(cm.peak / peak - 1) < 0.001, mode
        assert not cm.launches


def test_sweep_close_holds_gossip_bit_for_bit(smoke):
    import torch

    from repro_torch.analysis import kernel_cases

    case = kernel_cases.shared_cases()[0]
    x, y = case.make("cpu")
    want = case.run_plain(x, y)
    assert smoke.sweep_close(torch, case, want.clone(), want) == 0.0
    off = want.clone()
    off[0, 0] = torch.nextafter(off[0, 0], torch.tensor(1e9))
    assert smoke.sweep_close(torch, case, off, want) == float("inf")
    gmm = next(c for c in kernel_cases.sweep_cases("dbrx_132b")
               if c.label == "dbrx_132b/tiny/grouped_matmul_dw/ragged")
    t = gmm.make("cpu")
    want = gmm.run_plain(*t)
    assert smoke.sweep_close(torch, gmm, want + 1e-3, want) < 2e-3
    assert smoke.sweep_close(torch, gmm, want + 1.0, want) == float("inf")


def test_fsdp_phase_is_listed_wired_and_reckons_its_bytes(smoke):
    """Phase 11 (the sharded trainer in an NCCL world of one): listed,
    run after the examples, and its static pieces: the byte reckoning of
    internlm2-1.8b at depth 8 on 4 nodes (882.4 M params, 3.53 GB fp32 a
    node, 14.12 GB of params and as much of velocities and of overlap
    GossipState, gathered views of 3.53 / 2.01 / 0.758 GB), the layouts'
    buckets and the gossip_axpy launches expected of each run, and the
    line printed when one card cannot hold the two-rank worlds."""
    import ast
    import types

    from repro_torch.dist import fsdp
    from repro_torch.models.transformer import Model

    assert "11. fsdp" in smoke.__doc__
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    calls = [c.func.id for c in ast.walk(main)
             if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)]
    assert calls.index("phase_fsdp") > calls.index("phase_examples")
    cfg = smoke.fsdp_config()
    assert (cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size) == (8, 2048, 8192, 92544)
    reck = smoke.fsdp_bytes(cfg)
    assert reck["params_per_node"] == 882411520
    assert reck["node_bytes"] == 4 * 882411520
    gb = {k: round(v / 1e9, 3) for k, v in reck.items() if k != "params_per_node"}
    assert gb == {"node_bytes": 3.53, "params": 14.119, "velocities": 14.119,
                  "gossip_state": 14.119, "monolithic": 3.53, "streamed": 2.013,
                  "scan_streamed": 0.758}
    spec = types.SimpleNamespace(num_nodes=smoke.FSDP_NODES, num_shards=1)
    model = Model(cfg)
    buckets = {"monolithic": fsdp.make_layout(model, spec).plan.num_buckets,
               "streamed": fsdp.make_stream_layout(model, spec, scan_aware=False)
               .plan.num_buckets,
               "scan-streamed": fsdp.make_stream_layout(model, spec).plan.num_buckets}
    assert buckets == {"monolithic": 11, "streamed": 3, "scan-streamed": 3}
    assert smoke.fsdp_expected_launches(11, "sequential") == 33
    assert smoke.fsdp_expected_launches(3, "sequential") == 9
    assert smoke.fsdp_expected_launches(3, "overlap") == 12      # 3 steps and the flush
    assert "were not run" in smoke.fsdp_not_run_line(1)
    assert smoke.fsdp_not_run_line(2) is None
    assert smoke.FSDP_TOL == {"loss_atol": 5e-6, "loss_rtol": 1e-6, "params": 2e-6}


def test_tp_phase_is_listed_wired_and_decides_its_world(smoke):
    """Phase 12 (tensor parallel): listed, run after phase 11; the world
    it picks (gloo with the ranks sharing one card, NCCL with a card a
    rank) and its serving rule (every step routed as the world of one
    routes it: its logits within the tolerance and its token equal where
    the top-2 margin is over twice that; at most a quarter of the steps
    routed otherwise)."""
    import ast

    import torch

    assert "12. tp" in smoke.__doc__
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    calls = [c.func.id for c in ast.walk(main)
             if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)]
    assert calls.index("phase_tp") > calls.index("phase_fsdp")
    assert smoke.tp_world(1) == ("gloo", True)
    assert smoke.tp_world(2) == ("nccl", False) and smoke.tp_world(8) == ("nccl", False)
    tol = smoke.TP_LOGIT_TOL
    logits = torch.zeros(2, 4, 5)
    routes = torch.arange(16.).reshape(2, 4, 2)
    want = {"logits": logits, "tokens": torch.tensor([[1., 2., 3., 4.], [5., 6., 7., 8.]]),
            "margins": torch.full((2, 4), 3 * tol), "routes": routes}
    rows = slice(0, 2)

    def agree(tokens, margins=None, err=0.0, moved=()):
        w = dict(want, margins=margins) if margins is not None else want
        got_logits, got_routes = logits + err, routes.clone()
        for b, i in moved:           # another expert, and a whole expert's term
            got_routes[b, i, 0] = -1
            got_logits[b, i] += 2.0
        return smoke.serve_agree({"logits": got_logits, "tokens": torch.tensor(tokens),
                                  "routes": got_routes}, w, rows)

    same = [[1, 2, 3, 4], [5, 6, 7, 8]]
    res = agree(same)
    assert res["ok"] and res["logits_err"] == 0.0 and res["compared"] == 8
    assert not agree(same, err=2 * tol)["ok"]
    assert not agree([[1, 9, 3, 4], [5, 6, 7, 8]])["ok"]
    narrow = want["margins"].clone()
    narrow[0, 1] = 2 * tol          # a near tie at step 1: the argmax may differ there only
    res = agree([[1, 9, 3, 4], [5, 6, 7, 8]], narrow)
    assert res["ok"] and res["compared"] == 7
    assert not agree([[7, 9, 3, 4], [5, 6, 7, 8]], narrow)["ok"]
    # a re-routed step is counted apart; more than a quarter of them fails
    res = agree([[1, 9, 3, 4], [5, 6, 7, 8]], moved=[(0, 1), (1, 2)])
    assert res["ok"] and res["rerouted"] == 2 and res["rerouted_err"] == 2.0
    assert res["logits_err"] == 0.0 and res["compared"] == 6
    assert not agree(same, moved=[(0, 1), (1, 2), (1, 3)])["ok"]
    assert set(smoke.TP_SERVED) <= {cfg.name for cfg, *_ in smoke.serving_configs()}


def test_sp_phase_is_listed_wired_and_its_meta_views_record(smoke):
    """Phase 13 (sequence parallel, kv-seq serving, the inventory): listed,
    run after phase 12; phase 9 runs the checker with the FSDP lanes; the
    planted fault changes a sequence-parallel loss; the one-process meta
    inventory of a kv-seq-sharded prefill and decode at tiny size."""
    import ast
    import dataclasses

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import tp

    assert "13. sp" in smoke.__doc__ and "--all-layouts" in smoke.__doc__
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    calls = lambda fn: [c.func.id for c in ast.walk(fns[fn])  # noqa: E731
                        if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)]
    assert calls("main").index("phase_sp") > calls("main").index("phase_tp")
    assert "phase_checker" in calls("phase_sweep")
    assert smoke.CHECK_ARGV == ["--shard", "2", "--all-layouts", "--faults", "--strict"]
    cfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), num_layers=1)
    recs = smoke.meta_view_records(cfg, 1, train=False, prompt=8)
    assert {r.kind for r in recs} == {"all_gather", "psum"}
    assert all(r.axes == ("model",) for r in recs)
    # the fault (one rank's partial sums left unreduced shows only in a
    # world of ranks) patches the reduce-scatter's forward and restores it
    orig = tp._SeqReduceScatter.forward
    with smoke.sp_without_reduce_scatter():
        assert tp._SeqReduceScatter.forward is not orig
    assert tp._SeqReduceScatter.forward is orig
    # the serving fault: flash-decoding's combine issues its max and sum
    # all-reduces but not the outputs' (the third), and is restored after
    import types

    import torch

    from repro_torch.dist import comm
    from repro_torch.models import attention

    seen = []
    orig_split, orig_reduce = attention._sdpa_split, comm.all_reduce
    q, k, v = (torch.ones(1, 2, 2, 4), torch.ones(1, 3, 1, 4), torch.ones(1, 3, 1, 4))
    pos = torch.arange(3)[None]
    split = lambda: attention._sdpa_split(  # noqa: E731
        q, k, v, q_positions=pos[:, 1:], k_positions=pos, causal=True, window=0,
        logit_softcap=0.0, tp=types.SimpleNamespace(group=None))
    comm.all_reduce = lambda t, group, op="sum": seen.append(op) or t
    try:
        split()
        with smoke.kv_seq_without_o_reduce():
            assert attention._sdpa_split is not orig_split
            split()
    finally:
        comm.all_reduce = orig_reduce
    assert attention._sdpa_split is orig_split
    assert seen == ["max", "sum", "sum", "max", "sum"]


def test_sweep_phase_runs_the_contract_tile_poison_and_launch_checks(smoke):
    """Phase 9 holds every case to the launch rules and contract, its probe
    tiles, its poisoned launches and its launch count, then runs the
    planted faults and the checker, and logs the seconds the checks add."""
    import ast

    assert "planted" in smoke.__doc__ and "poisoned" in smoke.__doc__
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def called(fn):
        return {c.func.attr if isinstance(c.func, ast.Attribute) else c.func.id
                for c in ast.walk(fns[fn]) if isinstance(c, ast.Call)
                and isinstance(c.func, (ast.Attribute, ast.Name))}

    assert {"lint_case", "poison_case", "run_counted", "launch_violations", "sweep_faults",
            "phase_checker", "sweep_summary"} <= called("phase_sweep")
    assert {"shift_box", "lint_tiles", "leaky_flash", "plain_attention",
            "poison_case", "run_counted"} <= called("sweep_faults")
    line = smoke.sweep_summary(80, 12.5, {"tiles": 1.25, "poison": 6.5}, {"wgmma": 40},
                               {"gossip_axpy": 0.0})
    assert line.startswith("sweep: 80 registry cases") and "in 12.5 s" in line
    assert "tile probes took 1.2 s" in line and "poisoned launches 6.5 s" in line


def test_sweep_planted_faults_are_flagged_on_the_cpu(smoke):
    """The phase's planted faults with the plain versions standing in for
    the kernels: a shifted probe box, a flash launch on k / v views
    shifted into the poisoned tail, ``ops.attention`` on its plain path."""
    import torch

    from repro_torch.analysis import check, kernel_cases, kernel_lint
    from repro_torch.kernels import ops, ref

    boxes = [((qt, 0, 0), (64 * qt, 0, 0), (64 * qt + 64, 1, 1)) for qt in range(4)]
    got, _ = kernel_lint.lint_tiles(kernel_lint.shift_box(boxes), (256, 1, 1),
                                    kernel_lint.contract_for("flash_attention"))
    assert smoke.planted_names(got) == {"output-overlap-undeclared", "output-not-covered"}

    case = next(c for c in kernel_cases.sweep_cases("dbrx_132b")
                if c.label == "dbrx_132b/tiny/flash_attention/ragged")
    t = case.make("cpu", pad=kernel_lint.POISON_PAD)

    def attend(q, k, v, out):
        out[0].copy_(ref.attention_ref(q, k, v, causal=True))

    ks, _ = smoke.shifted_kv(t[1], t[2])
    shift = smoke.LEAK_SHIFT
    assert ks.shape == t[1].shape and torch.equal(ks[0, :-shift], t[1][0, shift:])
    assert kernel_lint.poison_case(case, t, launch=attend)[0] == []
    got, _ = kernel_lint.poison_case(case, t, launch=smoke.leaky_flash(attend))
    assert {"masked-tail-read", "masked-tail-guard-missing"} <= smoke.planted_names(got)

    orig = ops.attention
    with smoke.plain_attention():
        assert ops.attention is not orig
        viols, _ = check.check_kernel_cases([case], card=False)
    assert ops.attention is orig
    assert smoke.planted_names(viols) == {"kernel-launch-missing"}
    assert check.check_kernel_cases([case], card=False)[0] == []


@pytest.mark.parametrize("name,mapping", [
    ("flash_attention", {"flash_tile()": 4}),
    ("grouped_matmul", {"tile_coords(": 5, "locate_tile<": 3, "dw_tile(": 4}),
    ("ssm_scan", {"scalar_item(": 3, "decode_ticket(": 3}),
    ("gossip_axpy", {"scalar_head(": 3, "vectors_aligned(": 3, "whole_vectors(": 1,
                     "whole_vectors<kVec>(": 2,
                     "first_tile_vec()": 3, "tile_step_vecs()": 3}),
])
def test_each_library_exports_a_tile_probe_on_the_kernels_own_mapping(name, mapping):
    """Each ``csrc/*.cu`` exports ``<name>_tile_probe`` (read from the
    source: nvcc runs on the card's machine only), and its block -> tile
    functions are called by the kernels and by the probe alike (their
    definition, each kernel's call and the probe's)."""
    src = (REPO / "src" / "repro_torch" / "csrc" / f"{name}.cu").read_text()
    assert f'extern "C" int {name}_tile_probe(' in src
    assert "emit_box(" in src and "_tile_probe_kernel" in src
    for fn, n in mapping.items():
        assert src.count(fn) >= n, (fn, src.count(fn))
    assert "struct TileBox" in (REPO / "src" / "repro_torch" / "csrc" /
                                "launch_config.cuh").read_text()
