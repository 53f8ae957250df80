"""chip_smoke.py's helpers that run without a card: the ptxas report
parser and its wgmma-serialization note, the count of live (query, key)
pairs behind the flash bound, the SSD chunk scan's bound and the
profiler's names of the port's kernels, and the grouped-matmul launches
a MoE training pass makes."""
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
    assert smoke.flash_pairs(Sq, Sk, causal, window, kv_len) == want


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
