"""chip_smoke.py's helpers that run without a card: the ptxas report
parser and the count of live (query, key) pairs behind the flash bound."""
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


@pytest.mark.parametrize("Sq,Sk,causal,window,kv_len,want", [
    (4, 4, True, 0, 0, 10),        # 1 + 2 + 3 + 4
    (4, 4, False, 0, 0, 16),
    (4, 6, False, 0, 3, 12),       # keys past kv_len are not live
    (5, 5, True, 2, 0, 9),         # 1 + 2 + 2 + 2 + 2
])
def test_flash_pairs_counts_the_live_query_key_pairs(smoke, Sq, Sk, causal, window,
                                                     kv_len, want):
    assert smoke.flash_pairs(Sq, Sk, causal, window, kv_len) == want
