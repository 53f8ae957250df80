"""The benchmark's frozen copies against the port's own output at the
smoke configuration: the corpus, the planner and the gossip's byte
counts; and the profiler arithmetic on hand-made spans."""

import numpy as np
import pytest
import torch

from perfbench.frozen import corpus, gossip_bytes, planner
from perfbench.frozen import profile as fprof


@pytest.mark.parametrize("arch,nodes,batch,seq,seed", [
    ("internlm2_1_8b", 8, 4, 16, 0),
    ("internlm2_1_8b", 8, 1, 48, 2**31 + 12345),
    ("internlm2_1_8b", 4, 2, 9, 7),
])
def test_corpus_draws_the_ports_tokens(arch, nodes, batch, seq, seed):
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.pipeline import DecentralizedBatches

    cfg = get_smoke_config(arch)
    it = DecentralizedBatches(cfg, nodes, batch, seq, seed=seed, device="cpu")
    want = [next(it) for _ in range(3)]
    got = corpus.batches(cfg.vocab_size, nodes, batch, seq, 3, seed)
    assert got.shape == (3, nodes, batch, seq + 1) and got.dtype == np.int32
    for k in range(3):
        np.testing.assert_array_equal(got[k][..., :-1], want[k]["tokens"].numpy())
        np.testing.assert_array_equal(got[k][..., 1:], want[k]["labels"].numpy())
    # a longer draw starts with the same batches
    np.testing.assert_array_equal(corpus.batches(cfg.vocab_size, nodes, batch, seq, 5, seed)[:3],
                                  got)


@pytest.mark.parametrize("graph,m,cb,seed", [
    ("paper8", 8, 0.5, 0), ("paper8", 8, 0.3, 4), ("paper8", 8, 1.0, 0), ("paper8", 8, 0.7, 9),
])
def test_planner_gives_the_ports_plan(graph, m, cb, seed):
    from repro_torch.core import named_graph, plan_matcha

    want = plan_matcha(named_graph(graph, m, seed=3), cb, seed=seed)
    got = planner.plan(graph, m, cb, seed=seed)
    np.testing.assert_array_equal(got.permutations, want.permutations)
    np.testing.assert_array_equal(got.probabilities, want.probabilities)
    assert got.alpha == want.alpha
    np.testing.assert_array_equal(got.schedule(40, 9),
                                  want.schedule(40, seed=9).activations.astype(np.float32))


def test_paper8_plan_is_the_one_the_cells_run():
    p = planner.plan("paper8", 8, 0.5)
    np.testing.assert_allclose(p.probabilities, [0.879, 0.483, 0.276, 0.517, 0.0, 0.846],
                               atol=5e-4)
    assert p.alpha == pytest.approx(0.4156, abs=1e-4)


@pytest.mark.parametrize("nodes", [8, 2])
def test_gossip_bytes_match_the_kernels_cost(nodes):
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.kernels.gossip_axpy import cost
    from repro_torch.models.transformer import Model
    from repro_torch.tree import flatten

    shapes = [s for s, _ in flatten(Model(get_smoke_config("internlm2_1_8b")).param_shapes())
              .values()]
    sizes = [int(np.prod(s)) for s in shapes]
    want = sum(cost(nodes * n, torch.float32, torch.float32)[1] for n in sizes)
    assert gossip_bytes.axpy_bytes_per_step(sizes, nodes) == want


def test_profile_union_gaps_and_kernel_time():
    spans = [(0.0, 10.0, "gemm"), (5.0, 12.0, "void gossip_axpy_kernel<float, float>"),
             (20.0, 25.0, "gemm"), (40.0, 41.0, "copy")]
    host = [(0.0, 50.0, "perfbench.step"), (13.0, 19.0, "aten::to"),
            (14.0, 18.0, "cudaStreamSynchronize")]
    out = fprof.summarize(spans, host)
    assert fprof.busy_intervals(spans) == [(0.0, 12.0), (20.0, 25.0), (40.0, 41.0)]
    assert out["busy_s"] == pytest.approx(18e-6)
    assert out["gaps"][0] == ("perfbench.step", pytest.approx(15e-6))
    assert out["gaps"][1] == ("aten::to / cudaStreamSynchronize", pytest.approx(8e-6))
    assert fprof.kernel_seconds(out["ops"], "gossip_axpy_kernel") == (pytest.approx(7e-6), 1)
    assert out["ops"][0][0] == "gemm" and out["ops"][0][2] == 2
