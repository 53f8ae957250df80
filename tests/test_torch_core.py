"""The port's copies of the numpy-only modules against the originals.

Configs, the MATCHA planner and the synthetic corpus are copied into
``repro_torch`` (the JAX package cannot be imported without JAX). These
tests pin each copy to the original: identical config fields, plans,
schedule bits and batch tokens, compared exactly (no tolerance: the
same numpy code on the same seeds).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import registry as jreg
from repro.data.pipeline import DecentralizedBatches as JaxBatches
from repro.data.pipeline import partition_seeds as jax_partition_seeds
from repro_torch import core
from repro_torch.configs import registry
from repro_torch.data.pipeline import DecentralizedBatches, partition_seeds

GRAPH = "paper8"


def _graphs():
    return jcore.named_graph(GRAPH, 8, seed=3), core.named_graph(GRAPH, 8, seed=3)


def _assert_same_plan(a, b):
    np.testing.assert_array_equal(b.permutations, a.permutations)
    np.testing.assert_array_equal(b.probabilities, a.probabilities)
    assert b.alpha == a.alpha
    assert b.rho == a.rho
    assert b.lambda2 == a.lambda2
    assert b.num_matchings == a.num_matchings
    assert [sorted(m.edges) for m in b.matchings] == [sorted(m.edges) for m in a.matchings]


def test_configs_match_field_by_field():
    assert registry.ARCH_IDS == jreg.ARCH_IDS
    # the fields only the port has (latent attention, the sigmoid router,
    # the expert share, rms_eps) keep their defaults in every JAX config
    port_only = {f.name: f.default for f in dataclasses.fields(registry.get_config("dbrx_132b"))
                 if f.name not in dataclasses.asdict(jreg.get_config("dbrx_132b"))}
    assert set(port_only) >= {"mla_kv_rank", "moe_router", "moe_router_experts", "rms_eps"}
    for arch in jreg.ARCH_IDS:
        for getter in ("get_config", "get_smoke_config"):
            want = dataclasses.asdict(getattr(jreg, getter)(arch))
            got = dataclasses.asdict(getattr(registry, getter)(arch))
            assert {k: got.pop(k) for k in port_only} == port_only, (arch, getter)
            assert got == want, (arch, getter)
        assert registry.get_config(arch).param_counts() == jreg.get_config(arch).param_counts()


@pytest.mark.parametrize("budget", [0.3, 0.5, 1.0])
def test_plan_matcha_and_schedule_bits_match(budget):
    jg, g = _graphs()
    a = jcore.plan_matcha(jg, budget, seed=0)
    b = core.plan_matcha(g, budget, seed=0)
    _assert_same_plan(a, b)
    for seed in (0, 7):
        np.testing.assert_array_equal(
            b.schedule(50, seed=seed).activations, a.schedule(50, seed=seed).activations
        )
    assert core.verify_spectral(b) == jcore.verify_spectral(a)


def test_plan_vanilla_and_periodic_match():
    jg, g = _graphs()
    _assert_same_plan(jcore.plan_vanilla(jg), core.plan_vanilla(g))
    ja, js = jcore.plan_periodic(jg, 0.5)
    ta, ts = core.plan_periodic(g, 0.5)
    _assert_same_plan(ja, ta)
    np.testing.assert_array_equal(ts.activations, js.activations)
    np.testing.assert_array_equal(
        core.periodic_schedule(ta.matchings, 0.5, 20).activations,
        jcore.periodic_schedule(ja.matchings, 0.5, 20).activations,
    )
    np.testing.assert_array_equal(
        core.vanilla_schedule(ta.matchings, 5).activations,
        jcore.vanilla_schedule(ja.matchings, 5).activations,
    )


@pytest.mark.parametrize("iid", [True, False])
def test_decentralized_batches_are_bit_identical(iid):
    cfg = registry.get_smoke_config("internlm2_1_8b")
    jcfg = jreg.get_smoke_config("internlm2_1_8b")
    ours = DecentralizedBatches(cfg, 4, 2, 16, iid=iid, seed=5, device="cpu")
    ref = JaxBatches(jcfg, 4, 2, 16, iid=iid, seed=5)
    for _ in range(2):
        got, want = next(ours), next(ref)
        assert set(got) == {"tokens", "labels"}
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            assert got[key].shape == (4, 2, 16)
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    s, p = partition_seeds(6, iid=iid, seed=2)
    js, jp = jax_partition_seeds(6, iid=iid, seed=2)
    np.testing.assert_array_equal(s, js)
    if iid:
        assert p is None and jp is None
    else:
        np.testing.assert_array_equal(p, jp)
