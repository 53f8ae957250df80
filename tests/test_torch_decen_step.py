"""The whole slice: the port's decentralized step against JAX.

Eight nodes on paper8, MATCHA at budget 0.5, masked gossip, three
steps, fp32 compute, from identical JAX-initialized weights and the
same numpy batches. The JAX package's ``shard_map`` step cannot serve as
the oracle on this container (see ROADMAP queue 3), so the reference is
assembled from single-device pieces, in the reference's order:

  per node   jax.value_and_grad(Model.loss), then the JAX sgd(0.05, 0.9)
  gossip     per leaf, the fp32 target x + sum_j b_j (x[pi_j] - x), then
             repro.kernels.gossip_axpy.gossip_axpy(x, target, alpha,
             interpret=True)

and that gossip is itself cross-checked against ``mix_dense`` with the
dense ``faults.effective_mixing_matrix``.

Tolerances: params, velocities and consensus to 2e-5 relative
Frobenius norm per leaf and losses to 1e-5 relative. These are fp32
runs of the same algorithm, differing only in summation order and in
XLA's FMA contraction (measured: params 9e-8, velocities 1.3e-6,
losses 1.5e-7, consensus 6e-8).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.data.pipeline import DecentralizedBatches as JaxBatches
from repro.dist.decen_train import consensus_distance as jax_consensus
from repro.dist.gossip import mix_dense as jax_mix_dense
from repro.faults.model import effective_mixing_matrix
from repro.kernels.gossip_axpy import gossip_axpy as jax_gossip_axpy
from repro.models.transformer import Model as JaxModel
from repro.optim.optimizers import apply_updates as jax_apply_updates
from repro.optim.optimizers import sgd as jax_sgd
from repro_torch import core
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.dist import decen_train as dt
from repro_torch.dist.gossip import mix_dense, mix_matchings, mix_matchings_masked
from repro_torch.optim.optimizers import sgd
from repro_torch.tree import flatten

NODES, BATCH, SEQ, STEPS = 8, 2, 16, 3
LR, MOMENTUM = 0.05, 0.9
TOL_STATE, TOL_LOSS = 2e-5, 1e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _reference_gossip(perms, alpha):
    """Per leaf: fp32 target, then the Pallas kernel (interpret mode)."""

    @jax.jit
    def leaf(x, bits):
        xf = x.astype(jnp.float32)
        delta = jnp.zeros_like(xf)
        for j in range(perms.shape[0]):
            delta = delta + bits[j] * (xf[perms[j]] - xf)
        return jax_gossip_axpy(x, xf + delta, alpha, interpret=True)

    return lambda stacked, bits: jax.tree.map(
        lambda x: leaf(x, jnp.asarray(bits)), stacked
    )


@pytest.fixture(scope="module")
def run():
    jcfg = dataclasses.replace(jax_smoke_config("internlm2_1_8b"), compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), compute_dtype="float32")
    # one plan feeds both sides: test_torch_core pins the port's planner
    # to the JAX one
    plan = core.plan_matcha(
        core.named_graph("paper8", NODES, seed=3), 0.5, budget_steps=400, seed=0
    )
    activations = plan.schedule(STEPS, seed=0).activations
    perms = np.asarray(plan.permutations)
    batches = JaxBatches(jcfg, NODES, BATCH, SEQ, seed=0)
    batches = [
        {k: np.array(v) for k, v in next(batches).items()} for _ in range(STEPS)
    ]

    # -- JAX reference from single-device pieces --------------------------
    jmodel = JaxModel(jcfg)
    init = jmodel.init(jax.random.key(0))
    jopt = jax_sgd(LR, momentum=MOMENTUM)
    grad_fn = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))
    gossip = _reference_gossip(perms, float(plan.alpha))
    nodes = [init] * NODES
    states = [jopt.init(init) for _ in range(NODES)]
    ref = {"losses": [], "consensus": [], "dense_gap": []}
    for k in range(STEPS):
        losses = []
        for i in range(NODES):
            b = {key: jnp.asarray(v[i]) for key, v in batches[k].items()}
            (loss, _), g = grad_fn(nodes[i], b)
            updates, states[i] = jopt.update(g, states[i], nodes[i])
            nodes[i] = jax_apply_updates(nodes[i], updates)
            losses.append(float(loss))
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *nodes)
        bits = activations[k].astype(np.float32)
        mixed = gossip(stacked, bits)
        W = effective_mixing_matrix(perms, plan.alpha, np.tile(bits, (NODES, 1)))
        dense = jax_mix_dense(stacked, jnp.asarray(W))
        ref["dense_gap"].append(max(
            _rel(a, b) for a, b in zip(jax.tree.leaves(mixed), jax.tree.leaves(dense))
        ))
        nodes = [jax.tree.map(lambda a, i=i: a[i], mixed) for i in range(NODES)]
        ref["losses"].append(np.asarray(losses))
        ref["consensus"].append(float(jax_consensus(mixed)))
    ref["params"] = flatten(jax.tree.map(np.asarray, mixed))
    ref["velocity"] = flatten(jax.tree.map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]),
        *[s["velocity"] for s in states],
    ))

    # -- the port ------------------------------------------------------------
    model_init = params_from_numpy(jax.tree.map(np.asarray, init), "cpu")
    params = dt._stack(model_init, NODES)
    opt = sgd(LR, momentum=MOMENTUM)
    from repro_torch.models.transformer import Model

    model = Model(cfg)
    opt_state = dt.init_stacked_opt_state(opt, model, NODES, device="cpu")
    step = dt.make_train_step(model, opt, plan, gossip_mode="masked")
    got = {"losses": [], "consensus": [], "phases": []}
    for k in range(STEPS):
        batch = {key: torch.as_tensor(v) for key, v in batches[k].items()}
        bits = torch.as_tensor(activations[k].astype(np.float32))
        params, opt_state, losses, metrics = step(params, opt_state, batch, bits)
        got["losses"].append(losses.numpy())
        got["consensus"].append(float(dt.consensus_distance(params)))
        got["phases"].append(step.last_phases.ms())
    got["params"] = flatten(params_to_numpy(params))
    got["velocity"] = flatten(params_to_numpy(opt_state["velocity"]))
    got["step"] = opt_state["step"].numpy()
    got["ce"] = metrics["ce"].numpy()
    return ref, got


def test_reference_gossip_equals_dense_mixing_matrix(run):
    ref, _ = run
    assert max(ref["dense_gap"]) <= 1e-6


def test_params_and_velocities_match_reference(run):
    ref, got = run
    assert got["params"].keys() == ref["params"].keys()
    for path, want in ref["params"].items():
        assert got["params"][path].shape == want.shape, path
        assert _rel(got["params"][path], want) <= TOL_STATE, path
    for path, want in ref["velocity"].items():
        assert _rel(got["velocity"][path], want) <= TOL_STATE, path
    np.testing.assert_array_equal(got["step"], np.full(NODES, STEPS, np.int32))


def test_losses_and_consensus_match_reference(run):
    ref, got = run
    for k in range(STEPS):
        np.testing.assert_allclose(got["losses"][k], ref["losses"][k], rtol=TOL_LOSS)
        assert abs(got["consensus"][k] - ref["consensus"][k]) <= TOL_STATE * ref["consensus"][k]
    np.testing.assert_array_equal(got["ce"], got["losses"][-1])
    assert ref["consensus"][-1] > 0      # the nodes did diverge and mix


def test_step_reports_phase_times(run):
    _, got = run
    for phases in got["phases"]:
        assert set(phases) == {"step", "fwd_bwd", "forward", "backward", "optimizer",
                               "gossip", "gossip/target", "gossip/apply"}
        assert all(v >= 0 for v in phases.values())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_masked_static_dense_agree_for_every_schedule_row(dtype, tol):
    plan = core.plan_matcha(
        core.named_graph("paper8", NODES, seed=3), 0.5, budget_steps=400, seed=0
    )
    sched = plan.schedule(6, seed=3)
    rng = np.random.default_rng(0)
    x = {"w": torch.from_numpy(rng.standard_normal((NODES, 16, 8)).astype(np.float32)).to(dtype),
         "b": torch.from_numpy(rng.standard_normal((NODES, 129)).astype(np.float32)).to(dtype),
         "n": torch.arange(NODES)}
    for k in range(sched.num_iterations):
        active = sched.active_indices(k)
        bits = sched.activations[k].astype(np.float32)
        W = np.eye(NODES) - plan.alpha * sched.laplacian(k)
        want = mix_dense(x, W)
        dup = active + active[:1]              # a duplicate id must dedupe
        for name, got in (
            ("masked", mix_matchings_masked(x, plan.alpha, plan.permutations, bits)),
            ("static", mix_matchings(x, plan.alpha, plan.permutations, dup)),
            ("gated", mix_matchings(x, plan.alpha, plan.permutations, active,
                                    gate_bits=np.ones((NODES, plan.num_matchings)))),
        ):
            assert got["n"] is x["n"]
            for leaf in ("w", "b"):
                assert got[leaf].dtype == dtype
                np.testing.assert_allclose(
                    got[leaf].float().numpy(), want[leaf].float().numpy(),
                    atol=tol, rtol=tol, err_msg=f"{name} row {k}",
                )


def test_static_and_none_modes():
    plan = core.plan_vanilla(core.named_graph("paper8", NODES, seed=3))
    x = {"w": torch.randn(NODES, 5, generator=torch.Generator().manual_seed(0))}
    assert mix_matchings(x, plan.alpha, plan.permutations, ()) is x
    with pytest.raises(ValueError, match="out of range"):
        mix_matchings(x, plan.alpha, plan.permutations, (plan.num_matchings,))
    with pytest.raises(ValueError, match="activation bits"):
        mix_matchings_masked(x, plan.alpha, plan.permutations, np.ones(2))
    # overlap is ported: its step threads the in-flight GossipState
    from repro_torch.models.transformer import Model

    model = Model(get_smoke_config("internlm2_1_8b"))
    overlap = dt.make_train_step(model, sgd(0.1), plan, gossip_mode="overlap")
    assert isinstance(overlap, dt.OverlapStep) and overlap.bplan == dt.param_bucket_plan(model)
    with pytest.raises(ValueError, match="unknown gossip_mode"):
        dt.make_train_step(None, sgd(0.1), plan, gossip_mode="ring")
