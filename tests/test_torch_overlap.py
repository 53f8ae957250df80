"""The port's overlap gossip mode against the JAX package's pieces.

The JAX package's overlap step runs under ``shard_map`` and fails on
this container (ROADMAP queue 3), so, as for the masked step, the
reference is assembled from single-device pieces in the reference's
order (``repro.dist.decen_train.make_train_step``'s ``body_overlap``):

  apply    per node, JAX ``_apply_delayed`` (the Pallas gossip-axpy in
           interpret mode) lands the pending delta
  launch   per node, JAX ``bucketing.ravel`` of the corrected params;
           recv_i = sum_j b_j sent[pi_j(i)] as a numpy gather in fp32,
           j ascending, from zeros; then JAX ``delayed_delta``
  SGD      per node, ``jax.value_and_grad(Model.loss)`` and the JAX
           sgd(0.05, 0.9) on the corrected params

Tolerances: the launch and delta are elementwise fp32 with 0/1 bits, so
the port's equal JAX's within 1e-6 (different fused multiply-adds at
most); the three-step run holds params, velocities and deltas to 2e-5
relative Frobenius norm and losses to 1e-5 relative, as the masked
step's test does (tests/test_torch_decen_step.py); gossip-only overlap
round r+1 equals masked round r within 1e-5, as in
tests/test_gossip_parity.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.data.pipeline import DecentralizedBatches as JaxBatches
from repro.dist import bucketing as jb
from repro.dist.decen_train import _apply_delayed as jax_apply_delayed
from repro.dist.gossip import delayed_delta as jax_delayed_delta
from repro.models.transformer import Model as JaxModel
from repro.optim.optimizers import apply_updates as jax_apply_updates
from repro.optim.optimizers import sgd as jax_sgd
from repro_torch import core
from repro_torch.configs.registry import get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data.pipeline import DecentralizedBatches
from repro_torch.dist import bucketing
from repro_torch.dist import decen_train as dt
from repro_torch.dist import gossip
from repro_torch.dist.gossip import (
    delayed_delta,
    delayed_delta_inplace,
    launch_matchings_masked,
    mix_matchings_masked,
)
from repro_torch.models.transformer import Model
from repro_torch.optim.optimizers import sgd
from repro_torch.tree import flatten, tree_map

NODES, BATCH, SEQ, STEPS = 8, 2, 16, 3
LR, MOMENTUM = 0.05, 0.9
TOL_STATE, TOL_LOSS, TOL_ELEM = 2e-5, 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several test workers at once,
    and oversubscribed OpenMP threads slow these training loops tenfold
    (one thread is as fast here when the file runs alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _plan():
    return core.plan_matcha(
        core.named_graph("paper8", NODES, seed=3), 0.5, budget_steps=400, seed=0
    )


def _numpy_recv(sent, perms, bits):
    """recv[i] = sum_j b_j sent[pi_j(i)], fp32, j ascending, from zeros;
    ``bits`` (M,) or (nodes, M)."""
    per_node = np.ndim(bits) == 2
    out = []
    for i in range(sent.shape[0]):
        acc = np.zeros(sent.shape[1:], np.float32)
        for j in range(perms.shape[0]):
            b = np.float32(bits[i, j] if per_node else bits[j])
            acc = acc + b * sent[perms[j][i]]
        out.append(acc)
    return np.stack(out)


@pytest.mark.parametrize("per_node", [False, True])
def test_launch_and_delta_match_jax(per_node, monkeypatch):
    plan = _plan()
    perms = np.asarray(plan.permutations)
    rng = np.random.default_rng(0)
    sent = [rng.standard_normal((NODES, n)).astype(np.float32) for n in (37, 1000)]
    row = np.asarray([1, 0, 1, 1, 0, 1], np.float32)[: plan.num_matchings]
    bits = rng.integers(0, 2, (NODES, plan.num_matchings)).astype(np.float32) \
        if per_node else row
    t_sent = [torch.from_numpy(s) for s in sent]
    recv = launch_matchings_masked(t_sent, torch.from_numpy(bits), perms)
    delta = delayed_delta(t_sent, recv, torch.from_numpy(bits))
    for s, r, d in zip(sent, recv, delta):
        want_recv = _numpy_recv(s, perms, bits)
        np.testing.assert_allclose(r.numpy(), want_recv, atol=TOL_ELEM, rtol=TOL_ELEM)
        want = np.stack([
            np.asarray(jax_delayed_delta(
                (jnp.asarray(s[i]),), (jnp.asarray(want_recv[i]),),
                jnp.asarray(bits[i] if per_node else bits))[0])
            for i in range(NODES)
        ])
        np.testing.assert_allclose(d.numpy(), want, atol=TOL_ELEM, rtol=TOL_ELEM)
    # the in-place version over blocks of columns: the same bits
    monkeypatch.setattr(gossip, "DELTA_BLOCK", 64)
    buf = [s.clone() for s in t_sent]
    ptrs = [b.data_ptr() for b in buf]
    delayed_delta_inplace(buf, torch.from_numpy(bits), perms)
    assert [b.data_ptr() for b in buf] == ptrs
    for got, want in zip(buf, delta):
        assert torch.equal(got, want)


def test_apply_delayed_matches_jax_on_one_node():
    cfg = get_smoke_config("internlm2_1_8b")
    jcfg = jax_smoke_config("internlm2_1_8b")
    plan = _plan()
    init = JaxModel(jcfg).init(jax.random.key(1))
    jbplan = jb.plan_buckets(init)
    bplan = dt.param_bucket_plan(Model(cfg))
    rng = np.random.default_rng(1)
    delta = tuple(rng.standard_normal(s).astype(np.float32) for s in bplan.bucket_sizes)
    want = jax_apply_delayed(init, tuple(jnp.asarray(d) for d in delta), jbplan,
                             float(plan.alpha))
    stacked = dt._stack(params_from_numpy(jax.tree.map(np.asarray, init), "cpu"), 1)
    got = dt._apply_delayed(stacked, tuple(torch.from_numpy(d)[None] for d in delta),
                            bplan, float(plan.alpha))
    want = flatten(jax.tree.map(np.asarray, want))
    got = flatten(params_to_numpy(got))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path][0], w, atol=TOL_ELEM, rtol=TOL_ELEM,
                                   err_msg=path)
    # the flush is the same definition
    flush = dt.make_gossip_flush(plan, bplan)
    gstate = dt.GossipState(delta=tuple(torch.from_numpy(d)[None] for d in delta))
    flushed = flatten(params_to_numpy(flush(stacked, gstate)))
    for path in got:
        np.testing.assert_array_equal(flushed[path], got[path])


def test_gossip_only_overlap_is_masked_one_round_later():
    """Zero grads: overlap round r+1 equals masked round r, and both
    contract to the preserved node mean."""
    plan = core.plan_matcha(core.paper_figure1_graph(), 1.0, budget_steps=300)
    rng = np.random.default_rng(0)
    x0 = {"w": torch.from_numpy(rng.standard_normal((8, 33, 5)).astype(np.float32)),
          "b": torch.from_numpy(rng.standard_normal((8, 17)).astype(np.float32))}
    local = tree_map(lambda a: (tuple(a.shape[1:]), a.dtype), x0)
    bplan = bucketing.plan_buckets(local)
    ones = torch.ones(plan.num_matchings)
    gstate = dt.init_gossip_state(plan, bplan, device="cpu")
    flush = dt.make_gossip_flush(plan, bplan)
    K = 30
    seq = [x0]
    xm = x0
    for _ in range(K):
        xm = mix_matchings_masked(xm, plan.alpha, plan.permutations, ones)
        seq.append(xm)
    xo = tree_map(torch.clone, x0)
    for r in range(K + 1):
        xo = flush(xo, gstate, inplace=True)
        bucketing.ravel_stacked(bplan, xo, out=gstate.delta)
        delayed_delta_inplace(gstate.delta, ones, plan.permutations)
        for key in x0:
            np.testing.assert_allclose(xo[key].numpy(), seq[r][key].numpy(), atol=1e-5,
                                       err_msg=f"round {r}")
    for key in x0:
        a0, aK = x0[key].numpy(), xo[key].numpy()
        spread0 = np.abs(a0 - a0.mean(0, keepdims=True)).max()
        spreadK = np.abs(aK - aK.mean(0, keepdims=True)).max()
        assert spreadK < 0.1 * spread0, (spreadK, spread0)
        np.testing.assert_allclose(aK.mean(0), a0.mean(0), atol=1e-4)


@pytest.fixture(scope="module")
def run():
    jcfg = dataclasses.replace(jax_smoke_config("internlm2_1_8b"), compute_dtype="float32")
    cfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), compute_dtype="float32")
    plan = _plan()
    activations = plan.schedule(STEPS, seed=0).activations
    perms = np.asarray(plan.permutations)
    alpha = float(plan.alpha)
    batches = JaxBatches(jcfg, NODES, BATCH, SEQ, seed=0)
    batches = [{k: np.array(v) for k, v in next(batches).items()} for _ in range(STEPS)]

    # -- JAX reference from single-device pieces --------------------------
    jmodel = JaxModel(jcfg)
    init = jmodel.init(jax.random.key(0))
    jbplan = jb.plan_buckets(init)
    jopt = jax_sgd(LR, momentum=MOMENTUM)
    grad_fn = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))
    apply_fn = jax.jit(lambda p, d: jax_apply_delayed(p, d, jbplan, alpha))
    nodes = [init] * NODES
    states = [jopt.init(init) for _ in range(NODES)]
    deltas = [tuple(jnp.zeros(s, jnp.float32) for s in jbplan.bucket_sizes)] * NODES
    ref = {"losses": []}
    for k in range(STEPS):
        bits = activations[k].astype(np.float32)
        nodes = [apply_fn(nodes[i], deltas[i]) for i in range(NODES)]
        sent = [np.stack([np.asarray(jb.ravel(jbplan, nodes[i])[b]) for i in range(NODES)])
                for b in range(jbplan.num_buckets)]
        recv = [_numpy_recv(s, perms, bits) for s in sent]
        deltas = [
            jax_delayed_delta(tuple(jnp.asarray(s[i]) for s in sent),
                              tuple(jnp.asarray(r[i]) for r in recv), jnp.asarray(bits))
            for i in range(NODES)
        ]
        losses = []
        for i in range(NODES):
            b = {key: jnp.asarray(v[i]) for key, v in batches[k].items()}
            (loss, _), g = grad_fn(nodes[i], b)
            updates, states[i] = jopt.update(g, states[i], nodes[i])
            nodes[i] = jax_apply_updates(nodes[i], updates)
            losses.append(float(loss))
        ref["losses"].append(np.asarray(losses))
    ref["delta"] = [np.stack([np.asarray(d[b]) for d in deltas])
                    for b in range(jbplan.num_buckets)]
    nodes = [apply_fn(nodes[i], deltas[i]) for i in range(NODES)]
    ref["params"] = flatten(jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                                         *nodes))
    ref["velocity"] = flatten(jax.tree.map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]),
        *[s["velocity"] for s in states],
    ))

    # -- the port ------------------------------------------------------------
    model = Model(cfg)
    params = dt._stack(params_from_numpy(jax.tree.map(np.asarray, init), "cpu"), NODES)
    opt = sgd(LR, momentum=MOMENTUM)
    opt_state = dt.init_stacked_opt_state(opt, model, NODES, device="cpu")
    bplan = dt.param_bucket_plan(model)
    gstate = dt.init_gossip_state(plan, bplan, device="cpu")
    ptrs = [t.data_ptr() for t in gstate.delta]
    step = dt.make_train_step(model, opt, plan, gossip_mode="overlap")
    got = {"losses": [], "same_storage": [], "same_state": [], "launch_ms": []}
    for k in range(STEPS):
        batch = {key: torch.as_tensor(v) for key, v in batches[k].items()}
        bits = torch.as_tensor(activations[k].astype(np.float32))
        params, opt_state, out_state, losses, _ = step(params, opt_state, gstate, batch, bits)
        got["same_state"].append(out_state is gstate)
        got["same_storage"].append([t.data_ptr() for t in gstate.delta] == ptrs)
        got["losses"].append(losses.numpy())
        got["launch_ms"].append(step.last_launch_ms)
    got["delta"] = [t.numpy().copy() for t in gstate.delta]
    got["params"] = flatten(params_to_numpy(dt.make_gossip_flush(plan, bplan)(params, gstate)))
    got["velocity"] = flatten(params_to_numpy(opt_state["velocity"]))
    return ref, got


def test_overlap_steps_match_reference(run):
    ref, got = run
    for k in range(STEPS):
        np.testing.assert_allclose(got["losses"][k], ref["losses"][k], rtol=TOL_LOSS)
    assert len(got["delta"]) == len(ref["delta"])
    for g, w in zip(got["delta"], ref["delta"]):
        assert g.shape == w.shape and _rel(g, w) <= TOL_STATE
    assert got["params"].keys() == ref["params"].keys()
    for path, want in ref["params"].items():
        assert _rel(got["params"][path], want) <= TOL_STATE, path
    for path, want in ref["velocity"].items():
        assert _rel(got["velocity"][path], want) <= TOL_STATE, path
    assert np.abs(ref["delta"][0]).max() > 0        # the exchange did move


def test_gossip_state_is_updated_in_place(run):
    _, got = run
    assert all(got["same_state"]) and all(got["same_storage"])
    assert all(ms is not None and ms >= 0 for ms in got["launch_ms"])


def _overlap_run(bits_fn, steps=2):
    cfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), compute_dtype="float32")
    model = Model(cfg)
    plan = _plan()
    sched = plan.schedule(steps, seed=0)
    opt = sgd(LR, momentum=MOMENTUM)
    params = dt.init_stacked_params(model, NODES, seed=0, device="cpu")
    opt_state = dt.init_stacked_opt_state(opt, model, NODES, device="cpu")
    bplan = dt.param_bucket_plan(model)
    gstate = dt.init_gossip_state(plan, bplan, device="cpu")
    data = DecentralizedBatches(cfg, NODES, BATCH, SEQ, seed=0, device="cpu")
    bits0 = bits_fn(sched.activations[0].astype(np.float32))
    step = dt.make_train_step(model, opt, plan, gossip_mode="overlap",
                              faulted=np.ndim(bits0) == 2)
    for k in range(steps):
        bits = torch.as_tensor(bits_fn(sched.activations[k].astype(np.float32)))
        params, opt_state, gstate, _, _ = step(params, opt_state, gstate, next(data), bits)
    return flatten(params), [t.clone() for t in gstate.delta]


def test_faulted_overlap_all_ones_gates_are_bit_equal():
    plain = _overlap_run(lambda row: row)
    gated = _overlap_run(lambda row: np.tile(row, (NODES, 1)))
    for path, t in plain[0].items():
        assert torch.equal(gated[0][path], t), path
    for a, b in zip(plain[1], gated[1]):
        assert torch.equal(a, b)


def test_dropped_exchange_zeroes_the_delta_at_both_ends():
    plan = _plan()
    perms = np.asarray(plan.permutations)
    rng = np.random.default_rng(3)
    sent = torch.from_numpy(rng.standard_normal((NODES, 50)).astype(np.float32))
    ones = np.ones((NODES, plan.num_matchings), np.float32)
    j = 0
    a = next(i for i in range(NODES) if perms[j][i] != i)
    pa = int(perms[j][a])
    dropped = ones.copy()
    dropped[a, j] = dropped[pa, j] = 0.0
    full = delayed_delta_inplace([sent.clone()], torch.from_numpy(ones), perms)[0]
    cut = delayed_delta_inplace([sent.clone()], torch.from_numpy(dropped), perms)[0]
    term = sent[perms[j]] - sent                 # matching j's term at every node
    diff = full - cut
    for i in range(NODES):
        want = term[i] if i in (a, pa) else torch.zeros_like(term[i])
        np.testing.assert_allclose(diff[i].numpy(), want.numpy(), atol=1e-5)
    # symmetric and doubly stochastic: the deltas still sum to zero
    np.testing.assert_allclose(cut.sum(0).numpy(), np.zeros(50), atol=1e-4)


def test_overlap_training_consensus_within_2x_of_masked():
    """At equal iterations on the tiny preset the overlap mode's
    consensus distance stays within 2x of masked, and the loss falls
    (tests/test_gossip_parity.py, at 30 steps instead of 60 so the file
    stays under about a minute on the CPU)."""
    cfg = get_smoke_config("internlm2_1_8b")
    model = Model(cfg)
    plan = core.plan_matcha(core.paper_figure1_graph(), 0.5, budget_steps=400)
    steps = 30
    sched = plan.schedule(steps, seed=1)
    gen = torch.Generator().manual_seed(7)
    results = {}
    for mode in ("masked", "overlap"):
        opt = sgd(0.3, momentum=0.9)
        params = dt.init_stacked_params(model, 8, seed=0, device="cpu")
        params = tree_map(lambda a: a + 0.01 * torch.randn(a.shape, generator=gen)
                          if a.dtype == torch.float32 else a, params)
        opt_state = dt.init_stacked_opt_state(opt, model, 8, device="cpu")
        data = DecentralizedBatches(cfg, 8, 4, 32, seed=0, device="cpu")
        step = dt.make_train_step(model, opt, plan, gossip_mode=mode)
        gstate = None
        if mode == "overlap":
            bplan = dt.param_bucket_plan(model)
            gstate = dt.init_gossip_state(plan, bplan, device="cpu")
        first = None
        for k in range(steps):
            bits = torch.as_tensor(sched.activations[k].astype(np.float32))
            if mode == "overlap":
                params, opt_state, gstate, losses, _ = step(
                    params, opt_state, gstate, next(data), bits)
            else:
                params, opt_state, losses, _ = step(params, opt_state, next(data), bits)
            if first is None:
                first = float(losses.mean())
        if mode == "overlap":
            params = dt.make_gossip_flush(plan, bplan)(params, gstate)
        results[mode] = (first, float(losses.mean()), float(dt.consensus_distance(params)))
    f_o, l_o, c_o = results["overlap"]
    _, _, c_m = results["masked"]
    assert l_o < f_o - 0.3, f"overlap loss did not decrease: {f_o} -> {l_o}"
    assert c_o <= 2.0 * c_m, f"overlap consensus {c_o} worse than 2x masked {c_m}"
