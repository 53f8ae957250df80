"""The port's FSDP runtime (``repro_torch.dist.fsdp``) in one process.

Against the JAX package, bit for bit: the FSDP pieces of the bucket
layout (``shard_buckets``, ``plan_group_buckets``, the shard-major scan
rows and ``scan_ravel*``), the models' layer groups and stream stages
(an unrolled, a scanned, a periodic, an encoder-decoder and a
vision-prefix model), and the three layouts' ravel / unravel and
``gather_params`` / ``scatter_params`` at S 1 and 2; and
``consensus_distance_sharded`` within 1e-6. The JAX builders take only a
spec's node and shard counts, so no JAX mesh is needed.

Against the port's replicated step (the JAX package's sharded step tests
fail on this jax, ROADMAP queue 3): at a world of one (S 1) the
monolithic step is bit-equal to ``TrainStep`` over 3 steps, the streamed
and scan-streamed layouts within the limits of
tests/test_stream_fsdp.py (loss atol 5e-6 / rtol 1e-6, params 2e-6), and
the scan-streamed overlap step and flush within the same of
``OverlapStep``. The model has 8 layers, so its stack is one scanned
segment and the scan-aware layout streams rows.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.dist import bucketing as jb
from repro.dist import fsdp as jf
from repro.models.transformer import Model as JaxModel
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core import named_graph, plan_matcha
from repro_torch.data.pipeline import DecentralizedBatches
from repro_torch.dist import bucketing as tb
from repro_torch.dist import decen_train as dt
from repro_torch.dist import fsdp as tf
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.transformer import Model
from repro_torch.optim.optimizers import sgd
from repro_torch.telemetry import StepTimer, TraceRecorder
from repro_torch.tree import flatten

NODES, BATCH, SEQ, STEPS = 4, 4, 32, 3
LOSS_TOL = dict(atol=5e-6, rtol=1e-6)        # tests/test_stream_fsdp.py:207-212
PARAM_TOL = dict(atol=2e-6, rtol=2e-6)

# (arch, layers): unrolled, scanned (SCAN_THRESHOLD 8), periodic (jamba
# 4 layers), encoder-decoder, vision prefix
MODELS = [("internlm2_1_8b", 0), ("internlm2_1_8b", 8), ("jamba_v0_1_52b", 4),
          ("whisper_base", 0), ("internvl2_1b", 0)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny models run as fast on one torch thread, and the suite runs
    several test processes at once: more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _models(arch, layers):
    tcfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    if layers:
        tcfg = dataclasses.replace(tcfg, num_layers=layers)
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
    return Model(tcfg), JaxModel(jcfg)


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree)


def _same_tree(port, ref):
    """Port tree of tensors == JAX tree of arrays, leaf for leaf, bits."""
    got = flatten(port)
    want = {".".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(ref)}
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def _same_plan(tp, jp):
    assert tp.bucket_sizes == jp.bucket_sizes
    assert tp.leaf_bucket == jp.leaf_bucket and tp.leaf_offset == jp.leaf_offset
    assert tp.shapes == jp.shapes and tp.is_float == jp.is_float
    paths, _ = jax.tree_util.tree_flatten_with_path(jax.tree.unflatten(
        jp.treedef, list(range(len(jp.shapes)))))
    assert tp.treedef == tuple(tuple(k.key for k in p) for p, _ in paths)


# ---------------------------------------------------------------------------
# The bucket layout's FSDP pieces
# ---------------------------------------------------------------------------
def test_shard_buckets_and_shard_major_rows_match_jax():
    rng = np.random.default_rng(0)
    buckets = (rng.standard_normal((3, 12)).astype(np.float32),
               rng.standard_normal((6,)).astype(np.float32))
    for s in (1, 2, 3):
        got = tb.shard_buckets(tuple(torch.from_numpy(b) for b in buckets), s)
        want = jb.shard_buckets(tuple(jnp.asarray(b) for b in buckets), s)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        back = tb.unshard_buckets(got)
        for g, b in zip(back, buckets):
            np.testing.assert_array_equal(g.numpy(), b)
    rows = rng.standard_normal((2, 3, 12)).astype(np.float32)
    for s in (1, 2, 3, 4):
        flat = tb.rows_to_shard_major(torch.from_numpy(rows), s)
        np.testing.assert_array_equal(flat.numpy(),
                                      np.asarray(jb.rows_to_shard_major(jnp.asarray(rows), s)))
        np.testing.assert_array_equal(tb.rows_from_shard_major(flat, 3, s).numpy(), rows)
    with pytest.raises(ValueError, match="pad_to=5"):
        tb.shard_buckets((torch.zeros(12),), 5)
    with pytest.raises(ValueError, match="pad_to=5"):
        tb.rows_to_shard_major(torch.zeros(3, 12), 5)


@pytest.mark.parametrize("arch,layers", [MODELS[1], MODELS[2]])
def test_plan_group_buckets_and_scan_ravel_match_jax(arch, layers):
    """Grouped plans field for field (whole-subtree and scan-aware, pad_to
    1, 2, 4), and the scanned group's scan_ravel / scan_unravel and
    stacked forms bit for bit on random values."""
    tmodel, jmodel = _models(arch, layers)
    tnamed = tf.param_group_subtrees(tmodel)
    jnamed = jf.param_group_subtrees(jmodel)
    reps = tuple(g.repeats for g in tmodel.param_group_specs())
    assert reps == tuple(g.repeats for g in jmodel.param_group_specs())
    rng = np.random.default_rng(1)
    for pad in (1, 2, 4):
        for scan in (False, True):
            tplan = tb.plan_group_buckets(list(tnamed), pad_to=pad, scan_aware=scan,
                                          scan_repeats=reps)
            jplan = jb.plan_group_buckets(list(jnamed), pad_to=pad, scan_aware=scan,
                                          scan_repeats=reps)
            assert tplan.names == jplan.names and tplan.repeats == jplan.repeats
            assert tplan.bucket_sizes == jplan.bucket_sizes
            assert tplan.max_group_elements == jplan.max_group_elements
            for tp, jp in zip(tplan.plans, jplan.plans):
                _same_plan(tp, jp)
        gi = next(i for i, r in enumerate(tplan.repeats) if r > 1)
        r = tplan.repeats[gi]
        sub = {path: rng.standard_normal((r,) + shape).astype(np.float32)
               for path, (shape, _) in flatten(tb._strip_leading(tnamed[gi][1], r, "g")).items()}
        sub = tb.unflatten(tuple(tuple(p.split(".")) for p in sub), list(sub.values()))
        got = tb.scan_ravel(tplan.plans[gi], _torch_tree(sub), r, pad)
        want = jb.scan_ravel(jplan.plans[gi], _jax_tree(sub), r, pad)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        _same_tree(tb.scan_unravel(tplan.plans[gi], got, r, pad),
                   jb.scan_unravel(jplan.plans[gi], want, r, pad))
        stacked = {k: np.stack([v, 2 * v]) for k, v in flatten(sub).items()}
        stacked = tb.unflatten(tuple(tuple(p.split(".")) for p in stacked), list(stacked.values()))
        got = tb.scan_ravel_stacked(tplan.plans[gi], _torch_tree(stacked), r, pad)
        want = jb.scan_ravel_stacked(jplan.plans[gi], _jax_tree(stacked), r, pad)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        _same_tree(tb.scan_unravel_stacked(tplan.plans[gi], got, r, pad),
                   jb.scan_unravel_stacked(jplan.plans[gi], want, r, pad))


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


# ---------------------------------------------------------------------------
# Layer groups and stream stages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,layers", MODELS)
def test_param_groups_and_stream_stages_match_jax(arch, layers):
    tmodel, jmodel = _models(arch, layers)
    fields = ("name", "keys", "segment", "layer", "repeats")
    tg, jg = tmodel.param_group_specs(), jmodel.param_group_specs()
    assert [tuple(getattr(g, f) for f in fields) for g in tg] == \
        [tuple(getattr(g, f) for f in fields) for g in jg]
    covered = {k for g in tg for k in g.keys}
    assert covered == set(tmodel.param_shapes())
    cfg = tmodel.cfg
    batch = {"tokens": np.zeros((1, 8), np.int32), "labels": np.zeros((1, 8), np.int32)}
    if cfg.encoder_layers:
        batch["encoder_frames"] = np.zeros((1, 6, cfg.frontend_dim or cfg.d_model), np.float32)
    elif cfg.frontend:
        batch["prefix_embeddings"] = np.zeros((1, 3, cfg.frontend_dim or cfg.d_model),
                                              np.float32)
    describe = lambda st: (st.name, st.group_ids,
                           None if st.scan is None else st.scan.repeats)
    assert [describe(s) for s in tmodel.stream_stages(batch)] == \
        [describe(s) for s in jmodel.stream_stages(batch)]


# ---------------------------------------------------------------------------
# Layouts, gather / scatter, consensus
# ---------------------------------------------------------------------------
def _layout_pair(kind, tmodel, jmodel, shards):
    spec = types.SimpleNamespace(num_nodes=NODES, num_shards=shards)
    if kind == "monolithic":
        return tf.make_layout(tmodel, spec), jf.make_layout(jmodel, spec)
    scan = kind == "scan-streamed"
    return (tf.make_stream_layout(tmodel, spec, scan_aware=scan),
            jf.make_stream_layout(jmodel, spec, scan_aware=scan))


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("kind", ["monolithic", "streamed", "scan-streamed"])
def test_layouts_ravel_gather_and_scatter_match_jax(kind, shards):
    tmodel, jmodel = _models("internlm2_1_8b", 8)
    tl, jl = _layout_pair(kind, tmodel, jmodel, shards)
    assert tl.shard_sizes == jl.shard_sizes
    params = tmodel.init(0, device="cpu")
    jparams = _jax_tree(params)
    got = tl.ravel(params)
    want = jl.ravel(jparams)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _same_tree(tl.unravel_cast(got), jl.unravel_cast(want))
    stacked = {k: torch.stack([v + i for i in range(NODES)]) for k, v in flatten(params).items()}
    stacked = tb.unflatten(tuple(tuple(p.split(".")) for p in stacked), list(stacked.values()))
    t_sh = tf.scatter_params(tl, stacked)
    j_sh = jf.scatter_params(jl, _jax_tree(stacked))
    for g, w in zip(t_sh, j_sh, strict=True):
        assert tuple(g.shape) == (NODES, shards, g.shape[-1])
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _same_tree(tf.gather_params(tl, t_sh), jf.gather_params(jl, j_sh))
    # this rank's slice at a world of one is the whole node range, shard 0
    if shards == 1:
        spec = dt.make_spec(make_test_mesh(), NODES)
        mine = tf.scatter_params(tl, stacked, spec)
        for m, g in zip(mine, t_sh):
            np.testing.assert_array_equal(m.numpy(), g[:, 0].numpy())
        _same_tree(tf.gather_params(tl, mine, spec), jf.gather_params(jl, j_sh))


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_consensus_distance_sharded_matches_jax(shards):
    rng = np.random.default_rng(shards)
    arrays = tuple(rng.standard_normal((NODES, shards, n)).astype(np.float32)
                   for n in (64, 3, 257))
    got = float(tf.consensus_distance_sharded(tuple(torch.from_numpy(a) for a in arrays)))
    want = float(jf.consensus_distance_sharded(tuple(jnp.asarray(a) for a in arrays)))
    assert abs(got - want) <= 1e-6
    if shards == 1:     # a world of one's local form
        spec = dt.make_spec(make_test_mesh(), NODES)
        local = float(tf.consensus_distance_sharded(
            tuple(torch.from_numpy(a[:, 0]) for a in arrays), spec))
        assert abs(local - want) <= 1e-6


# ---------------------------------------------------------------------------
# The sharded step at a world of one, against the replicated step
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def run():
    cfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), num_layers=8,
                              compute_dtype="float32")
    model, opt = Model(cfg), sgd(0.05, momentum=0.9)
    plan = plan_matcha(named_graph("ring", NODES, seed=3), 0.5, seed=0)
    sched = plan.schedule(STEPS, seed=0)
    data = DecentralizedBatches(cfg, NODES, BATCH, SEQ, seed=0, device="cpu")
    batches = [next(data) for _ in range(STEPS)]
    bits = [sched.activations[k].astype(np.float32) for k in range(STEPS)]
    spec = dt.make_spec(make_test_mesh(), NODES)
    refs = {}

    def replicated(mode):
        if mode not in refs:
            p = dt.init_stacked_params(model, NODES, seed=0, device="cpu")
            s = dt.init_stacked_opt_state(opt, model, NODES, device="cpu")
            step = dt.make_train_step(model, opt, plan, gossip_mode=mode)
            g = dt.init_gossip_state(plan, step.bplan, device="cpu") if mode == "overlap" else None
            losses = []
            for b, k in zip(batches, bits):
                if g is not None:
                    p, s, g, loss, _ = step(p, s, g, b, k)
                else:
                    p, s, loss, _ = step(p, s, b, k)
                losses.append(loss)
            if g is not None:
                p = dt.make_gossip_flush(plan, step.bplan)(p, g)
            refs[mode] = (p, torch.stack(losses))
        return refs[mode]

    def sharded(kind, mode):
        layout = (tf.make_layout(model, spec) if kind == "monolithic" else
                  tf.make_stream_layout(model, spec, scan_aware=kind == "scan-streamed"))
        p = tf.init_fsdp_params(model, layout, spec, seed=0, device="cpu")
        s = tf.init_fsdp_opt_state(opt, layout, spec, device="cpu")
        step = tf.make_fsdp_train_step(model, opt, plan, spec, layout, gossip_mode=mode)
        g = tf.init_fsdp_gossip_state(layout, spec, device="cpu") if mode == "overlap" else None
        losses = []
        for b, k in zip(batches, bits):
            if g is not None:
                p, s, g, loss, _ = step(p, s, g, b, k)
            else:
                p, s, loss, _ = step(p, s, b, k)
            losses.append(loss)
        if g is not None:
            p = tf.make_fsdp_gossip_flush(plan, layout)(p, g)
        return tf.gather_params(layout, p, spec), torch.stack(losses), layout

    return types.SimpleNamespace(replicated=replicated, sharded=sharded)


@pytest.mark.parametrize("kind", ["monolithic", "streamed", "scan-streamed"])
def test_world_of_one_matches_the_replicated_step(run, kind):
    ref, ref_losses = run.replicated("masked")
    got, losses, layout = run.sharded(kind, "sequential")
    assert layout.plan.num_buckets == (3 if kind != "monolithic" else 2)
    if kind == "monolithic":
        assert torch.equal(losses, ref_losses)
        for k, v in flatten(ref).items():
            assert torch.equal(flatten(got)[k], v), k
        return
    np.testing.assert_allclose(losses.numpy(), ref_losses.numpy(), **LOSS_TOL)
    for k, v in flatten(ref).items():
        np.testing.assert_allclose(flatten(got)[k].numpy(), v.numpy(), **PARAM_TOL, err_msg=k)


def test_world_of_one_overlap_and_flush_match_the_replicated_overlap_step(run):
    ref, ref_losses = run.replicated("overlap")
    got, losses, _ = run.sharded("scan-streamed", "overlap")
    np.testing.assert_allclose(losses.numpy(), ref_losses.numpy(), **LOSS_TOL)
    for k, v in flatten(ref).items():
        np.testing.assert_allclose(flatten(got)[k].numpy(), v.numpy(), **PARAM_TOL, err_msg=k)


def test_step_builders_check_modes_layouts_and_batches(run):
    cfg = get_smoke_config("internlm2_1_8b")
    model, opt = Model(cfg), sgd(0.1)
    plan = plan_matcha(named_graph("ring", NODES, seed=3), 0.5, seed=0)
    spec = dt.make_spec(make_test_mesh(), NODES)
    layout = tf.make_layout(model, spec)
    with pytest.raises(ValueError, match="unknown fsdp gossip_mode"):
        tf.make_fsdp_train_step(model, opt, plan, spec, layout, gossip_mode="static")
    other = tf.make_layout(model, types.SimpleNamespace(num_nodes=NODES, num_shards=2))
    with pytest.raises(ValueError, match="shard factor"):
        tf.make_fsdp_train_step(model, opt, plan, spec, other)
    step = tf.make_fsdp_train_step(model, opt, plan, spec, layout,
                                   timer=StepTimer(TraceRecorder()))
    shards = tf.init_fsdp_params(model, layout, spec, device="cpu")
    state = tf.init_fsdp_opt_state(opt, layout, spec, device="cpu")
    data = DecentralizedBatches(cfg, NODES, BATCH, SEQ, seed=0, device="cpu")
    step(shards, state, next(data), np.ones(plan.num_matchings, np.float32))
    assert {"gather", "fwd_bwd", "forward", "backward", "reduce_scatter", "optimizer",
            "gossip", "gossip/target", "gossip/apply"} <= set(step.last_phase_ms)
