"""The port's bucket layout against ``repro.dist.bucketing``.

The plan must equal the JAX plan field for field (leaf order included:
``jax.tree.flatten`` sorts each dict level, ``repro_torch.tree`` keeps
insertion order), on the tiny internlm2 parameter tree and on a
hand-made tree with int leaves, at byte targets of 256, the default and
``None``, with and without ``pad_to``. ``ravel`` must be bit-equal to
JAX's (a reshuffle: exact), the stacked ravel/unravel must round-trip
exactly, and the JAX tests' error cases and leaf-splitting rule hold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.dist import bucketing as jb
from repro.models.transformer import Model as JaxModel
from repro_torch.configs.registry import get_smoke_config
from repro_torch.dist import bucketing as tb
from repro_torch.dist import decen_train as dt
from repro_torch.models.transformer import Model


def _np_tree(seed=0):
    """Leaves inserted out of sorted order, an int leaf and a 0-d leaf."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((33, 7)).astype(np.float32),
        "nested": {
            "step": np.asarray(3, np.int32),
            "emb": rng.standard_normal((64, 16)).astype(np.float32),
            "scale": np.asarray(rng.standard_normal(), np.float32),
        },
        "b": rng.standard_normal((129,)).astype(np.float32),
        "a_idx": np.arange(5, dtype=np.int64),
    }


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _jax_paths(tree):
    paths, _ = jax.tree_util.tree_flatten_with_path(tree)
    return tuple(tuple(k.key for k in path) for path, _ in paths)


def _same_plan(got, want, jax_tree):
    assert got.treedef == _jax_paths(jax_tree)
    for field in ("shapes", "is_float", "leaf_bucket", "leaf_offset", "bucket_sizes"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.num_buckets == want.num_buckets
    assert got.total_elements == want.total_elements


@pytest.mark.parametrize("pad_to", [1, 8])
@pytest.mark.parametrize("target", [256, "default", None])
@pytest.mark.parametrize("tree", ["internlm2_tiny", "hand_made"])
def test_plan_equals_jax_field_for_field(tree, target, pad_to):
    kw = {} if target == "default" else {"target_bytes": target}
    if tree == "internlm2_tiny":
        jax_tree = jax.eval_shape(
            lambda: JaxModel(jax_smoke_config("internlm2_1_8b")).init(jax.random.key(0)))
        port_tree = Model(get_smoke_config("internlm2_1_8b")).param_shapes()
    else:
        jax_tree = jax.tree.map(jnp.asarray, _np_tree())
        port_tree = _to_torch(_np_tree())
    got = tb.plan_buckets(port_tree, pad_to=pad_to, **kw)
    want = jb.plan_buckets(jax_tree, pad_to=pad_to, **kw)
    _same_plan(got, want, jax_tree)
    if tree == "internlm2_tiny" and target == "default" and pad_to == 1:
        model = Model(get_smoke_config("internlm2_1_8b"))
        assert dt.param_bucket_plan(model) == got


@pytest.mark.parametrize("target", [256, None])
def test_ravel_is_bit_equal_to_jax(target):
    np_tree = _np_tree(1)
    jax_tree = jax.tree.map(jnp.asarray, np_tree)
    plan = tb.plan_buckets(_to_torch(np_tree), target_bytes=target, pad_to=4)
    jplan = jb.plan_buckets(jax_tree, target_bytes=target, pad_to=4)
    got = tb.ravel(plan, _to_torch(np_tree))
    want = jb.ravel(jplan, jax_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = tb.unravel(plan, got, like=_to_torch(np_tree))
    for key in ("w", "b"):
        np.testing.assert_array_equal(back[key].numpy(), np_tree[key])
    assert back["nested"]["step"].item() == 3
    assert tb.unravel(plan, got)["nested"]["step"] is None
    np.testing.assert_array_equal(back["nested"]["scale"].numpy(), np_tree["nested"]["scale"])


def test_stacked_ravel_unravel_round_trip_and_jax_layout():
    rng = np.random.default_rng(2)
    np_tree = {"z": rng.standard_normal((3, 5, 4)).astype(np.float32),
               "a": {"k": rng.standard_normal((3, 9)).astype(np.float32),
                     "n": np.zeros((3, 2), np.int32)}}
    stacked = _to_torch(np_tree)
    local = {"z": ((5, 4), torch.float32),
             "a": {"k": ((9,), torch.float32), "n": ((2,), torch.int32)}}
    plan = tb.plan_buckets(local, target_bytes=64, pad_to=4)
    buckets = tb.ravel_stacked(plan, stacked)
    want = jb.ravel_stacked(
        jb.plan_buckets(jax.tree.map(lambda a: jnp.asarray(a[0]), np_tree),
                        target_bytes=64, pad_to=4),
        jax.tree.map(jnp.asarray, np_tree))
    for g, w in zip(buckets, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = tb.unravel_stacked(plan, buckets, like=stacked)
    assert torch.equal(back["z"], stacked["z"]) and torch.equal(back["a"]["k"], stacked["a"]["k"])
    assert back["a"]["n"] is stacked["a"]["n"]
    assert tb.unravel_stacked(plan, buckets)["a"]["n"] is None
    # in place into given buffers, tails zeroed
    out = tuple(torch.full_like(b, 7.0) for b in buckets)
    ptrs = [b.data_ptr() for b in out]
    tb.ravel_stacked(plan, stacked, out=out)
    assert [b.data_ptr() for b in out] == ptrs
    for g, w in zip(out, buckets):
        assert torch.equal(g, w)


def test_ravel_rejects_mismatched_tree():
    tree = _to_torch(_np_tree())
    plan = tb.plan_buckets(tree)
    wrong = dict(tree)
    wrong["w"] = torch.zeros((5, 5))
    with pytest.raises(ValueError, match="shape"):
        tb.ravel(plan, wrong)
    with pytest.raises(ValueError, match="buckets"):
        tb.unravel(plan, ())
    missing = dict(tree)
    del missing["b"]
    with pytest.raises(ValueError, match="structure"):
        tb.ravel(plan, missing)
    with pytest.raises(ValueError, match="pad_to"):
        tb.plan_buckets(tree, pad_to=0)
    with pytest.raises(ValueError, match="target_bytes"):
        tb.plan_buckets(tree, target_bytes=0)
    with pytest.raises(ValueError, match="planned"):
        tb.unravel_stacked(plan, tuple(torch.zeros(s) for s in plan.bucket_sizes))


def test_greedy_packing_respects_target_and_never_splits_leaves():
    tree = {f"l{i}": torch.zeros((100,)) for i in range(10)}
    # 100 fp32 = 400 B per leaf; 1000 B target = 250 elements -> a third
    # leaf would overflow, so two leaves per bucket
    plan = tb.plan_buckets(tree, target_bytes=1000)
    assert plan.num_buckets == 5
    assert plan.bucket_sizes == (200,) * 5
    # an oversized leaf lands alone in exactly one bucket
    plan2 = tb.plan_buckets(
        {"a": torch.zeros((10,)), "big": torch.zeros((10_000,)), "z": torch.zeros((10,))},
        target_bytes=1000)
    assert plan2.bucket_sizes == (10, 10_000, 10)
