"""The ``pod`` axis in the port: the rules, the mesh and a gloo world of
``(pod 2, data 2)``, against the JAX package and the single-process step.

In process:

* the rules: for all ten registry configs on ``(pod 2, data 2, model
  T)`` meshes, T in 1, 2, 4 and 16, the port's ``serve_rules`` /
  ``train_rules`` / ``rules_for_config`` mappings equal JAX's, name for
  name, with ``multi_pod``, ``kv_seq_sharded`` and ``sequence_parallel``
  (JAX's functions called with a duck-typed mesh, which is all they
  read);
* ``num_nodes`` raises where JAX's does: ``multi_pod`` without a
  ``pod`` axis, and a ``pod`` axis without ``multi_pod``;
* the rank order ``((p * D + d) * S + s) * T + t`` and each axis's
  group, on the mesh and on a virtual mesh; ``DistSpec.node_axes``.

Over gloo (one world of 4 ranks, spawned once under its own timeout by
``tests/torch_dist_worker.py``): 8 tiny fp32 nodes on ``paper8``, two a
rank, in masked, static and overlap gossip for 3 steps, bit-equal to the
single-process step; every step's collectives (exchanges over ``("pod",
"data")``) equal, op for op, those of the rank's meta view of the same
mesh, and every c10d op the backend received came through
``repro_torch.dist.comm``; and on ``(data 2, shard 2)`` the FSDP step in
its three layouts, whose collectives equal the meta view's too.
"""
import sys
import types
from pathlib import Path

import pytest

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jax_config
from repro.dist import sharding as jshd
from repro_torch.configs.registry import get_config
from repro_torch.dist import decen_train as dt
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as mesh_lib

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_worker as w  # noqa: E402


def _pod_mesh(T: int):
    return types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                 shape={"pod": 2, "data": 2, "model": T})


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("T", [1, 2, 4, 16])
def test_pod_rules_equal_jax_for_every_config(arch, T):
    mesh = _pod_mesh(T)
    jc, tc = jax_config(arch), get_config(arch)
    for kv in (False, True):
        assert shd.serve_rules(mesh, tc, multi_pod=True, kv_seq_sharded=kv).mapping == \
            jshd.serve_rules(mesh, jc, multi_pod=True, kv_seq_sharded=kv).mapping, kv
    for sp in (False, True):
        assert shd.train_rules(mesh, tc, multi_pod=True, sequence_parallel=sp).mapping == \
            jshd.train_rules(mesh, jc, multi_pod=True, sequence_parallel=sp).mapping, sp
    got = shd.rules_for_config(mesh, tc, batch_axes=("pod", "data"), kv_seq_sharded=True,
                               sequence_parallel=True).mapping
    want = jshd.rules_for_config(mesh, jc, batch_axes=("pod", "data"), kv_seq_sharded=True,
                                 sequence_parallel=True).mapping
    assert got == want
    if T > 1:
        assert got["seq_res"] == got["kv_seq"] == "model"


def test_num_nodes_raises_where_jax_raises():
    pod, flat = _pod_mesh(2), types.SimpleNamespace(axis_names=("data", "model"),
                                                    shape={"data": 2, "model": 2})
    for fn in (lambda m, mp: shd.num_nodes(m, 4, multi_pod=mp),
               lambda m, mp: jshd.num_nodes(m, multi_pod=mp)):
        with pytest.raises(ValueError, match="have no 'pod' axis"):
            fn(flat, True)
        with pytest.raises(ValueError, match="has a 'pod' axis"):
            fn(pod, False)
    assert shd.num_nodes(pod, 4, multi_pod=True) == jshd.num_nodes(pod, multi_pod=True) == 4
    with pytest.raises(ValueError, match=r"do not split evenly over 4 \(pod, data\) ranks"):
        shd.num_nodes(pod, 6, multi_pod=True)


def test_pod_rank_order_groups_and_node_axes():
    P, D, S, T = 2, 2, 2, 2
    for rank in range(P * D * S * T):
        m = mesh_lib.virtual_mesh(pod=P, data=D, shard=S, model=T, rank=rank)
        p, d, s, t = m.pod_rank, m.data_rank, m.shard_rank, m.model_rank
        assert rank == ((p * D + d) * S + s) * T + t
        assert m.node_rank == p * D + d and m.global_rank(m.node_rank) == rank
        at = lambda p_, d_, s_, t_: ((p_ * D + d_) * S + s_) * T + t_  # noqa: E731
        assert m.model_group.ranks == tuple(at(p, d, s, i) for i in range(T))
        assert m.shard_group.ranks == tuple(at(p, d, i, t) for i in range(S))
        assert m.data_group.ranks == tuple(at(p, i, s, t) for i in range(D))
        assert m.pod_group.ranks == tuple(at(i, d, s, t) for i in range(P))
        assert m.nodes_group.ranks == tuple(at(i, j, s, t) for i in range(P)
                                            for j in range(D))
        assert m.nodes_group.axes == ("pod", "data") and m.nodes_group.index == m.node_rank
    m = mesh_lib.virtual_mesh(pod=2, data=2, rank=3)
    assert (m.axis_names, m.shape, m.nodes) == (("pod", "data", "shard", "model"),
                                                {"pod": 2, "data": 2, "shard": 1, "model": 1}, 4)
    spec = dt.make_spec(m, 8, multi_pod=True)
    assert spec.node_axes == ("pod", "data") and (spec.node_lo, spec.node_hi) == (6, 8)
    assert spec.node_axis.peers == (0, 1, 2, 3) and spec.node_axis.group is m.nodes_group
    with pytest.raises(ValueError, match="has a 'pod' axis"):
        dt.make_spec(m, 8)
    flat = mesh_lib.virtual_mesh(data=2, rank=1)
    assert flat.nodes_group is flat.data_group and flat.pod_group is None
    assert dt.make_spec(flat, 4).node_axes == ("data",)
    with pytest.raises(ValueError, match="needs a world of ranks"):
        mesh_lib.make_mesh(multi_pod=True)
    with pytest.raises(ValueError, match=r"\(2, 2, 1, 1\) test mesh needs 4 ranks"):
        mesh_lib.make_test_mesh(data=2, pod=2)


# ---------------------------------------------------------------------------
# The (pod 2, data 2) world
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pod4(tmp_path_factory):
    return w.run_world("pod4", 4, timeout=150, data=str(tmp_path_factory.mktemp("pod")))


def test_pod_world_places_two_nodes_a_rank_over_the_node_axes(pod4):
    assert pod4["node_axes"] == ["pod", "data"] and pod4["nodes"] == [0, 2]
    assert (pod4["pod_rank"], pod4["data_rank"]) == (0, 0)


@pytest.mark.parametrize("mode", ["masked", "static", "overlap"])
def test_pod_gossip_is_bit_equal_to_one_process(pod4, mode):
    r = pod4[mode]
    assert r["params"] == 0.0 and r["loss"] == 0.0, r
    assert r["axes"] == [["pod", "data"]], r


@pytest.mark.parametrize("mode", ["masked", "static", "overlap"])
def test_pod_step_inventory_equals_its_meta_view(pod4, mode):
    inv = pod4[mode]["inventory"]
    assert inv["equal"] and inv["count"] > 0 and inv["kinds"] == ["ppermute"], inv


@pytest.mark.parametrize("layout", ["monolithic", "streamed", "scan_streamed"])
def test_fsdp_step_inventory_equals_its_meta_view(pod4, layout):
    inv = pod4[f"fsdp_{layout}"]
    assert inv["equal"], inv
    assert inv["kinds"] == ["all_gather", "ppermute", "psum", "psum_scatter"], inv
