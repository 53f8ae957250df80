"""The port's checkpoints against the JAX package's, on disk.

* A stacked SGD state (the smoke internlm2's params from the JAX
  ``Model.init``, some leaves cast to bf16, distinct per node; fp32
  velocities and an int32 step per node) written by one package's
  ``save_run_step`` and restored by the other's ``restore_run``, in
  both layouts (one stacked ``params.npz``, one file per node): every
  leaf bit-equal, every dtype kept. No tolerance: checkpoints are exact.
  The same for the nested trees of periodic segments (gemma3, jamba)
  and for whisper's encoder and cross-attention leaves.
* The port's MessagePack codec against the ``msgpack`` package (the
  reference it is held to; the port itself never imports it): byte-equal
  output on the sidecars both packages write and on encoding edge cases,
  and the same objects decoded.
* The port's versions of ``tests/test_checkpoint_dist.py``: 128 nodes
  restored in numeric order, a node-file count that disagrees with
  ``ckpt.json``, truncated and CRC-corrupt files raising
  ``CheckpointCorruptError``, no temp file left behind, history
  pruning, and ``find_resumable`` skipping torn entries.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models.transformer import Model as JaxModel
from repro_torch.checkpoint import ckpt, mpack
from repro_torch.tree import flatten

NODES = 4


def _bits(a) -> np.ndarray:
    """A leaf's raw bits as numpy (bf16 as uint16), for exact compares."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _dtype(a) -> str:
    if isinstance(a, torch.Tensor):
        return str(a.dtype).removeprefix("torch.")
    return str(np.asarray(a).dtype)


def _jax_state(arch="internlm2_1_8b", **over):
    """(stacked params, SGD state) as JAX arrays: the smoke model's
    init, every other leaf in bf16, node i offset by i."""
    cfg = dataclasses.replace(jax_smoke_config(arch), compute_dtype="float32", **over)
    init = JaxModel(cfg).init(jax.random.key(0))
    leaves, treedef = jax.tree.flatten(init)
    leaves = [a.astype(jnp.bfloat16) if i % 2 else a for i, a in enumerate(leaves)]
    init = jax.tree.unflatten(treedef, leaves)
    params = jax.tree.map(
        lambda a: jnp.stack([a + jnp.asarray(i, a.dtype) for i in range(NODES)]), init
    )
    rng = np.random.default_rng(0)
    velocity = jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)), params
    )
    opt_state = {"step": jnp.full((NODES,), 7, jnp.int32), "velocity": velocity}
    return params, opt_state


def _to_port(tree):
    """JAX arrays -> tensors with the same bits (bf16 through uint16)."""
    def leaf(a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree.map(leaf, tree)


def _assert_same(got, want):
    g, w = flatten(got), flatten(want)
    assert g.keys() == w.keys()
    for path in w:
        assert _dtype(g[path]) == _dtype(w[path]), path
        assert tuple(g[path].shape) == tuple(w[path].shape), path
        np.testing.assert_array_equal(_bits(g[path]), _bits(w[path]), err_msg=path)


def _nested(tree):
    """A JAX pytree of dicts as plain nested dicts (flatten's input)."""
    if isinstance(tree, dict):
        return {k: _nested(v) for k, v in tree.items()}
    return tree


@pytest.mark.parametrize("per_node_files", [False, True], ids=["stacked", "per_node"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_restores_what_the_other_wrote(tmp_path, writer, per_node_files):
    jparams, jopt = _jax_state()
    tparams, topt = _to_port(jparams), _to_port(jopt)
    root = str(tmp_path / "hist")
    extra = {"shard": 1, "stream_layers": False, "stream_scan": True}
    if writer == "jax":
        jckpt.save_run_step(root, jparams, jopt, step=11, per_node_files=per_node_files,
                            extra=extra)
        params, opt_state, step = ckpt.restore_run(root, device="cpu")
    else:
        ckpt.save_run_step(root, tparams, topt, step=11, per_node_files=per_node_files,
                           extra=extra)
        params, opt_state, step = jckpt.restore_run(root)
        params, opt_state = _nested(params), _nested(opt_state)
    assert step == 11
    _assert_same(params, _nested(jparams))
    _assert_same(opt_state, _nested(jopt))
    assert _dtype(opt_state["step"]) == "int32"
    files = sorted(os.listdir(ckpt.step_dir(root, 11)))
    assert ("node_03.npz" in files) == per_node_files and "ckpt.json" in files


@pytest.mark.parametrize("arch,over", [
    ("gemma3_4b", dict(num_layers=4)),          # a periodic tree: blocks_0.pos_{j}
    ("jamba_v0_1_52b", dict(num_layers=5)),     # periodic + a tail segment
    ("whisper_base", {}),                       # encoder, cross-attention, frontend
], ids=["gemma3-periodic", "jamba-periodic-tail", "whisper"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_new_family_trees_cross_between_packages(tmp_path, writer, arch, over):
    jparams, jopt = _jax_state(arch, **over)
    if arch != "whisper_base":
        assert "pos_1" in jparams["blocks_0"]
    root = str(tmp_path / "hist")
    if writer == "jax":
        jckpt.save_run_step(root, jparams, jopt, step=3)
        params, opt_state, step = ckpt.restore_run(root, device="cpu")
    else:
        ckpt.save_run_step(root, _to_port(jparams), _to_port(jopt), step=3)
        params, opt_state, step = jckpt.restore_run(root)
        params, opt_state = _nested(params), _nested(opt_state)
    assert step == 3
    _assert_same(params, _nested(jparams))
    _assert_same(opt_state, _nested(jopt))


def _sidecars(root):
    for dirpath, _, names in os.walk(root):
        for name in sorted(names):
            if name.endswith(".meta.msgpack"):
                yield os.path.join(dirpath, name)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_codec_is_byte_equal_to_msgpack_on_real_sidecars(tmp_path, writer):
    jparams, jopt = _jax_state()
    root = str(tmp_path / writer)
    if writer == "jax":
        jckpt.save_run(root, jparams, jopt, step=3, per_node_files=True)
    else:
        ckpt.save_run(root, _to_port(jparams), _to_port(jopt), step=3, per_node_files=True)
    paths = list(_sidecars(root))
    assert len(paths) == NODES + 1
    for path in paths:
        raw = open(path, "rb").read()
        obj = msgpack.unpackb(raw, raw=False, strict_map_key=False)
        assert mpack.unpackb(raw) == obj
        assert mpack.packb(obj) == raw
        assert msgpack.packb(obj, use_bin_type=True) == raw


EDGE_CASES = [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    0.5, -1e300, float("inf"), "", "x" * 31, "x" * 32, "x" * 255, "x" * 256,
    "x" * 65536, "é✓" * 11, b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65536,
    list(range(15)), list(range(16)), list(range(65536)), (1, "a", None),
    {f"k{i}": i for i in range(15)}, {f"k{i}": i for i in range(16)},
    {1: [2.5, {"nested": [True, b"bits"]}], "x": {}},
]


@pytest.mark.parametrize("obj", EDGE_CASES, ids=lambda o: type(o).__name__)
def test_codec_is_byte_equal_to_msgpack_on_edge_cases(obj):
    raw = msgpack.packb(obj, use_bin_type=True)
    assert mpack.packb(obj) == raw
    assert mpack.unpackb(raw) == msgpack.unpackb(raw, raw=False, strict_map_key=False)


def test_codec_reads_other_encodings_and_refuses_what_it_cannot_hold():
    assert mpack.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5
    assert mpack.unpackb(b"\xcd\x00\x05") == 5           # a wider int than needed
    with pytest.raises(ValueError, match="extra data"):
        mpack.unpackb(b"\x01\x02")
    with pytest.raises(ValueError, match="ends early"):
        mpack.unpackb(b"\xcd\x00")
    with pytest.raises(TypeError, match="cannot serialize"):
        mpack.packb({"x": object()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float8_e4m3fn", "float8_e5m2",
                                   "int32", "int64", "bool"])
def test_port_roundtrip_keeps_dtype_and_bits(tmp_path, dtype):
    rng = np.random.default_rng(1)
    t = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32) * 4)
    tree = {"a": {"w": t.to(getattr(torch, dtype))}, "s": torch.tensor(3, dtype=torch.int32)}
    path = str(tmp_path / "one")
    ckpt.save(path, tree, metadata={"step": 2})
    back, meta = ckpt.restore(path, device="cpu")
    assert meta == {"step": 2}
    w = tree["a"]["w"]
    got = back["a"]["w"]
    assert got.dtype == w.dtype and back["s"].dtype == torch.int32
    bits = torch.int16 if w.element_size() == 2 else None
    if w.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        bits = torch.uint8
    same = (torch.equal(got.view(bits), w.view(bits)) if bits is not None
            else torch.equal(got, w))
    assert same
    # the JAX package reads it with the same dtype (without x64, JAX
    # narrows int64 to int32 whoever wrote the file)
    jtree, jmeta = jckpt.restore(path)
    want = "int32" if dtype == "int64" and not jax.config.jax_enable_x64 else dtype
    assert str(jtree["a"]["w"].dtype) == want and jmeta == {"step": 2}


def test_restore_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device is usable here")
    ckpt.save_run(str(tmp_path / "r"), {"w": torch.zeros(2, 3)},
                  {"step": torch.zeros(2, dtype=torch.int32)}, step=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.restore_run(str(tmp_path / "r"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ckpt.restore(str(tmp_path / "r" / "params"))


# ---------------------------------------------------------------------------
# The cases of tests/test_checkpoint_dist.py, on the port
# ---------------------------------------------------------------------------
def _tiny_run(n=4):
    params = {"w": torch.arange(n, dtype=torch.float32)[:, None] * torch.ones(1, 3)}
    opt_state = {"step": torch.full((n,), 7, dtype=torch.int32)}
    return params, opt_state


def test_per_node_restore_order_at_128_nodes(tmp_path):
    n = 128
    params = {"w": torch.arange(n, dtype=torch.float32)[:, None] * torch.ones(1, 3),
              "b": 1000.0 + torch.arange(n, dtype=torch.float32)}
    opt_state = {"step": torch.full((n,), 7, dtype=torch.int32)}
    directory = str(tmp_path / "run")
    ckpt.save_run(directory, params, opt_state, step=5, per_node_files=True)
    params2, opt2, step = ckpt.restore_run(directory, device="cpu")
    assert step == 5
    _assert_same(params2, params)
    _assert_same(opt2, opt_state)


def test_per_node_restore_validates_file_count(tmp_path):
    n = 12
    params = {"w": torch.arange(n, dtype=torch.float32)}
    opt_state = {"step": torch.zeros(n, dtype=torch.int32)}
    directory = str(tmp_path / "run")
    ckpt.save_run(directory, params, opt_state, step=1, per_node_files=True)
    removed = os.path.join(directory, "node_05.npz")
    os.rename(removed, removed + ".bak")
    with pytest.raises(ValueError, match="num_nodes"):
        ckpt.restore_run(directory, device="cpu")
    os.rename(removed + ".bak", removed)
    ckpt.restore_run(directory, device="cpu")
    os.rename(os.path.join(directory, "node_03.npz"), os.path.join(directory, "node_99.npz"))
    with pytest.raises(ValueError, match="contiguous"):
        ckpt.restore_run(directory, device="cpu")


def test_truncated_and_corrupt_files_raise_named_error(tmp_path):
    params, opt_state = _tiny_run()
    directory = str(tmp_path / "run")
    ckpt.save_run(directory, params, opt_state, step=3, per_node_files=True)
    victim = os.path.join(directory, "node_02.npz")
    payload = open(victim, "rb").read()
    with open(victim, "wb") as f:
        f.write(payload[: len(payload) // 2])
    with pytest.raises(ckpt.CheckpointCorruptError) as exc:
        ckpt.restore_run(directory, device="cpu")
    assert "node_02.npz" in str(exc.value) and "earlier complete one" in str(exc.value)
    with open(victim, "wb") as f:
        f.write(payload[:100] + bytes([payload[100] ^ 0xFF]) + payload[101:])
    with pytest.raises(ckpt.CheckpointCorruptError, match="CRC32"):
        ckpt.restore_run(directory, device="cpu")
    with open(victim, "wb") as f:
        f.write(payload)
    ckpt.restore_run(directory, device="cpu")
    # a torn file of a sidecar without checksums still raises by name
    side = os.path.join(directory, "node_01.meta.msgpack")
    meta = mpack.unpackb(open(side, "rb").read())
    del meta["npz_crc32"], meta["npz_size"]
    with open(side, "wb") as f:
        f.write(mpack.packb(meta))
    with open(os.path.join(directory, "node_01.npz"), "wb") as f:
        f.write(b"half a checkpoint")
    with pytest.raises(ckpt.CheckpointCorruptError, match="cannot be parsed"):
        ckpt.restore_run(directory, device="cpu")


def test_save_is_atomic_no_tmp_left_behind(tmp_path):
    params, opt_state = _tiny_run()
    directory = str(tmp_path / "run")
    ckpt.save_run(directory, params, opt_state, step=1)
    ckpt.save_run(directory, params, opt_state, step=2)
    assert [f for f in os.listdir(directory) if ".tmp." in f] == []
    assert ckpt.restore_run(directory, device="cpu")[2] == 2


def test_history_layout_resume_and_pruning(tmp_path):
    params, opt_state = _tiny_run()
    root = str(tmp_path / "hist")
    for s in (2, 4, 6):
        d = ckpt.save_run_step(root, params, opt_state, step=s, keep_last=3)
        assert d == ckpt.step_dir(root, s) and os.path.isdir(d)
    assert ckpt.find_resumable(root) == ckpt.step_dir(root, 6)
    assert ckpt.restore_run(root, device="cpu")[2] == 6
    torn = ckpt.step_dir(root, 8)                 # crash mid-save: no ckpt.json
    os.makedirs(torn)
    with open(os.path.join(torn, "params.npz"), "wb") as f:
        f.write(b"half a checkpoint")
    assert ckpt.find_resumable(root) == ckpt.step_dir(root, 6)
    with open(os.path.join(ckpt.step_dir(root, 6), "params.npz"), "wb") as f:
        f.write(b"also torn")
    assert ckpt.find_resumable(root) == ckpt.step_dir(root, 4)
    assert ckpt.restore_run(root, device="cpu")[2] == 4
    ckpt.save_run_step(root, params, opt_state, step=10, keep_last=2)
    kept = sorted(f for f in os.listdir(root) if f.startswith("step_"))
    assert kept == ["step_00000008", "step_00000010"]
    assert ckpt.find_resumable(root) == ckpt.step_dir(root, 10)


def test_find_resumable_empty_and_missing(tmp_path):
    assert ckpt.find_resumable(str(tmp_path / "nope")) is None
    os.makedirs(tmp_path / "empty")
    assert ckpt.find_resumable(str(tmp_path / "empty")) is None
