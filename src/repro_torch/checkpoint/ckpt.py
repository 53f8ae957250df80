"""Checkpointing: tree save/restore, per decentralized node.

The port of ``repro.checkpoint.ckpt``, in the same on-disk format, so
that each package restores what the other wrote. One ``.npz`` per
checkpoint holds the flattened leaves under path keys (dict keys
sorted, list and tuple items ``#i``, joined by ``/``); bfloat16 is
stored as its uint16 bits and float8 as uint8 bits, since npz cannot
hold them. A MessagePack sidecar (``.meta.msgpack``, written by the
port's own codec, ``repro_torch.checkpoint.mpack``) records the tree's
structure with numpy dtype names, the metadata, and the payload's CRC32
and byte size. In a decentralized run each node owns its replica, so
``save_run`` / ``restore_run`` handle the node-stacked layout the
trainer uses: one stacked ``params.npz``, or one ``node_XX.npz`` per
node.

Crash safety, as in the JAX package: every file is written to a temp
file, fsynced and renamed into place, never in place; ``restore``
checks the sidecar's size and CRC32 and raises
:class:`CheckpointCorruptError` on a torn, truncated or corrupt file.
``save_run_step`` keeps a history (one ``step_XXXXXXXX/`` directory per
checkpoint, ``ckpt.json`` written last as the completeness marker) and
``find_resumable`` walks it newest first, skipping incomplete or corrupt
entries: the resolver behind ``launch.train --resume auto``.

Unlike the JAX package, ``save`` writes the npz straight into its temp
file and takes the CRC32 over that file in chunks, and ``restore``
checks the file in chunks before it loads it, so that a stacked
full-width leaf (gigabytes) is never held twice in host memory. The
bytes on disk keep the same format. Leaves come back as tensors on the
requested device, with their dtypes and values bit-equal.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint import mpack
from repro_torch.device import resolve_device

PyTree = Any
_SEP = "/"
_CHUNK = 64 << 20                 # bytes read at a time for the CRC32


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file is torn, truncated, or fails its checksum.

    The message names the offending file and the remedy (delete or
    ignore this checkpoint and resume from an earlier complete one;
    ``find_resumable`` does exactly that)."""


# dtypes npz cannot store natively, saved as bit views: numpy dtype name
# -> (stored numpy dtype, numpy and torch dtypes of the same width that
# both packages read, through which the bits pass)
_VIEW_DTYPES = {
    "bfloat16": (np.uint16, np.int16, torch.int16),
    "float8_e4m3fn": (np.uint8, np.uint8, torch.uint8),
    "float8_e5m2": (np.uint8, np.uint8, torch.uint8),
}


def _dtype_name(leaf) -> str:
    """The numpy name of a leaf's dtype, as the JAX package records it."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _to_numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    name = _dtype_name(t)
    if name in _VIEW_DTYPES:
        stored, _, bits = _VIEW_DTYPES[name]
        return t.view(bits).numpy().view(stored)
    return t.numpy()


def _to_tensor(arr: np.ndarray, dtype_name: Optional[str], device) -> torch.Tensor:
    if dtype_name in _VIEW_DTYPES:
        _, np_bits, _ = _VIEW_DTYPES[dtype_name]
        t = torch.from_numpy(arr.view(np_bits)).view(getattr(torch, dtype_name))
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _flatten(tree: PyTree, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}{_SEP}"))
    else:
        out[prefix.rstrip(_SEP)] = _to_numpy(tree)
    return out


def _structure(tree: PyTree) -> Any:
    if isinstance(tree, dict):
        return {"__kind__": "dict", "keys": {k: _structure(v) for k, v in tree.items()}}
    if isinstance(tree, tuple):
        return {"__kind__": "tuple", "items": [_structure(v) for v in tree]}
    if isinstance(tree, list):
        return {"__kind__": "list", "items": [_structure(v) for v in tree]}
    return {"__kind__": "leaf", "dtype": _dtype_name(tree)}


def _rebuild(struct: Any, flat: Dict[str, np.ndarray], device, prefix: str = "") -> PyTree:
    kind = struct["__kind__"]
    if kind == "dict":
        return {
            k: _rebuild(v, flat, device, f"{prefix}{k}{_SEP}")
            for k, v in struct["keys"].items()
        }
    if kind in ("tuple", "list"):
        items = [
            _rebuild(v, flat, device, f"{prefix}#{i}{_SEP}")
            for i, v in enumerate(struct["items"])
        ]
        return tuple(items) if kind == "tuple" else items
    return _to_tensor(flat[prefix.rstrip(_SEP)], struct.get("dtype"), device)


def _tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` leafwise over trees of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return tuple(items) if isinstance(tree, tuple) else items
    return fn(tree, *rest)


def _first_leaf(tree: PyTree):
    if isinstance(tree, dict):
        return _first_leaf(next(iter(tree.values())))
    if isinstance(tree, (list, tuple)):
        return _first_leaf(tree[0])
    return tree


def _file_crc32(path: str) -> Tuple[int, int]:
    """(CRC32, size in bytes) of a file, read in chunks."""
    crc, size = 0, 0
    with open(path, "rb") as f:
        while True:
            block = f.read(_CHUNK)
            if not block:
                break
            crc = zlib.crc32(block, crc)
            size += len(block)
    return crc & 0xFFFFFFFF, size


def _atomic_write(path: str, data: Union[bytes, Callable]) -> Optional[Tuple[int, int]]:
    """tmp file in the destination directory + fsync + atomic rename:
    after ``os.replace`` the file is either the complete new payload or
    (on a crash before the rename) absent or old, never torn. ``data`` is
    the bytes, or a function that writes them into the open file; then
    the written file's (CRC32, size) is returned."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            if callable(data):
                data(f)
            else:
                f.write(data)
            f.flush()
            os.fsync(f.fileno())
        check = _file_crc32(tmp) if callable(data) else None
        os.replace(tmp, path)
        return check
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _sidecar(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".meta.msgpack"


def save(path: str, tree: PyTree, *, metadata: Optional[dict] = None) -> None:
    """Atomic checkpoint write: the ``.npz`` payload goes to a temp file,
    is checksummed and renamed into place; the sidecar (structure,
    metadata, payload CRC32 + size) follows, also atomically. A crash at
    any point leaves no torn file, at worst a stale payload/sidecar pair,
    which the checksum check in :func:`restore` rejects."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    crc, size = _atomic_write(
        path if path.endswith(".npz") else path + ".npz",
        lambda f: np.savez(f, **flat),
    )
    side = {
        "structure": _structure(tree),
        "metadata": metadata or {},
        "npz_crc32": crc,
        "npz_size": size,
    }
    _atomic_write(_sidecar(path), mpack.packb(side))


def restore(path: str, *, device="cuda") -> Tuple[PyTree, dict]:
    """Load one checkpoint as tensors on ``device``, verifying the
    sidecar checksum when present (checkpoints written before the
    checksum existed still load). Torn, truncated, or mismatched files
    raise :class:`CheckpointCorruptError` naming the file."""
    device = resolve_device(device)
    npz_path = path if path.endswith(".npz") else path + ".npz"
    with open(_sidecar(path), "rb") as f:
        side = mpack.unpackb(f.read())
    crc, size = _file_crc32(npz_path)
    want_size = side.get("npz_size")
    want_crc = side.get("npz_crc32")
    if want_size is not None and size != int(want_size):
        raise CheckpointCorruptError(
            f"checkpoint file {npz_path!r} is {size} bytes but its "
            f"sidecar records {want_size} — the file is truncated or torn; "
            "delete this checkpoint and resume from an earlier complete one"
        )
    if want_crc is not None and crc != int(want_crc):
        raise CheckpointCorruptError(
            f"checkpoint file {npz_path!r} fails its CRC32 content check — "
            "the file is corrupt; delete this checkpoint and resume from "
            "an earlier complete one"
        )
    try:
        with np.load(npz_path) as npz:
            flat = {k: npz[k] for k in npz.files}
        return _rebuild(side["structure"], flat, device), side["metadata"]
    except Exception as exc:   # torn pre-checksum files: BadZipFile etc.
        raise CheckpointCorruptError(
            f"checkpoint file {npz_path!r} cannot be parsed ({exc}) — the "
            "file is torn or corrupt; delete this checkpoint and resume "
            "from an earlier complete one"
        ) from exc


# ---------------------------------------------------------------------------
# Decentralized run checkpoints (node-stacked params)
# ---------------------------------------------------------------------------
_NODE_FILE = re.compile(r"node_(\d+)\.npz")


def save_run(
    directory: str,
    stacked_params: PyTree,          # leaves with a leading node dim
    opt_state: PyTree,
    *,
    step: int,
    per_node_files: bool = False,
    extra: Optional[dict] = None,
) -> None:
    """Checkpoint a node-stacked run: ``params`` (stacked, or one file per
    node), ``opt_state``, then ``ckpt.json`` with the step, the layout,
    the node count and ``extra``."""
    os.makedirs(directory, exist_ok=True)
    meta = {"step": int(step)}
    num_nodes = int(_first_leaf(stacked_params).shape[0])
    if per_node_files:
        for n in range(num_nodes):
            node_tree = _tree_map(lambda a: a[n], stacked_params)
            save(os.path.join(directory, f"node_{n:02d}"), node_tree, metadata=meta)
    else:
        save(os.path.join(directory, "params"), stacked_params, metadata=meta)
    save(os.path.join(directory, "opt_state"), opt_state, metadata=meta)
    info = {
        "step": int(step),
        "per_node_files": per_node_files,
        "num_nodes": num_nodes,
    }
    info.update(extra or {})
    # ckpt.json is the completeness marker: written last, atomically; a
    # directory without a (complete) ckpt.json is an aborted save
    _atomic_write(os.path.join(directory, "ckpt.json"), json.dumps(info).encode("utf-8"))


def _node_files(directory: str, info: dict) -> list:
    """Per-node checkpoint files in *numeric* node order.

    Lexicographic ordering breaks at >= 100 nodes (``node_100.npz``
    sorts before ``node_99.npz``), so the index is parsed from the file
    name, the index set must be exactly 0..n-1, and the count must agree
    with the node count recorded in ckpt.json."""
    entries = []
    for f in os.listdir(directory):
        m = _NODE_FILE.fullmatch(f)
        if m:
            entries.append((int(m.group(1)), f))
    entries.sort()
    indices = [i for i, _ in entries]
    want = info.get("num_nodes")
    if want is not None and len(entries) != int(want):
        raise ValueError(
            f"checkpoint {directory!r} has {len(entries)} per-node files "
            f"but ckpt.json records num_nodes={want}"
        )
    if indices != list(range(len(entries))):
        raise ValueError(
            f"per-node checkpoint files are not a contiguous 0..n-1 set "
            f"in {directory!r}: indices {indices[:8]}..."
        )
    return [f for _, f in entries]


def restore_run(directory: str, *, device="cuda") -> Tuple[PyTree, PyTree, int]:
    """``(stacked_params, opt_state, step)`` of a ``save_run`` directory,
    as tensors on ``device``. A ``save_run_step`` history root resolves to
    its newest complete entry."""
    device = resolve_device(device)
    marker = os.path.join(directory, "ckpt.json")
    if not os.path.exists(marker):
        resolved = find_resumable(directory)
        if resolved is not None and resolved != directory:
            return restore_run(resolved, device=device)
    with open(marker) as f:
        info = json.load(f)
    if info["per_node_files"]:
        nodes = _node_files(directory, info)
        # stacked on the host, then moved: the device holds one copy
        trees = [restore(os.path.join(directory, f), device="cpu")[0] for f in nodes]
        params = _tree_map(lambda *xs: torch.stack(xs).to(device), *trees)
    else:
        params, _ = restore(os.path.join(directory, "params"), device=device)
        if info.get("num_nodes") is not None:
            got = int(_first_leaf(params).shape[0])
            if got != int(info["num_nodes"]):
                raise ValueError(
                    f"checkpoint {directory!r} stacks {got} nodes but "
                    f"ckpt.json records num_nodes={info['num_nodes']}"
                )
    opt_state, _ = restore(os.path.join(directory, "opt_state"), device=device)
    return params, opt_state, info["step"]


# ---------------------------------------------------------------------------
# Crash-safe history layout (one step_XXXXXXXX/ subdir per checkpoint)
# ---------------------------------------------------------------------------
_STEP_DIR = re.compile(r"step_(\d{8})")


def step_dir(root: str, step: int) -> str:
    """Path of the history entry for ``step`` under ``root``."""
    return os.path.join(root, f"step_{int(step):08d}")


def save_run_step(
    root: str,
    stacked_params: PyTree,
    opt_state: PyTree,
    *,
    step: int,
    per_node_files: bool = False,
    extra: Optional[dict] = None,
    keep_last: int = 3,
) -> str:
    """Crash-safe periodic checkpoint: ``save_run`` into a fresh
    ``step_XXXXXXXX/`` subdirectory (never overwriting the previous
    checkpoint in place), then prune history beyond ``keep_last``
    complete entries. A crash at any point during the save leaves every
    earlier step directory untouched and restorable: the half-written
    directory lacks its ckpt.json marker (or fails its checksums) and
    :func:`find_resumable` skips it. Returns the step directory path."""
    d = step_dir(root, step)
    save_run(d, stacked_params, opt_state, step=step,
             per_node_files=per_node_files, extra=extra)
    if keep_last > 0:
        steps = sorted(_history_steps(root))
        for s in steps[:-keep_last]:
            shutil.rmtree(step_dir(root, s), ignore_errors=True)
    return d


def _history_steps(root: str) -> list:
    out = []
    try:
        entries = os.listdir(root)
    except FileNotFoundError:
        return out
    for name in entries:
        m = _STEP_DIR.fullmatch(name)
        if m and os.path.isdir(os.path.join(root, name)):
            out.append(int(m.group(1)))
    return out


def verify_run(directory: str) -> dict:
    """Full integrity check of one checkpoint directory: ckpt.json
    present and parseable, every expected file loads (on the host) and
    passes its checksum. Raises (``CheckpointCorruptError`` /
    ``ValueError`` / ``OSError``) on the first problem; returns the
    ckpt.json info on success."""
    with open(os.path.join(directory, "ckpt.json")) as f:
        info = json.load(f)
    if info["per_node_files"]:
        for fname in _node_files(directory, info):
            restore(os.path.join(directory, fname), device="cpu")
    else:
        restore(os.path.join(directory, "params"), device="cpu")
    restore(os.path.join(directory, "opt_state"), device="cpu")
    return info


def find_resumable(root: str) -> Optional[str]:
    """Newest complete, checksum-valid checkpoint under ``root``.

    ``root`` may be a flat ``save_run`` directory (returned iff it
    verifies) or a ``save_run_step`` history root (entries walked
    newest first; torn or incomplete ones, e.g. from a crash
    mid-checkpoint, are skipped). Returns ``None`` when nothing under
    ``root`` is restorable."""
    if not os.path.isdir(root):
        return None
    if os.path.exists(os.path.join(root, "ckpt.json")):
        try:
            verify_run(root)
            return root
        except Exception:
            return None
    for s in sorted(_history_steps(root), reverse=True):
        d = step_dir(root, s)
        try:
            verify_run(d)
            return d
        except Exception:
            continue
    return None
