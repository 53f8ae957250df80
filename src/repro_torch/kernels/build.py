"""Build the CUDA C++ sources in ``csrc/`` at first use; load with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``build/repro_torch/<name>-<hash>.so`` at the root of the checkout, a
shared library with a plain C interface. The hash covers the source,
the headers beside it and the compiler flags, so an edited source
builds anew and an unchanged one is reused. ``build()`` starts one
``nvcc`` per missing library, all at once, and waits for all of them;
a failed build raises with the compiler's output.

Nothing here runs at import time: the CPU tests import every module,
and only a caller that launches a kernel on the card needs ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# sm_90a, not sm_90: wgmma and setmaxnreg exist only for the "a" target.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the "
            "port's kernels are built from source at first use"
        )
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def sources() -> list:
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Compile the listed sources (default: all) whose library is
    missing, in parallel. Returns ``{name: compiler output}`` (with
    ptxas's register and shared-memory report) for each one compiled."""
    names = list(names) if names is not None else sources()
    pending = [n for n in names if not library_path(n).exists()]
    if not pending:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in pending:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            out,
        )
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)       # atomic: a reader never sees half a file
        else:
            failed.append(name)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


class LaunchConfig(ctypes.Structure):
    """``csrc/launch_config.cuh``'s ``LaunchConfig``, which each library's
    ``<name>_launch_config`` entry fills."""

    _fields_ = [
        ("grid", ctypes.c_longlong * 3),
        ("cover", ctypes.c_longlong * 3),
        ("threads", ctypes.c_int),
        ("smem_bytes", ctypes.c_int),
        ("path", ctypes.c_int),
        ("acc_bytes", ctypes.c_int),
    ]

    def as_dict(self) -> dict:
        return dict(grid=tuple(self.grid), cover=tuple(self.cover),
                    threads=self.threads, smem_bytes=self.smem_bytes,
                    path=self.path, acc_bytes=self.acc_bytes)


def launch_config(fn, *args) -> dict:
    """Call a library's ``<name>_launch_config(*args, LaunchConfig*)`` and
    return the filled config as a dict; raises on a refused shape."""
    cfg = LaunchConfig()
    err = fn(*args, ctypes.byref(cfg))
    if err:
        raise ValueError(f"{fn.__name__} refused {args}: cudaError {err}")
    return cfg.as_dict()


BOX_FIELDS = 9          # a csrc TileBox: writer[3], lo[3], hi[3], as int64


def tile_boxes(probe, device, capacity: int = 4096):
    """Run a library's ``<name>_tile_probe``: ``probe(boxes, capacity,
    count, stream)`` launches the probe on ``device`` and returns a
    cudaError_t. Returns the boxes it wrote as an ``(n, 9)`` int64 numpy
    array (``writer[3], lo[3], hi[3]`` a row), asking again with room for
    all of them when the first buffer was too small."""
    import torch

    while True:
        boxes = torch.empty((capacity, BOX_FIELDS), dtype=torch.int64, device=device)
        count = torch.zeros(1, dtype=torch.int32, device=device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = probe(boxes.data_ptr(), capacity, count.data_ptr(), stream)
        if err:
            raise RuntimeError(f"tile probe failed: cudaError {err}")
        n = int(count.item())
        if n <= capacity:
            return boxes[:n].cpu().numpy()
        capacity = n


def check_out(kernel: str, out, shape, dtype, device) -> None:
    """Raise unless ``out`` can take a kernel's output of ``shape`` and
    ``dtype`` on ``device``: contiguous, the same shape, dtype and device
    (an ``out=`` buffer, which the kernel lint's guarded launches pass)."""
    if tuple(out.shape) != tuple(shape) or out.dtype != dtype or out.device != device:
        raise ValueError(
            f"{kernel}: out is {tuple(out.shape)} {out.dtype} on {out.device}, the kernel "
            f"writes {tuple(shape)} {dtype} on {device}"
        )
    if not out.is_contiguous():
        raise ValueError(f"{kernel}: out must be contiguous")


def require_hopper(device, kernel: str) -> None:
    """Raise unless ``device`` is an sm_90 card: the kernels are built
    for sm_90a only."""
    import torch

    major, minor = torch.cuda.get_device_capability(device)
    if (major, minor) != (9, 0):
        raise RuntimeError(
            f"{kernel} is built for sm_90a (Hopper); {device} is sm_{major}{minor}"
        )


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if missing."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib
