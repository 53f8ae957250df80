#!/usr/bin/env python3
"""Where a full-width checkpoint's time goes, on a machine with a card.

    python3 tools/ckpt_io.py

Makes the state that ``chip_smoke.py`` checkpoints: the first two of 8
internlm2-1.8b replicas at full width with the depth cut to 2 layers,
params and fp32 velocities (8.08 GB), on the card. Then it times, with
the host clock, one stage after another of what
``repro_torch.checkpoint.ckpt`` does, and the whole ``save_run_step`` and
``restore_run`` beside them:

  save     device-to-host copy of every leaf; ``np.savez`` into a file;
           fsync; the CRC32 pass over the file;
  restore  the CRC32 pass; ``np.load`` of every member; host-to-device
           copy;

and, as floors, the same bytes written with ``ndarray.tofile`` and
fsynced, read back with ``np.fromfile``, and ``zlib.crc32`` over 1 GB in
memory. Reads follow the writes, so they may come from the page cache.
Files go to a temp directory under ``build/`` and are deleted. Prints the
card's name and power limit first. Needs a CUDA card; exits non-zero
without one.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
NODES = 2


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("tools/ckpt_io.py needs a CUDA card")
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import Model
    from repro_torch.tree import flatten

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip()}", flush=True)
    cfg = dataclasses.replace(get_config("internlm2_1_8b"), num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = flatten(Model(cfg).param_shapes())
    make = lambda: {p: torch.randn((NODES,) + tuple(s), generator=gen, device="cuda")
                    for p, (s, _) in shapes.items()}
    params = make()
    state = {"step": torch.zeros(NODES, dtype=torch.int32, device="cuda"), "velocity": make()}
    tree = {"params": params, "state": state}
    nbytes = sum(t.numel() * t.element_size() for t in flatten(tree).values())
    gb = nbytes / 1e9

    def clock(label, fn, size=gb):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"ckpt_io: {label}: {dt:.2f} s ({size / dt:.2f} GB/s over {size:.2f} GB)",
              flush=True)
        return out

    parent = os.path.join(ROOT, "build")
    os.makedirs(parent, exist_ok=True)
    print(f"ckpt_io: {len(flatten(tree))} leaves, {gb:.2f} GB; "
          f"{shutil.disk_usage(parent).free / 1e9:.0f} GB free under build/", flush=True)
    root = tempfile.mkdtemp(prefix="ckpt-io-", dir=parent)
    try:
        buf = np.random.default_rng(0).integers(0, 255, 1 << 30, dtype=np.uint8)
        clock("zlib.crc32 of 1 GB in memory", lambda: zlib.crc32(buf), (1 << 30) / 1e9)
        del buf

        # the stages of save(), on the stacked params then the state
        flat = clock("device-to-host copy (_flatten)",
                     lambda: {k: ckpt._flatten(v) for k, v in tree.items()})
        paths = {k: os.path.join(root, f"{k}.npz") for k in flat}
        files = {}

        def savez():
            for k, f in flat.items():
                files[k] = open(paths[k], "wb")
                np.savez(files[k], **f)

        clock("np.savez into files", savez)

        def fsync():
            for f in files.values():
                f.flush()
                os.fsync(f.fileno())
                f.close()

        clock("fsync", fsync)
        clock("CRC32 pass over the files", lambda: [ckpt._file_crc32(p) for p in paths.values()])

        def load():
            out = {}
            for k, p in paths.items():
                with np.load(p) as z:
                    out[k] = {m: z[m] for m in z.files}
            return out

        loaded = clock("np.load of every member", load)
        clock("host-to-device copy", lambda: [torch.from_numpy(a).to("cuda")
                                              for f in loaded.values() for a in f.values()])
        del loaded

        raw = os.path.join(root, "raw.bin")

        def tofile():
            with open(raw, "wb") as f:
                for part in flat.values():
                    for a in part.values():
                        a.tofile(f)
                f.flush()
                os.fsync(f.fileno())

        clock("floor: ndarray.tofile of the same bytes + fsync", tofile)
        clock("floor: np.fromfile of them", lambda: np.fromfile(raw, dtype=np.uint8))
        del flat
        for p in list(paths.values()) + [raw]:
            os.remove(p)

        d = clock("save_run_step, whole",
                  lambda: ckpt.save_run_step(os.path.join(root, "hist"), params, state, step=1))
        back = clock("restore_run to the card, whole",
                     lambda: ckpt.restore_run(d, device="cuda"))
        got = flatten({"params": back[0], "state": back[1]})
        same = all(torch.equal(got[p], t) for p, t in flatten(tree).items())
        print(f"ckpt_io: restored state bit-equal: {same}", flush=True)
        if not same:
            sys.exit("tools/ckpt_io.py: the restored state differs")
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
