"""One replica's initial weights, made from the seed on the device.

The laws come from the family reference's ``param_specs``: ``normal:<std>``
(lecun or embedding scale), ``ones`` and ``zeros``. Every normal leaf is
carved out of one ``randn`` call from a generator on the device, so the
same seed gives the same weights and set-up makes one large draw.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def _numel(shape) -> int:
    return math.prod(shape)


def make(specs, seed: int, device) -> Dict[str, torch.Tensor]:
    """{path: float32 tensor} of one replica."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    normal = sum(_numel(s) for _, s, law in specs if law.startswith("normal"))
    nbuf = torch.randn(normal, generator=gen, device=device, dtype=torch.float32)
    out, n_off = {}, 0
    for path, shape, law in specs:
        kind, _, arg = law.partition(":")
        n = _numel(shape)
        if kind == "normal":
            t = nbuf[n_off:n_off + n].view(shape).mul_(float(arg))
            n_off += n
        elif kind == "ones":
            t = torch.ones(shape, device=device)
        elif kind == "zeros":
            t = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"{path}: unknown law {law!r}")
        out[path] = t
    return out
